"""The row-cycle CUDA kernel against its plain PyTorch version, on the card.

Marked `gpu`: without a GPU every test here skips (the kernel has no CPU
mode).  This file imports neither JAX nor the reference package, so it
runs on a machine that has only PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Bars are the reference's Pallas-vs-oracle bars (tests/test_kernels.py):
event times within one dt, identical NaN (timed-out) pattern, dv_sense
rtol 1e-3 / atol 1e-5, v_end rtol 1e-4 / atol 1e-5.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import dse, transient  # noqa: E402
from repro_torch.core.space import DesignSpace  # noqa: E402
from repro_torch.kernels import ops, row_cycle  # noqa: E402

pytestmark = pytest.mark.gpu

DT = transient.DT_NS
CAPS = (transient.N_ACT_STEPS, transient.N_RESTORE_STEPS,
        transient.N_PRE_STEPS)


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc (the kernel has no CPU mode)")
    return torch.device("cuda")


def random_operands(rng, b, n, device, replica=True, legacy=False):
    """Random ladders (the generator of tests/test_kernels.py, thresholds
    every ladder reaches): the first half [replica, main] pairs, 64 padding
    rows at the end, one starved (timed-out) standalone row."""
    c = rng.uniform(1, 5, (b, n))
    g = rng.uniform(0.05, 0.2, (b, n - 1))
    gc_res = np.zeros((b, n))
    gc_res[:, 0] = 0.125
    gc_pre = np.zeros((b, n))
    gc_pre[:, :n - 1] = 0.125
    v0 = np.full((b, n), 0.55)
    v0[:, n - 1] = 1.0
    params = np.stack([rng.uniform(0.5, 4.0, b), rng.uniform(0.005, 0.05, b),
                       np.full(b, 1.1), np.full(b, 0.55), np.ones(b),
                       np.zeros(b)], axis=1)
    if replica:
        params[: b // 2, 5] = np.tile([1.0, 2.0], b // 4)
    params[-64:, 4] = 0.0
    params[b // 2 + 3, 0] = 1e5
    if legacy:
        params = params[:, :5]
    return [torch.as_tensor(np.ascontiguousarray(x, np.float32), device=device)
            for x in (c, g, gc_res, gc_pre, v0, params)]


def assert_match(evt_k, vend_k, evt_p, vend_p):
    evt_k, vend_k, evt_p, vend_p = (x.cpu().numpy()
                                    for x in (evt_k, vend_k, evt_p, vend_p))
    t_k, t_p = evt_k[:, [0, 2, 3]], evt_p[:, [0, 2, 3]]
    np.testing.assert_array_equal(np.isnan(t_k), np.isnan(t_p))
    steps = np.rint(np.where(np.isnan(t_p), 0.0, np.abs(t_k - t_p)) / DT)
    assert steps.max() <= 1
    np.testing.assert_allclose(evt_k[:, 1], evt_p[:, 1], rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(vend_k, vend_p, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("b,n", [(2048, 4), (2048, 6), (2048, 8), (200, 6)])
def test_kernel_matches_plain(rng, cuda, b, n):
    args = random_operands(rng, b, n, cuda)
    before = row_cycle.row_cycle_fused_cuda.launches
    evt_k, vend_k = ops.row_cycle_fused(*args, DT, *CAPS, backend="cuda")
    assert row_cycle.row_cycle_fused_cuda.launches == before + 1
    evt_p, vend_p = ops.row_cycle_fused(*args, DT, *CAPS, backend="ref")
    assert torch.isnan(evt_k[b // 2 + 3, 0])
    assert_match(evt_k, vend_k, evt_p, vend_p)


def test_kernel_matches_plain_legacy_params(rng, cuda):
    args = random_operands(rng, 512, 6, cuda, replica=False, legacy=True)
    assert args[5].shape == (512, 5)
    assert_match(*ops.row_cycle_fused(*args, DT, *CAPS, backend="cuda"),
                 *ops.row_cycle_fused(*args, DT, *CAPS, backend="ref"))


def test_auto_backend_launches_the_kernel_on_cuda(rng, cuda):
    args = random_operands(rng, 128, 6, cuda)
    before = row_cycle.row_cycle_fused_cuda.launches
    ops.row_cycle_fused(*args, DT, *CAPS)
    assert row_cycle.row_cycle_fused_cuda.launches == before + 1


def test_wrapper_rejects_main_row_at_even_index(rng, cuda):
    args = random_operands(rng, 128, 6, cuda)
    args[5][2, 5] = 2.0
    with pytest.raises(ValueError, match="even index"):
        ops.row_cycle_fused(*args, DT, *CAPS, backend="cuda")


def test_wrapper_rejects_unsupported_inputs(rng, cuda):
    with pytest.raises(ValueError, match="N=5 not supported"):
        ops.row_cycle_fused(*random_operands(rng, 128, 5, cuda), DT, *CAPS,
                            backend="cuda")
    args = random_operands(rng, 128, 6, cuda)
    with pytest.raises(TypeError, match="float32"):
        row_cycle.row_cycle_fused_cuda(args[0].double(), *args[1:], DT, *CAPS)
    with pytest.raises(ValueError, match="contiguous"):
        row_cycle.row_cycle_fused_cuda(args[0].t().contiguous().t(),
                                       *args[1:], DT, *CAPS)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        row_cycle.row_cycle_fused_cuda(args[0].cpu(), *args[1:], DT, *CAPS)


def test_sweep_on_card_matches_plain_sweep(cuda):
    space = DesignSpace.paper_grid().with_replica()
    before = row_cycle.row_cycle_fused_cuda.launches
    k = dse.sweep(space, device=cuda)
    assert row_cycle.row_cycle_fused_cuda.launches == before + 1
    p = dse.sweep(space, backend="ref", device=cuda)
    assert torch.equal(k.feasible, p.feasible)
    assert torch.equal(dse.pareto_mask(k), dse.pareto_mask(p))
    steps = ((k.t_fire_ns - p.t_fire_ns).abs().nan_to_num() / DT).round()
    assert steps.max().item() <= 1
    best = dse.best_design(k)
    assert (best.tech, best.scheme, best.layers) == ("aos", "sel_strap", 87)
