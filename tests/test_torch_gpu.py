"""The port's CUDA kernels against their plain PyTorch versions, on the
card: the fused row cycle and the multi-step RC ladder (phased engine).

Marked `gpu`: without a GPU every test here skips (the kernel has no CPU
mode).  This file imports neither JAX nor the reference package, so it
runs on a machine that has only PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Bars are the reference's Pallas-vs-oracle bars (tests/test_kernels.py):
event times within one dt, identical NaN (timed-out) pattern, dv_sense
rtol 1e-3 / atol 1e-5, v_end rtol 1e-4 / atol 1e-5; rc_multistep traces
rtol 1e-5 / atol 1e-6.  Fused vs phased engine: the reference's own bars
(tests/test_fused_row_cycle.py).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import calibration as cal  # noqa: E402
from repro_torch.core import dse, transient  # noqa: E402
from repro_torch.core.space import DesignSpace  # noqa: E402
from repro_torch.kernels import ops, rc_transient, row_cycle  # noqa: E402

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


def random_ladder(rng, b, n, t, device):
    """Random ladders with a nonzero clamp network and a rising ramp."""
    c = rng.uniform(1, 5, (b, n))
    g = rng.uniform(0.05, 0.2, (b, n - 1))
    gc = rng.uniform(0.0, 0.3, (b, n))
    vc = rng.uniform(0.0, 1.1, (b, n))
    v0 = rng.uniform(0, 1.1, (b, n))
    ramp = 1.0 - np.exp(-(np.arange(t) + 1) * DT / 0.7)
    return [torch.as_tensor(np.ascontiguousarray(x, np.float32), device=device)
            for x in (c, g, gc, vc, v0, ramp)]


@pytest.mark.parametrize("b,n,t", [(1000, 4, 64), (1025, 6, 800),
                                   (129, 8, 100), (1, 6, 5)])
def test_rc_multistep_kernel_matches_plain(rng, cuda, b, n, t):
    args = random_ladder(rng, b, n, t, cuda)
    before = rc_transient.rc_multistep_cuda.launches
    out_k = ops.rc_multistep(*args, DT, backend="cuda")
    assert rc_transient.rc_multistep_cuda.launches == before + 1
    out_p = ops.rc_multistep(*args, DT, backend="ref")
    torch.cuda.synchronize()
    assert out_k.shape == (t, b, n)
    np.testing.assert_allclose(out_k.cpu().numpy(), out_p.cpu().numpy(),
                               rtol=1e-5, atol=1e-6)


def test_rc_multistep_wrapper_rejects_unsupported_inputs(rng, cuda):
    args = random_ladder(rng, 64, 5, 8, cuda)
    with pytest.raises(ValueError, match="N=5 not supported"):
        rc_transient.rc_multistep_cuda(*args, DT)
    args = random_ladder(rng, 64, 6, 8, cuda)
    with pytest.raises(ValueError, match="ramp must be"):
        rc_transient.rc_multistep_cuda(*args[:5], args[5][None], DT)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        rc_transient.rc_multistep_cuda(*args[:5], args[5].cpu(), DT)


@pytest.mark.parametrize("replica", [False, True], ids=["fixed", "replica"])
@pytest.mark.parametrize("tech,scheme,layers", [
    ("si", "sel_strap", [87, 137]), ("aos", "sel_strap", [87, 137]),
    ("d1b", "direct", [1])])
def test_phased_engine_on_card_matches_fused(cuda, tech, scheme, layers,
                                             replica):
    t = cal.get_tech(tech)
    before = rc_transient.rc_multistep_cuda.launches
    p = transient.simulate_row_cycle(t, scheme, layers, traces=True,
                                     replica=replica, device=cuda)
    assert rc_transient.rc_multistep_cuda.launches == before + (
        4 if replica else 3)
    f = transient.simulate_row_cycle(t, scheme, layers, replica=replica,
                                     device=cuda)
    plain = transient.simulate_row_cycle_phased(
        t, scheme, layers, backend="ref", replica=replica, device=cuda)
    for name in ("t_fire_ns", "t_restore_ns", "t_precharge_ns", "trc_ns"):
        a, b = getattr(p, name), getattr(plain, name)
        assert bool(((a == b) | (a.isnan() & b.isnan())).all()), name

    def diff(name):
        return (getattr(f, name) - getattr(p, name)).abs().max().item()

    assert diff("t_precharge_ns") <= DT + 1e-6
    res = ((f.t_restore_ns - f.t_sense_ns)
           - (p.t_restore_ns - p.t_sense_ns)).abs().max().item()
    assert res <= DT + 1e-5
    assert diff("t_sense_ns") <= DT + 0.05
    assert diff("trc_ns") <= 3 * DT + 0.05
