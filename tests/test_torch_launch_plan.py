"""The fused row-cycle engine's launch plan, on the CPU.

On the card the CUDA kernel takes a whole padded batch in one launch; the
plain version keeps the reference's `b_chunk` slices
(`repro_torch.core.transient.fused_launch_plan`).  Rows are independent
and every slice boundary is a B_ALIGN multiple, so both layouts give the
same events and final voltages bit for bit; the kernel itself is held to
that on the card (tests/test_torch_gpu.py, `chip_smoke.py`).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import transient  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

ALIGN = transient.B_ALIGN


@pytest.mark.parametrize("b,b_chunk,one,want", [
    (1, 2048, True, (64, [(0, 64)])),
    (100, 2048, False, (128, [(0, 128)])),
    (2048, 2048, True, (2048, [(0, 2048)])),
    (2049, 2048, True, (4096, [(0, 4096)])),
    (2049, 2048, False, (4096, [(0, 2048), (2048, 4096)])),
    (299008, 2048, True, (299008, [(0, 299008)])),
    (300, 64, False, (320, [(0, 64), (64, 128), (128, 192), (192, 256),
                            (256, 320)])),
])
def test_plan(b, b_chunk, one, want):
    assert transient.fused_launch_plan(b, b_chunk, one) == want


def test_plan_of_the_mc_sweep():
    """paper_grid().with_mc(samples=4096): 299,008 rows, 146 chunks of the
    default 2048 through the plain version, one launch on the card."""
    rows = 73 * 4096
    padded, chunks = transient.fused_launch_plan(
        rows, transient.DEFAULT_B_CHUNK, one_launch=False)
    assert padded == 146 * 2048 and len(chunks) == 146
    assert transient.fused_launch_plan(
        rows, transient.DEFAULT_B_CHUNK, one_launch=True) == (
            padded, [(0, padded)])


@pytest.mark.parametrize("b_chunk", [0, 32, 100, -64])
def test_plan_refuses_unaligned_chunks(b_chunk):
    with pytest.raises(ValueError, match="B_ALIGN"):
        transient.fused_launch_plan(100, b_chunk, True)


def random_operands(rng, b, n=6):
    """Random ladders (tests/test_kernels.py's generator), the first half
    [replica, main] pairs, one starved (timed-out) row."""
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
    params[: b // 4 * 2, 5] = np.tile([1.0, 2.0], b // 4)
    params[b // 2 + 3, 0] = 1e5
    return [torch.as_tensor(np.ascontiguousarray(x, np.float32))
            for x in (c, g, gc_res, gc_pre, v0, params)]


def identical(a, b):
    return bool(((a == b) | (a.isnan() & b.isnan())).all())


def test_one_launch_equals_chunks(rng, monkeypatch):
    """The dispatch as it runs on the card (one call over the padded batch)
    against the plain version's chunks: equal bit for bit."""
    operands = random_operands(rng, 200)
    evt_c, v_c = transient._row_cycle_fused_chunked(operands, "ref", ALIGN)
    calls = []

    def one_call(*args, backend):
        calls.append(args[0].shape[0])
        return ref.row_cycle_fused_ref(*args)

    monkeypatch.setattr(ops, "resolve_backend", lambda backend, x: "cuda")
    monkeypatch.setattr(ops, "row_cycle_fused", one_call)
    evt_1, v_1 = transient._row_cycle_fused_chunked(operands, "auto", ALIGN)
    assert calls == [4 * ALIGN]
    assert evt_1.shape == evt_c.shape == (200, 4)
    assert identical(evt_1, evt_c) and torch.equal(v_1, v_c)
    assert evt_1[:, [0, 2, 3]].isnan().any()          # the starved row


def test_plain_version_keeps_the_chunks(rng, monkeypatch):
    operands = random_operands(rng, 130)
    calls = []
    plain = ops.row_cycle_fused

    def record(*args, backend):
        calls.append(args[0].shape[0])
        return plain(*args, backend=backend)

    monkeypatch.setattr(ops, "row_cycle_fused", record)
    transient._row_cycle_fused_chunked(operands, "auto", ALIGN)
    assert calls == [ALIGN] * 3
