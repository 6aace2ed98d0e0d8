"""The port's CUDA kernels against their plain PyTorch versions, on the
card: the fused row cycle, the multi-step RC ladder (phased engine) and
the strap-gated decode attention (LM server).

Marked `gpu`: without a GPU every test here skips (the kernel has no CPU
mode).  This file imports neither JAX nor the reference package, so it
runs on a machine that has only PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Bars are the reference's Pallas-vs-oracle bars (tests/test_kernels.py):
event times within one dt, identical NaN (timed-out) pattern, dv_sense
rtol 1e-3 / atol 1e-5, v_end rtol 1e-4 / atol 1e-5; rc_multistep traces
rtol 1e-5 / atol 1e-6 and, beside them, bit for bit (int32 views) with the
plain version.  Fused vs phased engine: the reference's own bars
(tests/test_fused_row_cycle.py).  strap_attend: the reference's
Pallas-vs-oracle bars, rtol / atol 3e-5 in float32 and 3e-2 in bf16;
in bf16 also rtol 2^-6 (two bf16 ulps, both sides round a float32 result
once) / atol 1e-3, a bar tied to the output's scale.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import calibration as cal  # noqa: E402
from repro_torch.core import dse, transient  # noqa: E402
from repro_torch.core.space import DesignSpace  # noqa: E402
from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.device import as_f32, scalar_f32  # noqa: E402
from repro_torch.kernels import (ops, rc_transient, ref,  # noqa: E402
                                 row_cycle, strap_gather)
from repro_torch.kernels.bench import (count_syncs,  # noqa: E402
                                       rc_adversarial_ladders)
from repro_torch.memory.strap_cache import StrapCacheConfig  # noqa: E402
from repro_torch.models import registry as models  # noqa: E402
from repro_torch.serving.engine import ServeEngine  # noqa: E402

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


def test_row_cycle_one_launch_equals_chunks_and_plain(rng, cuda):
    """A batch past the default chunk: the dispatch issues one launch over
    the padded batch; its events and final voltages equal explicit
    per-2048-row kernel calls and the plain version bit for bit."""
    b = 5000
    args = random_operands(rng, b, 6, cuda)
    before = row_cycle.row_cycle_fused_cuda.launches
    evt, v_end = transient._row_cycle_fused_chunked(
        args, "auto", transient.DEFAULT_B_CHUNK)
    assert row_cycle.row_cycle_fused_cuda.launches == before + 1
    padded_rows, chunks = transient.fused_launch_plan(
        b, transient.DEFAULT_B_CHUNK, one_launch=False)
    padded = transient._pad_operands(args, padded_rows - b)
    per_chunk = [ops.row_cycle_fused(*[x[lo:hi].contiguous() for x in padded],
                                     DT, *CAPS, backend="cuda")
                 for lo, hi in chunks]
    evt_c = torch.cat([e for e, _ in per_chunk])[:b]
    v_c = torch.cat([v for _, v in per_chunk])[:b]
    evt_p, v_p = ops.row_cycle_fused(*args, DT, *CAPS, backend="ref")

    def same(x, y):
        return bool(((x == y) | (x.isnan() & y.isnan())).all())

    assert same(evt, evt_c) and torch.equal(v_end, v_c)
    assert same(evt, evt_p) and torch.equal(v_end, v_p)
    assert torch.isnan(evt[b // 2 + 3, 0])


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
    assert torch.equal(out_k.view(torch.int32), out_p.view(torch.int32))


@pytest.mark.parametrize("name", sorted(rc_adversarial_ladders(
    np.random.default_rng(0))))
def test_rc_multistep_kernel_bitwise_on_adversarial_ladders(cuda, name):
    """Ladders at the edges of the kernel's exact quotient form (spread
    coefficients, zero and -0.0 states, values at the guard's 2^-100, a
    ramp that falls to exactly zero) give the plain version's trace bit
    for bit."""
    host = rc_adversarial_ladders(np.random.default_rng(0))[name]
    args = [torch.as_tensor(x, device=cuda) for x in host]
    out_k = ops.rc_multistep(*args, DT, backend="cuda")
    out_p = ops.rc_multistep(*args, DT, backend="ref")
    torch.cuda.synchronize()
    np.testing.assert_allclose(out_k.cpu().numpy(), out_p.cpu().numpy(),
                               rtol=1e-5, atol=1e-6)
    assert torch.equal(out_k.view(torch.int32), out_p.view(torch.int32))


def test_rc_multistep_reciprocal_is_ieee_division(cuda):
    """The kernel's branch-free reciprocal equals 1.0f / b on every float32
    of its range, both signs."""
    assert rc_transient.reciprocal_mismatches(cuda) == 0


def test_rc_multistep_block_geometry_from_the_library(rng, cuda):
    """The built library reports its block: whole warps, at least one row a
    block, and a batch one row past a block's rows still matches the plain
    version bit for bit."""
    geo = rc_transient.block_geometry()
    assert geo["threads"] % 32 == 0 and 0 < geo["rows"] <= geo["threads"]
    args = random_ladder(rng, geo["rows"] + 1, 6, 40, cuda)
    out_k = ops.rc_multistep(*args, DT, backend="cuda")
    out_p = ops.rc_multistep(*args, DT, backend="ref")
    assert torch.equal(out_k.view(torch.int32), out_p.view(torch.int32))


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
    for key, trace in p.traces.items():
        assert torch.equal(trace.view(torch.int32),
                           plain.traces[key].view(torch.int32)), key


@pytest.mark.parametrize("replica", [False, True], ids=["fixed", "replica"])
def test_phased_call_makes_no_host_sync(cuda, replica):
    """The phased call at B = 1024 (numpy layers, as a user passes them)
    enqueues its work without waiting for the card: it runs under
    `torch.cuda.set_sync_debug_mode("error")`."""
    si = cal.get_tech("si")
    layers = np.linspace(32, 288, 1024).astype(np.float32)

    def call():
        return transient.simulate_row_cycle(si, "sel_strap", layers,
                                            traces=True, replica=replica,
                                            device=cuda)

    want = call()
    before = rc_transient.rc_multistep_cuda.launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = call()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert rc_transient.rc_multistep_cuda.launches == before + (
        4 if replica else 3)
    assert count_syncs(call)[0] == 0
    for name in ("t_fire_ns", "trc_ns", "dv_sense_v"):
        a, b = getattr(got, name), getattr(want, name)
        assert torch.equal(a.view(torch.int32), b.view(torch.int32)), name


def test_device_scalars_divide_truly_on_the_card(cuda):
    """A 0-d float32 built on the card is a true divisor there (a Python
    float divisor is a reciprocal multiply); arrays arrive unchanged."""
    rng = np.random.default_rng(3)
    x = (rng.uniform(-10, 10, 1 << 16)
         * 10.0 ** rng.integers(-5, 5, 1 << 16)).astype(np.float32)
    for d in (0.02, 7e-3, 1.0 / 3.0):
        got = (torch.as_tensor(x, device=cuda) / scalar_f32(d, cuda)).cpu()
        want = torch.from_numpy(x / np.float32(d))
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.equal(as_f32(x, cuda).cpu(), torch.from_numpy(x))
    assert torch.equal(as_f32(x, cuda, non_blocking=True).cpu(),
                       torch.from_numpy(x))


# the reference's kernel test shapes, then two that reach the kernel's
# other branches: D = 30 (rows copied element by element, D padded to the
# mma depth) and D = 256 with grp = 8 (the widest instantiation)
STRAP_SHAPES = [(2, 8, 16, 2, 64, 8, 2), (1, 4, 8, 1, 128, 4, 4),
                (3, 6, 32, 3, 32, 6, 3), (2, 16, 8, 4, 64, 16, 4),
                (1, 8, 128, 2, 128, 2, 2), (2, 8, 16, 2, 30, 8, 2),
                (3, 8, 16, 1, 256, 8, 2)]


def unaligned(x):
    """`x` copied to one element past a 16-byte-aligned base: contiguous,
    but its base pointer is not 16-byte aligned."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    out = buf[1:].view(x.shape)
    out.copy_(x)
    return out


def strap_case(rng, b, p, page, hkv, d, hq, g, device, dtype=torch.float32,
               shift=False):
    """Random pages with, where the shape allows, a masked strap, a partial
    length, a duplicated id and an all-masked row; with `shift`, the pages
    start off a 16-byte boundary."""
    s = p // g
    q, k, v = (torch.as_tensor(rng.normal(size=shape).astype(np.float32),
                               device=device).to(dtype)
               for shape in ((b, hq, d), (b, p, page, hkv, d),
                             (b, p, page, hkv, d)))
    if shift:
        k, v = unaligned(k), unaligned(v)
    ids = np.stack([rng.permutation(s) for _ in range(b)])
    lengths = np.full(b, p * page)
    if s > 1:
        ids[0, -1] = -1
        lengths[0] = p * page - page * g // 2 - 1
        ids[-1, 0] = ids[-1, 1]
    if b > 1:
        ids[1] = -1
    t = lambda x: torch.as_tensor(np.asarray(x, np.int32), device=device)
    return q, k, v, t(ids), g, t(lengths)


@pytest.mark.parametrize("shape", STRAP_SHAPES,
                         ids=["x".join(map(str, s)) for s in STRAP_SHAPES])
def test_strap_attend_kernel_matches_plain(rng, cuda, shape):
    q, k, v, ids, g, lengths = strap_case(rng, *shape, cuda)
    before = strap_gather.strap_attend_cuda.launches
    out_k = ops.strap_attend(q, k, v, ids, g, lengths=lengths)
    assert strap_gather.strap_attend_cuda.launches == before + 1
    out_p = ops.strap_attend(q, k, v, ids, g, lengths=lengths, backend="ref")
    np.testing.assert_allclose(out_k.cpu().numpy(), out_p.cpu().numpy(),
                               rtol=3e-5, atol=3e-5)
    if shape[0] > 1:
        assert not out_k[1].any()           # all-masked row: zeros


def test_strap_attend_kernel_bf16_decode_shape(rng, cuda):
    """Qwen2-1.5B's decode call: q (8, 12, 128), 36 pages of 64, S = 9."""
    q, k, v, ids, g, lengths = strap_case(rng, 8, 36, 64, 2, 128, 12, 4,
                                          cuda, torch.bfloat16)
    out_k = ops.strap_attend(q, k, v, ids, g, lengths=lengths)
    assert out_k.dtype == torch.bfloat16
    out_p = ops.strap_attend(q, k, v, ids, g, lengths=lengths, backend="ref")
    np.testing.assert_allclose(out_k.float().cpu().numpy(),
                               out_p.float().cpu().numpy(), rtol=3e-2,
                               atol=3e-2)
    np.testing.assert_allclose(out_k.float().cpu().numpy(),
                               out_p.float().cpu().numpy(), rtol=2.0 ** -6,
                               atol=1e-3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("shape", STRAP_SHAPES,
                         ids=["x".join(map(str, s)) for s in STRAP_SHAPES])
def test_strap_attend_kernel_matches_split_plain(rng, cuda, shape, dtype):
    """The kernel against the plain version of its own split plan
    (`ref.strap_attend_split_ref` at `split_plan`'s chunk); a duplicated id
    counts twice: the same as the strap's tokens listed twice."""
    q, k, v, ids, g, lengths = strap_case(rng, *shape, cuda, dtype)
    plan = strap_gather.split_plan(k.shape, g, ids.shape[1])
    out_k = ops.strap_attend(q, k, v, ids, g, lengths=lengths)
    out_s = ref.strap_attend_split_ref(q, k, v, ids, g, plan.chunk,
                                       lengths=lengths)
    tol = 3e-5 if dtype == torch.float32 else 3e-2
    np.testing.assert_allclose(out_k.float().cpu().numpy(),
                               out_s.float().cpu().numpy(), rtol=tol,
                               atol=tol)
    if shape[0] > 1:
        assert not out_k[1].any()           # all-masked row: zeros
    if shape[0] > 2:
        # the last row lists strap ids[-1, 1] twice: the same as listing
        # it once and once more a copy of it, in pages doubled
        p = k.shape[1]
        twin = ids[-1:].clone()
        twin[0, 0] = ids[-1, 1] + p // g
        out_t = ops.strap_attend(
            q[-1:], torch.cat([k[-1:], k[-1:]], 1).contiguous(),
            torch.cat([v[-1:], v[-1:]], 1).contiguous(), twin, g,
            lengths=2 * lengths[-1:])
        np.testing.assert_allclose(out_k[-1:].float().cpu().numpy(),
                                   out_t.float().cpu().numpy(), rtol=tol,
                                   atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_strap_attend_kernel_unaligned_pages(rng, cuda, dtype):
    """Pages whose base pointer is off a 16-byte boundary: the kernel
    copies K and V rows element by element (D = 200: the widest
    instantiation, D padded to the mma depth)."""
    q, k, v, ids, g, lengths = strap_case(rng, 3, 8, 16, 2, 200, 12, 2, cuda,
                                          dtype, shift=True)
    assert not strap_gather.vector_loads(k, v)
    out_k = ops.strap_attend(q, k, v, ids, g, lengths=lengths)
    out_p = ops.strap_attend(q, k, v, ids, g, lengths=lengths, backend="ref")
    tol = 3e-5 if dtype == torch.float32 else 3e-2
    np.testing.assert_allclose(out_k.float().cpu().numpy(),
                               out_p.float().cpu().numpy(), rtol=tol,
                               atol=tol)
    assert not out_k[1].any()               # all-masked row: zeros


def test_strap_attend_kernel_bf16_gated_selection(rng, cuda):
    """Qwen2-1.5B's decode call with 4 of the 9 straps selected (the gated
    engine's top 4), the newest strap partly filled."""
    q, k, v, ids, g, lengths = strap_case(rng, 8, 36, 64, 2, 128, 12, 4,
                                          cuda, torch.bfloat16)
    ids = ids[:, :4].contiguous()
    before = strap_gather.strap_attend_cuda.launches
    out_k = ops.strap_attend(q, k, v, ids, g, lengths=lengths)
    assert strap_gather.strap_attend_cuda.launches == before + 1
    out_p = ops.strap_attend(q, k, v, ids, g, lengths=lengths, backend="ref")
    np.testing.assert_allclose(out_k.float().cpu().numpy(),
                               out_p.float().cpu().numpy(), rtol=2.0 ** -6,
                               atol=1e-3)


def test_strap_attend_wrapper_rejects_unsupported_inputs(rng, cuda):
    q, k, v, ids, g, lengths = strap_case(rng, 2, 8, 16, 2, 64, 8, 2, cuda)
    kernel = strap_gather.strap_attend_cuda
    with pytest.raises(TypeError, match="int32"):
        kernel(q, k, v, ids.long(), g, lengths=lengths)
    with pytest.raises(TypeError, match="must match"):
        kernel(q, k.bfloat16(), v, ids, g, lengths=lengths)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        kernel(q.double(), k.double(), v.double(), ids, g)
    with pytest.raises(ValueError, match="multiple of Hkv"):
        kernel(q[:, :7].contiguous(), k, v, ids, g)
    with pytest.raises(ValueError, match="pages_per_strap"):
        kernel(q, k, v, ids, 3)
    with pytest.raises(ValueError, match="contiguous"):
        kernel(q, k.transpose(1, 2), v, ids, g)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        kernel(q, k, v, ids.cpu(), g)
    wide = torch.zeros(2, 8, 512, device=cuda)
    pages = torch.zeros(2, 8, 16, 2, 512, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        kernel(wide, pages, pages, ids, g)


def test_strap_engine_on_card_equals_dense(cuda):
    """qwen2-1.5b-smoke (float32) on the card: the strap-exact engine gives
    the dense engine's greedy tokens (tests/test_strap_cache.py's claim),
    through the kernel."""
    cfg = get_arch("qwen2-1.5b-smoke")
    params = models.init_params(
        cfg, torch.Generator(device=cuda).manual_seed(0), device=cuda)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 32))
    out = {}
    for backend in ("dense", "strap"):
        eng = ServeEngine(cfg, params, max_tokens=48, cache_backend=backend,
                          strap_cfg=StrapCacheConfig(8, 2), device=cuda)
        before = strap_gather.strap_attend_cuda.launches
        eng.prefill(prompts)
        out[backend] = torch.cat([eng.step()[0] for _ in range(6)], 1)
        launches = strap_gather.strap_attend_cuda.launches - before
        assert launches == (cfg.n_layers * 6 if backend == "strap" else 0)
    assert torch.equal(out["dense"], out["strap"])


def test_service_window_on_card_is_one_launch_and_equals_direct(cuda):
    """The co-design service on the card: a sweep and a yield query in one
    window share one row-cycle launch; each response equals the direct
    sweep (NaN-aware, bit for bit); a fixed and a replica space in one
    window take one launch each; a repeat is a memo hit with no launch."""
    from repro_torch.launch.serve import _batches_identical
    from repro_torch.serving.dse_service import DSEService

    kernel = row_cycle.row_cycle_fused_cuda
    svc = DSEService(window_ms=0.0, device=cuda)
    svc.warm()
    s_grid = DesignSpace.paper_grid()
    s_mc = DesignSpace.paper_grid().with_mc(samples=512, key=2)
    torch.cuda.synchronize()
    before = kernel.launches
    fa = svc.submit(s_grid)
    fy = svc.submit(s_mc, kind="yield", spec={"margin_mv": 80.0})
    assert svc.flush() == 2
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert _batches_identical(fa.result(timeout=60.0).batch,
                              dse.sweep(s_grid, device=cuda))
    ry = fy.result(timeout=60.0)
    want = dse.sweep(s_mc, device=cuda)
    assert _batches_identical(ry.batch, want)
    assert _batches_identical(ry.summary, want.mc_summary(margin_mv=80.0))

    s_fixed = DesignSpace.product(techs=["aos"], layers=(64, 87))
    s_rep = DesignSpace.paper_grid().with_replica()
    torch.cuda.synchronize()
    before = kernel.launches
    ff, fr = svc.submit(s_fixed), svc.submit(s_rep)
    svc.flush()
    torch.cuda.synchronize()
    assert kernel.launches == before + 2
    assert _batches_identical(ff.result(timeout=60.0).batch,
                              dse.sweep(s_fixed, device=cuda))
    assert _batches_identical(fr.result(timeout=60.0).batch,
                              dse.sweep(s_rep, device=cuda))

    before = kernel.launches
    again = svc.submit(s_grid)
    svc.flush()
    torch.cuda.synchronize()
    assert again.result(timeout=60.0).memo_hit
    assert kernel.launches == before


def test_service_dispatcher_thread_on_card(cuda):
    """Blocking clients on other threads, the dispatcher thread launching:
    every client reads results equal to the direct sweep."""
    import threading

    from repro_torch.launch.serve import _batches_identical
    from repro_torch.serving.dse_service import DSEService

    spaces = (DesignSpace.product(techs=["aos"], layers=(87, 137)),
              DesignSpace.product(techs=["si"], layers=(87,)),
              DesignSpace.paper_targets().with_mc(samples=16, key=0))
    golden = [dse.sweep(s, device=cuda) for s in spaces]
    out, errors = {}, []

    def client(i, service):
        try:
            out[i] = service.sweep(spaces[i % 3], timeout=120.0)
        except Exception as e:          # pragma: no cover
            errors.append(e)

    with DSEService(window_ms=5.0, device=cuda) as service:
        threads = [threading.Thread(target=client, args=(i, service))
                   for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120.0)
        assert not any(t.is_alive() for t in threads)
    assert errors == []
    assert all(_batches_identical(out[i], golden[i % 3]) for i in range(6))


# --------------------------------------------------------------------------
# The sweep fabric on the card (launch.shard, launch.elastic)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("slots", [1, 4])
def test_sharded_sweep_on_card_one_launch_a_slot(cuda, slots):
    """The Monte-Carlo paper grid over a mesh of `slots` slots on the card:
    one row-cycle launch a slot, the batch bit-identical (int32 views) to
    the direct sweep."""
    from repro_torch.launch import shard
    from repro_torch.launch.mesh import make_sweep_mesh, make_test_mesh

    mesh = (make_sweep_mesh(1, device=cuda) if slots == 1 else
            make_test_mesh((slots,), ("batch",), device=cuda))
    space = DesignSpace.paper_grid().with_mc(samples=512, key=0)
    want = dse.sweep(space, device=cuda)
    torch.cuda.synchronize()
    before = row_cycle.row_cycle_fused_cuda.launches
    got = dse.sweep(space, sharding=mesh, device=cuda)
    torch.cuda.synchronize()
    assert row_cycle.row_cycle_fused_cuda.launches == before + slots
    assert shard.batch_mismatches(got, want) == []


def test_sharded_pareto_on_card_equals_sequential(cuda):
    from repro_torch.launch.mesh import make_test_mesh

    batch = dse.sweep(DesignSpace.paper_grid().with_mc(samples=64, key=1),
                      device=cuda)
    for slots, block in ((1, 4096), (4, 4096), (3, 97)):
        mesh = make_test_mesh((slots,), ("batch",), device=cuda)
        assert torch.equal(dse.pareto_mask(batch, sharding=mesh, block=block),
                           dse.pareto_mask(batch, block=block))


def test_elastic_host_drop_on_card(cuda):
    """Eight slots on the card, host3 dropped after slab 1: one restart,
    8 -> 7 slots, a quarter of the points redone, the batch bit-identical
    to the direct sweep; every slab run is one launch a slot."""
    from repro_torch.launch import elastic, shard
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.runtime.fault import FailureInjector

    space = DesignSpace.paper_grid().with_mc(samples=64, key=0)
    want = dse.sweep(space, device=cuda)
    torch.cuda.synchronize()
    before = row_cycle.row_cycle_fused_cuda.launches
    batch, rep = elastic.elastic_sweep(
        space, make_test_mesh((8,), ("batch",), device=cuda), device=cuda,
        injector=FailureInjector(schedule={1: "drop:host3"}))
    torch.cuda.synchronize()
    assert shard.batch_mismatches(batch, want) == []
    assert (rep.restarts, rep.dropped_hosts) == (1, ["host3"])
    assert rep.device_history == [8, 8, 7, 7, 7]
    assert rep.resume_overhead_frac == pytest.approx(0.25)
    assert (row_cycle.row_cycle_fused_cuda.launches - before
            == sum(rep.device_history))
