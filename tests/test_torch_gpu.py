"""The port's CUDA kernels against their plain PyTorch versions, on the
card: the fused row cycle, the multi-step RC ladder (phased engine) and
the strap-gated decode attention (LM server), the MoE layer against
its per-pair plain version, the SSM scan and the ssm, hybrid and
enc-dec decode steps on the card, and training: a train step on the card
against the CPU, the SSD backward where its decay overflows, a
checkpoint of the card's state restored on the CPU, and the sharded
train step on a one-rank NCCL mesh, bit for bit the train step.

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


# (B, P, page, Hkv, D, Hq, G) at the full-width decode calls of the new
# families: Pixtral-12B (GQA group 4, 8 kv heads) and OLMo-1B (MHA, group
# 1, 16 kv heads), a 2,304-token strap cache of 256-token straps
STRAP_FAMILY_SHAPES = {"pixtral_group4": (8, 36, 64, 8, 128, 32, 4),
                       "olmo_group1": (8, 36, 64, 16, 128, 16, 4)}


@pytest.mark.parametrize("top", [0, 4], ids=["exact", "gated_top4"])
@pytest.mark.parametrize("name", sorted(STRAP_FAMILY_SHAPES))
def test_strap_attend_kernel_bf16_family_decode_shapes(rng, cuda, name, top):
    q, k, v, ids, g, lengths = strap_case(rng, *STRAP_FAMILY_SHAPES[name],
                                          cuda, torch.bfloat16)
    if top:
        ids = ids[:, :top].contiguous()
    before = strap_gather.strap_attend_cuda.launches
    out_k = ops.strap_attend(q, k, v, ids, g, lengths=lengths)
    assert strap_gather.strap_attend_cuda.launches == before + 1
    out_p = ops.strap_attend(q, k, v, ids, g, lengths=lengths, backend="ref")
    got, want = out_k.float().cpu().numpy(), out_p.float().cpu().numpy()
    np.testing.assert_allclose(got, want, rtol=3e-2, atol=3e-2)
    np.testing.assert_allclose(got, want, rtol=2.0 ** -6, atol=1e-3)
    assert not out_k[1].any()               # all-masked row: zeros


@pytest.mark.parametrize("name", ["pixtral-12b-smoke", "olmo-1b-smoke"])
def test_family_strap_engine_on_card_equals_dense(cuda, name):
    """The VLM (group 2) and OLMo's MHA (group 1) smoke configs in float32:
    strap-exact greedy tokens equal the dense engine's, through the
    kernel, one launch a layer and step."""
    cfg = get_arch(name)
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


@pytest.mark.parametrize("expert", [None, 0, -1],
                         ids=["no_drops", "expert0_biased",
                              "last_expert_biased"])
@pytest.mark.parametrize("name", ["phi3.5-moe-42b-a6.6b-smoke",
                                  "arctic-480b-smoke"])
def test_moe_apply_on_card_matches_pair_loop(cuda, monkeypatch, name, expert):
    """`moe_apply` in float32 on the card against the plain per-pair
    version (`moe.moe_apply_pairs`), TF32 off; the biased cases raise one
    expert's router logit by 4 at capacity_factor 1.0, so pairs drop and
    the reference's dropped-pair writes apply.  Bar: 2e-5, the port's
    float32 bar."""
    import dataclasses

    from repro_torch.models import lm, moe

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = get_arch(name)
    params = models.init_params(
        cfg, torch.Generator(device=cuda).manual_seed(0), device=cuda)
    lp = lm.layer_params(params, 0)
    gen = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(2, 64, cfg.d_model, generator=gen, device=cuda)
    if expert is not None:
        cfg = dataclasses.replace(cfg, capacity_factor=1.0)
        x[..., 0] = 1.0
        router = lp["router"].clone()
        router[0] = 0.0
        router[0, expert] = 4.0
        lp = dict(lp, router=router)
    y, _ = moe.moe_apply(cfg, lp, x)
    want, info = moe.moe_apply_pairs(cfg, lp, x)
    assert (info["dropped"] == 0) == (expert is None)
    np.testing.assert_allclose(y.cpu().numpy(), want.cpu().numpy(),
                               rtol=2e-5, atol=2e-5)


def ssd_recurrence64(x, bmat, cmat, dt, a_neg):
    """The SSD token by token in float64 (tests/test_models.py's
    recurrence; head h reads B/C group h // (nh // ng))."""
    b, l, nh, hp = x.shape
    rep = nh // bmat.shape[2]
    x, dt, a = x.double(), dt.double(), a_neg.double()
    bh = bmat.double().repeat_interleave(rep, dim=2)
    ch = cmat.double().repeat_interleave(rep, dim=2)
    h = torch.zeros(b, nh, hp, bmat.shape[-1], dtype=torch.float64,
                    device=x.device)
    ys = []
    for t in range(l):
        dtx = x[:, t] * dt[:, t][..., None]
        h = (h * torch.exp(dt[:, t] * a)[..., None, None]
             + dtx[..., :, None] * bh[:, t][:, :, None, :])
        ys.append(torch.einsum("bhpn,bhn->bhp", h, ch[:, t]))
    return torch.stack(ys, 1), h


@pytest.mark.parametrize("ng", [1, 2])
def test_ssd_chunked_on_card_equals_recurrence(cuda, monkeypatch, ng):
    """The chunked scan in float32 on the card (TF32 off) against the
    float64 recurrence: 3 chunks of 64 over 192 tokens, 16 heads of 64, a
    state of 128.  Bar: rtol / atol 2e-4, the reference's (`TestSSD`)."""
    import dataclasses

    from repro_torch.models import ssm

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = dataclasses.replace(get_arch("mamba2-780m"), ssm_chunk=64)
    gen = torch.Generator(device=cuda).manual_seed(ng)
    draw = lambda *shape: torch.randn(*shape, generator=gen, device=cuda)
    b, l, nh, hp, st = 2, 192, 16, 64, 128
    x, bm, cm = draw(b, l, nh, hp), draw(b, l, ng, st) * 0.5, \
        draw(b, l, ng, st) * 0.5
    dt, a_neg = draw(b, l, nh).abs() * 0.1, -draw(nh).abs()
    y, h = ssm.ssd_chunked(cfg, x, bm, cm, dt, a_neg)
    y_ref, h_ref = ssd_recurrence64(x, bm, cm, dt, a_neg)
    np.testing.assert_allclose(y.cpu().numpy(), y_ref.cpu().numpy(),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(h.cpu().numpy(), h_ref.cpu().numpy(),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("name", ["mamba2-780m-smoke", "zamba2-7b-smoke",
                                  "whisper-tiny-smoke"])
def test_family_decode_on_card_matches_prefill_of_one_more_token(cuda,
                                                                 name):
    """float32 smoke configs on the card: a decode step after the prefill
    of 64 tokens against the prefill of 65, 2e-2 relative (the reference's
    bar, tests/test_models.py); Whisper's cross cache unchanged."""
    cfg = get_arch(name)
    params = models.init_params(
        cfg, torch.Generator(device=cuda).manual_seed(0), device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (2, 65), generator=gen,
                         device=cuda, dtype=torch.int32)
    batch = {"tokens": toks}
    if cfg.is_encdec:
        batch["enc_embeds"] = torch.randn(2, 48, cfg.d_model, generator=gen,
                                          device=cuda) * 0.02
    full, _ = models.prefill(cfg, params, batch)
    _, cache = models.prefill(cfg, params, dict(batch, tokens=toks[:, :64]))
    cache = {k: (torch.nn.functional.pad(v, (0, 0, 0, 0, 0, 8))
                 if k in ("k", "v") else v) for k, v in cache.items()}
    cross = {k: cache[k].clone() for k in ("xk", "xv") if k in cache}
    step, cache = models.decode_step(
        cfg, params, cache, toks[:, 64:],
        torch.full((2,), 64, dtype=torch.int32, device=cuda))
    err = ((step - full).abs().max() / full.abs().max()).item()
    assert err < 2e-2, err
    assert all(torch.equal(cache[k], v) for k, v in cross.items())


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


# --------------------------------------------------------------------------
# training on the card
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name,microbatch", [
    ("qwen2-1.5b-smoke", None), ("qwen2-1.5b-smoke", 2),
    ("phi3.5-moe-42b-a6.6b-smoke", None), ("arctic-480b-smoke", None),
    ("mamba2-780m-smoke", None), ("zamba2-7b-smoke", None),
    ("whisper-tiny-smoke", None)])
def test_train_step_on_card_matches_cpu(cuda, monkeypatch, name,
                                        microbatch):
    """One `make_train_step` step (float32, TF32 off) on the card and on
    the CPU from the same weights and batch: loss and grad_norm within
    2e-5 relative, every parameter within 2e-5 of max(max|cpu|, lr) (2e-4
    on the ssm and hybrid configs; Adam's eps 1e-3, as in
    tests/test_torch_train_step.py)."""
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.step import make_train_step
    from repro_torch.tree import leaves, tree_map

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = get_arch(name)
    oc = OptConfig(lr=1e-3, eps=1e-3, warmup_steps=1, total_steps=10)
    tol = 2e-4 if cfg.family in ("ssm", "hybrid") else 2e-5
    start = models.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (4, 65)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    if cfg.is_encdec:
        batch["enc_embeds"] = rng.standard_normal((4, 32, cfg.d_model),
                                                  dtype=np.float32)
    out = {}
    for dev in ("cpu", cuda):
        params = tree_map(lambda t: t.to(dev, copy=True), start)
        fn, opt = make_train_step(cfg, oc, microbatch)
        params, _, m = fn(params, opt.init(params),
                          {k: torch.as_tensor(v, device=dev)
                           for k, v in batch.items()})
        out[str(dev)] = (leaves(params), {k: v.item() for k, v in m.items()})
    (pc, mc), (pg, mg) = out["cpu"], out[str(cuda)]
    for k in mc:
        assert abs(mg[k] - mc[k]) <= 2e-5 * abs(mc[k]), (k, mg[k], mc[k])
    for want, got, old in zip(pc, pg, leaves(start)):
        got = got.detach().cpu()
        assert torch.isfinite(got).all() and not torch.equal(got, old)
        scale = max(want.abs().max().item(), oc.lr)
        assert (got - want.detach()).abs().max().item() <= tol * scale


def test_ssd_backward_on_card_stays_finite_where_the_decay_overflows(cuda):
    """Mamba2-780M's widths and chunks of 256 with the model's dt and A
    (decay sums far past float32 exp's range in the masked triangle): the
    float32 gradients are finite and within 2e-4 of max|float64| of the
    same function run in float64 on the card."""
    from repro_torch.models import ssm

    cfg = get_arch("mamba2-780m")
    rng = np.random.default_rng(0)
    b, l, nh, hp, st = 1, 512, cfg.ssm_nheads, cfg.ssm_headdim, \
        cfg.ssm_state
    inputs = [rng.standard_normal((b, l, nh, hp)),
              rng.standard_normal((b, l, 1, st)) * 0.5,
              rng.standard_normal((b, l, 1, st)) * 0.5,
              np.logaddexp(rng.standard_normal((b, l, nh)), 0.0),
              -np.exp(0.5 * rng.standard_normal(nh))]
    inputs = [np.asarray(a, np.float32) for a in inputs]
    assert float((inputs[3][:, :256] * -inputs[4]).sum(1).max()) > 89

    def grads(dtype):
        ts = [torch.tensor(a, dtype=dtype, device=cuda, requires_grad=True)
              for a in inputs]
        y, _ = ssm.ssd_chunked(cfg, *ts)
        return torch.autograd.grad(y.sum(), ts)

    for g32, g64 in zip(grads(torch.float32), grads(torch.float64)):
        assert torch.isfinite(g32).all()
        err = (g32.double() - g64).abs().max() / g64.abs().max()
        assert err.item() <= 2e-4


def test_checkpoint_of_card_state_restores_on_cpu_bit_for_bit(cuda,
                                                              tmp_path):
    """A bf16 / float32 / int8 / int32 tree saved from the card without
    blocking, then updated in place, restores on the CPU with the saved
    bits."""
    from repro_torch.ckpt.manager import CheckpointManager
    from repro_torch.tree import leaves, tree_map

    gen = torch.Generator(device=cuda).manual_seed(0)
    tree = {"p": torch.randn(64, 32, generator=gen, device=cuda)
            .to(torch.bfloat16),
            "w": torch.randn(3, 16, generator=gen, device=cuda),
            "q": torch.randint(-127, 128, (8, 4), generator=gen,
                               device=cuda, dtype=torch.int8),
            "count": torch.full((), 5, dtype=torch.int32, device=cuda)}
    saved = tree_map(lambda t: t.to("cpu", copy=True), tree)
    ck = CheckpointManager(tmp_path)
    ck.save(7, tree, blocking=False)
    tree["p"].mul_(2)
    tree["w"].add_(1)
    ck.wait()
    got, step = ck.restore(like=tree, device="cpu")
    assert step == 7
    for a, b_ in zip(leaves(saved), leaves(got)):
        assert a.dtype == b_.dtype and torch.equal(a, b_)


# --------------------------------------------------------------------------
# distributed training on the card: NCCL at world size 1
# --------------------------------------------------------------------------

@pytest.fixture()
def nccl_world1(cuda, tmp_path):
    """A one-rank NCCL group on the card (file rendezvous) and its (1, 1,
    1) ("pod", "data", "model") mesh; the group is destroyed after the
    test."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_train_mesh

    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/rdv",
                            world_size=1, rank=0)
    try:
        yield make_train_mesh((1, 1, 1), device="cuda")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("name,microbatch", [
    ("qwen2-1.5b-smoke", None), ("qwen2-1.5b-smoke", 2),
    ("phi3.5-moe-42b-a6.6b-smoke", None), ("arctic-480b-smoke", None)])
def test_sharded_step_at_world_size_one_is_the_train_step_bit_for_bit(
        cuda, nccl_world1, monkeypatch, name, microbatch):
    """Two `make_sharded_train_step` steps on the (1, 1, 1) NCCL mesh and
    two `make_train_step` steps from the same weights and batch: losses,
    grad norms, every parameter and every optimizer-state leaf equal bit
    for bit (int32 views of float32)."""
    from repro_torch.distributed.sharding import shard_tree
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.step import (make_sharded_train_step,
                                        make_train_step, train_specs)
    from repro_torch.tree import leaves, tree_map

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = get_arch(name)
    oc = OptConfig(lr=1e-3, eps=1e-3, warmup_steps=1, total_steps=10)
    start = models.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (4, 65)).astype(np.int32)
    batch = {"tokens": torch.as_tensor(toks[:, :-1], device=cuda),
             "targets": torch.as_tensor(toks[:, 1:], device=cuda)}
    p_specs, _ = train_specs(cfg, nccl_world1)
    runs = []
    for factory in ("single", "sharded"):
        params = tree_map(lambda t: t.to(cuda, copy=True), start)
        if factory == "single":
            fn, opt = make_train_step(cfg, oc, microbatch)
        else:
            params = shard_tree(params, p_specs, nccl_world1)
            fn, opt = make_sharded_train_step(cfg, nccl_world1, oc,
                                              microbatch)
        state = opt.init(params)
        metrics = []
        for _ in range(2):
            params, state, m = fn(params, state, batch)
            metrics += [m["loss"], m["grad_norm"]]
        runs.append(leaves({"o": state, "p": params}) + metrics)

    def bits(t):
        t = t.detach()
        return t.view(torch.int32) if t.dtype == torch.float32 else t

    for a, b in zip(*runs):
        assert a.dtype == b.dtype and torch.equal(bits(a), bits(b))
