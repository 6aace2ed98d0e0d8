"""The port's phased row-cycle engine and its rc_multistep kernel path
against the JAX reference, on the CPU.

On the CPU the dispatch runs the plain PyTorch version
(`repro_torch.kernels.ref.rc_multistep_ref`); the CUDA kernel itself is
held against it on the card by tests/test_torch_gpu.py (marked `gpu`) and
by `chip_smoke.py`.

Bars:
- rc_multistep: the reference's Pallas-vs-oracle bar (tests/test_kernels.py),
  rtol 1e-5 / atol 1e-6, float32 rounding.  The same bar holds at the ACT
  window's T = 800 steps: the implicit-Euler step is contractive, so
  rounding differences do not grow with T.
- phased engine vs the reference's phased engine: event times within one
  dt with an identical NaN pattern (float32 rounding at a threshold can
  flip one step); waveforms within TRACE_ATOL_V = 5e-4 V (0.05% of VDD)
  on every row whose events agree.  The port's plain version equals a
  strict IEEE float32 evaluation of the recurrences bit for bit
  (`test_plain_version_is_strict_ieee_float32`); XLA compiles the
  reference's scan differently (3e-5 V from strict float32 on the Si
  ladder, 7e-5 V on AOS), and on the stiff D1B ladder (first branch
  20 mS against C/dt of 0.02 mS) the back substitution cancels, so the
  reference sits up to 3.1e-4 V from strict float32 there.
- port fused vs port phased: the reference's own fused-vs-phased bars
  (tests/test_fused_row_cycle.py): precharge and restore durations within
  one dt, t_sense within one dt + 0.05 ns, tRC within 3 dt + 0.05 ns.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import calibration as jcal  # noqa: E402
from repro.core import transient as jtransient  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.rc_transient import rc_multistep_pallas  # noqa: E402
from repro_torch.core import calibration as cal  # noqa: E402
from repro_torch.core import transient  # noqa: E402
from repro_torch.kernels import ops, rc_transient  # noqa: E402

DT = transient.DT_NS
REGEN_SLACK_NS = 0.05
TRACE_ATOL_V = 5e-4
ANCHORS = (("si", "sel_strap", (87, 137)), ("aos", "sel_strap", (87, 137)),
           ("d1b", "direct", (1,)))
EVENTS = ("t_fire_ns", "t_precharge_ns")


def random_ladder(rng, b, n):
    """The generator of tests/test_kernels.py: random ladders with a
    restore clamp on the sense node."""
    c = rng.uniform(1, 5, (b, n)).astype(np.float32)
    g = rng.uniform(0.05, 0.2, (b, n - 1)).astype(np.float32)
    gc = np.zeros((b, n), np.float32)
    gc[:, 0] = 0.2
    vc = np.full((b, n), 0.55, np.float32)
    v0 = rng.uniform(0, 1.1, (b, n)).astype(np.float32)
    return [c, g, gc, vc, v0]


def port_rc(args, ramp, dt, backend="auto"):
    t = [torch.as_tensor(a) for a in args]
    return ops.rc_multistep(*t, torch.as_tensor(ramp), dt,
                            backend=backend).numpy()


# ---------------------------------------------------------------------------
# rc_multistep: plain version vs the reference oracle and Pallas kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,n,t", [(1, 6, 16), (130, 4, 25), (9, 6, 50),
                                   (64, 8, 33), (256, 6, 10)])
def test_rc_multistep_matches_reference_oracle(rng, b, n, t):
    args = random_ladder(rng, b, n)
    ramp = np.clip(np.arange(t) / 8, 0, 1).astype(np.float32)
    out = port_rc(args, ramp, 0.02)
    want = jref.rc_multistep_ref(*map(jnp.asarray, args), jnp.asarray(ramp),
                                 0.02)
    assert out.shape == (t, b, n)
    np.testing.assert_allclose(out, np.asarray(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("b,n,t", [(1, 6, 16), (130, 4, 25)])
def test_rc_multistep_matches_pallas_interpret(rng, b, n, t):
    args = random_ladder(rng, b, n)
    ramp = np.clip(np.arange(t) / 8, 0, 1).astype(np.float32)
    want = rc_multistep_pallas(*map(jnp.asarray, args), jnp.asarray(ramp),
                               0.02, interpret=True)
    np.testing.assert_allclose(port_rc(args, ramp, 0.02), np.asarray(want),
                               rtol=1e-5, atol=1e-6)


def test_rc_multistep_act_window_matches_reference_oracle(rng):
    """T = 800 steps with a rising WL ramp (the phased engine's ACT call);
    the bar stays rtol 1e-5 / atol 1e-6 (see the module docstring)."""
    args = random_ladder(rng, 64, 6)
    t_ns = (np.arange(transient.N_ACT_STEPS) + 1) * DT
    ramp = (1.0 - np.exp(-t_ns / 0.5)).astype(np.float32)
    want = jref.rc_multistep_ref(*map(jnp.asarray, args), jnp.asarray(ramp),
                                 DT)
    np.testing.assert_allclose(port_rc(args, ramp, DT), np.asarray(want),
                               rtol=1e-5, atol=1e-6)


def _strict_f32_rc_multistep(c, g_branch, g_clamp, v_clamp, v0, ramp, dt):
    """The reference oracle's recurrences in numpy float32: one IEEE
    rounding per operation, no contraction."""
    f32 = np.float32
    b, n = c.shape
    cdt = c / f32(dt) * f32(1e-3)
    zeros = np.zeros((b, 1), f32)
    v, out = v0, []
    for s in ramp:
        g = g_branch.copy()
        g[:, -1] = g_branch[:, -1] * s
        d = cdt + np.concatenate([zeros, g], 1) + np.concatenate(
            [g, zeros], 1) + g_clamp
        dl, du = np.concatenate([zeros, -g], 1), np.concatenate([-g, zeros], 1)
        rhs = cdt * v + g_clamp * v_clamp
        cp, dp = [du[:, 0] / d[:, 0]], [rhs[:, 0] / d[:, 0]]
        for i in range(1, n):
            den = d[:, i] - dl[:, i] * cp[i - 1]
            cp.append(du[:, i] / den)
            dp.append((rhs[:, i] - dl[:, i] * dp[i - 1]) / den)
        x = [dp[-1]]
        for i in range(n - 2, -1, -1):
            x.append(dp[i] - cp[i] * x[-1])
        v = np.stack(x[::-1], 1)
        out.append(v)
    return np.stack(out)


@pytest.mark.parametrize("tech,scheme", [("d1b", "direct"),
                                         ("si", "sel_strap")])
def test_plain_version_is_strict_ieee_float32(tech, scheme):
    """On the paper's ladders (the stiff D1B one included) the plain
    version is bit-identical to strict float32 arithmetic."""
    from repro_torch.core.netlist import build_bl_ladder

    ladder = build_bl_ladder(cal.get_tech(tech), scheme, [1.0, 137.0], "cpu")
    c, g = ladder.c.numpy(), ladder.g_branch.numpy()
    b, n = c.shape
    zeros = np.zeros((b, n), np.float32)
    v0 = np.full((b, n), 0.55, np.float32)
    v0[:, n - 1] = 1.0746
    t_ns = ((np.arange(50) + 1) * DT).astype(np.float32)
    ramp = (1.0 - np.exp(-t_ns / np.float32(0.5))).astype(np.float32)
    args = [c, g, zeros, zeros, v0]
    np.testing.assert_array_equal(
        port_rc(args, ramp, DT), _strict_f32_rc_multistep(*args, ramp, DT))


def test_rc_multistep_empty_ramp_gives_empty_trace(rng):
    out = port_rc(random_ladder(rng, 3, 6), np.zeros((0,), np.float32), DT)
    assert out.shape == (0, 3, 6)


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

def test_dispatch_refuses_cuda_backend_on_cpu_tensors(rng):
    args = random_ladder(rng, 8, 6)
    ramp = np.ones((4,), np.float32)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        port_rc(args, ramp, DT, backend="cuda")
    with pytest.raises(ValueError, match="unknown backend"):
        port_rc(args, ramp, DT, backend="pallas")


def test_ref_backend_equals_auto_on_cpu(rng):
    args = random_ladder(rng, 16, 6)
    ramp = np.linspace(0, 1, 12).astype(np.float32)
    np.testing.assert_array_equal(port_rc(args, ramp, DT, backend="auto"),
                                  port_rc(args, ramp, DT, backend="ref"))


def test_auto_dispatch_never_routes_a_cuda_tensor_to_ref(monkeypatch):
    """Under "auto" a CUDA tensor goes to the kernel wrapper (which
    launches or raises); the plain version is never called for it."""
    calls = []

    class CudaLike:
        is_cuda = True

    monkeypatch.setattr(ops, "rc_multistep_cuda",
                        lambda *a: calls.append("cuda") or "trace")

    def no_ref(*a):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(ops.ref, "rc_multistep_ref", no_ref)
    x = CudaLike()
    assert ops.rc_multistep(x, x, x, x, x, x, DT) == "trace"
    assert calls == ["cuda"]


def test_wrapper_checks_inputs_before_building(rng):
    """The kernel wrapper refuses CPU tensors without touching nvcc."""
    args = [torch.as_tensor(a) for a in random_ladder(rng, 4, 6)]
    before = rc_transient.rc_multistep_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensors only"):
        rc_transient.rc_multistep_cuda(*args, torch.ones(3), DT)
    assert rc_transient.rc_multistep_cuda.launches == before


# ---------------------------------------------------------------------------
# phased engine: port vs reference
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=[False, True], ids=["fixed", "replica"])
def phased_pairs(request):
    """{anchor: (reference result, port result)} for one timing mode."""
    replica = request.param
    out = {}
    for tech, scheme, layers in ANCHORS:
        ref = jtransient.simulate_row_cycle_phased(
            jcal.get_tech(tech), scheme, jnp.asarray(layers), replica=replica)
        port = transient.simulate_row_cycle_phased(
            cal.get_tech(tech), scheme, list(layers), replica=replica,
            device="cpu")
        out[tech] = (ref, port)
    return replica, out


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("tech", [a[0] for a in ANCHORS])
def test_phased_events_match_reference(phased_pairs, tech):
    _, pairs = phased_pairs
    ref, port = pairs[tech]
    for name in EVENTS:
        a, b = _np(getattr(port, name)), _np(getattr(ref, name))
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=name)
        diff = np.where(np.isnan(b), 0.0, np.abs(a - b))
        assert diff.max() <= DT + 1e-6, (name, diff.max())
    res_p = _np(port.t_restore_ns) - _np(port.t_sense_ns)
    res_r = _np(ref.t_restore_ns) - _np(ref.t_sense_ns)
    assert np.abs(res_p - res_r).max() <= DT + 1e-5
    assert np.abs(_np(port.t_sense_ns)
                  - _np(ref.t_sense_ns)).max() <= DT + REGEN_SLACK_NS
    assert np.abs(_np(port.trc_ns)
                  - _np(ref.trc_ns)).max() <= 3 * DT + REGEN_SLACK_NS


@pytest.mark.parametrize("tech", [a[0] for a in ANCHORS])
def test_phased_traces_match_reference(phased_pairs, tech):
    replica, pairs = phased_pairs
    ref, port = pairs[tech]
    keys = {"act", "restore", "pre"} | ({"replica"} if replica else set())
    assert set(port.traces) == set(ref.traces) == keys
    for k in keys:
        assert tuple(port.traces[k].shape) == tuple(ref.traces[k].shape), k
        assert port.traces[k].dtype == torch.float32
    # ACT (and the replica column) see the same inputs on every row
    for k in keys & {"act", "replica"}:
        np.testing.assert_allclose(_np(port.traces[k]), _np(ref.traces[k]),
                                   rtol=0, atol=TRACE_ATOL_V, err_msg=k)
    # RESTORE / PRE start from the state at the previous event: compare the
    # rows whose events agree to the step
    same = ((_np(port.t_fire_ns) == _np(ref.t_fire_ns))
            & (_np(port.t_restore_ns - port.t_sense_ns)
               == _np(ref.t_restore_ns - ref.t_sense_ns)))
    for k in ("restore", "pre"):
        np.testing.assert_allclose(_np(port.traces[k])[:, same],
                                   _np(ref.traces[k])[:, same],
                                   rtol=0, atol=TRACE_ATOL_V, err_msg=k)


def test_phased_starved_tech_is_nan_in_both():
    """A WL ramp slower than the ACT window never develops the signal:
    t_fire and tRC are NaN in the port and in the reference."""
    tech = dataclasses.replace(cal.SI, name="starved_phased",
                               r_wl_kohm=40_000.0)
    jtech = dataclasses.replace(jcal.SI, name="starved_phased",
                                r_wl_kohm=40_000.0)
    port = transient.simulate_row_cycle_phased(tech, "sel_strap", [137.0],
                                               device="cpu")
    ref = jtransient.simulate_row_cycle_phased(jtech, "sel_strap",
                                               jnp.asarray([137.0]))
    assert np.isnan(float(ref.t_fire_ns[0]))
    assert np.isnan(float(port.t_fire_ns[0]))
    assert np.isnan(float(port.trc_ns[0])) and np.isnan(float(ref.trc_ns[0]))


# ---------------------------------------------------------------------------
# the port against itself: fused vs phased
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("replica", [False, True], ids=["fixed", "replica"])
@pytest.mark.parametrize("tech,scheme,layers", ANCHORS)
def test_port_fused_matches_port_phased(tech, scheme, layers, replica):
    t = cal.get_tech(tech)
    f = transient.simulate_row_cycle(t, scheme, list(layers),
                                     replica=replica, device="cpu")
    p = transient.simulate_row_cycle(t, scheme, list(layers), traces=True,
                                     replica=replica, device="cpu")
    assert f.traces == {}
    keys = {"act", "restore", "pre"} | ({"replica"} if replica else set())
    assert set(p.traces) == keys
    assert all(v.ndim == 3 for v in p.traces.values())

    def diff(name):
        return (getattr(f, name) - getattr(p, name)).abs().max().item()

    assert diff("t_fire_ns") <= DT + 1e-6
    assert diff("t_precharge_ns") <= DT + 1e-6
    res_f = f.t_restore_ns - f.t_sense_ns
    res_p = p.t_restore_ns - p.t_sense_ns
    assert (res_f - res_p).abs().max().item() <= DT + 1e-5
    assert diff("t_sense_ns") <= DT + REGEN_SLACK_NS
    assert diff("trc_ns") <= 3 * DT + REGEN_SLACK_NS


def test_first_crossing_semantics():
    """First True along axis 0 -> (idx + 1) * dt; a crossing on the very
    last step is the finite T * dt; never crossed is NaN — as the
    reference's `_first_crossing_ns`."""
    ok = np.zeros((5, 4), bool)
    ok[2:, 0] = True
    ok[4, 1] = True
    ok[0, 3] = True
    got = transient._first_crossing_ns(torch.as_tensor(ok), DT).numpy()
    want = np.asarray(jtransient._first_crossing_ns(jnp.asarray(ok), DT))
    np.testing.assert_array_equal(np.isnan(got), [False, False, True, False])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("rising", [True, False])
def test_wl_ramp_matches_reference(rising):
    """float32 exp differs in the last ulp between XLA and PyTorch:
    rtol 1e-6 / atol 1e-7."""
    t_ns = (np.arange(transient.N_ACT_STEPS) + 1) * np.float32(DT)
    t_ns = t_ns.astype(np.float32)
    got = transient.wl_ramp(cal.SI, torch.as_tensor(t_ns), rising).numpy()
    want = np.asarray(jtransient.wl_ramp(jcal.SI, jnp.asarray(t_ns), rising))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
