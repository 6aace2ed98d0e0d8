"""The port's scalar physics — the (tech, scheme, layers) functions of
`core/{sense,energy,netlist,parasitics,routing,disturb}.py` and all of
`core/device_models.py` — against the reference, and every golden of
tests/test_paper_numbers.py reached through the port.

Tolerance: float32 rounding, rtol 1e-6 (atol 0).  The physics functions
compose the port's lowered arithmetic and in practice agree bit for bit;
the device models run float32 transcendentals (exp, log1p, tanh, log10)
whose last ulp differs between XLA and PyTorch's CPU kernels.  Shapes,
dtypes and boolean results are exact; Python-float results equal.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import calibration as jcal  # noqa: E402
from repro.core import device_models as jdm  # noqa: E402
from repro.core import disturb as jdisturb  # noqa: E402
from repro.core import energy as jenergy  # noqa: E402
from repro.core import netlist as jnetlist  # noqa: E402
from repro.core import parasitics as jparasitics  # noqa: E402
from repro.core import routing as jrouting  # noqa: E402
from repro.core import sense as jsense  # noqa: E402
from repro_torch.core import calibration as cal  # noqa: E402
from repro_torch.core import (density, device_models, disturb,  # noqa: E402
                              energy, netlist, parasitics, routing, sense,
                              transient)

RTOL = 1e-6
CPU = "cpu"
LAYER_SETS = {"grid": [1, 32, 87, 137, 200], "scalar": 87, "one": [64.0]}
TECH_SCHEMES = [(t, s) for t, tech in sorted(jcal.TECHS.items())
                for s in (tech.allowed_schemes or tuple(jrouting.SCHEMES))]


def check(port, ref):
    """A port tensor against a reference array: same shape and dtype,
    values within float32 rounding (booleans and ints exactly)."""
    assert isinstance(port, torch.Tensor), type(port)
    port, ref = port.numpy(), np.asarray(ref)
    assert port.shape == ref.shape
    assert port.dtype == ref.dtype, (port.dtype, ref.dtype)
    if ref.dtype.kind == "f":
        np.testing.assert_allclose(port, ref, rtol=RTOL, atol=0)
    else:
        np.testing.assert_array_equal(port, ref)


# (tech, scheme, layers) -> (reference value, port value)
LAYERED = {
    "effective_cbl_ff": lambda jt, pt, s, L: (
        jnetlist.effective_cbl_ff(jt, s, L),
        netlist.effective_cbl_ff(pt, s, L, device=CPU)),
    "charge_share_mv": lambda jt, pt, s, L: (
        jsense.charge_share_mv(jt, s, L),
        sense.charge_share_mv(pt, s, L, device=CPU)),
    "sense_margin_mv": lambda jt, pt, s, L: (
        jsense.sense_margin_mv(jt, s, L),
        sense.sense_margin_mv(pt, s, L, device=CPU)),
    "sense_margin_mv_disturbed": lambda jt, pt, s, L: (
        jsense.sense_margin_mv(jt, s, L, with_disturb=True),
        sense.sense_margin_mv(pt, s, L, with_disturb=True, device=CPU)),
    "functional": lambda jt, pt, s, L: (
        jsense.functional(jt, s, L),
        sense.functional(pt, s, L, device=CPU)),
    "functional_nominal": lambda jt, pt, s, L: (
        jsense.functional(jt, s, L, with_disturb=False),
        sense.functional(pt, s, L, with_disturb=False, device=CPU)),
    "write_energy_fj": lambda jt, pt, s, L: (
        jenergy.write_energy_fj(jt, s, L),
        energy.write_energy_fj(pt, s, L, device=CPU)),
    "read_energy_fj": lambda jt, pt, s, L: (
        jenergy.read_energy_fj(jt, s, L),
        energy.read_energy_fj(pt, s, L, device=CPU)),
    "disturb_loss_mv": lambda jt, pt, s, L: (
        jdisturb.disturb_loss_mv(jt, s, L),
        disturb.disturb_loss_mv(pt, s, L, device=CPU)),
    "disturb_loss_mv_duty": lambda jt, pt, s, L: (
        jdisturb.disturb_loss_mv(jt, s, L, rh_toggles=3e5, trc_cycles=2e6),
        disturb.disturb_loss_mv(pt, s, L, rh_toggles=3e5, trc_cycles=2e6,
                                device=CPU)),
    "local_bl_cap_ff": lambda jt, pt, s, L: (
        jparasitics.local_bl_cap_ff(jt, L),
        parasitics.local_bl_cap_ff(pt, L, device=CPU)),
}


@pytest.mark.parametrize("tech,scheme", TECH_SCHEMES,
                         ids=[f"{t}-{s}" for t, s in TECH_SCHEMES])
@pytest.mark.parametrize("fn", sorted(LAYERED))
def test_layered_function_matches_reference(fn, tech, scheme):
    for layers in LAYER_SETS.values():
        ref, port = LAYERED[fn](jcal.TECHS[tech], cal.TECHS[tech], scheme,
                                layers)
        check(port, ref)


@pytest.mark.parametrize("tech,scheme", TECH_SCHEMES,
                         ids=[f"{t}-{s}" for t, s in TECH_SCHEMES])
def test_bonding_geometry_matches_reference(tech, scheme):
    ref = jrouting.bonding_geometry(jcal.TECHS[tech], scheme)
    port = routing.bonding_geometry(cal.TECHS[tech], scheme, device=CPU)
    for f in dataclasses.fields(ref):
        check(getattr(port, f.name), getattr(ref, f.name))
    check(routing.hcb_pitch_um(cal.TECHS[tech], scheme, device=CPU),
          jrouting.hcb_pitch_um(jcal.TECHS[tech], scheme))


@pytest.mark.parametrize("tech", sorted(jcal.TECHS))
def test_per_tech_python_values_equal_reference(tech):
    jt, pt = jcal.TECHS[tech], cal.TECHS[tech]
    assert energy.wl_energy_fj(pt) == jenergy.wl_energy_fj(jt)
    assert parasitics.wl_parasitics(pt) == jparasitics.wl_parasitics(jt)
    assert (disturb.off_state_leakage_note(pt)
            == jdisturb.off_state_leakage_note(jt))


def test_unregistered_scheme_counts_as_isolating():
    """The reference's `SCHEME_ISOLATES_UNSELECTED.get(scheme, True)`."""
    for tech in sorted(jcal.TECHS):
        check(disturb.disturb_loss_mv(cal.TECHS[tech], "no_such_scheme",
                                      [87], device=CPU),
              jdisturb.disturb_loss_mv(jcal.TECHS[tech], "no_such_scheme",
                                       [87]))


DEVICES = sorted(jdm.DEVICES)


def test_device_constants_equal_reference():
    assert device_models.KT_Q_MV == jdm.KT_Q_MV
    assert sorted(device_models.DEVICES) == DEVICES
    for name in DEVICES:
        assert (dataclasses.asdict(device_models.DEVICES[name])
                == dataclasses.asdict(jdm.DEVICES[name]))
    for const in ("IGO_SELECTOR", "SI_ACCESS", "AOS_ACCESS"):
        assert (dataclasses.asdict(getattr(device_models, const))
                == dataclasses.asdict(getattr(jdm, const)))


DEVICE_FNS = {
    "ids_ua_vgs_sweep": lambda m, d: m.ids_ua(
        d, np.linspace(0.0, 2.0, 41, dtype=np.float32), 0.5,
        **({"device": CPU} if m is device_models else {})),
    "ids_ua_bias_grid": lambda m, d: m.ids_ua(
        d, np.linspace(-0.5, 2.5, 13, dtype=np.float32)[:, None],
        np.linspace(0.0, 1.2, 7, dtype=np.float32)[None, :],
        **({"device": CPU} if m is device_models else {})),
    "ids_ua_on": lambda m, d: m.ids_ua(
        d, 2.0, 1.0, **({"device": CPU} if m is device_models else {})),
    "r_on_eff_kohm": lambda m, d: m.r_on_eff_kohm(
        d, 2.0, 0.55, **({"device": CPU} if m is device_models else {})),
    "subthreshold_swing_mv_dec": lambda m, d: m.subthreshold_swing_mv_dec(
        d, **({"device": CPU} if m is device_models else {})),
}


@pytest.mark.parametrize("device_name", DEVICES)
@pytest.mark.parametrize("fn", sorted(DEVICE_FNS))
def test_device_model_matches_reference(fn, device_name):
    check(DEVICE_FNS[fn](device_models, device_models.DEVICES[device_name]),
          DEVICE_FNS[fn](jdm, jdm.DEVICES[device_name]))


@pytest.mark.parametrize("device_name", DEVICES)
def test_retention_time_equals_reference(device_name):
    for cs_ff, dv in ((4.0, 0.2), (2.5, 0.1)):
        assert (device_models.retention_time_ms(
            device_models.DEVICES[device_name], cs_ff, dv)
            == jdm.retention_time_ms(jdm.DEVICES[device_name], cs_ff, dv))


# ---------------------------------------------------------------------------
# tests/test_paper_numbers.py's goldens, reached through the port
# ---------------------------------------------------------------------------

SI, AOS, D1B = cal.SI, cal.AOS, cal.D1B
L_SI, L_AOS, ONE = [137], [87], [1]


def rel(a, b):
    return abs(a - b) / abs(b)


def f(x) -> float:
    return float(x.reshape(-1)[0]) if isinstance(x, torch.Tensor) else x


def trc(tech, scheme, layers):
    return f(transient.simulate_row_cycle(tech, scheme, layers,
                                          device=CPU).trc_ns)


def energy_cut(fn):
    return 1 - f(fn(SI, "sel_strap", L_SI, device=CPU)) / f(
        fn(D1B, "direct", ONE, device=CPU))


geom = lambda t, s: routing.bonding_geometry(t, s, device=CPU)  # noqa: E731

GOLDENS = {
    "cbl_sel_strap_si": lambda: rel(f(netlist.effective_cbl_ff(
        SI, "sel_strap", L_SI, device=CPU)), 6.6) < 0.03,
    "cbl_d1b": lambda: f(netlist.effective_cbl_ff(
        D1B, "direct", ONE, device=CPU)) == pytest.approx(20.0),
    "margin_si_130mv": lambda: rel(f(sense.sense_margin_mv(
        SI, "sel_strap", L_SI, device=CPU)), 130.0) < 0.03,
    "margin_aos_189mv": lambda: rel(f(sense.sense_margin_mv(
        AOS, "sel_strap", L_AOS, device=CPU)), 189.0) < 0.03,
    "margin_d1b_54mv": lambda: rel(f(sense.sense_margin_mv(
        D1B, "direct", ONE, device=CPU)), 54.0) < 0.03,
    "margin_si_disturbed_70mv": lambda: rel(f(sense.sense_margin_mv(
        SI, "sel_strap", L_SI, with_disturb=True, device=CPU)), 70.0) < 0.03,
    "write_si": lambda: rel(f(energy.write_energy_fj(
        SI, "sel_strap", L_SI, device=CPU)), 6.26) < 0.03,
    "write_aos": lambda: rel(f(energy.write_energy_fj(
        AOS, "sel_strap", L_AOS, device=CPU)), 5.38) < 0.03,
    "read_si": lambda: rel(f(energy.read_energy_fj(
        SI, "sel_strap", L_SI, device=CPU)), 1.57) < 0.03,
    "read_aos": lambda: rel(f(energy.read_energy_fj(
        AOS, "sel_strap", L_AOS, device=CPU)), 1.35) < 0.03,
    "energy_60pct_reduction_vs_d1b": lambda: (
        0.54 < energy_cut(energy.write_energy_fj) < 0.66
        and 0.54 < energy_cut(energy.read_energy_fj) < 0.68),
    "density_si_2p6": lambda: rel(f(density.bit_density_gb_mm2(
        SI, L_SI, device=CPU)), 2.6) < 0.01,
    "density_aos_2p6": lambda: rel(f(density.bit_density_gb_mm2(
        AOS, L_AOS, device=CPU)), 2.6) < 0.01,
    "layer_count_si_137": lambda: int(density.layers_for_density(
        SI, 2.6, device=CPU)[()]) == 137,
    "layer_count_aos_87": lambda: int(density.layers_for_density(
        AOS, 2.6, device=CPU)[()]) == 87,
    "stack_height_si_9p6": lambda: rel(f(density.stack_height_um(
        SI, L_SI, device=CPU)), 9.6) < 0.01,
    "stack_height_aos_6p9": lambda: rel(f(density.stack_height_um(
        AOS, L_AOS, device=CPU)), 6.9) < 0.01,
    "density_6x_over_d1b": lambda: rel(f(density.density_scaling_vs_d1b(
        SI, L_SI, device=CPU)), 6.0) < 0.02,
    "hcb_pitch_si_sel_strap": lambda: rel(
        f(geom(SI, "sel_strap").hcb_pitch_um), 0.75) < 0.01,
    "hcb_pitch_aos_sel_strap": lambda: rel(
        f(geom(AOS, "sel_strap").hcb_pitch_um), 0.62) < 0.01,
    "hcb_pitch_si_direct": lambda: rel(
        f(geom(SI, "direct").hcb_pitch_um), 0.26) < 0.03,
    "hcb_pitch_aos_direct": lambda: rel(
        f(geom(AOS, "direct").hcb_pitch_um), 0.22) < 0.01,
    "blsa_area_si": lambda: rel(
        f(geom(SI, "sel_strap").blsa_area_um2), 1.12) < 0.01,
    "blsa_area_aos": lambda: rel(
        f(geom(AOS, "sel_strap").blsa_area_um2), 0.76) < 0.02,
    "manufacturable_si_sel_strap": lambda: bool(
        geom(SI, "sel_strap").manufacturable),
    "not_manufacturable_si_direct": lambda: not bool(
        geom(SI, "direct").manufacturable),
    "not_manufacturable_aos_core_mux": lambda: not bool(
        geom(AOS, "core_mux").manufacturable),
    "trc_si_10p9": lambda: rel(trc(SI, "sel_strap", L_SI), 10.9) < 0.02,
    "trc_aos_10p5": lambda: rel(trc(AOS, "sel_strap", L_AOS), 10.5) < 0.02,
    "trc_d1b_21p3": lambda: rel(trc(D1B, "direct", ONE), 21.3) < 0.02,
    "trc_2x_speedup": lambda: (trc(D1B, "direct", ONE)
                               / trc(SI, "sel_strap", L_SI)) > 1.9,
}


@pytest.mark.parametrize("name", sorted(GOLDENS))
def test_paper_golden_through_the_port(name):
    assert GOLDENS[name]()


# ---------------------------------------------------------------------------
# tests/test_core_engine.py's device-model anchors, through the port
# ---------------------------------------------------------------------------

def test_device_model_anchors():
    ion = float(device_models.ids_ua(device_models.IGO_SELECTOR, 2.0, 1.0,
                                     device=CPU))
    assert ion > 50.0
    ss = {name: float(device_models.subthreshold_swing_mv_dec(d, device=CPU))
          for name, d in device_models.DEVICES.items()}
    assert abs(ss["igo_selector"] - 60) < 8
    assert abs(ss["aos_access"] - 65) < 8
    assert abs(ss["si_access"] - 85) < 10
    t_aos = device_models.retention_time_ms(device_models.AOS_ACCESS, 4.0)
    t_si = device_models.retention_time_ms(device_models.SI_ACCESS, 4.0)
    assert t_aos > 1000 * t_si and t_aos > 64.0
    i = device_models.ids_ua(device_models.SI_ACCESS,
                             torch.linspace(0.0, 2.0, 41), 0.5, device=CPU)
    assert bool((torch.diff(i) > 0).all())


def test_scalar_entry_points_default_to_cuda():
    """Without a GPU the scalar functions refuse to run unless asked for
    the CPU (their default device is "cuda")."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    for call in (lambda: sense.sense_margin_mv(SI, "sel_strap", L_SI),
                 lambda: energy.read_energy_fj(SI, "sel_strap", L_SI),
                 lambda: routing.bonding_geometry(SI, "sel_strap"),
                 lambda: device_models.ids_ua(device_models.SI_ACCESS,
                                              1.0, 0.5)):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()
