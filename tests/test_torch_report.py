"""The port's Monte-Carlo reductions and paper report tables against the
JAX reference, on the CPU.

Bars:
- MC reductions on the same numpy columns (`yield_fraction`, `ess`,
  `yield_ppm`, `quantile`, `mc_summary`): rtol 1e-5 / atol 1e-6 and an
  identical NaN pattern.  The segment sums, cumulative sums and the
  quantile interpolation run in another order (`index_add_` vs XLA's
  scatter, `torch.nanquantile`'s lerp vs jnp's weighted sum), so the two
  agree to float32 rounding, not bit for bit.
- Report tables: strings, ints and bools equal; times carry the
  reference's own fused-engine bars (tests/test_fused_row_cycle.py): a
  fire time within one dt, t_sense within one dt + 0.05 ns, tRC (and its
  quantiles) within 3 dt + 0.05 ns, a difference of two tRCs within twice
  that, a ratio of tRCs within 2%; the margin at the SA fire within 1% of
  the signal (one step of fire time moves it that far,
  tests/test_torch_sweep.py); every other float rtol 1e-5 / atol 1e-6.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import batch as jbatch  # noqa: E402
from repro.core import dse as jdse  # noqa: E402
from repro.core import report as jreport  # noqa: E402
from repro.core import space as jspace  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import calibration as cal  # noqa: E402
from repro_torch.core import density, dse, report, space, transient  # noqa: E402
from repro_torch.core.batch import (ARRAY_FIELDS, INDEX_FIELDS,  # noqa: E402
                                    MASK_FIELDS, MC_SAMPLED_FIELDS)

DT = transient.DT_NS
REGEN_SLACK_NS = 0.05
TRC_BAR = 3 * DT + REGEN_SLACK_NS


def host(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_close(a, b, rtol=1e-5, atol=1e-6, msg=""):
    a, b = host(a), host(b)
    assert a.shape == b.shape, (msg, a.shape, b.shape)
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=msg)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=msg)


# ---------------------------------------------------------------------------
# MC reductions on the same numpy columns
# ---------------------------------------------------------------------------

def mc_columns(rng, n_samples, base, pad=3, dead=1):
    """Sample-major columns of an MC sweep: ~10% invalid samples, NaN tRC
    on a few rows, `pad` invalid padding rows at the end, and design
    `dead` with every sample invalid."""
    b = n_samples * base + pad
    cols = {f: rng.normal(1.0, 0.1, b) for f in ARRAY_FIELDS}
    cols["tech_idx"] = np.tile(np.arange(base) % 2, n_samples + 1)[:b]
    cols["scheme_idx"] = np.zeros(b)
    cols["layers"] = np.tile(np.arange(base) * 10.0 + 32, n_samples + 1)[:b]
    cols["margin_mv"] = rng.normal(100.0, 20.0, b)
    cols["margin_disturbed_mv"] = cols["margin_mv"] - rng.uniform(5, 40, b)
    cols["trc_ns"] = rng.normal(10.5, 0.5, b)
    cols["trc_ns"][rng.random(b) < 0.05] = np.nan
    cols["t_sense_ns"] = rng.normal(4.0, 0.2, b)
    cols["valid"] = rng.random(b) > 0.1
    cols["valid"][-pad:] = False
    cols["valid"][dead:n_samples * base:base] = False
    cols["feasible"] = cols["valid"] & (rng.random(b) > 0.3)
    cols["manufacturable"] = rng.random(b) > 0.2
    return cols


def both_batches(cols, corners, n_samples, base):
    """(reference DesignBatch, port DesignBatch) from the same columns."""
    def dtype(f):
        return (np.int32 if f in INDEX_FIELDS
                else bool if f in MASK_FIELDS else np.float32)

    ref = jbatch.DesignBatch(
        corners={k: jnp.asarray(v, jnp.float32) for k, v in corners.items()},
        tech_names=("si", "aos"), scheme_names=("sel_strap",),
        n_samples=n_samples, base_len=base,
        **{f: jnp.asarray(np.asarray(cols[f], dtype(f))) for f in ARRAY_FIELDS})
    port = interop.batch_columns_from_numpy(
        cols, ("si", "aos"), ("sel_strap",), corners=corners,
        n_samples=n_samples, base_len=base, device="cpu")
    return ref, port


@pytest.fixture(params=["uniform", "weighted"])
def mc_pair(request, rng):
    s, base = 48, 5
    cols = mc_columns(rng, s, base)
    corners = {"rh_toggles": rng.uniform(0, 1, len(cols["valid"]))}
    if request.param == "weighted":
        corners["mc_log_w"] = rng.normal(0.0, 1.5, len(cols["valid"]))
    return both_batches(cols, corners, s, base)


@pytest.mark.parametrize("spec", [dict(margin_mv=90.0), dict(trc_ns=10.6),
                                  dict(margin_mv=80.0, trc_ns=11.0),
                                  dict(margin_mv=60.0, disturbed=True), {}])
def test_yield_fraction_matches_reference(mc_pair, spec):
    ref, port = mc_pair
    got = port.yield_fraction(**spec)
    assert_close(got, ref.yield_fraction(**spec))
    assert math.isnan(float(got[1]))        # the all-invalid design


def test_ess_matches_reference(mc_pair):
    ref, port = mc_pair
    assert_close(port.ess(), ref.ess())


@pytest.mark.parametrize("field", ["trc_ns", "margin_mv", "t_sense_ns"])
@pytest.mark.parametrize("q", [0.5, 0.05, [0.05, 0.5, 0.95]],
                         ids=["median", "p05", "vector"])
def test_quantile_matches_reference(mc_pair, field, q):
    ref, port = mc_pair
    got = port.quantile(q, field)
    want = ref.quantile(q, field)
    assert tuple(got.shape) == tuple(np.shape(want))
    assert_close(got, want, msg=f"{field} q={q}")


@pytest.mark.parametrize("spec", [dict(margin_mv=90.0),
                                  dict(margin_mv=70.0, trc_ns=11.0)])
def test_yield_ppm_matches_reference(mc_pair, spec):
    ref, port = mc_pair
    got = port.yield_ppm(min_ess=2.0, **spec)
    want = ref.yield_ppm(min_ess=2.0, **spec)
    assert sorted(got) == sorted(want)
    for k in want:
        assert_close(got[k], want[k], msg=k)


def test_mc_summary_matches_reference(mc_pair):
    ref, port = mc_pair
    got = port.mc_summary(margin_mv=85.0, trc_ns=11.0, q=0.25)
    want = ref.mc_summary(margin_mv=85.0, trc_ns=11.0, q=0.25)
    assert len(got) == len(want) == 5
    assert sorted(got.corners) == sorted(want.corners)
    assert "mc_log_w" not in got.corners
    for f in ARRAY_FIELDS:
        assert_close(getattr(got, f).to(torch.float32),
                     np.asarray(getattr(want, f), np.float32), msg=f)
    for k in want.corners:
        assert_close(got.corners[k], want.corners[k], msg=k)


def test_reductions_refuse_a_selected_batch(mc_pair):
    _, port = mc_pair
    picked = port.select(torch.ones(len(port), dtype=torch.bool))
    with pytest.raises(ValueError, match="sample-major"):
        picked.yield_fraction(margin_mv=80.0)


def test_sampled_fields_are_the_reference_ones():
    assert MC_SAMPLED_FIELDS == jbatch.MC_SAMPLED_FIELDS


@pytest.mark.slow
def test_mc_sweep_reductions_match_reference():
    """End to end: `paper_targets().with_mc(samples=64, key=0)` swept by
    both.  The sweeps' tRC agree within the fused-engine bar, so tRC
    quantiles carry it; margin reductions and yields agree to rounding."""
    ref = jdse.sweep(jspace.DesignSpace.paper_targets().with_mc(
        samples=64, key=0))
    port = dse.sweep(space.DesignSpace.paper_targets().with_mc(
        samples=64, key=0), device="cpu")
    for spec in (dict(margin_mv=cal.MIN_FUNCTIONAL_MARGIN_MV),
                 dict(margin_mv=cal.MIN_DISTURBED_MARGIN_MV, disturbed=True),
                 dict(margin_mv=125.0, trc_ns=11.0)):
        assert_close(port.yield_fraction(**spec), ref.yield_fraction(**spec),
                     msg=str(spec))
    assert_close(port.ess(), ref.ess())
    q = [0.05, 0.5, 0.95]
    assert_close(port.quantile(q, "margin_mv"), ref.quantile(q, "margin_mv"))
    assert_close(port.quantile(q, "trc_ns"), ref.quantile(q, "trc_ns"),
                 rtol=0, atol=TRC_BAR)
    summary = port.mc_summary(margin_mv=cal.MIN_FUNCTIONAL_MARGIN_MV)
    want = ref.mc_summary(margin_mv=cal.MIN_FUNCTIONAL_MARGIN_MV)
    np.testing.assert_array_equal(host(summary.feasible),
                                  host(want.feasible))
    assert_close(summary.corners["yield_frac"], want.corners["yield_frac"])


# ---------------------------------------------------------------------------
# scalar density helpers
# ---------------------------------------------------------------------------

def test_density_helpers_match_reference():
    from repro.core import calibration as jcal
    from repro.core import density as jdensity

    dens = np.linspace(0.5, 3.5, 13)
    layers = np.asarray([1, 32, 87, 137, 200])
    for name in ("si", "aos", "d1b"):
        t, jt = cal.get_tech(name), jcal.get_tech(name)
        assert density.cell_area_nm2(t) == jdensity.cell_area_nm2(jt)
        if not t.baseline_2d:           # a 2D baseline has no per-layer cell
            np.testing.assert_array_equal(
                host(density.layers_for_density(t, dens, device="cpu")),
                np.asarray(jdensity.layers_for_density(jt, dens)))
        for fn in ("bit_density_gb_mm2", "stack_height_um",
                   "density_scaling_vs_d1b"):
            assert_close(getattr(density, fn)(t, layers, device="cpu"),
                         getattr(jdensity, fn)(jt, layers), msg=fn)


# ---------------------------------------------------------------------------
# report tables
# ---------------------------------------------------------------------------

def float_bar(path: tuple) -> dict:
    """The bar of a number, from the innermost key of its path that names
    a timed quantity (e.g. table1_summary's trc_ns.si)."""
    for key in reversed(path):
        if key.startswith(("trc", "t_sense", "t_fire", "margin_fire")):
            break
    else:
        return dict(rtol=1e-5, atol=1e-6)
    if key.startswith("trc_delta"):
        return dict(rtol=0, atol=2 * TRC_BAR)
    if key.startswith("trc_speedup"):
        return dict(rtol=2e-2, atol=0)
    if key.startswith("trc"):
        return dict(rtol=0, atol=TRC_BAR)
    if key.startswith("t_sense"):
        return dict(rtol=0, atol=DT + REGEN_SLACK_NS)
    if key.startswith("t_fire"):
        return dict(rtol=0, atol=DT + 1e-6)
    return dict(rtol=1e-2, atol=0)              # margin at the SA fire


def assert_same_table(got, want, path=()):
    """Walk two report results together: same structure, labels equal,
    numbers within the bar of their key."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), path
        for k in want:
            assert_same_table(got[k], want[k], (*path, k))
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for g, w in zip(got, want):
            assert_same_table(g, w, path)
    elif isinstance(want, float):
        assert isinstance(got, float), (path, type(got))
        if math.isnan(want):
            assert math.isnan(got), path
        else:
            bar = float_bar(path)
            assert abs(got - want) <= bar["atol"] + bar["rtol"] * abs(want), (
                path, got, want)
    else:
        assert type(got) is type(want) and got == want, (path, got, want)


REPORTS = {
    "fig3_routing_comparison": {},
    "fig3_routing_comparison_static": dict(with_transient=False),
    "fig9a_stack_height": {},
    "fig9b_margin_vs_density": dict(densities=[1.0, 2.6]),
    "fig9c_spec_table": {},
    "mc_yield_table": dict(samples=16, trc_ceiling_ns=10.9),
    "mc_tail_yield_table": {},
    "fig_tail_probability": dict(floors_mv=[60.0, 100.0], samples=1024),
    "fig9b_margin_yield_vs_density": dict(densities=[1.0, 2.6], samples=32),
    "replica_timing_table": {},
    "table1_summary": {},
}


@pytest.mark.parametrize("name", sorted(REPORTS))
def test_report_matches_reference(name):
    fn = name.removesuffix("_static")
    kwargs = REPORTS[name]
    want = getattr(jreport, fn)(**kwargs)
    got = getattr(report, fn)(device="cpu", **kwargs)
    assert_same_table(got, want)


def test_table1_summary_hits_paper_goldens():
    """The anchors of tests/test_paper_numbers.py: 3% for analytic
    quantities, 2% for the transient tRC."""
    rel = lambda a, b: abs(a - b) / abs(b)
    t1 = report.table1_summary(device="cpu")
    assert t1["bit_density"] == "2.6 Gb/mm^2: 137L (Si), 87L (AOS)"
    for tech, want in (("si", 10.9), ("aos", 10.5), ("d1b", 21.3)):
        assert rel(t1["trc_ns"][tech], want) < 0.02, tech
    for tech, want in (("si", 130.0), ("aos", 189.0), ("d1b", 54.0)):
        assert rel(t1["sense_margin_mv"][tech], want) < 0.03, tech
    e = t1["energy_fj"]
    assert rel(e["write_si"], 6.26) < 0.03 and rel(e["write_aos"], 5.38) < 0.03
    assert rel(e["read_si"], 1.57) < 0.03 and rel(e["read_aos"], 1.35) < 0.03
    spec = report.fig9c_spec_table(device="cpu")
    assert rel(spec["aos"]["bit_density_gb_mm2"], 2.6) < 0.01
    assert rel(spec["si"]["stack_height_um"], 9.6) < 0.01
    assert rel(spec["ratios"]["density_x"], 6.0) < 0.02
    assert spec["ratios"]["trc_speedup_si"] > 1.9
