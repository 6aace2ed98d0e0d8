"""The port's legacy list surface of `core/dse.py` (`evaluate_grid`,
`sweep_combos`, `full_sweep`, list-in/list-out `pareto_front` /
`best_design`) and `transient.simulate_row_cycle_lowered`, on the CPU.

Bars:
- port `evaluate_grid` vs the port's own `sweep` — the reference's bars
  between its `evaluate_grid` and its `sweep`
  (tests/test_design_space.py:192-200): every static metric rel 1e-5 /
  abs 1e-6, tRC rel 1e-5, same (tech, scheme, layers) order, same
  `feasible`.
- port `evaluate_grid` vs the reference's `evaluate_grid` — the same
  static bars and `feasible`, the same NaN pattern, and tRC at the bar
  the slice test holds port and reference sweeps to
  (tests/test_torch_sweep.py): each of the three crossings within one
  `DT_NS` (float32 `exp` differs in the last ulp between XLA and
  PyTorch's CPU kernels, which can move a crossing by one step) plus
  0.05 ns of latch-regeneration slack, i.e. 3 dt + 0.05 ns.
- `simulate_row_cycle_lowered` vs `simulate_row_cycle_many` on the same
  operands: bit for bit.
"""

import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import calibration as jcal  # noqa: E402
from repro.core import dse as jdse  # noqa: E402
from repro.core import routing as jrouting  # noqa: E402
from repro_torch.core import calibration as cal  # noqa: E402
from repro_torch.core import dse, transient  # noqa: E402
from repro_torch.core.batch import DesignBatch, DesignPoint  # noqa: E402
from repro_torch.core.space import DesignSpace  # noqa: E402

CPU = "cpu"
DT = transient.DT_NS
REGEN_SLACK_NS = 0.05
SMALL_GRID = (64, 87, 137)
FIELDS = ("density_gb_mm2", "height_um", "cbl_ff", "margin_mv",
          "margin_disturbed_mv", "e_write_fj", "e_read_fj",
          "hcb_pitch_um", "blsa_area_um2")
COMBOS = [(t, s) for t, tech in sorted(jcal.TECHS.items())
          for s in (tech.allowed_schemes or tuple(jrouting.SCHEMES))]


def grid_of(tech_name, grid):
    tech = cal.TECHS[tech_name]
    return np.asarray(tech.layer_grid if tech.layer_grid is not None
                      else grid)


def assert_static_equivalent(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert isinstance(g, DesignPoint)
        assert (g.tech, g.scheme, g.layers) == (r.tech, r.scheme, r.layers)
        assert g.feasible == r.feasible
        for f in FIELDS:
            assert getattr(g, f) == pytest.approx(getattr(r, f),
                                                  rel=1e-5, abs=1e-6), f


@pytest.mark.parametrize("tech,scheme", COMBOS,
                         ids=[f"{t}-{s}" for t, s in COMBOS])
def test_evaluate_grid_matches_reference(tech, scheme):
    layers = grid_of(tech, SMALL_GRID)
    ref = jdse.evaluate_grid(jcal.TECHS[tech], scheme, layers)
    got = dse.evaluate_grid(cal.TECHS[tech], scheme, layers, device=CPU)
    assert_static_equivalent(got, ref)
    a = np.asarray([p.trc_ns for p in got])
    b = np.asarray([p.trc_ns for p in ref])
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    diff = np.where(np.isnan(b), 0.0, np.abs(a - b))
    slack = 4 * np.spacing(np.float32(np.nanmax(np.abs(b))))
    assert diff.max() <= 3 * DT + REGEN_SLACK_NS + slack, diff.max()


@pytest.mark.parametrize("with_transient", [True, False],
                         ids=["transient", "static"])
def test_evaluate_grid_is_the_scalar_oracle_of_sweep(with_transient):
    """`sweep(...).to_points()` against per-(tech, scheme) `evaluate_grid`
    over the whole space, as tests/test_design_space.py holds the
    reference's two paths."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        got = dse.sweep(DesignSpace.paper_grid(layer_grid=SMALL_GRID),
                        with_transient=with_transient,
                        device=CPU).to_points()
    ref = []
    for tech, scheme in [(t, s) for t, tech_ in cal.TECHS.items()
                         for s in (tech_.allowed_schemes
                                   or tuple(jrouting.SCHEMES))]:
        ref.extend(dse.evaluate_grid(cal.TECHS[tech], scheme,
                                     grid_of(tech, SMALL_GRID),
                                     with_transient=with_transient,
                                     device=CPU))
    assert_static_equivalent(got, ref)
    for g, r in zip(got, ref):
        if with_transient:
            assert g.trc_ns == pytest.approx(r.trc_ns, rel=1e-5)
        else:
            assert np.isnan(g.trc_ns) and np.isnan(r.trc_ns)


def test_evaluate_grid_takes_precomputed_trc():
    layers = np.asarray(SMALL_GRID)
    trc = np.asarray([1.5, 2.5, 3.5], np.float32)
    pts = dse.evaluate_grid(cal.AOS, "sel_strap", layers, trc=trc,
                            device=CPU)
    assert [p.trc_ns for p in pts] == [1.5, 2.5, 3.5]
    ref = jdse.evaluate_grid(jcal.AOS, "sel_strap", layers, trc=trc)
    assert [str(p) for p in pts] == [str(p) for p in ref]


def test_sweep_combos_match_reference():
    with pytest.warns(DeprecationWarning):
        ref = jdse.sweep_combos(np.asarray(SMALL_GRID))
    with pytest.warns(DeprecationWarning):
        got = dse.sweep_combos(np.asarray(SMALL_GRID))
    assert ([(t.name, s, tuple(np.asarray(g).tolist())) for t, s, g in got]
            == [(t.name, s, tuple(np.asarray(g).tolist()))
                for t, s, g in ref])
    assert all(t is cal.TECHS[t.name] for t, _, _ in got)


def test_full_sweep_shim_equals_sweep():
    grid = np.asarray(SMALL_GRID)
    with pytest.warns(DeprecationWarning, match="full_sweep is deprecated"):
        shim = dse.full_sweep(layer_grid=grid, with_transient=False,
                              device=CPU)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        direct = dse.sweep(DesignSpace.paper_grid(layer_grid=SMALL_GRID),
                           with_transient=False, device=CPU).to_points()
        ref = jdse.full_sweep(layer_grid=grid, with_transient=False)
    assert list(map(str, shim)) == list(map(str, direct))
    assert_static_equivalent(shim, ref)


def _warning_texts(fn) -> list[str]:
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        fn()
    return [str(w.message) for w in caught
            if issubclass(w.category, DeprecationWarning)]


@pytest.mark.parametrize("name", ["full_sweep", "sweep_combos"])
def test_deprecation_texts_equal_reference(name):
    calls = {
        "full_sweep": (lambda m, **kw: m.full_sweep(
            layer_grid=(87,), with_transient=False, **kw)),
        "sweep_combos": (lambda m, **kw: m.sweep_combos(
            layer_grid=(87,))),
    }[name]
    got = _warning_texts(lambda: calls(dse, **(
        {"device": CPU} if name == "full_sweep" else {})))
    ref = _warning_texts(lambda: calls(jdse))
    assert got == ref and len(got) == 1
    assert f"{name} is deprecated" in got[0]


def test_pareto_front_and_best_design_keep_list_form():
    batch = dse.sweep(DesignSpace.paper_grid(layer_grid=SMALL_GRID),
                      device=CPU)
    with pytest.warns(DeprecationWarning):
        pts = batch.to_points()
    front_pts = dse.pareto_front(pts, device=CPU)
    front_batch = dse.pareto_front(batch)
    assert isinstance(front_pts, list) and isinstance(front_batch,
                                                      DesignBatch)
    assert all(any(p is q for q in pts) for p in front_pts)
    assert ([(p.tech, p.scheme, p.layers) for p in front_pts]
            == [(front_batch.point(i).tech, front_batch.point(i).scheme,
                 front_batch.point(i).layers)
                for i in range(len(front_batch))])
    best = dse.best_design(pts, device=CPU)
    assert any(best is p for p in pts)            # the caller's own point
    assert best == dse.best_design(batch)
    assert (best.tech, best.scheme, best.layers) == ("aos", "sel_strap", 87)


def test_legacy_front_names_match_reference():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        pts = dse.full_sweep(layer_grid=SMALL_GRID, device=CPU)
        ref = jdse.full_sweep(layer_grid=SMALL_GRID)
    for rf in (True, False):
        got = dse.pareto_front(pts, require_feasible=rf, device=CPU)
        want = jdse.pareto_front(ref, require_feasible=rf)
        assert ([(p.tech, p.scheme, p.layers) for p in got]
                == [(p.tech, p.scheme, p.layers) for p in want])
    best, want = dse.best_design(pts, device=CPU), jdse.best_design(ref)
    assert (best.tech, best.scheme, best.layers) == (want.tech, want.scheme,
                                                     want.layers)


@pytest.mark.parametrize("replica", [False, True], ids=["fixed", "replica"])
def test_simulate_row_cycle_lowered_equals_many(replica):
    space = DesignSpace.paper_grid(layer_grid=SMALL_GRID)
    if replica:
        space = space.with_replica()
    operands = dse.plan_sweep(space, device=CPU).operands
    lowered = transient.simulate_row_cycle_lowered(operands)
    many = transient.simulate_row_cycle_many(operands, device=CPU)
    for f in ("t_sense_ns", "t_restore_ns", "t_precharge_ns", "trc_ns",
              "dv_sense_v", "t_fire_ns", "events"):
        a, b = getattr(lowered, f), getattr(many, f)
        assert torch.equal(a.isnan(), b.isnan()), f
        assert torch.equal(a.nan_to_num(), b.nan_to_num()), f
    assert lowered.events.shape[0] == operands.c.shape[0]
    assert len(lowered.trc_ns) == len(space)


def test_direct_sweep_does_not_use_the_serving_seam(monkeypatch):
    """`dse.sweep` runs the engine through `simulate_row_cycle_lowered`,
    as the reference does; only the service goes through
    `row_cycle_events` (so a counter there counts service dispatches)."""
    calls = []
    orig = transient.row_cycle_events
    monkeypatch.setattr(transient, "row_cycle_events",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    dse.sweep(DesignSpace.paper_targets(), device=CPU)
    transient.simulate_row_cycle_many([(cal.AOS, "sel_strap", [87])],
                                      device=CPU)
    assert calls == []


def test_legacy_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        dse.evaluate_grid(cal.AOS, "sel_strap", np.asarray([87]))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            dse.full_sweep(layer_grid=(87,))
