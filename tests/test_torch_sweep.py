"""The slice as a whole: the port's `dse.sweep` against the reference's,
column by column, on the CPU (plain version of the kernel).

Bars (the reference's own fused-vs-phased bars,
tests/test_fused_row_cycle.py): the ACT fire time within one dt; t_sense
within one dt + 0.05 ns regeneration slack; tRC within 3 dt + slack (one
dt per crossing).  The margin at the SA fire carries dv_sense's bar
(rtol 1e-3, atol 1e-5 V -> 1e-2 mV).  Every other float column agrees at
rtol 1e-5 (float32 rounding); identity columns, `feasible`, the Pareto
mask and the selected design are identical.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import calibration as jcal  # noqa: E402
from repro.core import dse as jdse  # noqa: E402
from repro.core import space as jspace  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import calibration as cal  # noqa: E402
from repro_torch.core import dse, space, transient  # noqa: E402
from repro_torch.core.batch import ARRAY_FIELDS, DesignBatch  # noqa: E402

DT = transient.DT_NS
REGEN_SLACK_NS = 0.05
GRID = (64, 87, 137)

SPACES = {
    "nominal": lambda m: m.DesignSpace.paper_grid(layer_grid=GRID),
    "replica": lambda m: m.DesignSpace.paper_grid(layer_grid=GRID)
    .with_replica(),
    "mc": lambda m: m.DesignSpace.paper_grid(layer_grid=GRID)
    .with_mc(samples=4, key=0),
}

EVENT_BARS = {"t_fire_ns": DT, "t_sense_ns": DT + REGEN_SLACK_NS,
              "trc_ns": 3 * DT + REGEN_SLACK_NS}
IDENTITY = ("tech_idx", "scheme_idx", "layers", "valid", "manufacturable",
            "feasible")


@pytest.fixture(scope="module", params=sorted(SPACES))
def sweeps(request):
    """(name, reference batch, port batch) for one space."""
    build = SPACES[request.param]
    return (request.param, jdse.sweep(build(jspace)),
            dse.sweep(build(space), device="cpu"))


def host(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_layout_and_identity_columns_match(sweeps):
    _, ref, port = sweeps
    assert len(port) == len(ref)
    assert (port.tech_names, port.scheme_names) == (ref.tech_names,
                                                    ref.scheme_names)
    assert (port.n_samples, port.base_len) == (ref.n_samples, ref.base_len)
    for name in IDENTITY:
        np.testing.assert_array_equal(host(getattr(port, name)),
                                      host(getattr(ref, name)), err_msg=name)
    assert sorted(port.corners) == sorted(ref.corners)
    for k in ref.corners:
        np.testing.assert_array_equal(host(port.corners[k]),
                                      host(ref.corners[k]))


def test_column_dtypes(sweeps):
    _, _, port = sweeps
    for name in ARRAY_FIELDS:
        dtype = getattr(port, name).dtype
        if name in ("tech_idx", "scheme_idx"):
            assert dtype == torch.int32, name
        elif name in ("manufacturable", "feasible", "valid"):
            assert dtype == torch.bool, name
        else:
            assert dtype == torch.float32, name


def sa_offset_mv(batch):
    """Per-row SA offset: the MC draw, else the tech's calibrated value."""
    if "mc_sa_offset_mv" in batch.corners:
        return host(batch.corners["mc_sa_offset_mv"])
    table = np.asarray([jcal.get_tech(n).sa_offset_mv
                        for n in batch.tech_names])
    return table[host(batch.tech_idx)]


def f32_slack(x):
    """Float32 resolution of times stored as (k+1) * dt at this magnitude."""
    return 4 * np.spacing(np.float32(np.nanmax(np.abs(x))))


@pytest.mark.parametrize("name", sorted(EVENT_BARS))
def test_event_columns_within_dt(sweeps, name):
    _, ref, port = sweeps
    a, b = host(getattr(port, name)), host(getattr(ref, name))
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    diff = np.where(np.isnan(b), 0.0, np.abs(a - b))
    assert diff.max() <= EVENT_BARS[name] + f32_slack(b), diff.max()


def test_margin_at_fire_follows_the_fire_step(sweeps):
    """Where the SA fires at the same step, the margin at the fire carries
    dv_sense's bar (rtol 1e-3, atol 1e-5 V = 1e-2 mV).  Where float32
    rounding moved the fire by one step, the margin moves the same way
    (a later fire sees more developed signal) by at most the signal one
    step develops, under 1% of the signal for these ladders."""
    _, ref, port = sweeps
    a, b = host(port.margin_fire_mv), host(ref.margin_fire_mv)
    step = np.rint((host(port.t_fire_ns) - host(ref.t_fire_ns)) / DT)
    dv_mv = np.abs(b + sa_offset_mv(ref))   # the simulated signal, in mV
    same = step == 0
    assert np.all(np.abs(a - b)[same] <= 1e-3 * dv_mv[same] + 1e-2)
    moved = ~same
    assert np.all(np.abs(step[moved]) == 1)
    assert np.all(np.sign(a - b)[moved] == step[moved])
    assert np.all(np.abs(a - b)[moved] <= 1e-2 * dv_mv[moved])


@pytest.mark.parametrize("name", ["density_gb_mm2", "height_um", "cbl_ff",
                                  "margin_mv", "margin_disturbed_mv",
                                  "e_write_fj", "e_read_fj", "hcb_pitch_um",
                                  "blsa_area_um2"])
def test_static_columns_match(sweeps, name):
    _, ref, port = sweeps
    np.testing.assert_allclose(host(getattr(port, name)),
                               host(getattr(ref, name)), rtol=1e-5)


def test_best_design_is_the_same_point(sweeps):
    _, ref, port = sweeps
    a, b = dse.best_design(port), jdse.best_design(ref)
    assert (a.tech, a.scheme, a.layers) == (b.tech, b.scheme, b.layers)


def test_pareto_mask_on_reference_columns_is_identical(sweeps):
    """The port's dominance test on the reference batch's own columns,
    carried across as numpy through `interop`."""
    _, ref, _ = sweeps
    cols = {f: np.asarray(getattr(ref, f)) for f in ARRAY_FIELDS}
    batch = interop.batch_columns_from_numpy(
        cols, ref.tech_names, ref.scheme_names, device="cpu")
    for feasible in (True, False):
        np.testing.assert_array_equal(
            dse.pareto_mask(batch, require_feasible=feasible, block=16).numpy(),
            np.asarray(jdse.pareto_mask(ref, require_feasible=feasible)))


def test_chunked_sweep_is_bit_identical_to_monolithic(sweeps):
    name, _, port = sweeps
    chunked = dse.sweep(SPACES[name](space), b_chunk=64, device="cpu")
    for f in ARRAY_FIELDS:
        np.testing.assert_array_equal(host(getattr(chunked, f)),
                                      host(getattr(port, f)), err_msg=f)


# --------------------------------------------------------------------------
# Paper goldens through the port (tests/test_paper_numbers.py anchors)
# --------------------------------------------------------------------------

def rel(a, b):
    return abs(a - b) / abs(b)


@pytest.fixture(scope="module")
def nominal():
    return dse.sweep(SPACES["nominal"](space), device="cpu")


def _row(batch, tech, scheme, layers):
    for i in range(len(batch)):
        p = batch.point(i)
        if (p.tech, p.scheme, p.layers) == (tech, scheme, layers):
            return p
    raise LookupError((tech, scheme, layers))


def test_golden_aos_density_and_trc(nominal):
    p = _row(nominal, "aos", "sel_strap", 87)
    assert rel(p.density_gb_mm2, 2.6) < 0.01
    assert rel(p.trc_ns, 10.5) < 0.02
    best = dse.best_design(nominal)
    assert (best.tech, best.scheme, best.layers) == ("aos", "sel_strap", 87)


def test_golden_si_and_d1b_trc(nominal):
    assert rel(_row(nominal, "si", "sel_strap", 137).trc_ns, 10.9) < 0.02
    assert rel(_row(nominal, "si", "sel_strap", 137).density_gb_mm2,
               2.6) < 0.01
    assert rel(_row(nominal, "d1b", "direct", 1).trc_ns, 21.3) < 0.02


@pytest.mark.parametrize("tech,scheme,golden", [("si", "sel_strap", 10.9),
                                                ("aos", "sel_strap", 10.5),
                                                ("d1b", "direct", 21.3)])
def test_nominal_trc_goldens(tech, scheme, golden):
    trc = float(transient.nominal_trc_ns(cal.get_tech(tech), scheme,
                                         device="cpu"))
    assert rel(trc, golden) < 0.02


# --------------------------------------------------------------------------
# Other entry points of the slice
# --------------------------------------------------------------------------

def test_sweep_without_transient_matches_reference():
    port = dse.sweep(SPACES["nominal"](space), with_transient=False,
                     device="cpu")
    ref = jdse.sweep(SPACES["nominal"](jspace), with_transient=False)
    assert torch.isnan(port.trc_ns).all()
    np.testing.assert_array_equal(port.feasible.numpy(),
                                  np.asarray(ref.feasible))
    np.testing.assert_allclose(port.margin_disturbed_mv.numpy(),
                               np.asarray(ref.margin_disturbed_mv), rtol=1e-5)


@pytest.mark.parametrize("replica", [False, True])
def test_simulate_row_cycle_matches_reference(replica):
    from repro.core import transient as jtransient
    layers = [64, 87, 137]
    a = transient.simulate_row_cycle(cal.AOS, "sel_strap", layers,
                                     replica=replica, device="cpu")
    b = jtransient.simulate_row_cycle(jcal.AOS, "sel_strap",
                                      np.asarray(layers), replica=replica)
    assert np.abs(a.t_fire_ns.numpy() - np.asarray(b.t_fire_ns)).max() <= DT
    assert np.abs(a.trc_ns.numpy() - np.asarray(b.trc_ns)).max() <= (
        3 * DT + REGEN_SLACK_NS)


def test_simulate_row_cycle_many_matches_single_calls():
    entries = [(cal.SI, "sel_strap", [87, 137]), (cal.AOS, "sel_strap", [87]),
               (cal.D1B, "direct", [1])]
    many = transient.simulate_row_cycle_many(entries, device="cpu")
    for (tech, scheme, layers), res in zip(entries, many):
        single = transient.simulate_row_cycle(tech, scheme, layers,
                                              device="cpu")
        np.testing.assert_array_equal(res.trc_ns.numpy(),
                                      single.trc_ns.numpy())


def test_unported_options_raise():
    # sharding= is ported (tests/test_torch_shard.py); what is not a mesh
    # is refused
    with pytest.raises(TypeError, match="SweepMesh or SweepSharding"):
        dse.sweep(space.DesignSpace.paper_targets(), sharding=object(),
                  device="cpu")
    with pytest.raises(TypeError, match="int seed"):
        space.DesignSpace.paper_targets().with_mc(samples=2, key=(1, 2))
    with pytest.raises(ValueError, match="B_ALIGN"):
        transient.validate_b_chunk(100)


# --------------------------------------------------------------------------
# DesignBatch row operations
# --------------------------------------------------------------------------

def test_batch_row_operations(nominal):
    n = len(nominal)
    padded = nominal.pad_to(64)
    assert len(padded) % 64 == 0 and padded.n_valid == n
    assert not padded.feasible[n:].any()
    sel = nominal.select(nominal.feasible)
    assert len(sel) == int(nominal.feasible.sum())
    sl = nominal.slice_rows(2, 5)
    assert sl.point(0) == nominal.point(2)
    with pytest.raises(ValueError, match="out of range"):
        nominal.slice_rows(3, n + 1)
    both = DesignBatch.concat([nominal, sl])
    assert len(both) == n + 3 and both.point(n) == nominal.point(2)
    with pytest.warns(DeprecationWarning):
        pts = nominal.to_points()
    assert pts[0] == nominal.point(0) and len(pts) == n
    # the legacy list surface round-trips through as_batch
    front = dse.pareto_front(pts, device="cpu")
    assert [p for p in front] == [nominal.point(int(i)) for i in
                                  torch.nonzero(dse.pareto_mask(nominal))
                                  .reshape(-1)]


def test_mc_batch_selection_clears_layout():
    batch = dse.sweep(SPACES["mc"](space), device="cpu")
    assert batch.n_samples == 4 and batch.base_len * 4 == len(batch)
    assert batch.select(batch.valid).n_samples == 0
    assert batch.slice_rows(0, 4).n_samples == 0
