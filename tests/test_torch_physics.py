"""Physics leaves, the space lowering and the operand lowering of the port
against the reference, on the paper grid, its replica variant and two
Monte-Carlo variants (i.i.d. and correlated draws).

Identity columns and Monte-Carlo draws are numpy on both sides and must be
exactly equal.  Float columns agree at rtol 1e-5 / atol 1e-6: float32
transcendentals (sqrt, exp) differ in the last ulp between XLA and
PyTorch's CPU kernels.  Dtypes are pinned (float32 / int32 / bool): the
reference's float64 numpy gathers turn float32 where they meet jnp, and
the port converts at the same points.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import density as jdensity  # noqa: E402
from repro.core import disturb as jdisturb  # noqa: E402
from repro.core import energy as jenergy  # noqa: E402
from repro.core import netlist as jnetlist  # noqa: E402
from repro.core import parasitics as jparasitics  # noqa: E402
from repro.core import routing as jrouting  # noqa: E402
from repro.core import sense as jsense  # noqa: E402
from repro.core import space as jspace  # noqa: E402
from repro.core import transient as jtransient  # noqa: E402
from repro_torch.core import (density, disturb, energy, netlist,  # noqa: E402
                              parasitics, routing, sense, space, transient)

RTOL, ATOL = 1e-5, 1e-6

SPACES = {
    "paper_grid": lambda m: m.DesignSpace.paper_grid(),
    "replica": lambda m: m.DesignSpace.paper_grid().with_replica(),
    "mc": lambda m: m.DesignSpace.paper_grid().with_mc(samples=8, key=0),
    "mc_corr": lambda m: m.DesignSpace.paper_grid().with_mc(
        samples=8, key=0, corr=0.5),
    "corners": lambda m: m.DesignSpace.paper_targets().with_corners(
        rh_toggles=(5e3, 2e4), trc_cycles=(1.5e6, 3e6)),
}


@pytest.fixture(scope="module", params=sorted(SPACES))
def spaces(request):
    """(reference LoweredSpace, port LoweredSpace) of one space."""
    build = SPACES[request.param]
    return build(jspace).lower(), build(space).lower(device="cpu")


def check(port, ref, dtype=torch.float32):
    assert isinstance(port, torch.Tensor) and port.dtype == dtype, port
    port, ref = port.numpy(), np.asarray(ref)
    assert port.shape == ref.shape
    if dtype == torch.float32:
        np.testing.assert_allclose(port, ref, rtol=RTOL, atol=ATOL)
    else:
        np.testing.assert_array_equal(port, ref)


def test_lower_matches_reference_exactly(spaces):
    ref, port = spaces
    assert port.tech_names == ref.tech_names
    assert port.scheme_names == ref.scheme_names
    assert (port.samples, port.replica, port.base_len) == (
        ref.samples, ref.replica, ref.base_len)
    for name, dtype in [("tech_idx", np.int32), ("scheme_idx", np.int32),
                        ("layers_np", np.float32), ("valid", bool)]:
        a, b = getattr(port, name), getattr(ref, name)
        assert a.dtype == b.dtype == dtype, name
        np.testing.assert_array_equal(a, b)
    assert sorted(port.corners) == sorted(ref.corners)
    for k, v in ref.corners.items():        # MC draws: bit for bit
        assert port.corners[k].dtype == v.dtype == np.float32
        np.testing.assert_array_equal(port.corners[k], v)


def test_space_view_gather_dtypes(spaces):
    _, port = spaces
    view = space.SpaceView.from_lowered(port)
    assert view.tech("r_on_cell_kohm").dtype == torch.float32
    assert view.tech("layers_target").dtype == torch.int32
    assert view.scheme("straps_per_global").dtype == torch.int32
    assert view.tech("baseline_2d").dtype == torch.bool
    assert view.tech_idx.dtype == torch.int32
    assert view.valid.dtype == torch.bool
    assert view.layers.dtype == torch.float32


def test_parasitics_match_reference(spaces):
    ref, port = spaces
    jpar = jparasitics.bl_parasitics_lowered(ref)
    par = parasitics.bl_parasitics_lowered(port)
    for f in dataclasses.fields(jpar):
        check(getattr(par, f.name), getattr(jpar, f.name))
    check(par.c_bl_total_ff, jpar.c_bl_total_ff)
    check(netlist.effective_cbl_lowered(port),
          jnetlist.effective_cbl_lowered(ref))


def test_ladder_matches_reference(spaces):
    ref, port = spaces
    c, g = netlist.build_ladder_lowered(port)
    jc, jg = jnetlist.build_ladder_lowered(ref)
    check(c, jc)
    check(g, jg)
    rc, rg = netlist.replica_ladder_arrays(c, g, port.tech("replica_cells"))
    jrc, jrg = jnetlist.replica_ladder_arrays(jc, jg, ref.tech("replica_cells"))
    check(rc, jrc)
    check(rg, jrg)


SCORE_LEAVES = {
    "bit_density": (density.bit_density_lowered,
                    jdensity.bit_density_lowered),
    "stack_height": (density.stack_height_lowered,
                     jdensity.stack_height_lowered),
    "sense_margin": (sense.sense_margin_lowered,
                     jsense.sense_margin_lowered),
    "sense_margin_disturbed": (
        lambda v: sense.sense_margin_lowered(v, with_disturb=True),
        lambda v: jsense.sense_margin_lowered(v, with_disturb=True)),
    "disturb_loss": (disturb.disturb_loss_lowered,
                     jdisturb.disturb_loss_lowered),
    "write_energy": (energy.write_energy_lowered,
                     jenergy.write_energy_lowered),
    "read_energy": (energy.read_energy_lowered,
                    jenergy.read_energy_lowered),
}


@pytest.mark.parametrize("leaf", sorted(SCORE_LEAVES))
def test_scoring_leaf_matches_reference(spaces, leaf):
    """The scoring leaves run on the device-side view, as the sweep's
    scoring pass runs them."""
    ref, port = spaces
    fn, jfn = SCORE_LEAVES[leaf]
    check(fn(space.SpaceView.from_lowered(port)),
          jfn(jspace.SpaceView.from_lowered(ref)))


def test_bonding_geometry_matches_reference(spaces):
    ref, port = spaces
    geom = routing.bonding_geometry_lowered(space.SpaceView.from_lowered(port))
    jgeom = jrouting.bonding_geometry_lowered(
        jspace.SpaceView.from_lowered(ref))
    check(geom.hcb_pitch_um, jgeom.hcb_pitch_um)
    check(geom.blsa_area_um2, jgeom.blsa_area_um2)
    check(geom.bonds_per_mm2_m, jgeom.bonds_per_mm2_m)
    check(geom.manufacturable, jgeom.manufacturable, dtype=torch.bool)


def test_design_operands_match_reference(spaces):
    ref, port = spaces
    ops = transient.lower_design_operands(port)
    jops = jtransient.lower_design_operands(ref)
    assert ops.replica == jops.replica
    for name in ("c", "g", "gc_res", "gc_pre", "v0", "params", "sa_tau_ns",
                 "t_overhead_ns"):
        check(getattr(ops, name), getattr(jops, name))
    # the integer-coded columns (active, role) are exact
    np.testing.assert_array_equal(ops.params[:, 4:].numpy(),
                                  np.asarray(jops.params)[:, 4:])
