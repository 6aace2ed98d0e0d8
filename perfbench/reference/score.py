"""Per-row scoring and the whole reference sweep.

Frozen copy of `score_columns` / `score_from_events` / `assemble_batch`
of `src/repro_torch/core/dse.py`, returning a dict of (B,) columns named
as the program's `DesignBatch` fields (`corners` a dict of its own), and
`sweep`: lower, parasitics, operands, engine, roll-up and scoring, the
steps of the program's `dse.sweep` (with or without the transient), all
recomputed here.
"""

from __future__ import annotations

import torch

from . import calibration as cal
from . import engine
from .density import bit_density_lowered, stack_height_lowered
from .device import as_f32
from .energy import read_energy_lowered, write_energy_lowered
from .parasitics import bl_parasitics_lowered
from .routing import bonding_geometry_lowered
from .sense import sense_margin_lowered
from .space import DesignSpace, SpaceView


def score_columns(view, cbl_ff, trc=None, t_sense=None, t_fire=None,
                  dv_sense=None) -> dict:
    """The transient columns are all given, or all None (a sweep with
    `with_transient=False`: NaN-filled)."""
    dev = view.device
    cbl = as_f32(cbl_ff, dev)
    dens = bit_density_lowered(view)
    height = stack_height_lowered(view)
    margin = sense_margin_lowered(view, cbl_ff=cbl)
    margin_d = sense_margin_lowered(view, with_disturb=True, cbl_ff=cbl)
    e_wr = write_energy_lowered(view, cbl_ff=cbl)
    e_rd = read_energy_lowered(view, cbl_ff=cbl)
    geom = bonding_geometry_lowered(view)
    if trc is not None:
        sa_offset = view.corner("mc_sa_offset_mv", None)
        if sa_offset is None:
            sa_offset = view.tech("sa_offset_mv")
        margin_fire = dv_sense * 1e3 - as_f32(sa_offset, dev)
    else:
        trc = torch.full((len(view),), float("nan"), dtype=torch.float32,
                         device=dev)
        t_sense = t_fire = margin_fire = trc
    feasible = (geom.manufacturable
                & (margin >= cal.MIN_FUNCTIONAL_MARGIN_MV - 1e-9)
                & (margin_d >= cal.MIN_DISTURBED_MARGIN_MV - 1e-9)
                & view.valid)
    if dv_sense is not None:
        feasible = feasible & torch.isfinite(trc)
    return dict(
        density_gb_mm2=dens, height_um=height, cbl_ff=cbl,
        margin_mv=margin, margin_disturbed_mv=margin_d,
        trc_ns=trc, t_sense_ns=t_sense, t_fire_ns=t_fire,
        margin_fire_mv=margin_fire, e_write_fj=e_wr, e_read_fj=e_rd,
        hcb_pitch_um=geom.hcb_pitch_um, blsa_area_um2=geom.blsa_area_um2,
        manufacturable=geom.manufacturable, feasible=feasible)


def sweep(space: DesignSpace, device, dtype=torch.float32,
          with_transient: bool = True) -> dict:
    """Every scored column of `space` -> dict of (B,) tensors on `device`,
    with `corners` (the MC channels), `samples` and `base_len`; the
    engine's state machine runs in `dtype` (and not at all with
    `with_transient=False`)."""
    sp = space.lower(device=device)
    par = bl_parasitics_lowered(sp)
    view = SpaceView.from_lowered(sp)
    if not with_transient:
        cols = score_columns(view, par.c_bl_total_ff)
    else:
        operands, sa_tau, overhead = engine.lower_design_operands(sp, par)
        evt = engine.events(operands, dtype=dtype)
        del operands
        if sp.replica:
            evt, sa_tau, overhead = evt[1::2], sa_tau[1::2], overhead[1::2]
        t_sense, _, trc = engine.regen_and_totals(
            sa_tau, overhead, evt[:, 0], evt[:, 1], evt[:, 2], evt[:, 3])
        cols = score_columns(view, par.c_bl_total_ff, trc, t_sense,
                             evt[:, 0], evt[:, 1])
    dev = sp.device
    cols.update(
        tech_idx=torch.as_tensor(sp.tech_idx, dtype=torch.int32, device=dev),
        scheme_idx=torch.as_tensor(sp.scheme_idx, dtype=torch.int32,
                                   device=dev),
        layers=sp.layers, valid=torch.as_tensor(sp.valid, device=dev),
        corners={k: torch.as_tensor(v, dtype=torch.float32, device=dev)
                 for k, v in sp.corners.items()},
        samples=sp.samples, base_len=sp.base_len)
    return cols
