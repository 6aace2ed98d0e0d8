"""Design-space exploration — the "co-optimization" of the paper's title.

Port of `repro.core.dse`:

    space = DesignSpace.paper_grid()        # declarative (core.space)
    batch = sweep(space)                    # ONE vectorized evaluation
    front = pareto_front(batch)             # masked tensor dominance
    best  = best_design(batch)              # paper's selection rule

`sweep` lowers the whole (tech x scheme x layers [x corners]) space to a
flat operand batch, runs the fused row-cycle engine over it (the CUDA
kernel on the GPU) and scores every metric as flat (B,) tensors on the
same device.

Legacy surface: `full_sweep` / `evaluate_grid` still return the old
`list[DesignPoint]` (deprecated; thin views over the batch), and
`pareto_front` / `best_design` accept either a `DesignBatch` or a list.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass

import numpy as np
import torch

from ..device import as_f32, resolve_device, to_host
from . import calibration as cal
from . import contracts, transient
from .batch import DesignBatch, DesignPoint
from .calibration import TECHS, TechCal
from .density import (bit_density_gb_mm2, bit_density_lowered,
                      stack_height_lowered, stack_height_um)
from .energy import (read_energy_fj, read_energy_lowered, write_energy_fj,
                     write_energy_lowered)
from .netlist import build_ladder_lowered, effective_cbl_ff
from .parasitics import BLParasitics, bl_parasitics_lowered
from .routing import SCHEMES, bonding_geometry, bonding_geometry_lowered
from .sense import sense_margin_lowered, sense_margin_mv
from .space import MC_AXES, MC_LOG_W, DesignSpace, LoweredSpace, SpaceView

__all__ = [
    "DesignBatch", "DesignPoint", "DesignSpace",
    "SweepPlan", "plan_sweep", "finalize_sweep",
    "score_columns", "score_from_events", "assemble_batch",
    "sweep", "pareto_mask", "dominated_by", "pareto_front", "best_design",
    "as_batch",
    "full_sweep", "evaluate_grid", "sweep_combos",
]

# Corner axes `sweep` knows how to route into the physics models (the
# reserved mc_* channels of a with_mc space ride the same mechanism).
SUPPORTED_CORNER_AXES = ("rh_toggles", "trc_cycles")


@dataclass(frozen=True)
class SweepPlan:
    """A lowered, dispatch-ready sweep: everything `sweep` does before the
    fused engine runs.  `plan_sweep` and `finalize_sweep` are the exact two
    halves of `sweep`."""
    space: DesignSpace
    sp: LoweredSpace
    par: BLParasitics                               # over the lowered space
    operands: transient.FusedOperands | None        # None: transient off

    def __len__(self) -> int:
        return len(self.sp)

    @property
    def with_transient(self) -> bool:
        return self.operands is not None


def plan_sweep(space: DesignSpace | None = None,
               with_transient: bool = True, device="cuda") -> SweepPlan:
    """Lower a `DesignSpace` to a dispatch-ready `SweepPlan` on `device`.

    Validates corner axes, assembles the parasitic decomposition, and
    (when the transient is on) lowers the whole space to ONE
    `FusedOperands` batch.
    """
    if space is None:
        space = DesignSpace.paper_grid()
    sp = space.lower(device=device)
    unknown = [k for k in sp.corners
               if k not in SUPPORTED_CORNER_AXES and k not in MC_AXES
               and k != MC_LOG_W]
    if unknown:
        raise ValueError(f"unsupported corner axes {unknown}; sweep "
                         f"understands {SUPPORTED_CORNER_AXES}")
    par = bl_parasitics_lowered(sp)
    operands = None
    if with_transient:
        ladder_c, ladder_g = build_ladder_lowered(sp, par)
        operands = transient.lower_design_operands(
            sp, ladder_c=ladder_c, ladder_g=ladder_g)
    return SweepPlan(space=space, sp=sp, par=par, operands=operands)


def score_columns(view, cbl_ff, trc=None, t_sense=None, t_fire=None,
                  dv_sense=None) -> dict:
    """Per-row scoring of a design-space view -> column dict.

    The transient columns (`trc`, `t_sense`, `t_fire`, `dv_sense`) are
    either all given (post-rollup, design-point length) or all None
    (`with_transient=False`: NaN-filled).  Every output is an elementwise
    (B,) tensor; keys match `DesignBatch` field names.
    """
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
        # margin actually available at the SA fire: the simulated signal at
        # the enable instant minus the SA offset (per sample on MC spaces)
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
        # a design whose timing never closed (NaN tRC: a phase timed out)
        # is invalid as a design, not merely slow
        feasible = feasible & torch.isfinite(trc)

    return dict(
        density_gb_mm2=dens, height_um=height, cbl_ff=cbl,
        margin_mv=margin, margin_disturbed_mv=margin_d,
        trc_ns=trc, t_sense_ns=t_sense, t_fire_ns=t_fire,
        margin_fire_mv=margin_fire, e_write_fj=e_wr, e_read_fj=e_rd,
        hcb_pitch_um=geom.hcb_pitch_um, blsa_area_um2=geom.blsa_area_um2,
        manufacturable=geom.manufacturable, feasible=feasible)


def score_from_events(view, cbl_ff, sa_tau_ns, t_overhead_ns, evt) -> dict:
    """Rollup + scoring from raw fused-engine event columns -> column dict.

    `evt` is the engine's (B_ops, 4) output BEFORE replica de-interleave;
    on replica spaces the main rows sit at odd indices.
    """
    sa_tau, overhead = sa_tau_ns, t_overhead_ns
    if view.replica:
        evt = evt[1::2]
        sa_tau = sa_tau[1::2]
        overhead = overhead[1::2]
    t_sense, _t_restore, trc = transient._regen_and_totals(
        sa_tau, overhead, evt[:, 0], evt[:, 1], evt[:, 2], evt[:, 3])
    return score_columns(view, cbl_ff, trc=trc, t_sense=t_sense,
                         t_fire=evt[:, 0], dv_sense=evt[:, 1])


def assemble_batch(sp: LoweredSpace, cols: dict) -> DesignBatch:
    """Zip scored metric columns with a lowered space's identity columns
    into the contract-checked `DesignBatch`."""
    dev = sp.device
    batch = DesignBatch(
        tech_idx=torch.as_tensor(sp.tech_idx, dtype=torch.int32, device=dev),
        scheme_idx=torch.as_tensor(sp.scheme_idx, dtype=torch.int32,
                                   device=dev),
        layers=sp.layers, valid=torch.as_tensor(sp.valid, device=dev),
        corners={k: torch.as_tensor(v, dtype=torch.float32, device=dev)
                 for k, v in sp.corners.items()},
        tech_names=sp.tech_names, scheme_names=sp.scheme_names,
        n_samples=sp.samples, base_len=sp.base_len, **cols)
    contracts.check_batch(batch, where="dse.sweep")
    return batch


def finalize_sweep(plan: SweepPlan,
                   res: transient.RowCycleResult | None = None) -> DesignBatch:
    """Score a planned sweep into a `DesignBatch`.

    `res` is the fused-engine result for `plan.operands` (None iff the plan
    was made with `with_transient=False`); it is scored from its raw
    events, as `sweep` does.
    """
    if plan.with_transient != (res is not None):
        raise ValueError(
            "finalize_sweep needs the fused-engine result exactly when "
            "the plan lowered transient operands (with_transient="
            f"{plan.with_transient}, res={'set' if res is not None else 'None'})")
    view = SpaceView.from_lowered(plan.sp)
    cbl = plan.par.c_bl_total_ff
    if res is None:
        cols = score_columns(view, cbl)
    else:
        cols = score_from_events(view, cbl, plan.operands.sa_tau_ns,
                                 plan.operands.t_overhead_ns, res.events)
    return assemble_batch(plan.sp, cols)


def sweep(space: DesignSpace | None = None, with_transient: bool = True,
          backend: str = "auto",
          b_chunk: int = transient.DEFAULT_B_CHUNK,
          sharding=None, device="cuda") -> DesignBatch:
    """Score a whole `DesignSpace` in one vectorized pass -> `DesignBatch`.

    `plan_sweep` -> one chunked fused-engine pass
    (`transient.simulate_row_cycle_many` on the lowered operands) ->
    `finalize_sweep`, all on `device`.  `backend` is the kernel dispatch
    of `kernels.ops.row_cycle_fused` ("auto": the CUDA kernel on the GPU,
    the plain version on the CPU).

    `sharding` (a `launch.mesh.SweepMesh` or `launch.shard.SweepSharding`)
    distributes BOTH the fused dispatch and the metric scoring over the
    mesh's slots: the plan is lowered on `device`, each slot (each rank
    under a process group) evaluates and scores its own slab via
    `launch.shard`, and the batch is assembled on `device`, bit-identical
    to the single-device sweep (which remains the equivalence oracle).
    """
    if sharding is not None and not with_transient:
        raise ValueError(
            "sharding= only distributes the fused transient dispatch; a "
            "with_transient=False sweep is elementwise scoring with "
            "nothing to shard — pass sharding=None")
    device = resolve_device(device)
    plan = plan_sweep(space, with_transient=with_transient, device=device)
    if plan.operands is not None and sharding is not None:
        from ..launch import shard
        cols = shard.sharded_sweep_columns(plan, sharding, backend=backend,
                                           b_chunk=b_chunk)
        return assemble_batch(plan.sp, cols)
    res = None
    if plan.operands is not None:
        res = transient.simulate_row_cycle_many(
            plan.operands, backend=backend, b_chunk=b_chunk, device=device)
    return finalize_sweep(plan, res)


# ---------------------------------------------------------------------------
# Pareto front / selection (vectorized dominance)
# ---------------------------------------------------------------------------

def pareto_mask(batch: DesignBatch, require_feasible: bool = True,
                block: int = 4096, extra_maximize=(),
                extra_minimize=(), sharding=None) -> torch.Tensor:
    """Non-dominated mask maximizing density & disturbed margin, minimizing
    tRC & read energy.  The O(B^2) pairwise comparison runs as masked
    broadcasts over blocks of `block` dominators, so peak memory is
    O(block * B).  `extra_maximize` / `extra_minimize` append further (B,)
    objective columns.  NaN metrics never dominate and are never
    dominated.

    `sharding` (SweepMesh / SweepSharding) distributes the dominator
    blocks over the mesh's slots instead of the host loop: each slot
    tests its own dominator slab against the full batch and the slots'
    dominated masks OR together (`launch.shard.sharded_pareto_dominated`).
    Dominance tests are exact comparisons and OR does not depend on
    order, so the sharded mask is bit-identical to the sequential one.
    """
    cand = batch.valid
    if require_feasible:
        cand = cand & batch.feasible
    dev = batch.device
    hi = torch.stack([batch.density_gb_mm2, batch.margin_disturbed_mv,
                      *(as_f32(x, dev) for x in extra_maximize)], dim=1)
    lo = torch.stack([batch.trc_ns, batch.e_read_fj,
                      *(as_f32(x, dev) for x in extra_minimize)], dim=1)
    if sharding is not None:
        from ..launch import shard
        dominated = shard.sharded_pareto_dominated(hi, lo, cand, sharding,
                                                   block=block)
    else:
        dominated = dominated_by(hi, lo, cand, hi, lo, cand, block)
    return cand & ~dominated


def dominated_by(hi_d, lo_d, cand_d, hi, lo, cand,
                 block: int = 4096) -> torch.Tensor:
    """Which rows of (hi, lo, cand) some candidate dominator row of
    (hi_d, lo_d, cand_d) dominates -> (B,) bool, on hi's device.

    The dominators run in blocks of `block` rows: each block is one
    masked broadcast against the whole batch.  `pareto_mask` passes the
    batch as its own dominators; the sharded mask passes each slot's
    slab of them.
    """
    dominated = torch.zeros((hi.shape[0],), dtype=torch.bool,
                            device=hi.device)
    for i0 in range(0, hi_d.shape[0], block):          # dominator blocks
        hi_i, lo_i = hi_d[i0:i0 + block], lo_d[i0:i0 + block]
        cand_i = cand_d[i0:i0 + block]
        ge = ((hi_i[:, None, :] >= hi[None, :, :]).all(-1)
              & (lo_i[:, None, :] <= lo[None, :, :]).all(-1))
        gt = ((hi_i[:, None, :] > hi[None, :, :]).any(-1)
              | (lo_i[:, None, :] < lo[None, :, :]).any(-1))
        dominated |= (ge & gt & cand_i[:, None] & cand[None, :]).any(dim=0)
    return dominated


def as_batch(points_or_batch, device="cuda") -> DesignBatch:
    """A `DesignBatch` passes through (on its own device); a legacy
    `list[DesignPoint]` is bridged via `DesignBatch.from_points` onto
    `device`."""
    if isinstance(points_or_batch, DesignBatch):
        return points_or_batch
    return DesignBatch.from_points(list(points_or_batch), device=device)


def _legacy_points(points_or_batch):
    """The list half of the back-compat boundary: the materialized legacy
    list when the caller passed one (so outputs keep list form), else
    None for the batch-native path."""
    if isinstance(points_or_batch, DesignBatch):
        return None
    return list(points_or_batch)


def pareto_front(points_or_batch, require_feasible: bool = True,
                 extra_maximize=(), extra_minimize=(), sharding=None,
                 device="cuda"):
    """Non-dominated set.  `DesignBatch` in -> filtered `DesignBatch` out;
    legacy `list[DesignPoint]` in -> list out (order preserved), bridged
    through `as_batch` onto `device`.  Extra (B,) objective columns and
    `sharding` (the dominance test over a mesh) pass through to
    `pareto_mask`."""
    points = _legacy_points(points_or_batch)
    batch = as_batch(points_or_batch if points is None else points, device)
    mask = pareto_mask(batch, require_feasible,
                       extra_maximize=extra_maximize,
                       extra_minimize=extra_minimize, sharding=sharding)
    if points is None:
        return batch.select(mask)
    return [p for p, m in zip(points, mask.tolist()) if m]


def best_design(points_or_batch,
                density_target: float = cal.DENSITY_TARGET_GB_MM2,
                min_yield: float | None = None, yield_frac=None,
                device="cuda"):
    """The paper's selection rule: hit the density target with a functional,
    manufacturable design; break ties by tRC then read energy then height.
    Accepts a `DesignBatch` or the legacy list (bridged onto `device`);
    returns a `DesignPoint` (the caller's own for a list), or None if
    nothing qualifies.

    `min_yield` adds a Monte-Carlo yield floor on an explicit (B,)
    `yield_frac` column or the batch's `corners["yield_frac"]`.
    """
    points = _legacy_points(points_or_batch)
    batch = as_batch(points_or_batch if points is None else points, device)
    cand = (to_host(batch.valid) & to_host(batch.feasible)
            & (to_host(batch.density_gb_mm2) >= density_target - 1e-9))
    if min_yield is not None:
        if yield_frac is None:
            yield_frac = batch.corners.get("yield_frac")
        if yield_frac is None:
            raise ValueError(
                "min_yield needs a yield column: pass yield_frac= or use "
                "a batch with corners['yield_frac']")
        cand &= to_host(yield_frac) >= min_yield - 1e-9
    idx = np.flatnonzero(cand)
    if idx.size == 0:
        return None
    trc = to_host(batch.trc_ns).astype(np.float64)[idx]
    trc = np.where(np.isnan(trc), np.inf, trc)
    e_rd = to_host(batch.e_read_fj).astype(np.float64)[idx]
    height = to_host(batch.height_um).astype(np.float64)[idx]
    order = np.lexsort((height, e_rd, trc))     # last key is primary
    best = int(idx[order[0]])
    return points[best] if points is not None else batch.point(best)


# ---------------------------------------------------------------------------
# Legacy list[DesignPoint] surface (deprecated)
# ---------------------------------------------------------------------------

def evaluate_grid(tech: TechCal, scheme: str, layers,
                  with_transient: bool = True, trc=None,
                  device="cuda") -> list[DesignPoint]:
    """Evaluate a vector of layer counts for one (tech, scheme) on `device`.

    Deprecated reference path: per-(tech, scheme) scalar evaluation kept
    as the equivalence oracle for the vectorized `sweep`.  `trc` may carry
    precomputed row-cycle times; otherwise the transient engine runs here.
    """
    device = resolve_device(device)
    arr = as_f32(np.asarray(layers), device)
    dens = to_host(bit_density_gb_mm2(tech, arr, device))
    height = to_host(stack_height_um(tech, arr, device))
    cbl = to_host(effective_cbl_ff(tech, scheme, arr, device))
    margin = to_host(sense_margin_mv(tech, scheme, arr, device=device))
    margin_d = to_host(sense_margin_mv(tech, scheme, arr, with_disturb=True,
                                     device=device))
    e_wr = to_host(write_energy_fj(tech, scheme, arr, device))
    e_rd = to_host(read_energy_fj(tech, scheme, arr, device))
    geom = bonding_geometry(tech, scheme, device)
    pitch = float(geom.hcb_pitch_um)
    blsa = float(geom.blsa_area_um2)
    manufacturable = bool(geom.manufacturable) or tech.baseline_2d
    if trc is not None:
        trc = to_host(trc)
    elif with_transient:
        trc = to_host(transient.simulate_row_cycle(tech, scheme, arr,
                                                 device=device).trc_ns)
    else:
        trc = np.full(len(layers), np.nan)

    pts = []
    for i, layer in enumerate(np.asarray(layers)):
        feas = (manufacturable
                and margin[i] >= cal.MIN_FUNCTIONAL_MARGIN_MV - 1e-9
                and margin_d[i] >= cal.MIN_DISTURBED_MARGIN_MV - 1e-9)
        pts.append(DesignPoint(
            tech=tech.name, scheme=scheme, layers=int(layer),
            density_gb_mm2=float(dens[i]), height_um=float(height[i]),
            cbl_ff=float(cbl[i]), margin_mv=float(margin[i]),
            margin_disturbed_mv=float(margin_d[i]), trc_ns=float(trc[i]),
            e_write_fj=float(e_wr[i]), e_read_fj=float(e_rd[i]),
            hcb_pitch_um=pitch, blsa_area_um2=blsa, feasible=bool(feas)))
    return pts


def sweep_combos(layer_grid) -> list[tuple[TechCal, str, np.ndarray]]:
    """The (tech, scheme, layer-grid) combos of the full design space.

    Deprecated: capability flags on each registered `TechCal` drive this
    now; new code should build a `DesignSpace` instead.
    """
    warnings.warn(
        "dse.sweep_combos is deprecated and will be removed (see "
        "docs/api.md for the timeline); build a DesignSpace "
        "(DesignSpace.paper_grid / product) instead",
        DeprecationWarning, stacklevel=2)
    combos: list[tuple[TechCal, str, np.ndarray]] = []
    for tech in TECHS.values():
        schemes = tech.allowed_schemes or tuple(SCHEMES)
        grid = (np.asarray(tech.layer_grid) if tech.layer_grid is not None
                else layer_grid)
        for scheme in schemes:
            combos.append((tech, scheme, grid))
    return combos


def full_sweep(layer_grid=None, with_transient: bool = True,
               device="cuda") -> list[DesignPoint]:
    """Sweep the whole (tech x scheme x layers) design space on `device`.

    Deprecated compatibility shim: equivalent to
    `sweep(DesignSpace.paper_grid(layer_grid)).to_points()`.
    """
    warnings.warn(
        "dse.full_sweep is deprecated and will be removed (see docs/api.md "
        "for the timeline); use dse.sweep(DesignSpace.paper_grid(...)) and "
        "consume the DesignBatch columns",
        DeprecationWarning, stacklevel=2)
    grid = None if layer_grid is None else tuple(
        float(x) for x in np.asarray(layer_grid).reshape(-1))
    space = DesignSpace.paper_grid(layer_grid=grid)
    with warnings.catch_warnings():
        # the shim IS the deprecated surface; its internal to_points call
        # must not double-warn the caller
        warnings.simplefilter("ignore", DeprecationWarning)
        return sweep(space, with_transient=with_transient,
                     device=device).to_points()
