"""Sharded multi-device dispatch of the fused row-cycle DSE sweep.

Port of `repro.launch.shard`.  The DSE layer lowers a whole
`DesignSpace` to ONE flat operand batch (`transient.FusedOperands`,
batch axis only).  This module splits that batch over the slots of a
`SweepMesh` (`launch.mesh`):

    mesh  = make_sweep_mesh()                  # every local card
    batch = dse.sweep(space, sharding=mesh)    # each slot: its own slab

    # equivalently, via this module's convenience wrapper:
    batch = shard.sharded_sweep(space, mesh=mesh)

Mechanics:

1. the operand batch is padded with inactive design points so every slot
   receives an identical, B_ALIGN-aligned slab (for grids larger than
   `slots * b_chunk`, a whole number of `b_chunk` chunks);
2. each slab goes to its slot's device (`put_global`) and through
   `transient._row_cycle_fused_chunked`: one `csrc/row_cycle.cu` launch a
   slot on the card, `b_chunk` chunks through the plain version on the
   CPU.  Every slot's launch is enqueued before any host read, so slots
   on different cards overlap;
3. each slab's event columns are scored on its slot by
   `dse.score_from_events`, the function the sequential sweep runs.  Per
   row the arithmetic is the same, so every column is bit-identical to
   the sequential sweep (the equivalence oracle); only the placement
   differs.

Under `torch.distributed` (a mesh built with `group=`, the same
`dse.sweep(space, sharding=mesh)` call on every rank) each process
computes only its own slots; the scored columns come back to every rank
with one `all_gather`, and the sharded Pareto test OR-reduces the ranks'
dominated masks with `all_reduce(MAX)` on uint8.  Every rank lowers the
whole space itself: the lowering is deterministic, so the plan is
replicated without being sent.

    python -m repro_torch.launch.shard --smoke [--mc N]
        [--expect-devices N] [--device cuda|cpu]

checks the sharded sweep against the single-device one, bit for bit.
"""

from __future__ import annotations

import argparse
import sys
import time
from dataclasses import dataclass

import torch

from ..core import contracts, transient
from ..core.transient import B_ALIGN, FusedOperands, RowCycleResult
from ..device import resolve_device
from .mesh import SweepMesh, make_sweep_mesh

__all__ = [
    "SweepSharding", "sweep_sharding", "batch_sharding", "put_global",
    "row_cycle_fused_sharded", "simulate_row_cycle_sharded",
    "sharded_sweep_columns", "sharded_pareto_dominated",
    "sharded_sweep", "batch_mismatches",
]


@dataclass(frozen=True)
class SweepSharding:
    """The batch axis split over the mesh axes named in `spec` (the
    counterpart of a `NamedSharding(mesh, P(spec))`)."""
    mesh: SweepMesh
    spec: tuple

    def is_canonical(self) -> bool:
        """Whether this places rows as the full-product sharding does: the
        axes of more than one slot, in order, are the mesh's own."""
        def split(axes):
            return [a for a in axes if self.mesh.axis_size(a) > 1]
        return split(self.spec) == split(self.mesh.axis_names)


def _as_mesh(sharding, device="cuda") -> SweepMesh:
    """Normalize a `sharding=` argument (SweepMesh | SweepSharding | None:
    a fresh `make_sweep_mesh(device=device)`).

    A `SweepSharding` must be equivalent to the canonical batch-axis
    sharding of its mesh — the sweep always distributes the flat batch
    over the FULL slot product, so a partial-axis spec would silently
    place operands differently than the caller asked; reject it instead.
    """
    if sharding is None:
        return make_sweep_mesh(device=device)
    if isinstance(sharding, SweepSharding):
        if not sharding.is_canonical():
            raise ValueError(
                f"sharding spec {sharding.spec} does not shard the batch "
                "axis over the mesh's full slot product; pass the mesh "
                f"itself (or sweep_sharding(mesh), spec "
                f"{sharding.mesh.axis_names}) — partial-axis placement is "
                "not supported by the sharded sweep")
        return sharding.mesh
    if isinstance(sharding, SweepMesh):
        return sharding
    raise TypeError(
        f"sharding must be a SweepMesh or SweepSharding, got {sharding!r}")


def sweep_sharding(sharding=None, device="cuda") -> SweepSharding:
    """The canonical sweep sharding: batch axis over ALL mesh axes.

    Accepts a SweepMesh (or None for a fresh all-card `make_sweep_mesh`
    on `device`)."""
    mesh = _as_mesh(sharding, device)
    return SweepSharding(mesh, mesh.axis_names)


# the reference's name for it in core.batch's docs
batch_sharding = sweep_sharding


def put_global(x: torch.Tensor, sharding) -> list[torch.Tensor]:
    """This process's shards of a (B, ...) tensor: one slab of B / slots
    rows per local slot, on the slot's device (global slot g holds rows
    [g * B / slots, (g + 1) * B / slots)).  Every process holds the whole
    lowered batch, so each takes its own rows from it."""
    mesh = _as_mesh(sharding)
    b = x.shape[0]
    if b % mesh.size:
        raise ValueError(f"{b} rows do not split into {mesh.size} equal "
                         "slabs; pad first (_dispatch_target)")
    s = b // mesh.size
    return [x[g * s:(g + 1) * s].to(dev)
            for g, dev in zip(mesh.local_slots, mesh.slots)]


def _dispatch_target(b: int, n_dev: int, b_chunk: int) -> int:
    """Padded batch size: identical per-slot slabs, each a B_ALIGN
    multiple; slabs larger than `b_chunk` hold a whole number of chunks
    so in-slot chunking never exceeds the memory bound."""
    slab = -(-b // n_dev)
    quantum = b_chunk if slab > b_chunk else B_ALIGN
    slab = -(-slab // quantum) * quantum
    return max(slab, B_ALIGN) * n_dev


def _pad_rows(x: torch.Tensor, total: int, value) -> torch.Tensor:
    """`x` with rows of `value` appended up to `total` rows."""
    return torch.cat([x, x.new_full((total - x.shape[0], *x.shape[1:]),
                                    value)])


def _collective_device(mesh: SweepMesh, out: torch.device) -> torch.device:
    """Where a collective's buffer lives: the card for NCCL; the host for
    gloo, whose collectives are fed host copies of finished results (the
    work itself ran on the slots)."""
    import torch.distributed as dist
    if dist.get_backend(mesh.group) == "nccl":
        return out
    return torch.device("cpu")


def _gather_rows(parts: list[torch.Tensor], mesh: SweepMesh,
                 out: torch.device) -> torch.Tensor:
    """This process's slot results, in slot order, on `out`; under a
    group, every rank's (an `all_gather` in rank order)."""
    local = torch.cat([p.to(out) for p in parts])
    if mesh.group is None:
        return local
    import torch.distributed as dist
    buf = local.to(_collective_device(mesh, out)).contiguous()
    gathered = [torch.empty_like(buf) for _ in range(mesh.world)]
    dist.all_gather(gathered, buf, group=mesh.group)
    return torch.cat(gathered).to(out)


def _gather_columns(slot_cols: list[dict], mesh: SweepMesh,
                    out: torch.device, b: int) -> dict:
    """Scored column slabs -> the caller's B rows of each column on `out`.

    The columns travel packed as one int32 matrix (float32 bits viewed,
    bools widened), so a process group moves them in one `all_gather`
    and NaN payloads survive it."""
    keys = list(slot_cols[0])
    if mesh.group is None:
        return {k: torch.cat([c[k].to(out) for c in slot_cols])[:b]
                for k in keys}
    dtypes = {k: slot_cols[0][k].dtype for k in keys}

    def pack(cols):
        return torch.stack([cols[k].view(torch.int32)
                            if cols[k].dtype == torch.float32
                            else cols[k].to(torch.int32) for k in keys], 1)

    rows = _gather_rows([pack(c) for c in slot_cols], mesh, out)[:b]
    unpacked = {}
    for i, k in enumerate(keys):
        col = rows[:, i].contiguous()
        if dtypes[k] == torch.float32:
            unpacked[k] = col.view(torch.float32)
        elif dtypes[k] == torch.bool:
            unpacked[k] = col != 0
        else:
            unpacked[k] = col.to(dtypes[k])
    return unpacked


def _slab_events(core, mesh: SweepMesh, backend: str, b_chunk: int):
    """Pad `core` to identical slabs, place them, and launch every local
    slot's row cycle before any host read -> ([(events, v_end)] per local
    slot, padded rows)."""
    b = core[0].shape[0]
    target = _dispatch_target(b, mesh.size, b_chunk)
    padded = transient._pad_operands(core, target - b)
    slabs = zip(*(put_global(x, mesh) for x in padded))
    return [transient._row_cycle_fused_chunked(list(s), backend, b_chunk)
            for s in slabs], target


def row_cycle_fused_sharded(operands, sharding=None, backend: str = "auto",
                            b_chunk: int = transient.DEFAULT_B_CHUNK):
    """Sharded fused row-cycle dispatch -> (events (B, 4), v_end (B, N)).

    `operands` is a `FusedOperands` or the raw 6-tuple of kernel operand
    tensors; `sharding` a SweepMesh / SweepSharding (None: every card).
    Each slot evaluates its own padded slab; the outputs come back on the
    operands' device, sliced to the caller's B rows.
    """
    b_chunk = transient.validate_b_chunk(b_chunk)
    mesh = _as_mesh(sharding)
    core = list(operands[:6])
    b, out = core[0].shape[0], core[0].device
    runs, _ = _slab_events(core, mesh, backend, b_chunk)
    evt = _gather_rows([e for e, _ in runs], mesh, out)
    v_end = _gather_rows([v for _, v in runs], mesh, out)
    return evt[:b], v_end[:b]


def simulate_row_cycle_sharded(operands: FusedOperands, sharding=None,
                               backend: str = "auto",
                               b_chunk: int = transient.DEFAULT_B_CHUNK,
                               ) -> RowCycleResult:
    """Sharded twin of `transient.simulate_row_cycle_lowered`: the same
    lowered `FusedOperands` in, the same trace-free `RowCycleResult` out,
    the engine dispatch spread over the mesh's slots."""
    contracts.check_operands(operands,
                             where="shard.simulate_row_cycle_sharded")
    evt, _ = row_cycle_fused_sharded(operands, sharding, backend, b_chunk)
    return transient.result_from_events(operands, evt)


def sharded_sweep_columns(plan, sharding=None, backend: str = "auto",
                          b_chunk: int = transient.DEFAULT_B_CHUNK,
                          rows: tuple[int, int] | None = None) -> dict:
    """Scored columns of a planned sweep, computed slab by slab on the
    mesh -> dict of (B,) tensors on the plan's device.

    The sharded pipeline of `dse.sweep(space, sharding=...)`: pad the
    plan's operand batch to identical per-slot slabs, launch each slot's
    row cycle, score each slab's events on its slot with
    `dse.score_from_events`, and gather.  Returns the `dse.score_columns`
    dict, sliced to the plan's design-point count, ready for
    `dse.assemble_batch`.

    `rows=(lo, hi)` restricts the dispatch to the design-point slab
    [lo, hi) — the elastic re-slabbing unit (`launch.elastic`): a slab's
    columns are computed on whatever mesh the survivors form, and
    concatenating slab columns in order reproduces the full-range result
    bit for bit.  On replica spaces the operand rows are the interleaved
    [replica, main] pairs of the point range (every slab boundary is
    even, B_ALIGN being so).
    """
    from ..core import dse
    from ..core.space import SpaceView
    b_chunk = transient.validate_b_chunk(b_chunk)
    mesh = _as_mesh(sharding)
    operands = plan.operands
    contracts.check_operands(operands, where="shard.sharded_sweep_columns")
    factor = 2 if operands.replica else 1
    view = SpaceView.from_lowered(plan.sp)
    out = view.device
    cbl = plan.par.c_bl_total_ff
    sa_tau, overhead = operands.sa_tau_ns, operands.t_overhead_ns
    core = list(operands[:6])
    lo, hi = (0, len(view)) if rows is None else rows
    if not (0 <= lo <= hi <= len(view)):
        raise ValueError(f"rows={rows} outside the plan's design-point "
                         f"range [0, {len(view)})")
    if rows is not None:
        view = view.slice_rows(lo, hi)
        cbl = cbl[lo:hi]
        core = [x[factor * lo:factor * hi] for x in core]
        sa_tau = sa_tau[factor * lo:factor * hi]
        overhead = overhead[factor * lo:factor * hi]

    runs, target_ops = _slab_events(core, mesh, backend, b_chunk)
    target_pts = target_ops // factor
    slab_pts = target_pts // mesh.size
    sa_tau = put_global(_pad_rows(sa_tau, target_ops, 1.0), mesh)
    overhead = put_global(_pad_rows(overhead, target_ops, 0.0), mesh)
    cbl = put_global(_pad_rows(cbl, target_pts, 1.0), mesh)
    view = view.pad_to(target_pts)
    slot_cols = []
    for i, (g, dev) in enumerate(zip(mesh.local_slots, mesh.slots)):
        slab_view = view.slice_rows(g * slab_pts, (g + 1) * slab_pts).to(dev)
        slot_cols.append(dse.score_from_events(
            slab_view, cbl[i], sa_tau[i], overhead[i], runs[i][0]))
    return _gather_columns(slot_cols, mesh, out, hi - lo)


def sharded_pareto_dominated(hi, lo, cand, sharding=None,
                             block: int = 4096) -> torch.Tensor:
    """Sharded dominated-mask for `dse.pareto_mask` -> (B,) bool on the
    objectives' device.

    `hi` / `lo` are the stacked (B, K) maximize/minimize objective
    columns and `cand` the (B,) candidate mask.  The dominator axis is
    padded to identical per-slot slabs (padding rows carry cand=False,
    so they dominate nothing) and each slot tests its slab against the
    full batch in `block`-row sub-blocks (`dse.dominated_by`, the
    sequential loop's body); the slots' verdicts OR together (`|=` within
    a process, `all_reduce(MAX)` on uint8 across a group).  Dominance is
    comparisons and boolean algebra, with no rounding, and OR does not
    depend on order, so the mask is bit-identical to the sequential one.
    NaN objectives compare False in every direction, so NaN rows neither
    dominate nor get dominated.
    """
    from ..core import dse
    mesh = _as_mesh(sharding)
    out = hi.device
    b = int(hi.shape[0])
    total = -(-b // mesh.size) * mesh.size
    slabs = zip(put_global(_pad_rows(hi, total, 0.0), mesh),
                put_global(_pad_rows(lo, total, 0.0), mesh),
                put_global(_pad_rows(cand, total, False), mesh), mesh.slots)
    dominated = torch.zeros((b,), dtype=torch.bool, device=out)
    for hi_d, lo_d, cand_d, dev in slabs:
        dominated |= dse.dominated_by(hi_d, lo_d, cand_d, hi.to(dev),
                                      lo.to(dev), cand.to(dev),
                                      block).to(out)
    if mesh.group is not None:
        import torch.distributed as dist
        buf = dominated.to(torch.uint8).to(_collective_device(mesh, out))
        dist.all_reduce(buf, op=dist.ReduceOp.MAX, group=mesh.group)
        dominated = buf.to(out) != 0
    return dominated


def sharded_sweep(space=None, mesh=None, device="cuda", **sweep_kwargs):
    """`dse.sweep` over a mesh (every card of `device` by default):
    `sharded_sweep(space)` == `dse.sweep(space,
    sharding=make_sweep_mesh(), device="cuda")`."""
    from ..core import dse
    return dse.sweep(space, sharding=sweep_sharding(mesh, device),
                     device=device, **sweep_kwargs)


def batch_mismatches(a, b) -> list[str]:
    """The fields (and corners) in which two `DesignBatch`es differ, bit
    for bit: float32 compared as int32 views, so a NaN matches only the
    same NaN and -0.0 differs from 0.0."""
    from ..core.batch import ARRAY_FIELDS

    def same(x, y):
        if x.shape != y.shape or x.dtype != y.dtype:
            return False
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        return bool(torch.equal(x.cpu(), y.cpu()))

    if len(a) != len(b) or set(a.corners) != set(b.corners):
        return ["layout"]
    bad = [f for f in ARRAY_FIELDS if not same(getattr(a, f), getattr(b, f))]
    return bad + [f"corners[{k}]" for k in sorted(a.corners)
                  if not same(a.corners[k], b.corners[k])]


# ---------------------------------------------------------------------------
# Bit-equivalence smoke
# ---------------------------------------------------------------------------

def _equivalence_smoke(mc_samples: int = 16,
                       expect_devices: int | None = None,
                       device="cuda") -> None:
    from ..core import dse
    from ..core.space import DesignSpace

    dev = resolve_device(device)
    mesh = make_sweep_mesh(device=dev)
    n_dev = mesh.size
    if expect_devices is not None and n_dev != expect_devices:
        raise SystemExit(
            f"expected {expect_devices} devices but found {n_dev}; "
            "refusing to report an equivalence check on another mesh")

    def check(space, label):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        sharded = dse.sweep(space, sharding=mesh, device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        bad = batch_mismatches(sharded, dse.sweep(space, device=dev))
        if bad:
            raise SystemExit(f"sharded sweep NOT bit-identical on {label}: "
                             f"mismatched fields {bad}")
        print(f"{label}: {len(sharded)} points on {n_dev} {dev.type} "
              f"slot(s) in {dt:.2f}s — bit-identical to the single-device "
              "sweep")

    check(DesignSpace.paper_grid(), "paper grid")
    check(DesignSpace.paper_grid().with_mc(samples=mc_samples, key=0),
          f"paper grid x {mc_samples} MC samples")
    check(DesignSpace.paper_targets().with_replica()
          .with_mc(samples=mc_samples, key=0),
          f"replica-closed targets x {mc_samples} MC samples")
    print("shard smoke: OK")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="sharded-vs-single-device bit-equivalence smoke")
    parser.add_argument("--smoke", action="store_true",
                        help="sharded-vs-single-device bit-equivalence check")
    parser.add_argument("--mc", type=int, default=16,
                        help="MC samples for the smoke's with_mc sweeps")
    parser.add_argument("--expect-devices", type=int, default=None,
                        help="fail unless the mesh has exactly this many "
                             "slots")
    parser.add_argument("--device", default="cuda",
                        help="device of the mesh (default cuda: every card; "
                             "cpu: one CPU slot)")
    args = parser.parse_args(argv)
    if not args.smoke:
        parser.print_help()
        return 0
    _equivalence_smoke(mc_samples=args.mc,
                       expect_devices=args.expect_devices,
                       device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
