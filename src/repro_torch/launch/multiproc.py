"""Two-process `torch.distributed` integration smoke for the sweep fabric.

Port of `repro.launch.multiproc`.  `launch.shard`'s multi-process story
has three load-bearing claims:

  1. the DesignSpace lowering is deterministic, so every process
     assembles bit-identical operand batches on its own;
  2. `put_global` gives each rank the rows of its own slots, so an
     `all_gather` of every rank's padded operand slabs is the whole
     padded batch, bit for bit;
  3. per-row evaluation + scoring does not depend on the slab, so the
     rows a process computes are bit-identical to the same rows of a
     single-process sweep — which is what makes the union over
     processes THE sweep.

This module proves all three under a real process group: `run_smoke`
spawns the members through `launch.group.run_group` (a gloo group met
through a `file://` store in a fresh temporary directory, no port to
pick and race for).  Each member asserts claim 2 with an
`all_gather` of its operand slabs against its own lowering, claim 3 with
its point slab against the single-process oracle, and then runs the
cross-process dispatch itself, which gloo can do on the CPU:
`dse.sweep(space, sharding=<global mesh>)` (each rank its own slots, the
columns back by `all_gather`) and the sharded Pareto mask (`all_reduce`
MAX), both bit-identical to the oracle on every rank.

With `--device cuda` both members share the card (`cuda:0`; NCCL
refuses two ranks on one GPU, so the group stays gloo and its
collectives take host copies of finished results), and their spaces add
the 299,008-row Monte-Carlo grid.

CLI:  python -m repro_torch.launch.multiproc --smoke [--device cpu]
      ... --smoke --mc 16 --local-devices 4          (bigger variant)
"""

from __future__ import annotations

import argparse
import sys
import time

from ..device import resolve_device

__all__ = ["run_smoke"]

MC_FULL = 4096      # the 299,008-row grid of the card's run


def _spaces(mc: int, on_card: bool):
    from ..core.space import DesignSpace
    spaces = [
        ("targets", DesignSpace.paper_targets()),
        ("targets-mc", DesignSpace.paper_targets().with_mc(mc)),
        ("replica-mc", DesignSpace.paper_targets().with_replica().with_mc(mc)),
    ]
    if on_card:
        spaces.append((f"paper-grid-mc{MC_FULL}",
                       DesignSpace.paper_grid().with_mc(MC_FULL, key=0)))
    return spaces


def _bits(x):
    import torch
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _member(num_processes: int, mc: int, local_devices: int,
            device: str) -> dict:
    """One group member (run by `launch.group.run_group` once it has
    joined the gloo group): verify the sharded-sweep multi-process
    contract -> this rank's JSON-able record."""
    import torch.distributed as dist

    dev = resolve_device(device)
    rank = dist.get_rank()
    checks = _checks(dev, num_processes, rank, mc, local_devices)
    return {"process": rank, "ok": True, "world": num_processes,
            "device": str(dev), "global_slots": num_processes * local_devices,
            "local_slots": local_devices, "checks": checks}


def _checks(dev, num_processes: int, process_id: int, mc: int,
                  local_devices: int) -> dict:
    import torch
    import torch.distributed as dist

    from ..core import dse, transient
    from ..kernels.row_cycle import LAUNCHES
    from ..runtime import trace
    from . import shard
    from .mesh import SweepMesh

    if dist.get_world_size() != num_processes:
        raise SystemExit(f"world size {dist.get_world_size()} != "
                         f"{num_processes} — the group did not form")
    slots = (dev,) * local_devices
    gmesh = SweepMesh(slots, (num_processes * local_devices,), ("batch",),
                      dist.group.WORLD)
    lmesh = SweepMesh(slots, (local_devices,), ("batch",))

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    checks = {}
    for label, space in _spaces(mc, dev.type == "cuda"):
        plan = dse.plan_sweep(space, device=dev)
        # claims 1+2: every rank's slabs of its own padded operand batch,
        # gathered, are this rank's whole padded batch
        core = list(plan.operands[:6])
        b = core[0].shape[0]
        target = shard._dispatch_target(b, gmesh.size,
                                        transient.DEFAULT_B_CHUNK)
        for x in transient._pad_operands(core, target - b):
            gathered = shard._gather_rows(shard.put_global(x, gmesh), gmesh,
                                          dev)
            if not torch.equal(_bits(gathered), _bits(x)):
                raise SystemExit(
                    f"{label}: the gathered operand slabs differ from this "
                    "rank's own lowering — the ranks lowered differently "
                    "or put_global misplaced a slab")
        # claims 1+3: this process's point slab, computed here from its
        # own plan on its local slots, equals the oracle's rows
        oracle = dse.sweep(space, device=dev)
        n = len(plan.sp)
        lo = process_id * n // num_processes
        hi = (process_id + 1) * n // num_processes
        cols = shard.sharded_sweep_columns(plan, lmesh, rows=(lo, hi))
        bad = [k for k, v in cols.items()
               if not torch.equal(_bits(v), _bits(getattr(oracle, k)[lo:hi]))]
        if bad:
            raise SystemExit(f"{label}: slab [{lo}, {hi}) NOT bit-identical "
                             f"to the single-process sweep: {bad}")
        # the cross-process dispatch: every rank its own slots, the
        # columns gathered, equal to the oracle on every rank
        before = trace.totals().get(LAUNCHES, 0)
        sync()
        t0 = time.perf_counter()
        sharded = dse.sweep(space, sharding=gmesh, device=dev)
        sync()
        sweep_s = time.perf_counter() - t0
        launches = trace.totals().get(LAUNCHES, 0) - before
        bad = shard.batch_mismatches(sharded, oracle)
        if bad:
            raise SystemExit(f"{label}: the sweep over the {gmesh.size}-slot "
                             f"global mesh differs from the oracle: {bad}")
        if dev.type == "cuda" and launches != local_devices:
            raise SystemExit(f"{label}: {launches} row-cycle launches on "
                             f"this rank, expected {local_devices}")
        check = {"points": n, "rows": [lo, hi], "sweep_s": sweep_s,
                 "launches": launches}
        if len(oracle) <= 4096:       # the O(B^2) mask: the small spaces
            if not torch.equal(dse.pareto_mask(oracle, sharding=gmesh),
                               dse.pareto_mask(oracle)):
                raise SystemExit(f"{label}: the sharded Pareto mask over "
                                 "the global mesh differs")
            check["pareto"] = True
        checks[label] = check
    return checks


def run_smoke(num_processes: int = 2, mc: int = 8, local_devices: int = 2,
              device="cuda", timeout_s: float = 600.0) -> list[dict]:
    """Launch the group's members (`launch.group.run_group`) and verify
    their reports -> the members' JSON records."""
    from .group import run_group

    dev = resolve_device(device)
    t0 = time.perf_counter()
    results = run_group("repro_torch.launch.multiproc:_member", num_processes,
                        dict(num_processes=num_processes, mc=mc,
                             local_devices=local_devices, device=dev.type),
                        timeout_s=timeout_s)
    wall_s = time.perf_counter() - t0

    for r in results:
        if not r.get("ok"):
            raise SystemExit(f"multiproc smoke: process {r['process']} "
                             f"reported not-ok: {r}")
    # the per-process slabs must tile every space's full point range —
    # a smoke where both processes checked the same rows proves nothing
    for label in results[0]["checks"]:
        slabs = sorted(r["checks"][label]["rows"] for r in results)
        n = results[0]["checks"][label]["points"]
        covered = slabs[0][0] == 0 and slabs[-1][1] == n and all(
            a[1] == b[0] for a, b in zip(slabs, slabs[1:]))
        if not covered:
            raise SystemExit(f"multiproc smoke: slabs {slabs} do not tile "
                             f"[0, {n}) on {label}")
        print(f"{label}: {n} points tiled over {len(results)} processes "
              f"{slabs} — each slab and the sweep over the "
              f"{results[0]['global_slots']}-slot global mesh bit-identical "
              "to the single-process sweep")
    print(f"multiproc smoke: OK ({num_processes} processes x "
          f"{local_devices} slots on {dev.type}, gloo, file rendezvous, "
          f"{wall_s:.1f}s)")
    return results


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="two-process torch.distributed smoke of the sweep fabric")
    parser.add_argument("--smoke", action="store_true",
                        help="run the 2-process integration smoke (parent)")
    parser.add_argument("--num-processes", type=int, default=2)
    parser.add_argument("--mc", type=int, default=8,
                        help="MC samples for the with_mc spaces")
    parser.add_argument("--local-devices", type=int, default=2,
                        help="mesh slots per process")
    parser.add_argument("--device", default="cuda",
                        help="device of every slot (default cuda: the "
                             "processes share the card; cpu)")
    parser.add_argument("--timeout", type=float, default=600.0)
    args = parser.parse_args(argv)
    if args.smoke:
        run_smoke(num_processes=args.num_processes, mc=args.mc,
                  local_devices=args.local_devices, device=args.device,
                  timeout_s=args.timeout)
    else:
        parser.print_help()
    return 0


if __name__ == "__main__":
    sys.exit(main())
