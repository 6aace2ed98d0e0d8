"""Elastic sharded sweep: heartbeat-monitored slab dispatch + re-slabbing.

Port of `repro.launch.elastic`.  The sharded sweep (`launch.shard`)
assumes every slot lives for the whole dispatch.  This module makes the
sweep survive host loss instead: the design-point range is cut into
slabs, each slab is dispatched as one sharded columns call
(`shard.sharded_sweep_columns(..., rows=...)`) with completed slabs
checkpointed, and a `runtime.fault` stack supervises the loop —

  - `HeartbeatMonitor` (driven by a deterministic simulated clock, one
    simulated host per mesh slot) detects the dropped host;
  - `replan_mesh` re-derives the mesh plan for the survivors and the
    dispatch mesh is rebuilt over the surviving slots only (a new
    `SweepMesh`);
  - `FaultTolerantRunner` catches the failure, restores the last
    checkpoint and resumes from the first incomplete slab — only the
    in-flight slab's work is recomputed.

Per-row scoring does not depend on the slab or the mesh (the
`sharded_sweep_columns` contract), so the concatenated slab columns are
bit-identical to a fault-free `dse.sweep(space)` whatever mesh each slab
ended up on — the recovery path cannot change results, only cost.  That
cost is the deterministic `ElasticReport.resume_overhead_frac`
(recomputed / total points).

Failure injection (`runtime.fault.FailureInjector` schedule {slab: kind}):

    "drop:<host>"  the named simulated host stops heartbeating after the
                   slab's dispatch; detection -> re-slab -> resume
    "crash"        hard failure of the coordinator step (no mesh change)
    "nan"          poisons the step metrics' loss (runner restores)

`elastic_sweep` re-slabs within one process: a mesh that spans a process
group is refused (its survivors could not keep the same slot count on
every rank).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from ..core import transient
from ..device import resolve_device
from ..runtime.fault import (FailureInjector, FaultTolerantRunner,
                             HeartbeatMonitor, replan_mesh)
from .mesh import SweepMesh

__all__ = ["HostDropError", "ClusterLostError", "ElasticReport",
           "elastic_sweep"]


class HostDropError(RuntimeError):
    """A heartbeat-detected host loss mid-sweep (recoverable: the runner
    restores the last checkpoint onto the survivors' mesh)."""


class ClusterLostError(Exception):
    """Every simulated host is dead.  Deliberately NOT a RuntimeError:
    the runner's recovery path catches (RuntimeError, FloatingPointError)
    and would otherwise restore-and-retry a sweep with no slots left —
    this must propagate to the caller instead."""


@dataclass
class ElasticReport:
    """What the elastic run did — all integers deterministic for a given
    space + injection schedule, so the overhead fraction is benchmarkable."""
    n_slabs: int
    slab_points: int
    total_points: int
    restarts: int = 0
    recomputed_points: int = 0
    dropped_hosts: list = field(default_factory=list)
    device_history: list = field(default_factory=list)  # slots per slab run

    @property
    def resume_overhead_frac(self) -> float:
        """Recomputed work as a fraction of the sweep's useful work."""
        return self.recomputed_points / max(self.total_points, 1)


def elastic_sweep(space=None, mesh=None, *, slab_points: int | None = None,
                  injector: FailureInjector | None = None,
                  heartbeat_timeout_s: float = 10.0, backend: str = "auto",
                  b_chunk: int = transient.DEFAULT_B_CHUNK, device="cuda"):
    """Fault-tolerant sharded sweep -> (DesignBatch, ElasticReport).

    Equivalent to `dse.sweep(space, sharding=mesh, device=device)` — bit
    for bit, by the slab-independence contract — but dispatched slab by
    slab under heartbeat supervision, so an injected host drop re-slabs
    onto the survivors and resumes from the last completed slab instead
    of losing the sweep.  The plan is lowered and the batch assembled on
    `device`; `mesh` (a SweepMesh, default every card of `device`) says
    where the slabs run.

    `slab_points` is the checkpoint granularity in design points
    (default: four slabs); `injector` a `runtime.fault.FailureInjector`
    keyed by slab index (see the module docstring for kinds).
    """
    from ..core import dse
    from . import shard

    device = resolve_device(device)
    mesh = shard._as_mesh(mesh, device)
    if mesh.group is not None:
        raise ValueError("elastic_sweep re-slabs within one process; pass "
                         "a mesh without a process group")
    plan = dse.plan_sweep(space, device=device)
    n = len(plan.sp)
    if slab_points is None:
        slab_points = max(1, -(-n // 4))
    n_slabs = -(-n // slab_points)

    workers = [f"host{i}" for i in range(mesh.size)]
    slot_of = dict(zip(workers, mesh.slots))
    # deterministic simulated cluster clock: one tick per slab, a jump
    # past the timeout when a drop is injected — detection is exact and
    # reproducible, never wall-clock dependent
    clock = [0.0]
    monitor = HeartbeatMonitor(workers, timeout_s=heartbeat_timeout_s,
                               clock=lambda: clock[0])
    injector = injector or FailureInjector()
    report = ElasticReport(n_slabs=n_slabs, slab_points=slab_points,
                           total_points=n)
    ctx = {"mesh": mesh, "alive": list(workers)}

    def step_fn(state, step):
        lo = step * slab_points
        hi = min(n, lo + slab_points)
        clock[0] += 1.0
        for w in ctx["alive"]:
            monitor.beat(w)
        report.device_history.append(ctx["mesh"].size)
        cols = shard.sharded_sweep_columns(plan, ctx["mesh"], backend=backend,
                                           b_chunk=b_chunk, rows=(lo, hi))
        fault = injector.check(step)
        if fault is not None and fault.startswith("drop:"):
            lost = fault.split(":", 1)[1]
            if lost not in ctx["alive"]:
                raise ValueError(f"cannot drop unknown/dead host {lost!r}")
            # the host stops beating; everyone else keeps beating until
            # the timeout elapses, at which point the monitor flags it
            clock[0] += monitor.timeout + 1.0
            for w in ctx["alive"]:
                if w != lost:
                    monitor.beat(w)
            # earlier casualties stay dead in the monitor, so membership —
            # not equality — is the detection check
            if lost not in monitor.dead():
                raise RuntimeError(
                    f"heartbeat detection drift: {lost!r} should be dead, "
                    f"monitor says dead={monitor.dead()}")
            survivors = monitor.alive()
            if not survivors:
                raise ClusterLostError(
                    "all hosts lost — nothing to re-slab onto")
            plan_new = replan_mesh(len(survivors), model_parallel=1)
            ctx["alive"] = survivors[:plan_new.devices]
            ctx["mesh"] = SweepMesh(
                tuple(slot_of[w] for w in ctx["alive"]),
                (len(ctx["alive"]),), ("batch",))
            report.dropped_hosts.append(lost)
            # this slab's columns die with the exception: the restore
            # path recomputes exactly [lo, hi) on the survivors' mesh
            report.recomputed_points += hi - lo
            raise HostDropError(
                f"host {lost} missed heartbeat at slab {step}; re-slabbing "
                f"{mesh.size} -> {len(survivors)} slots")
        if fault == "crash":
            report.recomputed_points += hi - lo
            raise RuntimeError(f"injected crash at slab {step}")
        state = {"cols": {**state["cols"], step: cols}}
        metrics = {"slab": step, "points": hi - lo,
                   "devices": ctx["mesh"].size}
        if fault == "nan":
            report.recomputed_points += hi - lo
            metrics["loss"] = float("nan")
        return state, metrics

    checkpoint = [({"cols": {}}, 0)]

    def save_fn(step, state):
        checkpoint[0] = (state, step)

    def restore_fn():
        return checkpoint[0]

    runner = FaultTolerantRunner(step_fn, save_fn, restore_fn,
                                 injector=FailureInjector(), ckpt_every=1)
    state, _metrics = runner.run({"cols": {}}, n_slabs)
    report.restarts = runner.restarts

    cols_full = {k: torch.cat([state["cols"][i][k] for i in range(n_slabs)])
                 for k in state["cols"][0]}
    return dse.assemble_batch(plan.sp, cols_full), report
