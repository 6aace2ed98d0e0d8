"""Fault-tolerance runtime: heartbeats, failure injection, straggler
mitigation, elastic re-meshing.

Port of `repro.runtime.fault`, with the same semantics; it touches no
tensor, so it is plain Python.  The cluster is simulated while the
*mechanisms* are real and unit-tested:

  - HeartbeatMonitor: workers report liveness; detection by timeout.
  - FailureInjector: deterministic fault schedule for tests and the
    elastic sweep (`launch.elastic`).
  - StragglerPolicy: bounded-wait gradient buckets — proceed with the
    fastest (1 - drop_fraction) workers, rescaling the gradient mean
    (the classic backup-worker trick).
  - ElasticPlan: given surviving device count, re-derive the largest valid
    (data, model) mesh and signal a checkpoint-restore onto it.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field


class HeartbeatMonitor:
    def __init__(self, workers: list[str], timeout_s: float = 10.0,
                 clock=time.monotonic):
        self.timeout = timeout_s
        self.clock = clock
        self.last_seen = {w: clock() for w in workers}

    def beat(self, worker: str, at: float | None = None):
        self.last_seen[worker] = self.clock() if at is None else at

    def dead(self, now: float | None = None) -> list[str]:
        now = self.clock() if now is None else now
        return [w for w, t in self.last_seen.items()
                if now - t > self.timeout]

    def alive(self, now: float | None = None) -> list[str]:
        dead = set(self.dead(now))
        return [w for w in self.last_seen if w not in dead]


@dataclass
class FailureInjector:
    """Deterministic schedule: {step: kind} with kind in
    {"crash", "nan", "slow:<worker>", "drop:<worker>"}.

    `FaultTolerantRunner` interprets "crash"/"nan" itself; other kinds
    are consumer-defined — the elastic sweep (`launch.elastic`)
    keys its schedule by slab index and reads "drop:<host>" as that
    simulated host ceasing to heartbeat after the slab's dispatch."""
    schedule: dict[int, str] = field(default_factory=dict)
    fired: set = field(default_factory=set)

    def check(self, step: int) -> str | None:
        if step in self.schedule and step not in self.fired:
            self.fired.add(step)
            return self.schedule[step]
        return None


@dataclass
class StragglerPolicy:
    """Bounded-wait gradient buckets.

    Given per-worker step durations, wait only until `quorum_fraction` of
    workers have reported or `deadline_factor` x median has elapsed; late
    gradients are dropped and the mean rescaled by n/actual.
    """
    quorum_fraction: float = 0.9375   # 15/16: tolerate 1 straggler per 16
    deadline_factor: float = 2.0

    def admit(self, durations: dict[str, float]) -> tuple[list[str], float]:
        if not durations:
            return [], 0.0
        items = sorted(durations.items(), key=lambda kv: kv[1])
        n = len(items)
        quorum = max(1, math.ceil(self.quorum_fraction * n))
        med = items[n // 2][1]
        deadline = self.deadline_factor * med
        admitted = [w for i, (w, t) in enumerate(items)
                    if i < quorum or t <= deadline]
        rescale = n / len(admitted)
        return admitted, rescale


@dataclass(frozen=True)
class ElasticPlan:
    data: int
    model: int

    @property
    def devices(self) -> int:
        return self.data * self.model


def replan_mesh(surviving_devices: int, model_parallel: int = 16,
                min_data: int = 1) -> ElasticPlan:
    """Largest (data, model) grid fitting the survivors: model parallelism
    is kept (param shards must stay complete); data shrinks to the largest
    whole multiple."""
    if surviving_devices < model_parallel:
        # degrade model parallelism to the largest power-of-two that fits
        mp = 1 << (surviving_devices.bit_length() - 1)
        return ElasticPlan(data=surviving_devices // mp, model=mp)
    data = max(min_data, surviving_devices // model_parallel)
    return ElasticPlan(data=data, model=model_parallel)


class FaultTolerantRunner:
    """Drives a step function with checkpoint/restart + failure simulation.

    step_fn(state, step) -> (state, metrics); save_fn(step, state);
    restore_fn() -> (state, step).  The elastic sweep drives its slabs
    through it; tested with injected crash/nan faults.
    """

    def __init__(self, step_fn, save_fn, restore_fn, injector=None,
                 ckpt_every: int = 50):
        self.step_fn = step_fn
        self.save_fn = save_fn
        self.restore_fn = restore_fn
        self.injector = injector or FailureInjector()
        self.ckpt_every = ckpt_every
        self.restarts = 0

    def run(self, state, n_steps: int, start_step: int = 0):
        step = start_step
        metrics_log = []
        while step < n_steps:
            fault = self.injector.check(step)
            try:
                if fault == "crash":
                    raise RuntimeError(f"injected crash at step {step}")
                state, metrics = self.step_fn(state, step)
                if fault == "nan":
                    metrics = dict(metrics, loss=float("nan"))
                loss = metrics.get("loss")
                if loss is not None and not math.isfinite(float(loss)):
                    raise FloatingPointError(f"non-finite loss at {step}")
                metrics_log.append(dict(metrics, step=step))
                step += 1
                if step % self.ckpt_every == 0:
                    self.save_fn(step, state)
            except (RuntimeError, FloatingPointError):
                self.restarts += 1
                state, step = self.restore_fn()
        return state, metrics_log
