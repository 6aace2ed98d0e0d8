"""What the traffic mixes are built from: seeded draws, the sample of
answers kept for the comparison, client threads, and the closed loop of
one client sweeping a space.

A mix (`traffic/<name>.py`) has `make(config, seed, device, probes)`,
which returns its loop: `warm()` (set-up: every shape the window uses),
`window(seconds)` (whole iterations or queries until `seconds` have
passed; returns what it did and the answers it kept), `reseed(seed)`
(the same loop on another seed's inputs, for the limits' readings) and
`close()`; with `sync_plan` true the traced run synchronizes around the
plan (a single client's loop, where nothing else runs beside it).
Nothing of the program is imported before a loop is built.
"""

from __future__ import annotations

import threading
import time

import numpy as np

from .spaces import program_space, with_key

STREAMS = {"warm": 0, "window": 1, "client": 3, "sample": 4}
KEY_RANGE = 1 << 62
JOIN_S = 600.0     # how long a run waits for a client thread to end


def rng(seed: int, stream: str, *more: int) -> np.random.Generator:
    """The generator of one purpose's draws; any whole `seed` works.
    Streams are split by purpose, so the window's inputs do not depend on
    the warm-up's."""
    return np.random.default_rng([seed % (1 << 64), STREAMS[stream], *more])


def decls(space: list, gen: np.random.Generator):
    """Endless declarations of `space`, each with a fresh Monte-Carlo key
    from `gen`, as a user's repeated studies draw them."""
    while True:
        yield with_key(space, int(gen.integers(KEY_RANGE)))


class Reservoir:
    """A uniform sample of `size` items from a stream of unknown length,
    drawn from a seeded generator (thread-safe)."""

    def __init__(self, size: int, gen: np.random.Generator):
        self.size, self.gen = size, gen
        self.items, self.seen = [], 0
        self.lock = threading.Lock()

    def offer(self, item) -> None:
        with self.lock:
            self.seen += 1
            if len(self.items) < self.size:
                self.items.append(item)
            else:
                j = int(self.gen.integers(self.seen))
                if j < self.size:
                    self.items[j] = item


def run_clients(n: int, body) -> None:
    """Run `body(i)` on n client threads; re-raise the first error."""
    errors = []

    def run(i):
        try:
            body(i)
        except BaseException as e:       # re-raised below, in the caller
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,), daemon=True)
               for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(JOIN_S)
        if t.is_alive():
            raise TimeoutError("a benchmark client did not finish")
    if errors:
        raise errors[0]


class SweepLoop:
    """One client: `dse.sweep` of the configuration's space (with its
    `sweep` keyword arguments) under a fresh MC key, then each of `ops`
    on the batch, then a synchronize (the client reads its answer).  Its
    set-up runs `warm` iterations: the host's first iterations run slower
    than the rest."""

    sync_plan = True

    def __init__(self, config: dict, seed: int, device, probes, ops,
                 warm: int = 1):
        self.config, self.seed, self.warm_iterations = config, seed, warm
        self.device, self.probes = device, probes
        self.ops = list(ops)
        self.sweep_kw = dict(config.get("sweep", {}))

    def one(self, decl: list):
        from repro_torch.core import dse

        batch = dse.sweep(program_space(decl), device=self.device,
                          **self.sweep_kw)
        outs = {op.name: op.run(batch, self.probes) for op in self.ops}
        self.probes.sync()
        return batch, outs

    def warm(self) -> None:
        todo = decls(self.config["space"], rng(self.seed, "warm"))
        for _ in range(self.warm_iterations):
            self.one(next(todo))

    def reseed(self, seed: int) -> None:
        self.seed = seed

    def window(self, seconds: float) -> dict:
        todo = decls(self.config["space"], rng(self.seed, "window"))
        kept = Reservoir(1, rng(self.seed, "sample"))
        rows = iterations = failed = 0
        errors, iter_ms = [], []
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            decl = next(todo)
            iterations += 1
            t = time.perf_counter()
            try:
                with self.probes.host_span("iteration"):
                    batch, outs = self.one(decl)
            except Exception as e:           # counted; the run is not correct
                failed += 1
                errors.append(repr(e))
                continue
            iter_ms.append((time.perf_counter() - t) * 1e3)
            rows += len(batch)
            kept.offer({"decl": decl, "sweep": self.sweep_kw,
                        "batch": batch, "outs": outs, "ops": self.ops})
        elapsed = time.perf_counter() - t0
        return {"rows": rows, "iterations": iterations, "elapsed_s": elapsed,
                "attempted": iterations, "failed": failed, "errors": errors,
                "kept": kept.items, "latencies_ms": [], "counters": {},
                "iter_ms": iter_ms}

    def close(self) -> None:
        pass
