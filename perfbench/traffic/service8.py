"""Clients of one warm co-design service, each sending the README's query
in a closed loop: `DSEService(window_ms=3.0)` with its background
dispatcher started, and `svc.query_yield(space, margin_mv=80.0)` on the
configuration's space (the README's `paper_grid().with_mc(samples=4096)`)
under a fresh MC key each time, as the request schema of `launch/serve.py`
leaves the key to the client.  The client reads each answer's yields.

Assumed (no source gives a team's size): `CLIENTS` clients.  With fresh
keys no query repeats, so the memo answers none; a window packs the
misses that arrived in it into one launch.
"""

import threading
import time

from perfbench.drive import Reservoir, decls, rng, run_clients
from perfbench.ops import McSummary
from perfbench.spaces import program_space

CLIENTS = 8
WINDOW_MS = 3.0
MARGIN_MV = 80.0
KEPT = 2           # answers of the window held to the reference


class ServiceLoop:
    sync_plan = False       # the dispatcher plans beside the clients

    def __init__(self, config, seed, device, probes):
        from repro_torch.serving.dse_service import DSEService

        self.config, self.seed = config, seed
        self.device, self.probes = device, probes
        self.ops = [McSummary(MARGIN_MV)]
        self.service = DSEService(window_ms=WINDOW_MS, device=device)
        self.service.start()

    def ask(self, decl):
        resp = self.service.query_yield(program_space(decl),
                                        margin_mv=MARGIN_MV)
        resp.summary.corners["yield_frac"].cpu()      # the client reads it
        return resp

    def warm(self) -> None:
        todo = decls(self.config["space"], rng(self.seed, "warm"))
        asks = [next(todo) for _ in range(CLIENTS)]
        run_clients(CLIENTS, lambda i: self.ask(asks[i]))
        self.service.memo_clear()

    def reseed(self, seed: int) -> None:
        self.seed = seed
        self.service.memo_clear()

    def window(self, seconds: float) -> dict:
        keep = Reservoir(KEPT, rng(self.seed, "sample"))
        lock = threading.Lock()
        done = {"rows": 0, "attempted": 0, "failed": 0, "lat": [],
                "errors": []}
        before = self.service.stats()
        t0 = time.perf_counter()

        def client(i: int) -> None:
            todo = decls(self.config["space"], rng(self.seed, "client", i))
            while time.perf_counter() - t0 < seconds:
                decl = next(todo)
                t = time.perf_counter()
                try:
                    with self.probes.host_span("query"):
                        resp = self.ask(decl)
                except Exception as e:       # counted; the run is not correct
                    with lock:
                        done["attempted"] += 1
                        done["failed"] += 1
                        done["errors"].append(repr(e))
                    continue
                ms = (time.perf_counter() - t) * 1e3
                with lock:
                    done["attempted"] += 1
                    done["rows"] += len(resp.batch)
                    done["lat"].append(ms)
                keep.offer({"decl": decl, "batch": resp.batch,
                            "outs": {"mc_summary": resp.summary},
                            "ops": self.ops})

        run_clients(CLIENTS, client)
        elapsed = time.perf_counter() - t0
        after = self.service.stats()
        counters = {
            "dispatches": after["dispatches"] - before["dispatches"],
            "windows": after["windows"] - before["windows"],
            "rows_dispatched": (after["rows"]["dispatched"]
                                - before["rows"]["dispatched"]),
            "memo_hits": after["memo"]["hits"] - before["memo"]["hits"],
            "memo_misses": (after["memo"]["misses"]
                            - before["memo"]["misses"])}
        return {"rows": done["rows"], "iterations": done["attempted"],
                "elapsed_s": elapsed, "attempted": done["attempted"],
                "failed": done["failed"], "errors": done["errors"],
                "kept": keep.items, "latencies_ms": done["lat"],
                "counters": counters}

    def close(self) -> None:
        self.service.stop()
        self.service.memo_clear()


def make(config, seed, device, probes):
    return ServiceLoop(config, seed, device, probes)
