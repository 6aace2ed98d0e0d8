"""Run benchmark cells with the program's recording open
(`repro_torch.runtime.trace`) and report what it sees, on one card:

    python3 tools/trace_cells.py --cells grid-mc4096.sweep,targets-tail.sweep \\
        --seed 7 --seconds 8 [--out FILE]

For each cell, after the cell's own set-up (`perfbench`, its traffic mix
and seed), under the benchmark's probes as in a traced run's window:

- one window of `--seconds` with the recording open: each span's total
  and self milliseconds an iteration, the counters an iteration in total
  and by span, and the synchronizations' sites, beside the probes' own
  spans (`plan_sweep`, `score`, ...);
- `perfbench.devtrace.TRACE_S` profiled seconds with the recording open
  under the range prefix "perfbench.", so the idle-gap breakdown names
  the program's spans as it names the benchmark's.

The process is set up as `perfbench/run.py` sets up a run (one thread a
host library, glibc's allocator pinned).  The whole report goes to
`--out` as JSON; a summary a cell to standard output.  The tool stands in
until the benchmark's traced run opens the recording itself.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import perfbench.run  # noqa: E402,F401  (the run's process set-up)


def _take(probes) -> dict:
    """The probes' spans since the last take (device events resolved)."""
    probes.resolve()
    out = {"host_ms": {k: list(v) for k, v in probes.host_ms.items()},
           "device_ms": {k: list(v) for k, v in probes.device_ms.items()}}
    probes.host_ms.clear()
    probes.device_ms.clear()
    probes.bound_s.clear()
    return out


def _per_iteration(summary: dict, iterations: int) -> dict:
    spans = {k: {"calls": v["calls"] / iterations,
                 "total_ms": v["total_ms"] / iterations,
                 "self_ms": v["self_ms"] / iterations}
             for k, v in summary["spans"].items()}
    per = lambda d: {k: v / iterations for k, v in d.items()}
    return {"spans": spans, "counters": per(summary["counters"]),
            "by_span": {k: per(v) for k, v in summary["by_span"].items()},
            "sync_sites": per(summary["sync_sites"])}


def measure(cell: str, seed: int, seconds: float, device) -> dict:
    import torch

    from perfbench import devtrace, harness, roofline
    from perfbench.probes import Probes
    from repro_torch.runtime import trace

    spec = harness.cell_spec(harness.load_benchmark(), cell)
    on_card = device.type == "cuda"
    kind = torch.cuda.get_device_name(device) if on_card else "cpu"
    probes = Probes(device, True, roofline.peaks(kind))
    t0 = time.perf_counter()
    loop = spec["mix"].make(spec["config"], seed, device, probes)
    loop.warm()
    probes.sync()
    report = {"cell": cell, "seed": seed, "seconds": seconds, "card": kind,
              "setup_s": time.perf_counter() - t0}
    with probes.instrument(sync_plan=loop.sync_plan):
        with trace.record(range_prefix="perfbench.") as rec:
            done = loop.window(seconds)
            probes.sync()
        spans = _take(probes)
        window = {"iterations": done["iterations"], "failed": done["failed"],
                  "iter_ms_median": statistics.median(done["iter_ms"]),
                  "probes_ms": {k: statistics.fmean(v) for k, v in
                                spans["host_ms"].items() if k != "iteration"},
                  "per_iteration": _per_iteration(rec.summary(),
                                                  done["iterations"])}
        window["probes_ms"].update(
            {f"{k} (device)": statistics.fmean(v)
             for k, v in spans["device_ms"].items()})
        report["window"] = window
        probes.timing = False
        with trace.record(range_prefix="perfbench.") as rec, \
                devtrace.Tracer(on_card) as tracer:
            done = loop.window(devtrace.TRACE_S)
            probes.sync()
        report["profiled"] = tracer.summary()
        report["profiled"]["iterations"] = done["iterations"]
        report["profiled"]["per_iteration"] = _per_iteration(
            rec.summary(), done["iterations"])
    loop.close()
    return report


def summary_lines(rep: dict) -> list:
    w = rep["window"]
    lines = [f"{rep['cell']}: {w['iterations']} iterations, median "
             f"{w['iter_ms_median']:.3f} ms, recording"]
    per = w["per_iteration"]
    spans = sorted(per["spans"].items(), key=lambda kv: -kv[1]["total_ms"])
    lines.append("  spans a iteration (total / self ms): " + ", ".join(
        f"{k} {v['total_ms']:.3f}/{v['self_ms']:.3f}" for k, v in spans))
    lines.append(f"  counters a iteration: {per['counters']}")
    lines.append(f"  by span: {per['by_span']}")
    lines.append(f"  sync sites: {per['sync_sites']}")
    lines.append(f"  probes: {w['probes_ms']}")
    prof = rep["profiled"]
    lines.append(f"  profiled: busy {prof['busy_s']:.4f} of "
                 f"{prof['window_s']:.4f} s; idle gaps {prof['idle_gaps']}")
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cells", required=True,
                    help="comma-separated cell names of BENCHMARK.json")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("trace_cells: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    out = {"cells": []}
    for cell in args.cells.split(","):
        rep = measure(cell, args.seed, args.seconds, dev)
        out["cells"].append(rep)
        print("\n".join(summary_lines(rep)), flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
