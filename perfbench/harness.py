"""One run of one cell: set-up, the measured window, the comparison and
the result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

Everything about a cell is found by name: its entry in `BENCHMARK.json`,
its configuration file, its traffic mix (`traffic/<name>.py`, whose
`make` builds the loop that drives the program, see `drive`, with the
comparison's limits beside it in `traffic/<name>.json`) and a reader for
each metric it reports (`metrics/<metric>.py`, or `metrics/<prefix>.py`
for every `<prefix>.<cells>` name that shares it: a `read(rec)` that
returns a number, or None where it finds nothing to read).  With
`--trace 0` the metrics are the cell's end-to-end metrics, with
`--trace 1` its per-layer ones, read from the spans of `probes` over the
window and from a `torch.profiler` trace of a few more seconds of the
same traffic after it (`devtrace`).
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import sys
import time
import traceback
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell_spec(bench: dict, name: str, root: Path = ROOT,
              folder: Path = HERE) -> dict:
    """The cell `name` with its configuration (a file named in `bench`,
    under `root`), its mix (the module `folder/traffic/<name>.py`) and
    the mix's limits (`folder/traffic/<name>.json`), and the metrics it
    reports untraced (`end_to_end`) and traced (`per_layer`)."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json "
                       f"(cells: {sorted(cells)})")
    cell = cells[name]
    config = next(c for c in bench["configs"] if c["name"] == cell["config"])
    mix = folder / "traffic" / cell["traffic"]

    def reported(metrics):
        return [m for m in metrics
                if "workloads" not in m or name in m["workloads"]]

    return {"cell": cell, "folder": folder,
            "config": json.loads((root / config["file"]).read_text()),
            "mix": _load(mix.with_suffix(".py"), "perfbench_mix"),
            "limits": json.loads(mix.with_suffix(".json").read_text())[
                "limits"],
            "end_to_end": reported(bench["end_to_end"]),
            "per_layer": reported(bench["per_layer"])}


def _load(path: Path, prefix: str):
    """The module of the file `path`, under a name of its own."""
    name = f"{prefix}_{path.stem.replace('.', '_').replace('-', '_')}"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str, folder: Path = HERE):
    """`read` of `folder/metrics/<metric>.py`, or of the file of the
    name's part before its first dot where the metric has none."""
    path = folder / "metrics" / f"{metric}.py"
    if not path.is_file():
        path = folder / "metrics" / f"{metric.split('.', 1)[0]}.py"
    return _load(path, "perfbench_metric").read


def forbidden_modules(modules=None) -> list:
    """Top-level names in `sys.modules` that the run must not load,
    compared whole (`repro_torch` is not `repro`)."""
    names = {m.split(".", 1)[0] for m in (modules or sys.modules)}
    return sorted(names & set(FORBIDDEN))


class Record:
    """What a run measured, for the metric readers."""

    def __init__(self, **kw):
        self.setup_s = None
        self.rows = self.iterations = 0
        self.elapsed_s = 0.0
        self.host_ms, self.device_ms, self.bound_s = {}, {}, {}
        self.latencies_ms, self.counters = [], {}
        self.busy_s = self.window_s = None
        self.__dict__.update(kw)


def run_cell(spec: dict, seed: int, seconds: float, traced: bool, device,
             t_start: float) -> dict:
    """Set up, measure, compare; returns the result line's fields and the
    numbers compared.  `device` is the card (or the CPU, in the tests)."""
    import torch

    from . import check, devtrace, roofline
    from .probes import Probes

    config = spec["config"]
    on_card = device.type == "cuda"
    kind = torch.cuda.get_device_name(device) if on_card else "cpu"
    probes = Probes(device, traced, roofline.peaks(kind))
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    loop = spec["mix"].make(config, seed, device, probes)
    loop.warm()
    probes.sync()
    setup_s = time.perf_counter() - t_start

    traced_sum = traced_done = None
    with probes.instrument(sync_plan=loop.sync_plan):
        done = loop.window(seconds)
        probes.sync()
        if traced:              # then profile more of the same traffic
            probes.timing = False
            with devtrace.Tracer(on_card) as tracer:
                traced_done = loop.window(devtrace.TRACE_S)
                probes.sync()
            traced_sum = tracer.summary()
            del tracer
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    probes.resolve()
    loop.close()

    rec = Record(setup_s=setup_s, rows=done["rows"],
                 iterations=done["iterations"], elapsed_s=done["elapsed_s"],
                 host_ms=dict(probes.host_ms),
                 device_ms=dict(probes.device_ms),
                 bound_s=dict(probes.bound_s),
                 latencies_ms=done["latencies_ms"],
                 counters=done["counters"])
    if traced_sum:
        rec.busy_s, rec.window_s = traced_sum["busy_s"], \
            traced_sum["window_s"]
    metrics = {}
    for m in spec["per_layer" if traced else "end_to_end"]:
        value = reader(m["name"], spec["folder"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    # the comparison runs once the program's state is freed
    kept = done.pop("kept")
    del loop
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    nums = check.judge(kept, device)
    ok, shown = check.verdict(nums, spec["limits"])
    ok = ok and done["failed"] == 0 and done["attempted"] > 0 and bool(kept)
    dev = {"platform": "gpu" if on_card else "cpu", "kind": kind,
           "count": 1, "memory_peak_bytes": int(peak)}
    if traced_sum:
        dev.update(busy_s=traced_sum["busy_s"],
                   window_s=traced_sum["window_s"])
    line = {"correct": ok, "attempted": done["attempted"],
            "failed": done["failed"], "metrics": metrics, "device": dev}
    if traced_sum:
        line["breakdown"] = {"device_ops": traced_sum["device_ops"],
                             "idle_gaps": traced_sum["idle_gaps"]}
    line["check"] = shown
    return {"line": line, "errors": done["errors"],
            "iter_ms": done.get("iter_ms", []),
            "traced_iter_ms": (traced_done or {}).get("iter_ms", []),
            "read_s": traced_sum["read_s"] if traced_sum else None}


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv, t_start: float) -> int:
    args = parse(argv)
    spec = cell_spec(load_benchmark(), args.workload)
    import torch

    chips = int(spec["cell"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: the cell needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    try:
        out = run_cell(spec, args.seed, args.seconds, bool(args.trace),
                       torch.device("cuda", 0), t_start)
    except Exception:
        traceback.print_exc()
        return 1
    found = forbidden_modules()
    if found:
        print(f"perfbench: the run loaded {found}", file=sys.stderr)
        return 3
    for err in out["errors"][:5]:
        print(f"perfbench: error in the window: {err}", file=sys.stderr)
    for what in ("iter_ms", "traced_iter_ms"):
        if out[what]:
            ms = sorted(out[what])
            print(f"perfbench: {what} {len(ms)} iterations, first "
                  f"{out[what][0]:.1f} ms, median {ms[len(ms) // 2]:.1f} "
                  f"ms, max {ms[-1]:.1f} ms", file=sys.stderr)
    if out["read_s"] is not None:
        print(f"perfbench: trace read back in {out['read_s']:.1f} s",
              file=sys.stderr)
    for name, v in out["line"]["check"].items():
        print(f"check {name} {v['value']} limit {v['limit']}",
              file=sys.stderr)
    print(json.dumps(out["line"]))
    return 0
