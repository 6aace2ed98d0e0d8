"""Readings that set the comparison's limits, on the card, at a cell's own
size (not run by the benchmark's runs):

    python3 perfbench/control.py --workload <cell> --seeds 101,102,...
        [--control-seeds 201,202,203] [--seconds 3] [--out readings.json]

For each seed of `--seeds`, the program's timed path at the cell's load
(a `--seconds` window of the cell's mix and the answers it keeps; a
single sweeping client keeps one iteration's) held to the float32
reference: the sound runs' numbers, whose largest is a limit's lower
reading.  For each of `--control-seeds`,
the control in the program's place: the reference in bfloat16, the
nearest precision below the float32 the configuration states (its
row-cycle state machine computed in bfloat16, every scored column and MC
channel stored in bfloat16 before the reductions), in place of the
answers a window of that seed keeps, with its ops' answers (no Pareto
mask: the control has no front of its own to give), held to the same
float32 reference; the smallest of its numbers is a limit's upper
reading.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def in_bfloat16(cols: dict) -> dict:
    """Every float column (and MC channel) rounded to bfloat16."""
    import torch

    def r(v):
        if isinstance(v, torch.Tensor) and v.dtype.is_floating_point:
            return v.to(torch.bfloat16).to(v.dtype)
        return v

    out = {k: r(v) for k, v in cols.items()}
    out["corners"] = {k: r(v) for k, v in cols["corners"].items()}
    return out


def control_items(items: list, device) -> list:
    """The control's answers in place of the program's `items` (the same
    declarations and ops, shaped as kept program answers)."""
    import torch

    from .reference import score
    from .spaces import reference_space

    out = []
    for item in items:
        kw = item.get("sweep", {})
        cols = in_bfloat16(score.sweep(reference_space(item["decl"]), device,
                                       torch.bfloat16, **kw))
        outs = {op.name: op.control(cols) for op in item["ops"]}
        ops = [op for op in item["ops"] if outs[op.name] is not None]
        out.append({"decl": item["decl"], "sweep": kw, "batch": cols,
                    "ops": ops, "outs": outs})
    return out


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    import torch

    from . import check, harness
    from .probes import Probes

    spec = harness.cell_spec(harness.load_benchmark(), args.workload)
    dev = torch.device("cuda", 0)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    ctl_seeds = [int(s) for s in args.control_seeds.split(",") if s]
    loop = spec["mix"].make(spec["config"], seeds[0], dev, Probes(dev, False))
    loop.warm()
    out = {"cell": args.workload, "device": torch.cuda.get_device_name(dev),
           "program": {}, "control": {}}
    for who, todo in (("program", seeds), ("control", ctl_seeds)):
        for s in todo:
            t = time.perf_counter()
            loop.reseed(s)
            items = loop.window(args.seconds)["kept"]
            if who == "control":
                items = control_items(items, dev)
            out[who][s] = check.judge(items, dev)
            print(f"{who} seed {s}: {out[who][s]} "
                  f"({time.perf_counter() - t:.1f} s)", flush=True)
            del items
    loop.close()
    names = sorted(set().union(*out["program"].values()))
    out["lower"] = {k: max(v[k] for v in out["program"].values())
                    for k in names}
    if out["control"]:
        out["upper"] = {k: min(v.get(k, 0) for v in out["control"].values())
                        for k in names}
    print(json.dumps({k: out.get(k) for k in ("cell", "lower", "upper")}))
    if args.out:
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.path[:] = [str(ROOT / "src"), str(ROOT)] + [
        p for p in sys.path if Path(p or ".").resolve() != HERE]
    from perfbench.control import main as _main
    sys.exit(_main(sys.argv[1:]))
