"""Run one function in every member of a `torch.distributed` process group
spawned on this host.

`run_group("package.module:function", world, kwargs)` starts `world`
processes of `python -m repro_torch.launch.group`.  Each joins a gloo
group through a `file://` rendezvous in a fresh temporary directory (no
port to pick and race for), calls `function(**kwargs)`, prints the
JSON-able result as its last line and leaves the group.  The parent
returns the results in rank order, or raises with every failing member's
output; members still running at the timeout are killed.  The members
may share a card: NCCL refuses two ranks on one GPU, so a group that
shares one is a gloo group, whose collectives stage CUDA tensors through
the host (`distributed.collectives`).
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import subprocess
import sys
import tempfile
import time
from datetime import timedelta
from pathlib import Path

__all__ = ["run_group"]

_SRC_DIR = Path(__file__).resolve().parents[2]


def run_group(target: str, world: int, kwargs: dict | None = None,
              timeout_s: float = 300.0, pythonpath=()) -> list:
    """Spawn `world` gloo members running `target` ("module:function",
    importable with `pythonpath` added to the port's own path) with
    `kwargs` (JSON-able); returns their results in rank order."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(p) for p in (_SRC_DIR, *pythonpath)]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    t0 = time.perf_counter()
    results, failures = [None] * world, []
    with tempfile.TemporaryDirectory(prefix="group-") as tmp:
        argv = [sys.executable, "-m", "repro_torch.launch.group",
                "--init-file", str(Path(tmp) / "rendezvous"),
                "--world", str(world), "--target", target,
                "--kwargs", json.dumps(kwargs or {}),
                "--timeout", str(timeout_s)]
        procs = [subprocess.Popen(argv + ["--rank", str(r)], env=env,
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for r in range(world)]
        try:
            for r, p in enumerate(procs):
                left = max(1.0, timeout_s - (time.perf_counter() - t0))
                try:
                    out, err = p.communicate(timeout=left)
                except subprocess.TimeoutExpired:
                    failures.append(f"rank {r} timed out after "
                                    f"{timeout_s:.0f} s")
                    continue
                if p.returncode != 0:
                    failures.append(f"rank {r} rc={p.returncode}:\n"
                                    f"{out.strip()[-2000:]}\n"
                                    f"{err.strip()[-4000:]}")
                    continue
                lines = [ln for ln in out.splitlines() if ln.strip()]
                results[r] = json.loads(lines[-1])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    if failures:
        raise RuntimeError(f"process group running {target} failed:\n"
                           + "\n---\n".join(failures))
    return results


def _member(init_file: str, world: int, rank: int, target: str,
            kwargs: dict, timeout_s: float) -> None:
    import torch.distributed as dist

    module, _, name = target.partition(":")
    fn = getattr(importlib.import_module(module), name)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=world, rank=rank,
                            timeout=timedelta(seconds=timeout_s))
    try:
        result = fn(**kwargs)
    finally:
        dist.destroy_process_group()
    print(json.dumps(result), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--init-file", required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--target", required=True)
    ap.add_argument("--kwargs", default="{}")
    ap.add_argument("--timeout", type=float, default=300.0)
    args = ap.parse_args(argv)
    _member(args.init_file, args.world, args.rank, args.target,
            json.loads(args.kwargs), args.timeout)
    return 0


if __name__ == "__main__":
    sys.exit(main())
