"""Time the port's CUDA kernels at the main paths' shapes, on one GPU.

    python src/repro_torch/kernels/bench.py [--src DIR] [--seed 0]
                                            [--out times.json]

Times, with CUDA events after a warm-up:

- the fused row-cycle kernel on the Monte-Carlo sweep's operands
  (`paper_grid().with_mc(samples=4096, key=0)`, 299,008 rows): one
  2048-row chunk (16 blocks on 16 SMs, one warp per scheduler, so the time
  is the slowest warp's steps times the cycles of one step: reported as
  cycles a step at the SM clock nvidia-smi reads) and the whole batch in
  one launch;
- strap_attend at Qwen2-1.5B's decode shape (bf16, B = 8, 36 pages of 64
  tokens, 2 kv heads of 128, 12 query heads, 9 straps, 2,080 valid
  tokens), exact (all 9 straps) and gated (4), over 28 distinct caches in
  turn as the 28 layers of a decode step call it: CUDA events around the
  calls, and the device time of the kernels alone (torch.profiler), on
  the first 1, 2, 4 and 8 rows too.

It times the `repro_torch` under `--src` (by default the checkout it sits
in): with another checkout's `src` it times that checkout's kernels, so
two trees run in turns (A, B, B, A) on one card compare them.  The
compiler's register report of each kernel is printed beside the times.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

MC_SAMPLES = 4096
CHUNK = 2048
LAYERS = 28
STRAP_SHAPE = (8, 36, 64, 2, 128, 12, 4)   # (B, P, page, Hkv, D, Hq, G)
VALID_TOKENS = 2080


def cuda_ms(fn, repeats: int = 1, warmup: int = 0) -> tuple[float, object]:
    """Time per call of `fn` over `repeats` calls (CUDA events), after
    `warmup` untimed calls, and the last call's result."""
    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(repeats):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / repeats, out


def device_ms_by_kernel(fn, calls: int) -> dict:
    """Device time per call of each kernel one run of `fn` (`calls` calls)
    launches, by kernel name: torch.profiler's CUDA kernel times summed,
    after a warm-up.  Unlike `cuda_ms` it leaves out the card's idle time
    between launches when the host enqueues more slowly than the card
    runs."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name: dict = {}
    for e in prof.events():
        if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.self_device_time_total / 1e3 / calls)
    return by_name


def device_ms(fn, calls: int) -> float:
    """The device time per call of all the kernels `fn` launches."""
    return sum(device_ms_by_kernel(fn, calls).values())


def smi(query: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60,
                         check=True)
    return out.stdout.strip().splitlines()[0]


def row_steps(evt, params, dt, caps):
    """Implicit-Euler steps each row takes on these inputs (a phase's
    crossing step, or its window on a timeout; replica rows stop after ACT,
    inactive rows take none)."""
    def phase(t, cap):
        return torch.where(torch.isnan(t), float(cap), torch.round(t / dt))

    act = phase(evt[:, 0], caps[0])
    rest = phase(evt[:, 2], caps[1]) + phase(evt[:, 3], caps[2])
    role = params[:, 5] if params.shape[1] > 5 else torch.zeros_like(act)
    replica = (role - 1.0).abs() < 0.5
    return torch.where(params[:, 4] > 0.5,
                       act + torch.where(replica, 0.0, rest), 0.0)


def bench_row_cycle(dev) -> dict:
    from repro_torch.core import dse, transient
    from repro_torch.core.space import DesignSpace
    from repro_torch.kernels import row_cycle

    space = DesignSpace.paper_grid().with_mc(samples=MC_SAMPLES, key=0)
    plan = dse.plan_sweep(space, device=dev)
    ops_all = [x.contiguous() for x in plan.operands[:6]]
    b = ops_all[0].shape[0]
    pad = -(-b // CHUNK) * CHUNK - b
    ops_all = [x.contiguous() for x in transient._pad_operands(ops_all, pad)]
    chunk = [x[:CHUNK].contiguous() for x in ops_all]
    dt = transient.DT_NS
    caps = (transient.N_ACT_STEPS, transient.N_RESTORE_STEPS,
            transient.N_PRE_STEPS)
    kernel = row_cycle.row_cycle_fused_cuda
    evt, _ = kernel(*chunk, dt, *caps)
    chunk_ms = cuda_ms(lambda: kernel(*chunk, dt, *caps), 20, 1)[0]
    clock = float(smi("clocks.sm"))
    slowest = float(row_steps(evt, chunk[5], dt, caps).max().item())
    full_ms = cuda_ms(lambda: kernel(*ops_all, dt, *caps), 5, 1)[0]
    return {"rows": b, "padded_rows": b + pad, "chunk_rows": CHUNK,
            "chunk_ms": chunk_ms, "full_one_launch_ms": full_ms,
            "chunk_slowest_row_steps": slowest, "sm_clock_mhz": clock,
            "cycles_per_step": chunk_ms * 1e3 * clock / slowest}


def strap_caches(rng, dev):
    b, p, page, hkv, d, hq, g = STRAP_SHAPE
    caches = []
    for _ in range(LAYERS):
        k, v = (torch.as_tensor(rng.normal(size=(b, p, page, hkv, d)).astype(
            np.float32), device=dev).bfloat16() for _ in range(2))
        caches.append((k, v))
    q = torch.as_tensor(rng.normal(size=(b, hq, d)).astype(np.float32),
                        device=dev).bfloat16()
    lengths = torch.full((b,), VALID_TOKENS, dtype=torch.int32, device=dev)
    return q, caches, lengths


def bench_strap(dev, rng) -> dict:
    from repro_torch.kernels import strap_gather

    b, p, page, hkv, d, hq, g = STRAP_SHAPE
    q, caches, lengths = strap_caches(rng, dev)
    n_straps = p // g
    newest = (VALID_TOKENS - 1) // (g * page)
    exact = torch.arange(n_straps, dtype=torch.int32,
                         device=dev).expand(b, -1).contiguous()
    gated = torch.tensor([[newest, 0, 3, 5]] * b, dtype=torch.int32,
                         device=dev)
    kernel = strap_gather.strap_attend_cuda
    res = {}
    for label, ids in (("exact", exact), ("gated_top4", gated)):
        def run(ids=ids, rows=b):
            return [kernel(q[:rows], k[:rows], v[:rows], ids[:rows], g,
                           lengths=lengths[:rows]) for k, v in caches]

        res[f"{label}_ms"] = cuda_ms(run, 5, 1)[0] / LAYERS
        by_kernel = device_ms_by_kernel(run, LAYERS)
        res[f"{label}_device_ms"] = sum(by_kernel.values())
        res[f"{label}_device_ms_by_kernel"] = {
            name[:80]: ms for name, ms in by_kernel.items()}
        res[f"{label}_device_ms_by_rows"] = {
            r: device_ms(lambda r=r, run=run: run(rows=r), LAYERS)
            for r in (1, 2, 4, 8)}
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", type=Path,
                    default=Path(__file__).resolve().parents[2],
                    help="the src directory whose repro_torch is timed")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench: no CUDA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(args.src.resolve()))
    import repro_torch
    from repro_torch.kernels import build, row_cycle, strap_gather

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    libs = [mod.build() for mod in (row_cycle, strap_gather)]
    rec = {"package": str(Path(repro_torch.__file__).parent),
           "card": smi("name,power.limit"),
           "build_s": time.perf_counter() - t0}
    rec["row_cycle"] = bench_row_cycle(dev)
    rec["strap_attend"] = bench_strap(dev, np.random.default_rng(args.seed))
    rec["registers"] = {k: v for lib in libs
                        for k, v in build.ptxas_registers(lib).items()}
    line = json.dumps(rec)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line)
    print(line)
    return 0


if __name__ == "__main__":
    here = Path(__file__).resolve().parent
    if sys.path and Path(sys.path[0]).resolve() == here:
        sys.path.pop(0)          # the kernels directory is not a package root
    sys.exit(main())
