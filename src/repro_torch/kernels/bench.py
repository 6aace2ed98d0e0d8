"""Time the port's CUDA kernels at the main paths' shapes, on one GPU.

    python src/repro_torch/kernels/bench.py [--src DIR] [--seed 0]
                                            [--only row_cycle,phased,...]
                                            [--out times.json]

Times, with CUDA events after a warm-up:

- the fused row-cycle kernel on the Monte-Carlo sweep's operands
  (`paper_grid().with_mc(samples=4096, key=0)`, 299,008 rows): one
  2048-row chunk (16 blocks on 16 SMs, one warp per scheduler, so the time
  is the slowest warp's steps times the cycles of one step: reported as
  cycles a step at the SM clock nvidia-smi reads) and the whole batch in
  one launch;
- rc_multistep at the phased path's three calls (ACT / RESTORE / PRE,
  (800 / 1000 / 500, 1024, 6), SI sel_strap over layers 32..288), with
  cycles a step at the SM clock nvidia-smi reads (median of 3 runs of 20
  launches: a host stall inside one run shows as device idle); and the
  phased call itself (`simulate_row_cycle(..., traces=True)`, fixed and
  replica-timed): median of 7 by CUDA events, the card's idle share and
  kernel count under torch.profiler, and the host-device synchronizations
  it makes (`count_syncs`);
- with `--only rc_variants` (not run by default), the kept rc_multistep
  kernel against the variants in `csrc/rc_multistep_variants.cu` (of the
  checkout this script sits in) at the phased path's three calls, each
  first held bit for bit against the plain version, timed in rounds over
  all of them;
- the sweep's host plan (`dse.plan_sweep` of the 299,008-row Monte-Carlo
  space), median of 3, and its synchronizations;
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
import statistics
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
PHASED_B = 1024
KERNEL_RUNS = 3     # runs of 20 launches a kernel time is the median of
CALL_RUNS = 7       # runs (after a warm-up) a phased call time is the median of
VARIANT_ROUNDS = 7  # rounds over all kernels of the rc_multistep variant A/B
VARIANTS_SOURCE = Path(__file__).resolve().parent / "csrc" / \
    "rc_multistep_variants.cu"


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


def profile(fn, warmup: bool = True) -> dict:
    """One call of `fn` under torch.profiler, after a warm-up call unless
    `warmup` is False (a train step that already ran warm): host wall
    time, the device time of its kernels (self CUDA time summed over the
    trace), the idle share of the card over the call, and the kernels
    taking most time."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    if warmup:
        fn()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    device = [e for e in prof.events()
              if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in device) / 1e3
    by_name: dict = {}
    for e in device:
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.self_device_time_total / 1e3, n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
    strap = [v for k, v in by_name.items() if "strap_" in k]
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "idle_share": 1.0 - busy_ms / wall_ms if wall_ms else None,
            "device_kernels": len(device),
            "strap_attend_ms": sum(ms for ms, _ in strap),
            "strap_attend_kernels": sum(n for _, n in strap),
            "top": [[name[:60], ms, n] for name, (ms, n) in top]}


def count_syncs(fn) -> tuple[int, dict]:
    """Run `fn` once under a recording (`runtime.trace`, which sets
    `torch.cuda.set_sync_debug_mode("warn")`): the number of synchronizing
    CUDA calls it makes, and where (the innermost frame of the port for
    each, with its count)."""
    from repro_torch.runtime import trace

    torch.cuda.synchronize()
    with trace.record() as rec:
        fn()
    torch.cuda.synchronize()
    return rec.counters[trace.SYNCS], dict(rec.sync_sites)


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


def rc_adversarial_ladders(rng) -> dict:
    """RC ladders that reach the edges of rc_multistep's exact quotient
    form, by name -> (c, g_branch, g_clamp, v_clamp, v0, ramp) float32
    numpy arrays: capacitances and conductances spread over 1e-3..1e3;
    a zero state with zero clamps (every numerator zero); states of -0.0
    and values near 2^-100 with zero clamps (the guard's bounds); a ramp
    that falls to exactly zero (a zero access branch); N = 4, 6, 8 and
    batches off the 32-row block."""
    def lu(shape):
        return 10.0 ** rng.uniform(-3.0, 3.0, shape)

    def rising(t, tau):
        return 1.0 - np.exp(-(np.arange(t) + 1) * 0.02 / tau)

    tiny = np.array([-0.0, 0.0, 2.0 ** -100, -(2.0 ** -100), 2.0 ** -99,
                     2.0 ** -101, 1.5 * 2.0 ** -100, -(2.0 ** -126)])
    cases = {}
    for n, b in ((4, 257), (6, 1024), (8, 100)):
        cases[f"spread_N{n}"] = (lu((b, n)), lu((b, n - 1)), lu((b, n)),
                                 rng.uniform(-1, 1, (b, n)),
                                 rng.uniform(-1, 1, (b, n)), rising(300, 2.0))
        z = np.zeros((b, n))
        cases[f"tiny_N{n}"] = (rng.uniform(1, 5, (b, n)),
                               rng.uniform(0.05, 0.2, (b, n - 1)), z, z,
                               rng.choice(tiny, size=(b, n)), rising(100, 0.7))
    z = np.zeros((70, 6))
    cases["zero_N6"] = (rng.uniform(1, 5, (70, 6)),
                        rng.uniform(0.05, 0.2, (70, 5)), z, z, z,
                        rising(50, 0.7))
    # the falling WL ramp as the phased engine forms it in float32: 1 - x
    # rounds to exactly 0 once x rounds to 1
    x = rising(400, 0.05).astype(np.float32)
    cases["ramp_to_zero_N6"] = (rng.uniform(1, 5, (96, 6)),
                                rng.uniform(0.05, 0.2, (96, 5)),
                                rng.uniform(0.0, 0.3, (96, 6)),
                                rng.uniform(0.0, 1.1, (96, 6)),
                                rng.uniform(0.0, 1.1, (96, 6)),
                                np.float32(1.0) - x)
    return {k: tuple(np.ascontiguousarray(a, np.float32) for a in v)
            for k, v in cases.items()}


def bench_plan(dev) -> dict:
    """The host plan of the Monte-Carlo sweep (`dse.plan_sweep`, 299,008
    rows), median of 3 after a warm-up (host clock, synchronized), and
    the synchronizations one plan makes."""
    from repro_torch.core import dse
    from repro_torch.core.space import DesignSpace

    space = DesignSpace.paper_grid().with_mc(samples=MC_SAMPLES, key=0)
    runs = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dse.plan_sweep(space, device=dev)
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0) * 1e3)
    syncs, sites = count_syncs(lambda: dse.plan_sweep(space, device=dev))
    return {"plan_ms": statistics.median(runs[1:]), "runs_ms": runs[1:],
            "syncs": syncs, "sync_sites": sites}


def rc_kernel_timing(kernel, args, clock_mhz: float,
                     runs: int = KERNEL_RUNS) -> dict:
    """The time of an rc_multistep-shaped `kernel` at `args` (c, g_branch,
    g_clamp, v_clamp, v0, ramp, dt): the median of `runs` runs of 20
    launches after 2 warm-up launches (CUDA events; a host stall inside
    one run shows as device idle), and the cycles a step at `clock_mhz`."""
    runs_ms = [cuda_ms(lambda: kernel(*args), 20, 2)[0] for _ in range(runs)]
    ms = statistics.median(runs_ms)
    steps = int(args[5].shape[0])
    return {"ms": ms, "runs_ms": runs_ms,
            "cycles_per_step": ms * 1e3 * clock_mhz / steps}


def phased_rc_calls(dev) -> list:
    """The arguments of the rc_multistep calls (ACT, RESTORE, PRE) of one
    phased call at B = PHASED_B (SI sel_strap, layers 32..288)."""
    from repro_torch.core import calibration as cal
    from repro_torch.core import transient
    from repro_torch.kernels import ops

    layers = np.linspace(32, 288, PHASED_B).astype(np.float32)
    calls = []
    plain = ops.rc_multistep

    def record(*args, **kwargs):
        calls.append(args)
        return plain(*args, **kwargs)

    ops.rc_multistep = record
    try:
        transient.simulate_row_cycle(cal.get_tech("si"), "sel_strap", layers,
                                     traces=True, device=dev)
    finally:
        ops.rc_multistep = plain
    return calls


def bench_phased(dev) -> dict:
    """The phased call at B = PHASED_B (SI sel_strap, layers 32..288) and
    its three rc_multistep calls."""
    from repro_torch.core import calibration as cal
    from repro_torch.core import transient
    from repro_torch.kernels import rc_transient

    si = cal.get_tech("si")
    layers = np.linspace(32, 288, PHASED_B).astype(np.float32)
    calls = phased_rc_calls(dev)
    kernel = rc_transient.rc_multistep_cuda
    clock = float(smi("clocks.sm"))
    chain_ops = getattr(rc_transient, "chain_ops", None)   # absent before
    res = {"sm_clock_mhz": clock,
           "chain_ops": chain_ops(6) if chain_ops else None}
    for name, args in zip(("act", "restore", "pre"), calls):
        timing = rc_kernel_timing(kernel, args, clock)
        res[f"{name}_kernel_ms"] = timing["ms"]
        res[f"{name}_kernel_runs_ms"] = timing["runs_ms"]
        res[f"{name}_shape"] = [int(args[5].shape[0]), *args[0].shape]
        res[f"{name}_cycles_per_step"] = timing["cycles_per_step"]
    for mode, replica in (("fixed", False), ("replica", True)):
        def call(replica=replica):
            return transient.simulate_row_cycle(
                si, "sel_strap", layers, traces=True, replica=replica,
                device=dev)

        runs = [cuda_ms(call)[0] for _ in range(CALL_RUNS + 1)][1:]
        res[f"{mode}_ms"] = statistics.median(runs)
        res[f"{mode}_runs_ms"] = runs
        prof = profile(call)
        res[f"{mode}_idle_share"] = prof["idle_share"]
        res[f"{mode}_device_kernels"] = prof["device_kernels"]
        res[f"{mode}_device_busy_ms"] = prof["device_busy_ms"]
        res[f"{mode}_syncs"], res[f"{mode}_sync_sites"] = count_syncs(call)
    return res


def rc_variant_kernels() -> dict:
    """The kernels of `csrc/rc_multistep_variants.cu`, by the names the
    library gives them, each as a function of rc_multistep_cuda's
    arguments that returns the trace."""
    import ctypes

    from repro_torch.kernels import build, rc_transient

    lib = build.load(VARIANTS_SOURCE, "rc_variant_launch",
                     [ctypes.c_int] + rc_transient._ARGTYPES)
    name_of = lib.rc_variant_name
    name_of.argtypes, name_of.restype = [ctypes.c_int], ctypes.c_char_p

    def kernel(v):
        def run(c, g_branch, g_clamp, v_clamp, v0, ramp, dt):
            (b, n), t = c.shape, ramp.shape[0]
            trace = torch.empty((t, b, n), dtype=torch.float32,
                                device=c.device)
            err = lib.rc_variant_launch(
                v, c.data_ptr(), g_branch.data_ptr(), g_clamp.data_ptr(),
                v_clamp.data_ptr(), v0.data_ptr(), ramp.data_ptr(),
                trace.data_ptr(), b, n, t, float(dt),
                torch.cuda.current_stream(c.device).cuda_stream)
            if err:
                raise RuntimeError(f"rc variant {v} launch failed: CUDA "
                                   f"error {err}")
            return trace
        return run

    kernels, v = {}, 0
    while (name := name_of(v)) is not None:
        kernels[name.decode()] = kernel(v)
        v += 1
    return kernels


def bench_rc_variants(dev, rng) -> dict:
    """The kept rc_multistep kernel against the variants of
    `csrc/rc_multistep_variants.cu` at the phased path's three calls.
    Each is first held bit for bit (int32 views) against the plain version
    there and on the N = 6 adversarial ladders, then timed in
    VARIANT_ROUNDS rounds over all kernels (the order reversed every other
    round), a round being one run of 20 launches after 2 warm-ups: median,
    runs and cycles a step of each call, by kernel."""
    from repro_torch.kernels import rc_transient, ref

    kernels = {"kept": rc_transient.rc_multistep_cuda, **rc_variant_kernels()}
    cases = {name: args for name, args in zip(("act", "restore", "pre"),
                                              phased_rc_calls(dev))}
    dt = cases["act"][6]
    for name, host in rc_adversarial_ladders(rng).items():
        if name.endswith("N6"):
            cases[name] = (*(torch.as_tensor(x, device=dev) for x in host),
                           dt)
    res: dict = {name: {"bit_identical": True} for name in kernels}
    for case, args in cases.items():
        want = ref.rc_multistep_ref(*args).view(torch.int32)
        for name, kernel in kernels.items():
            got = kernel(*args).view(torch.int32)
            if not torch.equal(got, want):
                res[name]["bit_identical"] = False
                res[name].setdefault("differs_on", []).append(case)
    clock = float(smi("clocks.sm"))
    res["sm_clock_mhz"] = clock
    names = list(kernels)
    for call in ("act", "restore", "pre"):
        runs = {name: [] for name in names}
        for r in range(VARIANT_ROUNDS):
            for name in names if r % 2 == 0 else names[::-1]:
                runs[name] += rc_kernel_timing(kernels[name], cases[call],
                                               clock, runs=1)["runs_ms"]
        steps = int(cases[call][5].shape[0])
        for name in names:
            ms = statistics.median(runs[name])
            res[name][f"{call}_ms"] = ms
            res[name][f"{call}_runs_ms"] = runs[name]
            res[name][f"{call}_cycles_per_step"] = ms * 1e3 * clock / steps
    return res


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
    ap.add_argument("--only", default="row_cycle,phased,plan,strap_attend",
                    help="comma-separated benches to run")
    args = ap.parse_args(argv)
    only = set(args.only.split(","))
    if not torch.cuda.is_available():
        print("bench: no CUDA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(args.src.resolve()))
    import repro_torch
    from repro_torch.kernels import build, rc_transient, row_cycle, strap_gather

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    libs = [mod.build() for mod in (row_cycle, rc_transient, strap_gather)]
    rec = {"package": str(Path(repro_torch.__file__).parent),
           "card": smi("name,power.limit"),
           "build_s": time.perf_counter() - t0}
    benches = {"row_cycle": lambda: bench_row_cycle(dev),
               "phased": lambda: bench_phased(dev),
               "plan": lambda: bench_plan(dev),
               "rc_variants": lambda: bench_rc_variants(
                   dev, np.random.default_rng(args.seed)),
               "strap_attend": lambda: bench_strap(
                   dev, np.random.default_rng(args.seed))}
    for name, fn in benches.items():
        if name in only:
            rec[name] = fn()
    if "rc_variants" in only:
        libs.append(build.build(VARIANTS_SOURCE))
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
