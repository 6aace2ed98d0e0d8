#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU, end to end.

    python3 chip_smoke.py [--seed 0] [--out results.json]

Phases (any failure exits non-zero and prints no result line):

1. the card's name and power limit (nvidia-smi);
2. build both CUDA kernels (row_cycle.cu, rc_multistep.cu) from
   src/repro_torch/kernels/csrc/ with nvcc into build/, in parallel;
3. hold the row-cycle kernel (backend="cuda") against its plain PyTorch
   version (backend="ref") on the card: N = 4, 6, 8, replica pairs,
   padding rows, timed-out rows, legacy (B, 5) params, B = 2048 and the
   full 299,008-row Monte-Carlo operand batch;
4. the main path: `dse.sweep(DesignSpace.paper_grid())` on the card, with
   the kernel's launch count read around it, the paper's goldens, the same
   sweep through the plain version, and the replica-timed sweep;
5. the sized run: `paper_grid().with_mc(samples=4096, key=0)` (299,008
   design rows, the `--mc-tail` default of examples/dram_codesign.py),
   timed per phase (plan, kernel, score, pareto) at b_chunk=2048 and at
   b_chunk=299008, median of 3 after a warm-up;
6. the rc_multistep kernel against its plain version on random ladders
   (N = 4, 6, 8, ragged B, clamp network and ramp);
7. the phased engine (`simulate_row_cycle(..., traces=True)`, the Fig. 8
   waveforms) at B = 1024 (SI sel_strap, layers 32..288), fixed and
   replica-timed, with rc_multistep's launch count read around it, the
   kernel held against its plain version at the path's own shapes, the
   path through the kernel vs through the plain version, fused vs phased,
   the Fig. 8 goldens, the full paper grid, and the B = 1024 call timed;
8. the MC reductions (yield_fraction, quantile, ess, mc_summary) on the
   299,008-row batch of phase 5 and yield_ppm on a 4096-sample tail sweep,
   timed and held against the same reductions on the CPU;
9. every `report.*` table at its default arguments on the card, with the
   Table-I goldens, each timed;
10. one JSON line listing the ported kernels, then the card line, then the
   result line {"ok": true, "device": {...}}.

It imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

MC_SAMPLES = 4096
REPEATS = 3
PHASED_B = 1024                 # benchmarks/bench_fused_row_cycle.py's batch
TAIL_SAMPLES = 4096             # report.mc_tail_yield_table's default
RC_RTOL, RC_ATOL = 1e-5, 1e-6   # tests/test_kernels.py's rc_multistep bar
REGEN_SLACK_NS = 0.05           # tests/test_fused_row_cycle.py's analog slack
F32_PEAK_OPS = 67e12            # H100 SXM float32 (non-tensor) peak, data sheet
HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3 bandwidth, data sheet


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def rel(a: float, b: float) -> float:
    return abs(a - b) / abs(b)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    lines = [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]
    check(lines, "nvidia-smi printed no card")
    return lines[0]


# --------------------------------------------------------------------------
# kernel vs plain version
# --------------------------------------------------------------------------

def random_operands(rng, b, n, *, replica, legacy=False):
    """Random ladders (the generator of tests/test_kernels.py) with padding
    rows at the end, one starved (timed-out) row and, optionally, the first
    half as [replica, main] pairs."""
    import numpy as np

    c = rng.uniform(1, 5, (b, n))
    g = rng.uniform(0.05, 0.2, (b, n - 1))
    gc_res = np.zeros((b, n))
    gc_res[:, 0] = 0.125
    gc_pre = np.zeros((b, n))
    gc_pre[:, :n - 1] = 0.125
    v0 = np.full((b, n), 0.55)
    v0[:, n - 1] = 1.0
    params = np.stack([rng.uniform(0.5, 4.0, b), rng.uniform(0.005, 0.05, b),
                       np.full(b, 1.1), np.full(b, 0.55), np.ones(b),
                       np.zeros(b)], axis=1)
    if replica:
        params[: b // 2, 5] = np.tile([1.0, 2.0], b // 4)
    params[-64:, 4] = 0.0                    # padding rows
    params[b // 2 + 3, 0] = 1e5              # a starved (timed-out) row
    if legacy:
        params = params[:, :5]
    return [np.ascontiguousarray(x, np.float32)
            for x in (c, g, gc_res, gc_pre, v0, params)]


def compare(evt_k, vend_k, evt_p, vend_p, dt: float) -> dict:
    """The reference's Pallas-vs-oracle bars: times within one dt, the same
    NaN pattern, dv_sense rtol 1e-3 / atol 1e-5, v_end rtol 1e-4 / atol 1e-5."""
    import torch

    t_k, t_p = evt_k[:, [0, 2, 3]], evt_p[:, [0, 2, 3]]
    check(torch.equal(torch.isnan(t_k), torch.isnan(t_p)),
          "kernel and plain version disagree on which phases timed out")
    dt_err = torch.where(torch.isnan(t_p), 0.0, (t_k - t_p).abs()).max().item()
    steps = round(dt_err / dt)
    check(steps <= 1, f"event time off by {dt_err} ns ({steps} steps)")
    dv_ok = ((evt_k[:, 1] - evt_p[:, 1]).abs()
             <= 1e-5 + 1e-3 * evt_p[:, 1].abs()).all().item()
    check(dv_ok, "dv_sense outside rtol 1e-3 / atol 1e-5")
    v_ok = ((vend_k - vend_p).abs() <= 1e-5 + 1e-4 * vend_p.abs()).all().item()
    check(v_ok, "v_end outside rtol 1e-4 / atol 1e-5")
    dv_err = (evt_k[:, 1] - evt_p[:, 1]).abs().max().item()
    v_err = (vend_k - vend_p).abs().max().item()
    return {"t_err_ns": dt_err, "t_err_steps": steps, "dv_err_v": dv_err,
            "v_end_err_v": v_err, "nan_rows": int(torch.isnan(t_p).any(1).sum())}


def kernel_vs_plain(ops_mod, args, dt, caps) -> tuple[dict, float]:
    """Kernel and plain version on the same CUDA tensors; returns the
    comparison and the plain version's time in ms."""
    import torch

    evt_k, vend_k = ops_mod.row_cycle_fused(*args, dt, *caps, backend="cuda")
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    start.record()
    evt_p, vend_p = ops_mod.row_cycle_fused(*args, dt, *caps, backend="ref")
    end.record()
    torch.cuda.synchronize()
    return compare(evt_k, vend_k, evt_p, vend_p, dt), start.elapsed_time(end)


# --------------------------------------------------------------------------
# timing helpers
# --------------------------------------------------------------------------

def cuda_ms(fn, repeats: int = 1) -> tuple[float, object]:
    """Device time of `fn` over `repeats` calls (CUDA events), per call."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(repeats):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / repeats, out


def profile(fn) -> dict:
    """One call of `fn` under torch.profiler: host wall time, the device
    time of its kernels (self CUDA time summed over the trace), the idle
    share of the card over the call, and the kernels taking most time."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    fn()                                      # warm-up outside the trace
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
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "idle_share": 1.0 - busy_ms / wall_ms if wall_ms else None,
            "device_kernels": len(device),
            "top": [[name[:60], ms, n] for name, (ms, n) in top]}


def steps_per_row(evt, params, dt, caps):
    """Implicit-Euler steps each row needs on these inputs: the steps up to
    each phase's crossing (its window on a timeout); replica rows stop after
    ACT, inactive rows take none."""
    import torch

    def phase_steps(t, cap):
        return torch.where(torch.isnan(t), float(cap), torch.round(t / dt))

    act = phase_steps(evt[:, 0], caps[0])
    rest = phase_steps(evt[:, 2], caps[1]) + phase_steps(evt[:, 3], caps[2])
    role = params[:, 5] if params.shape[1] > 5 else torch.zeros_like(act)
    replica = (role - 1.0).abs() < 0.5
    active = params[:, 4] > 0.5
    return torch.where(active, act + torch.where(replica, 0.0, rest), 0.0)


def ops_per_step(n: int) -> int:
    """float32 operations of one implicit-Euler step of an N-node row, as
    csrc/row_cycle.cu does them (each division and expf counted as one):
    ramp 7, assembly 6N, Thomas 9(N-1)+3, crossings and event 3(N-1)+6."""
    return 18 * n + 4


def bound_ms(evt, params, n, dt, caps) -> tuple[float, str, dict]:
    """The least time the card could take for this launch's work: the larger
    of its bytes (each input read once, each output written once) over the
    HBM rate and its float32 operations (the steps these inputs need) over
    the float32 peak."""
    b = evt.shape[0]
    n_bytes = 4 * b * (4 * n + (n - 1) + params.shape[1]) + 4 * b * (4 + n)
    row_steps = steps_per_row(evt, params, dt, caps)
    steps = float(row_steps.sum().item())
    n_ops = steps * ops_per_step(n)
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_PEAK_OPS * 1e3
    bound_by = "operations" if t_ops >= t_bytes else "bytes"
    return max(t_ops, t_bytes), bound_by, {
        "bytes": n_bytes, "ops": n_ops, "row_steps": steps,
        "max_row_steps": float(row_steps.max().item()),
        "max_warp_steps_mean": float(
            row_steps[: b - b % 32].reshape(-1, 32).max(1).values.mean().item())}


def events_identical(a, b) -> bool:
    import torch

    return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all().item())


# --------------------------------------------------------------------------
# rc_multistep and the phased engine
# --------------------------------------------------------------------------

def random_ladder(rng, b, n, t):
    """Random ladders with a nonzero clamp network and a rising WL ramp."""
    import numpy as np

    ramp = 1.0 - np.exp(-(np.arange(t) + 1) * 0.02 / rng.uniform(0.3, 2.0))
    return [np.ascontiguousarray(x, np.float32) for x in (
        rng.uniform(1, 5, (b, n)), rng.uniform(0.05, 0.2, (b, n - 1)),
        rng.uniform(0.0, 0.3, (b, n)), rng.uniform(0.0, 1.1, (b, n)),
        rng.uniform(0.0, 1.1, (b, n)), ramp)]


def rc_compare(ops_mod, args, dt) -> dict:
    """rc_multistep kernel vs plain version on the same CUDA tensors."""
    import torch

    out_k = ops_mod.rc_multistep(*args, dt, backend="cuda")
    out_p = ops_mod.rc_multistep(*args, dt, backend="ref")
    torch.cuda.synchronize()
    err = (out_k - out_p).abs()
    ok = bool((err <= RC_ATOL + RC_RTOL * out_p.abs()).all().item())
    check(ok and bool(torch.isfinite(out_k).all().item()),
          f"rc_multistep kernel outside rtol {RC_RTOL} / atol {RC_ATOL} "
          f"of its plain version (max |d| {err.max().item()})")
    return {"shape": list(out_k.shape), "max_abs_err": err.max().item(),
            "bit_identical": bool(torch.equal(out_k, out_p))}


@contextmanager
def recording(module, name):
    """Record the arguments of every call of `module.name`."""
    original = getattr(module, name)
    calls = []

    def wrapper(*args, **kwargs):
        calls.append((args, kwargs))
        return original(*args, **kwargs)

    setattr(module, name, wrapper)
    try:
        yield calls
    finally:
        setattr(module, name, original)


def rc_bound_ms(b, n, t) -> tuple[float, str, dict]:
    """The least time the card could take for one rc_multistep call: its
    bytes (five (B, N)-ish operands and the ramp read once, the (T, B, N)
    trace written once) over the HBM rate, or its float32 operations
    (13N - 5 a row-step as csrc/rc_multistep.cu does them, each division
    counted as one, plus 3N a row of set-up) over the float32 peak."""
    n_bytes = 4 * (b * (4 * n + n - 1) + t) + 4 * t * b * n
    n_ops = t * b * (13 * n - 5) + 3 * b * n
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_PEAK_OPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), {
        "bytes": n_bytes, "ops": n_ops}


def events_within_bars(f, p, dt) -> dict:
    """Fused vs phased: the reference's bars (tests/test_fused_row_cycle.py)
    — precharge and restore durations within one dt, t_sense within one
    dt + slack, tRC within 3 dt + slack, the same NaN pattern."""
    import torch

    for name in ("t_fire_ns", "t_precharge_ns", "trc_ns"):
        check(torch.equal(getattr(f, name).isnan(), getattr(p, name).isnan()),
              f"fused and phased disagree on which {name} are NaN")

    def diff(a, b):
        return (a - b).abs().nan_to_num().max().item()

    out = {"t_fire_ns": diff(f.t_fire_ns, p.t_fire_ns),
           "t_precharge_ns": diff(f.t_precharge_ns, p.t_precharge_ns),
           "t_res_dur_ns": diff(f.t_restore_ns - f.t_sense_ns,
                                p.t_restore_ns - p.t_sense_ns),
           "t_sense_ns": diff(f.t_sense_ns, p.t_sense_ns),
           "trc_ns": diff(f.trc_ns, p.trc_ns)}
    bars = {"t_fire_ns": dt + 1e-6, "t_precharge_ns": dt + 1e-6,
            "t_res_dur_ns": dt + 1e-5, "t_sense_ns": dt + REGEN_SLACK_NS,
            "trc_ns": 3 * dt + REGEN_SLACK_NS}
    for name, bar in bars.items():
        check(out[name] <= bar, f"fused vs phased {name} off by "
              f"{out[name]} ns (bar {bar})")
    return out


def rc_line(rc_kernel, ops_mod, act_args, launches, max_err) -> dict:
    """The kernels-line entry of rc_multistep, timed at the phased path's
    ACT call (its widest: T = 800 steps of B rows)."""
    c, ramp = act_args[0], act_args[5]
    ms, _ = cuda_ms(lambda: rc_kernel(*act_args), 20)
    plain_ms, _ = cuda_ms(lambda: ops_mod.rc_multistep(*act_args,
                                                       backend="ref"))
    b_ms, b_by, work = rc_bound_ms(c.shape[0], c.shape[1], ramp.shape[0])
    return {"name": "rc_multistep", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/rc_multistep.cu",
            "replaces": "src/repro/kernels/rc_transient.py:75",
            "launches": launches, "max_abs_err": max_err,
            "max_abs_err_unit": "V (trace node voltages)",
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None,
            "shape": [int(ramp.shape[0]), *c.shape], "bound_work": work}


def same_events(a, b) -> bool:
    return all(events_identical(getattr(a, f), getattr(b, f))
               for f in ("t_fire_ns", "t_sense_ns", "t_restore_ns",
                         "t_precharge_ns", "trc_ns", "dv_sense_v"))


# --------------------------------------------------------------------------
# main
# --------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random kernel-test ladders")
    ap.add_argument("--out", type=Path, default=None,
                    help="also write every measurement as JSON to this file")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is False: this script "
                           "runs the port on an NVIDIA GPU")
    if not (SRC / "repro_torch" / "kernels" / "csrc" / "row_cycle.cu").is_file():
        raise SmokeFailure(f"the port's sources are not next to {__file__} "
                           "(run it from a checkout of the repository)")
    sys.path.insert(0, str(SRC))

    import numpy as np

    from repro_torch.core import calibration as cal
    from repro_torch.core import dse, report, transient
    from repro_torch.core.space import DEFAULT_LAYER_GRID, DesignSpace
    from repro_torch.kernels import ops, rc_transient, row_cycle

    wall0 = time.perf_counter()
    record: dict = {"seed": args.seed}
    dev = torch.device("cuda")
    kernel = row_cycle.row_cycle_fused_cuda
    rc_kernel = rc_transient.rc_multistep_cuda
    dt = transient.DT_NS
    caps = (transient.N_ACT_STEPS, transient.N_RESTORE_STEPS,
            transient.N_PRE_STEPS)

    # 1. the card
    card = card_line()
    name = torch.cuda.get_device_name(0)
    log(f"[card] {card} | torch {torch.__version__} cuda {torch.version.cuda}")
    record["card"] = card

    # 2. build both kernels, one nvcc each, started together
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=2) as pool:
        libs = list(pool.map(lambda m: m.build(), (row_cycle, rc_transient)))
    build_s = time.perf_counter() - t0
    log(f"[build] {', '.join(lib.name for lib in libs)} in {build_s:.2f} s")
    for lib in libs:
        ptxas = Path(f"{lib}.ptxas.txt")
        for ln in ptxas.read_text().splitlines() if ptxas.exists() else []:
            if any(k in ln for k in ("entry function", "registers")):
                log(f"[build] ptxas: {ln.strip()}")
    record["build_s"] = build_s

    # 3. kernel vs plain version on the card
    rng = np.random.default_rng(args.seed)
    comparisons, max_err_ns, max_steps = {}, 0.0, 0
    cases = [(2048, 4, True, False), (2048, 6, True, False),
             (2048, 8, True, False), (2048, 6, False, True)]
    for b, n, replica, legacy in cases:
        host = random_operands(rng, b, n, replica=replica, legacy=legacy)
        tens = [torch.as_tensor(x, device=dev) for x in host]
        res, _ = kernel_vs_plain(ops, tens, dt, caps)
        key = f"random_B{b}_N{n}" + ("_replica" if replica else "") + (
            "_legacy5" if legacy else "")
        comparisons[key] = res
        max_err_ns = max(max_err_ns, res["t_err_ns"])
        max_steps = max(max_steps, res["t_err_steps"])
        check(res["nan_rows"] >= 1, f"{key}: the starved row did not time out")
        log(f"[kernel-vs-plain] {key}: {json.dumps(res)}")
    mc_space = DesignSpace.paper_grid().with_mc(samples=MC_SAMPLES, key=0)
    mc_plan = dse.plan_sweep(mc_space, device=dev)
    rows = len(mc_space)                     # 73 * 4096 = 299,008
    mc_ops = [x.contiguous() for x in mc_plan.operands[:6]]
    check(mc_ops[0].shape == (rows, 6), f"MC batch is {tuple(mc_ops[0].shape)}")
    res, plain_full_ms = kernel_vs_plain(ops, mc_ops, dt, caps)
    comparisons[f"mc{MC_SAMPLES}_B{rows}_N6"] = res
    max_err_ns = max(max_err_ns, res["t_err_ns"])
    max_steps = max(max_steps, res["t_err_steps"])
    log(f"[kernel-vs-plain] mc{MC_SAMPLES}_B{rows}_N6: {json.dumps(res)} "
        f"plain {plain_full_ms:.1f} ms")
    rep_plan = dse.plan_sweep(DesignSpace.paper_grid().with_replica(),
                              device=dev)
    rep_ops = transient._pad_operands(rep_plan.operands[:6], 192 - 146)
    res, _ = kernel_vs_plain(ops, [x.contiguous() for x in rep_ops], dt, caps)
    comparisons["paper_grid_replica_B192_N6"] = res
    max_err_ns = max(max_err_ns, res["t_err_ns"])
    log(f"[kernel-vs-plain] paper_grid_replica_B192_N6: {json.dumps(res)}")
    record["kernel_vs_plain"] = comparisons

    # 4. the main path, through the entry point a user calls
    space = DesignSpace.paper_grid()
    kernel.launches = 0
    batch = dse.sweep(space, device=dev)
    torch.cuda.synchronize()
    main_launches = kernel.launches
    log(f"[main] sweep(paper_grid()): {len(batch)} points, "
        f"{main_launches} kernel launch(es)")
    check(len(batch) == 73, f"paper grid has {len(batch)} points, expected 73")
    check(main_launches > 0, "the main path launched no row-cycle kernel")
    check(bool(torch.isfinite(batch.trc_ns[batch.feasible]).all()),
          "a feasible design has a non-finite tRC")
    best = dse.best_design(batch)
    log(f"[main] best_design: {best.tech}/{best.scheme} @ {best.layers}: "
        f"{best.density_gb_mm2:.4f} Gb/mm2, tRC {best.trc_ns:.4f} ns")
    check((best.tech, best.scheme, best.layers) == ("aos", "sel_strap", 87),
          f"best design is {best}")
    check(rel(best.density_gb_mm2, 2.6) < 0.01, "density golden 2.6 Gb/mm2")
    check(rel(best.trc_ns, 10.5) < 0.02, "AOS tRC golden 10.5 ns")
    by_point = {(p.tech, p.scheme, p.layers): p
                for p in (batch.point(i) for i in range(len(batch)))}
    goldens = {key: (by_point[key].trc_ns, want) for key, want in (
        (("si", "sel_strap", 137), 10.9), (("aos", "sel_strap", 87), 10.5),
        (("d1b", "direct", 1), 21.3))}
    for (tech, scheme, layers), (got, want) in goldens.items():
        key = f"{tech}/{scheme}@{layers}"
        log(f"[main] tRC {key}: {got:.4f} ns (paper {want})")
        check(rel(got, want) < 0.02, f"tRC golden {key}: {got} vs {want}")
    kernel.launches = 0
    for tech, scheme, want in (("si", "sel_strap", 10.9),
                               ("aos", "sel_strap", 10.5),
                               ("d1b", "direct", 21.3)):
        got = float(transient.nominal_trc_ns(cal.get_tech(tech), scheme,
                                             device=dev))
        check(rel(got, want) < 0.02, f"nominal_trc_ns {tech}: {got}")
    check(kernel.launches == 3, "nominal_trc_ns did not launch the kernel")
    plain = dse.sweep(space, backend="ref", device=dev)
    check(torch.equal(batch.feasible, plain.feasible),
          "feasible differs between kernel and plain sweeps")
    check(torch.equal(dse.pareto_mask(batch), dse.pareto_mask(plain)),
          "Pareto mask differs between kernel and plain sweeps")
    fire_err = (batch.t_fire_ns - plain.t_fire_ns).abs().nan_to_num().max().item()
    trc_err = (batch.trc_ns - plain.trc_ns).abs().nan_to_num().max().item()
    check(round(fire_err / dt) <= 1, f"t_fire off by {fire_err} ns")
    check(trc_err <= 3 * dt + REGEN_SLACK_NS + 1e-5, f"tRC off by {trc_err} ns")
    kernel.launches = 0
    rep = dse.sweep(space.with_replica(), device=dev)
    torch.cuda.synchronize()
    replica_launches = kernel.launches
    check(replica_launches > 0 and len(rep) == 73, "replica sweep")
    rep_plain = dse.sweep(space.with_replica(), backend="ref", device=dev)
    check(torch.equal(rep.feasible, rep_plain.feasible),
          "replica feasible differs between kernel and plain sweeps")
    rep_best = dse.best_design(rep)
    log(f"[main] replica sweep: {replica_launches} launch(es); best "
        f"{rep_best.tech}/{rep_best.scheme} @ {rep_best.layers}, tRC "
        f"{rep_best.trc_ns:.4f} ns; kernel vs plain sweep: t_fire "
        f"{fire_err:.3g} ns, tRC {trc_err:.3g} ns")
    record["main"] = {"points": len(batch), "launches": main_launches,
                      "replica_launches": replica_launches,
                      "goldens_trc_ns": {"/".join(map(str, k)): v[0]
                                         for k, v in goldens.items()},
                      "best": [best.tech, best.scheme, best.layers,
                               best.density_gb_mm2, best.trc_ns]}

    # 5. the sized run: 299,008 design rows, in default chunks and in one
    sized: dict = {}
    events = {}
    align = transient.B_ALIGN
    chunks = (transient.DEFAULT_B_CHUNK, -(-rows // align) * align)
    for b_chunk in chunks:
        runs = []
        for rep_i in range(REPEATS + 1):            # the first is the warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            plan = dse.plan_sweep(mc_space, device=dev)
            torch.cuda.synchronize()
            plan_ms = (time.perf_counter() - t0) * 1e3
            kernel.launches = 0
            kernel_ms, evt = cuda_ms(lambda: transient.row_cycle_events(
                plan.operands, b_chunk=b_chunk))
            launches = kernel.launches
            score_ms, mc_batch = cuda_ms(lambda: dse.finalize_sweep(
                plan, transient.result_from_events(plan.operands, evt)))
            pareto_ms, mask = cuda_ms(lambda: dse.pareto_mask(mc_batch))
            if rep_i:
                runs.append((plan_ms, kernel_ms, score_ms, pareto_ms))
        events[b_chunk] = evt
        med = [statistics.median(r[k] for r in runs) for k in range(4)]
        sweep_ms = med[0] + med[1] + med[2]
        sized[b_chunk] = {
            "rows": len(mc_batch), "launches": launches,
            "plan_ms": med[0], "kernel_ms": med[1], "score_ms": med[2],
            "pareto_ms": med[3], "ms_per_launch": med[1] / launches,
            "sweep_designs_per_s": len(mc_batch) / (sweep_ms / 1e3),
            "with_pareto_designs_per_s": len(mc_batch) / (
                (sweep_ms + med[3]) / 1e3),
            "feasible": int(mc_batch.feasible.sum()),
            "pareto": int(mask.sum()), "runs_ms": runs}
        log(f"[sized] b_chunk={b_chunk}: " + json.dumps(
            {k: v for k, v in sized[b_chunk].items() if k != "runs_ms"}))
    check(events_identical(*events.values()),
          f"b_chunk={chunks[0]} and b_chunk={chunks[1]} events are not "
          "bit-identical")
    check([sized[c]["launches"] for c in chunks]
          == [-(-rows // c) for c in chunks],
          f"launch counts {[s['launches'] for s in sized.values()]}")
    record["sized"] = sized

    # 6. rc_multistep kernel vs its plain version on random ladders
    rc_cmp, rc_err = {}, 0.0
    for b, n, t in ((1000, 4, 64), (1025, 6, 800), (129, 8, 100)):
        host_args = random_ladder(rng, b, n, t)
        res = rc_compare(ops, [torch.as_tensor(x, device=dev)
                               for x in host_args], dt)
        rc_cmp[f"random_B{b}_N{n}_T{t}"] = res
        rc_err = max(rc_err, res["max_abs_err"])
        log(f"[rc-vs-plain] random_B{b}_N{n}_T{t}: {json.dumps(res)}")

    # 7. the phased engine (Fig. 8 waveforms) through the entry point
    si = cal.get_tech("si")
    layers = np.linspace(32, 288, PHASED_B).astype(np.float32)
    phased, phased_launches = {}, {}
    for replica in (False, True):
        mode = "replica" if replica else "fixed"
        kernel.launches = rc_kernel.launches = 0
        with recording(ops, "rc_multistep") as calls:
            res = transient.simulate_row_cycle(si, "sel_strap", layers,
                                               traces=True, replica=replica,
                                               device=dev)
            torch.cuda.synchronize()
        phased_launches[mode] = rc_kernel.launches
        log(f"[phased] {mode} B={PHASED_B}: {rc_kernel.launches} "
            f"rc_multistep launch(es), {kernel.launches} fused")
        check(rc_kernel.launches == (4 if replica else 3) == len(calls),
              f"phased {mode}: {rc_kernel.launches} rc_multistep launches")
        check(kernel.launches == 0, "the phased path launched the fused "
              "row-cycle kernel")
        want = {"act", "restore", "pre"} | ({"replica"} if replica else set())
        check(set(res.traces) == want, f"traces {sorted(res.traces)}")
        for key, tr in res.traces.items():
            check(tr.ndim == 3 and tr.shape[1:] == (PHASED_B, 6)
                  and bool(torch.isfinite(tr).all()), f"trace {key}")
        for i, (a, kw) in enumerate(calls):
            cmp = rc_compare(ops, a[:6], a[6])
            rc_cmp[f"phased_{mode}_call{i}"] = cmp
            rc_err = max(rc_err, cmp["max_abs_err"])
            log(f"[rc-vs-plain] phased {mode} call {i}: {json.dumps(cmp)}")
        plain = transient.simulate_row_cycle_phased(
            si, "sel_strap", layers, backend="ref", replica=replica,
            device=dev)
        check(same_events(res, plain), f"phased {mode}: events through the "
              "kernel and through the plain version differ")
        fused = transient.simulate_row_cycle(si, "sel_strap", layers,
                                             replica=replica, device=dev)
        bars = events_within_bars(fused, res, dt)
        log(f"[phased] {mode}: kernel == plain events; fused vs phased "
            f"{json.dumps(bars)}")
        phased[mode] = {"launches": phased_launches[mode],
                        "fused_vs_phased": bars,
                        "calls": [list(a[0].shape) + [a[5].shape[0]]
                                  for a, _ in calls]}
        if not replica:
            phased_calls = calls
    grid_layers = list(DEFAULT_LAYER_GRID)
    combos = [(t, sc, grid_layers) for t in ("si", "aos")
              for sc in ("direct", "strap", "core_mux", "sel_strap")]
    combos.append(("d1b", "direct", [1]))
    grid_worst = {}
    for tech_name, scheme, lay in combos:
        tech = cal.get_tech(tech_name)
        for replica in (False, True):
            rc_kernel.launches = 0
            res = transient.simulate_row_cycle(tech, scheme, lay, traces=True,
                                               replica=replica, device=dev)
            check(rc_kernel.launches == (4 if replica else 3),
                  f"grid {tech_name}/{scheme}: {rc_kernel.launches} launches")
            plain = transient.simulate_row_cycle_phased(
                tech, scheme, lay, backend="ref", replica=replica,
                device=dev)
            check(same_events(res, plain), f"grid {tech_name}/{scheme}: "
                  "kernel and plain phased events differ")
            bars = events_within_bars(transient.simulate_row_cycle(
                tech, scheme, lay, replica=replica, device=dev), res, dt)
            for k, v in bars.items():
                grid_worst[k] = max(grid_worst.get(k, 0.0), v)
    log(f"[phased] full grid ({len(combos)} combos x fixed/replica): kernel "
        f"== plain; worst fused vs phased {json.dumps(grid_worst)}")
    fig8 = {}
    for tech_name, scheme, lay, want in (("si", "sel_strap", 137, 10.9),
                                         ("aos", "sel_strap", 87, 10.5),
                                         ("d1b", "direct", 1, 21.3)):
        got = float(transient.simulate_row_cycle(
            cal.get_tech(tech_name), scheme, [lay], traces=True,
            device=dev).trc_ns[0])
        fig8[f"{tech_name}/{scheme}@{lay}"] = got
        log(f"[phased] Fig. 8 tRC {tech_name}/{scheme}@{lay}: {got:.4f} ns "
            f"(paper {want})")
        check(rel(got, want) < 0.02, f"Fig. 8 golden {tech_name}: {got}")
    timing = {}
    for label, fn in (
            ("phased", lambda: transient.simulate_row_cycle(
                si, "sel_strap", layers, traces=True, device=dev)),
            ("fused", lambda: transient.simulate_row_cycle(
                si, "sel_strap", layers, device=dev))):
        runs = [cuda_ms(fn)[0] for _ in range(REPEATS + 1)][1:]
        timing[f"{label}_ms"] = statistics.median(runs)
        timing[f"{label}_runs_ms"] = runs
    for name_, (a, _) in zip(("act", "restore", "pre"), phased_calls):
        timing[f"{name_}_kernel_ms"] = cuda_ms(lambda a=a: rc_kernel(*a), 20)[0]
    timing["kernels_ms"] = sum(timing[f"{k}_kernel_ms"]
                               for k in ("act", "restore", "pre"))
    log(f"[phased] B={PHASED_B} timing: " + json.dumps(
        {k: v for k, v in timing.items() if not k.endswith("runs_ms")}))
    for label, fn in (
            ("phased", lambda: transient.simulate_row_cycle(
                si, "sel_strap", layers, traces=True, device=dev)),
            ("fused", lambda: transient.simulate_row_cycle(
                si, "sel_strap", layers, device=dev))):
        timing[f"{label}_profile"] = profile(fn)
        log(f"[profile] {label} B={PHASED_B}: "
            f"{json.dumps(timing[f'{label}_profile'])}")
    record["phased"] = {"modes": phased, "grid_worst": grid_worst,
                        "fig8_trc_ns": fig8, "timing": timing,
                        "rc_vs_plain": rc_cmp}

    # 8. the MC reductions: the 299,008-row batch of phase 5, and yield_ppm
    #    on a tail sweep as report.mc_tail_yield_table runs it
    floor = cal.MIN_FUNCTIONAL_MARGIN_MV
    cpu_batch = mc_batch._map(lambda a: a.cpu())
    reductions = {
        "yield_fraction": lambda b: b.yield_fraction(margin_mv=floor),
        "yield_fraction_spec": lambda b: b.yield_fraction(margin_mv=floor,
                                                          trc_ns=11.0),
        "quantile": lambda b: b.quantile([0.05, 0.5, 0.95]),
        "ess": lambda b: b.ess(),
        "mc_summary": lambda b: b.mc_summary(
            margin_mv=floor).corners["yield_frac"],
    }
    tail_space = DesignSpace.paper_targets().with_mc(
        samples=TAIL_SAMPLES, key=0, corr=1.0, tail_shift=(4.0, 0.0),
        tail_scale=(1.2, 1.0))
    tail = dse.sweep(tail_space, with_transient=False, device=dev)
    reductions_tail = {"yield_ppm": lambda b: b.yield_ppm(
        margin_mv=floor)["fail_ppm"]}
    designs_valid = torch.zeros(mc_batch.base_len, device=dev).index_add_(
        0, torch.arange(len(mc_batch), device=dev) % mc_batch.base_len,
        mc_batch.valid.float()) > 0
    mc_red = {}
    for batch_, todo in ((mc_batch, reductions), (tail, reductions_tail)):
        host_batch = cpu_batch if batch_ is mc_batch else tail._map(
            lambda a: a.cpu())
        for key, fn in todo.items():
            runs = [cuda_ms(lambda fn=fn: fn(batch_)) for _ in
                    range(REPEATS + 1)][1:]
            out = runs[-1][1]
            want = fn(host_batch)
            check(torch.equal(out.isnan().cpu(), want.isnan()),
                  f"{key}: NaN pattern differs between card and CPU")
            ok = (out.cpu() - want).abs() <= 1e-6 + 1e-5 * want.abs()
            check(bool((ok | want.isnan()).all()), f"{key}: card vs CPU")
            if batch_ is mc_batch and key != "quantile":
                check(not bool(out[designs_valid].isnan().any()),
                      f"{key}: NaN for a design with valid samples")
            mc_red[key] = {"ms": statistics.median(r[0] for r in runs),
                           "rows": len(batch_),
                           "max_abs_err_vs_cpu": (out.cpu() - want).abs()
                           .nan_to_num().max().item()}
    ppm = tail.yield_ppm(margin_mv=floor)
    mc_red["yield_ppm"]["fail_ppm"] = ppm["fail_ppm"].tolist()
    mc_red["yield_ppm"]["tail_ess"] = ppm["ess"].tolist()
    mc_red["mc_summary"]["profile"] = profile(
        lambda: mc_batch.mc_summary(margin_mv=floor))
    log(f"[mc] reductions: {json.dumps(mc_red)}")
    record["mc_reductions"] = mc_red

    # 9. the report tables at their default arguments
    report_s = {}
    tables = {}
    for fn_name in ("fig3_routing_comparison", "fig9a_stack_height",
                    "fig9b_margin_vs_density", "fig9c_spec_table",
                    "mc_yield_table", "mc_tail_yield_table",
                    "fig_tail_probability", "fig9b_margin_yield_vs_density",
                    "replica_timing_table", "table1_summary"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tables[fn_name] = getattr(report, fn_name)(device=dev)
        report_s[fn_name] = time.perf_counter() - t0
        log(f"[report] {fn_name}: {report_s[fn_name]:.3f} s")
    t1 = tables["table1_summary"]
    spec = tables["fig9c_spec_table"]
    for tech_name, want in (("si", 10.9), ("aos", 10.5), ("d1b", 21.3)):
        check(rel(t1["trc_ns"][tech_name], want) < 0.02,
              f"table1_summary tRC {tech_name}: {t1['trc_ns'][tech_name]}")
    check(rel(spec["aos"]["bit_density_gb_mm2"], 2.6) < 0.01
          and spec["aos"]["layers"] == 87, "fig9c AOS density golden")
    check(rel(spec["ratios"]["density_x"], 6.0) < 0.02, "~6x density golden")
    log(f"[report] table1 tRC {json.dumps(t1['trc_ns'])}; AOS "
        f"{spec['aos']['bit_density_gb_mm2']:.4f} Gb/mm2 @ "
        f"{spec['aos']['layers']}L; density x{spec['ratios']['density_x']:.3f}")
    record["report_s"] = report_s
    record["report_profile"] = profile(lambda: report.mc_yield_table(
        device=dev))
    log(f"[profile] report.mc_yield_table: "
        f"{json.dumps(record['report_profile'])}")
    record["report"] = {k: tables[k] for k in ("table1_summary",
                                               "mc_tail_yield_table")}

    # 10. the kernels line: one 2048-row chunk of the sized run, the path's
    #    default shape; rc_multistep at the phased path's ACT call
    chunk = [x[:transient.DEFAULT_B_CHUNK].contiguous()
             for x in mc_plan.operands[:6]]
    kernel_ms, (evt, _) = cuda_ms(lambda: kernel(*chunk, dt, *caps), 20)
    plain_ms, _ = cuda_ms(lambda: ops.row_cycle_fused(*chunk, dt, *caps,
                                                      backend="ref"), 2)
    b_ms, b_by, b_work = bound_ms(evt, chunk[5], 6, dt, caps)
    full_bound_ms, _, full_work = bound_ms(events[chunks[1]], mc_ops[5], 6,
                                           dt, caps)
    line = {"kernels": [{
        "name": "row_cycle_fused",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/row_cycle.cu",
        "replaces": "src/repro/kernels/row_cycle.py:181",
        "launches": main_launches,
        "max_abs_err": max_err_ns,
        "max_abs_err_unit": "ns (event times; v_end and dv_sense within "
                            "their bars)",
        "max_err_steps": max_steps,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": None,
        "shape": list(chunk[0].shape),
        "bound_work": b_work,
        "full_sweep_kernel_ms": {str(k): v["kernel_ms"] for k, v in sized.items()},
        "full_sweep_bound_ms": full_bound_ms,
        "full_sweep_plain_ms": plain_full_ms,
        "full_sweep_work": full_work,
    }, rc_line(rc_kernel, ops, phased_calls[0][0], phased_launches["fixed"],
               rc_err)]}
    record["kernels"] = line["kernels"]
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(record, indent=1))
    record["wall_s"] = time.perf_counter() - wall0
    log(f"[done] wall time {record['wall_s']:.1f} s")
    print(json.dumps(line))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
