#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU, end to end.

    python3 chip_smoke.py [--seed 0] [--out results.json]

Phases (any failure exits non-zero and prints no result line):

1. the card's name and power limit (nvidia-smi);
2. build the three CUDA kernels (row_cycle.cu, rc_multistep.cu,
   strap_attend.cu) from src/repro_torch/kernels/csrc/ with nvcc into
   build/, in parallel;
3. hold the row-cycle kernel (backend="cuda") against its plain PyTorch
   version (backend="ref") on the card, bit for bit (events, NaN pattern,
   v_end): N = 4, 6, 8, replica pairs, padding rows, timed-out rows,
   legacy (B, 5) params, B = 2048 and the full 299,008-row Monte-Carlo
   operand batch;
4. the main path: `dse.sweep(DesignSpace.paper_grid())` on the card, with
   the kernel's launch count read around it, the paper's goldens, the same
   sweep through the plain version, and the replica-timed sweep;
5. the sized run: `paper_grid().with_mc(samples=4096, key=0)` (299,008
   design rows, the `--mc-tail` default of examples/dram_codesign.py),
   timed per phase (plan, kernel, score, pareto), median of 3 after a
   warm-up, through the path (one launch at the default b_chunk=2048)
   and through explicit per-2048-row kernel calls (the earlier dispatch,
   146 launches); both equal bit for bit, and equal to the plain version;
6. the rc_multistep kernel against its plain version, bit for bit, on
   random ladders (N = 4, 6, 8, ragged B, clamp network and ramp) and on
   ladders at the edges of its exact quotient form
   (`bench.rc_adversarial_ladders`), and its branch-free reciprocal against
   IEEE division on every float32 of its range;
7. the phased engine (`simulate_row_cycle(..., traces=True)`, the Fig. 8
   waveforms) at B = 1024 (SI sel_strap, layers 32..288), fixed and
   replica-timed, with rc_multistep's launch count read around it, the
   kernel held against its plain version bit for bit at the path's own
   shapes, the path through the kernel vs through the plain version
   (events and traces bit for bit), fused vs phased, the Fig. 8 goldens,
   the full paper grid, the host-device syncs of one call (none: it runs
   under `torch.cuda.set_sync_debug_mode("error")`), and the B = 1024 call
   timed;
8. the MC reductions (yield_fraction, quantile, ess, mc_summary) on the
   299,008-row batch of phase 5 and yield_ppm on a 4096-sample tail sweep,
   timed and held against the same reductions on the CPU;
9. every `report.*` table at its default arguments on the card, with the
   Table-I goldens, each timed;
10. the strap_attend kernel against its plain version: float32 at every
   shape of the reference's kernel test and at two that reach the
   kernel's other branches (D = 30, D = 256), each with a masked strap, a
   partial length, a duplicated id and an all-masked row; bf16 at
   Qwen2-1.5B's decode shape and at those two; both dtypes on pages that
   start off a 16-byte boundary;
11. the LM server at smoke size (`qwen2-1.5b-smoke`, float32) on the card:
   the strap-exact engine gives the dense engine's greedy tokens;
12. the LM server at full width (`qwen2-1.5b`, bf16, seeded weights): 8
   requests of 2048-token prompts, 32 new tokens, through
   `ServeEngine.generate` with the dense, strap-exact and strap-gated
   (top 4) backends; strap_attend's launches counted, every call of the
   path held against the plain version, prefill and decode-step times,
   tokens/s, the strap engines teacher-forced with the dense tokens, one
   decode step under the profiler;
13. `examples/dram_codesign_torch.py --smoke` on the card: the paper's
   selected design through the row-cycle kernel;
14. the co-design service (`serving.dse_service.DSEService`), the
   slice's main path: two concurrent clients (a sweep and a yield query)
   in one window, one dispatch and exactly one row-cycle launch, the
   responses bit-identical to direct sweeps (NaN-aware); a repeat
   answered from the memo with no launch; the background dispatcher; a
   6 x 4 client stress run whose counters reconcile; `sweep_stream` of
   the paper grid equal to the monolithic sweep; the 299,008-row yield
   query served in one window (one launch), bit-identical to the direct
   sweep and its `mc_summary`, timed against it; `stats()`;
15. the service CLI's smoke (`repro_torch.launch.serve --smoke`);
16. the sweep fabric (`launch.mesh`, `launch.shard`, `launch.elastic`,
   `launch.multiproc`), each result bit for bit (int32 views) against
   phase 5's batch and Pareto mask: the 299,008-row sweep over every
   card's slot and over 4 slots on the card (one launch a slot), timed in
   turns with the direct sweep; a replica MC space over 3 slots; the
   Pareto mask over 4 slots; the elastic sweep over 8 slots with a host
   dropped (restarts 1, 8 -> 7 slots, overhead 0.25) and the reference's
   fault pile-up (restarts 4, 8 -> 6); an NCCL group of one rank; two
   gloo processes sharing the card (`launch.multiproc --smoke`); the shard
   CLI's smoke and the example twin's `--smoke --sharded`;
17. one JSON line listing the ported kernels (row_cycle at the sweep's
   one launch over 299,008 rows and at one 2048-row chunk, with the
   cycles of a step; rc_multistep at the phased path's ACT call, with
   cycles a step, its block as the library reports it and, in its
   `bound_work`, the chain model beside the byte bound;
   strap_attend at the full-width path's last exact-mode and gated
   steps, on 1 to 8 rows, and SDPA on the same tokens; row_cycle's
   `launches_by_path` counts each path's launches, read around it), then
   the card line, then the result line {"ok": true, "device": {...}}.

It imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import dataclasses
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
CHAIN_OP_CYCLES = 4             # assumed float32 mul/add/fma latency, sm_90
BF16_PEAK_OPS = 989e12          # H100 SXM bf16 dense tensor-core peak, data sheet
HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3 bandwidth, data sheet
STRAP_F32_TOL = 3e-5            # tests/test_kernels.py's strap bars (rtol = atol)
STRAP_BF16_TOL = 3e-2
# bf16 bar tied to the output's scale: kernel and plain version both
# accumulate in float32 and round once, so they may differ by a rounding
# step; 2^-6 |plain| is at least two bf16 ulps of |plain|, 1e-3 a floor
STRAP_BF16_ULP_RTOL, STRAP_BF16_ULP_ATOL = 2.0 ** -6, 1e-3
SDPA_BACKENDS = ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION",
                 "MATH")
# (B, P, page, Hkv, D, Hq, G): the reference's kernel test shapes, then
# D = 30 (K/V rows copied element by element, D padded to the mma depth)
# and D = 256 with grp = 8 (the widest instantiation)
STRAP_SHAPES = [(2, 8, 16, 2, 64, 8, 2), (1, 4, 8, 1, 128, 4, 4),
                (3, 6, 32, 3, 32, 6, 3), (2, 16, 8, 4, 64, 16, 4),
                (1, 8, 128, 2, 128, 2, 2), (2, 8, 16, 2, 30, 8, 2),
                (3, 8, 16, 1, 256, 8, 2)]
STRAP_BRANCH_SHAPES = STRAP_SHAPES[-2:]
STRAP_UNALIGNED_SHAPE = (3, 8, 16, 2, 200, 12, 2)
LM_ARCH = "qwen2-1.5b"
LM_B, LM_PROMPT, LM_NEW = 8, 2048, 32
LM_MAX = LM_PROMPT + LM_NEW + 16  # examples/serve_lm.py's PROMPT + NEW + 16
LM_BACKENDS = (("dense", "dense", 0), ("strap_exact", "strap", 0),
               ("strap_gated_top4", "strap", 4))


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
    check(events_identical(evt_k, evt_p) and bool(torch.equal(vend_k, vend_p)),
          "row-cycle kernel and plain version are not bit-identical")
    return {"t_err_ns": dt_err, "t_err_steps": steps, "dv_err_v": dv_err,
            "v_end_err_v": v_err, "bit_identical": True,
            "nan_rows": int(torch.isnan(t_p).any(1).sum())}


def kernel_vs_plain(ops_mod, args, dt, caps) -> tuple[dict, float, tuple]:
    """Kernel and plain version on the same CUDA tensors; returns the
    comparison, the plain version's time in ms and its outputs."""
    import torch

    evt_k, vend_k = ops_mod.row_cycle_fused(*args, dt, *caps, backend="cuda")
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    start.record()
    evt_p, vend_p = ops_mod.row_cycle_fused(*args, dt, *caps, backend="ref")
    end.record()
    torch.cuda.synchronize()
    return (compare(evt_k, vend_k, evt_p, vend_p, dt), start.elapsed_time(end),
            (evt_p, vend_p))


# --------------------------------------------------------------------------
# timing helpers
# --------------------------------------------------------------------------

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
    from repro_torch.kernels.bench import row_steps

    b = evt.shape[0]
    n_bytes = 4 * b * (4 * n + (n - 1) + params.shape[1]) + 4 * b * (4 + n)
    per_row = row_steps(evt, params, dt, caps)
    steps = float(per_row.sum().item())
    n_ops = steps * ops_per_step(n)
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_PEAK_OPS * 1e3
    bound_by = "operations" if t_ops >= t_bytes else "bytes"
    return max(t_ops, t_bytes), bound_by, {
        "bytes": n_bytes, "ops": n_ops, "row_steps": steps,
        "max_row_steps": float(per_row.max().item()),
        "max_warp_steps_mean": float(
            per_row[: b - b % 32].reshape(-1, 32).max(1).values.mean().item())}


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


def bitwise_equal(a, b) -> bool:
    """Every float32 of `a` has the bits of `b`'s (so -0.0 != 0.0 and
    NaN == NaN of the same payload)."""
    import torch

    return a.shape == b.shape and bool(torch.equal(a.view(torch.int32),
                                                   b.view(torch.int32)))


def rc_compare(ops_mod, args, dt) -> dict:
    """rc_multistep kernel vs plain version on the same CUDA tensors: bit
    for bit, and within the reference's bars."""
    import torch

    out_k = ops_mod.rc_multistep(*args, dt, backend="cuda")
    out_p = ops_mod.rc_multistep(*args, dt, backend="ref")
    torch.cuda.synchronize()
    err = (out_k - out_p).abs()
    ok = bool((err <= RC_ATOL + RC_RTOL * out_p.abs()).all().item())
    check(ok and bool(torch.isfinite(out_k).all().item()),
          f"rc_multistep kernel outside rtol {RC_RTOL} / atol {RC_ATOL} "
          f"of its plain version (max |d| {err.max().item()})")
    same = bitwise_equal(out_k, out_p)
    check(same, "rc_multistep kernel not bit-identical to its plain version "
          f"({int((out_k.view(torch.int32) != out_p.view(torch.int32)).sum())}"
          f" of {out_k.numel()} values differ)")
    return {"shape": list(out_k.shape), "max_abs_err": err.max().item(),
            "bit_identical": same}


@contextmanager
def recording(module, name, outputs: bool = False):
    """Record the arguments of every call of `module.name` (with its
    result, as a third item, when `outputs`)."""
    original = getattr(module, name)
    calls = []

    def wrapper(*args, **kwargs):
        out = original(*args, **kwargs)
        calls.append((args, kwargs, out) if outputs else (args, kwargs))
        return out

    setattr(module, name, wrapper)
    try:
        yield calls
    finally:
        setattr(module, name, original)


def rc_bound_ms(b, n, t) -> tuple[float, str, dict]:
    """The least time the card could take for one rc_multistep call: its
    bytes (five (B, N)-ish operands and the ramp read once, the (T, B, N)
    trace written once) over the HBM rate, or its float32 operations
    (13N - 5 a row-step as the plain version does them, each division
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


def rc_line(rc_kernel, ops_mod, act_args, launches, max_err,
            registers) -> dict:
    """The kernels-line entry of rc_multistep, timed at the phased path's
    ACT call (its widest: T = 800 steps of B rows), with the cycles a step
    at the SM clock nvidia-smi reads and the block the built library
    reports.  Beside the byte bound, `bound_work` carries the chain model:
    T steps of the step's dependent float operations, counted by hand from
    the source (`rc_transient.chain_ops`), at an assumed latency of
    CHAIN_OP_CYCLES each, at that clock.  It is a model, not a
    measurement."""
    from repro_torch.kernels import rc_transient
    from repro_torch.kernels.bench import cuda_ms, rc_kernel_timing, smi

    c, ramp = act_args[0], act_args[5]
    steps, n = int(ramp.shape[0]), int(c.shape[1])
    clock_mhz = float(smi("clocks.sm"))
    timing = rc_kernel_timing(rc_kernel, act_args, clock_mhz, REPEATS)
    plain_ms, _ = cuda_ms(lambda: ops_mod.rc_multistep(*act_args,
                                                       backend="ref"))
    b_ms, b_by, work = rc_bound_ms(c.shape[0], n, steps)
    ops = rc_transient.chain_ops(n)
    work["chain_model"] = {
        "basis": "model, not measured: dependent float ops a step counted "
                 "from csrc/rc_multistep.cu at an assumed latency",
        "float_ops_per_step": ops,
        "assumed_cycles_per_op": CHAIN_OP_CYCLES,
        "cycles_per_step": ops * CHAIN_OP_CYCLES,
        "floor_ms": steps * ops * CHAIN_OP_CYCLES / (clock_mhz * 1e3)}
    return {"name": "rc_multistep", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/rc_multistep.cu",
            "replaces": "src/repro/kernels/rc_transient.py:75",
            "launches": launches, "max_abs_err": max_err,
            "max_abs_err_unit": "V (trace node voltages; every trace "
                                "bit-identical to the plain version)",
            "ms": timing["ms"], "ms_runs": timing["runs_ms"],
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None, "shape": [steps, *c.shape],
            "bound_work": work, "sm_clock_mhz": clock_mhz,
            "cycles_per_step": timing["cycles_per_step"],
            "block": rc_transient.block_geometry(),
            "registers": {k: v for k, v in registers.items()
                          if "rc_multistep" in k}}


def same_events(a, b) -> bool:
    return all(events_identical(getattr(a, f), getattr(b, f))
               for f in ("t_fire_ns", "t_sense_ns", "t_restore_ns",
                         "t_precharge_ns", "trc_ns", "dv_sense_v"))


# --------------------------------------------------------------------------
# strap_attend and the LM server
# --------------------------------------------------------------------------

def strap_case(rng, b, p, page, hkv, d, hq, g, dev, dtype, shift=False):
    """Random pages and a strap selection with, where the shape allows, a
    masked strap and a partial length (row 0), a duplicated id (last row)
    and an all-masked row (row 1); with `shift`, K and V start one element
    past a 16-byte boundary (contiguous, but not 16-byte aligned)."""
    import numpy as np
    import torch

    s = p // g
    q, k, v = (torch.as_tensor(rng.normal(size=shape).astype(np.float32),
                               device=dev).to(dtype)
               for shape in ((b, hq, d), (b, p, page, hkv, d),
                             (b, p, page, hkv, d)))
    if shift:
        bufs = [torch.empty(x.numel() + 1, dtype=dtype, device=dev)
                for x in (k, v)]
        k, v = (buf[1:].view(x.shape).copy_(x) for buf, x in zip(bufs, (k, v)))
    ids = np.stack([rng.permutation(s) for _ in range(b)])
    lengths = np.full(b, p * page)
    if s > 1:
        ids[0, -1] = -1
        lengths[0] = p * page - page * g // 2 - 1
        ids[-1, 0] = ids[-1, 1]
    if b > 1:
        ids[1] = -1
    as_i32 = lambda x: torch.as_tensor(np.asarray(x, np.int32), device=dev)
    return (q, k, v, as_i32(ids), g), {"lengths": as_i32(lengths)}


def strap_compare(ops_mod, args, kwargs, out_k, tol) -> dict:
    """A strap_attend result of the kernel against the plain version on
    the same inputs, at rtol = atol = `tol` and, in bf16, also within two
    bf16 ulps of the plain output plus 1e-3; returns max |kernel - plain|
    and the plain output's scale (max and RMS of its magnitude)."""
    import torch

    out_p = ops_mod.strap_attend(*args, **{**kwargs, "backend": "ref"})
    check(out_k.dtype == out_p.dtype == args[0].dtype,
          f"strap_attend output dtype {out_k.dtype}")
    plain = out_p.float().abs()
    err = (out_k.float() - out_p.float()).abs()
    res = {"max_abs_err": err.max().item(), "plain_abs_max": plain.max().item(),
           "plain_rms": plain.square().mean().sqrt().item()}
    bars = [(tol, tol)]
    if out_p.dtype == torch.bfloat16:
        bars.append((STRAP_BF16_ULP_RTOL, STRAP_BF16_ULP_ATOL))
    check(bool(torch.isfinite(out_k).all().item()),
          "strap_attend kernel gave non-finite values")
    for rtol, atol in bars:
        check(bool((err <= atol + rtol * plain).all().item()),
              f"strap_attend kernel outside rtol {rtol} / atol {atol} of its "
              f"plain version ({res}, shape {tuple(args[1].shape)})")
    return res


def strap_bound_ms(q, k_pages, strap_ids, pages_per_strap, lengths):
    """The least time the card could take for one strap_attend call: the
    bytes it must move (q and the output, the ids and lengths, and the K
    and V rows of the valid tokens of the selected straps, each once) over
    the HBM rate, or its operations (a multiply-add against K and one
    against V per query head, element and valid token; exp, max and sum
    per query head and token) over the peak rate for the inputs' type."""
    import torch

    b, p, page, hkv, d = k_pages.shape
    hq = q.shape[1]
    blk = pages_per_strap * page
    ids = strap_ids.long()
    valid = (ids >= 0) & (ids < p // pages_per_strap)
    start = ids.clamp(min=0) * blk
    n_tok = torch.where(valid, (lengths.long()[:, None] - start).clamp(0, blk),
                        0)
    tokens = int(n_tok.sum().item())
    elt = k_pages.element_size()
    n_bytes = (2 * tokens * hkv * d * elt + 2 * q.numel() * q.element_size()
               + 4 * (strap_ids.numel() + lengths.numel()))
    n_ops = tokens * hq * (4 * d + 3)
    peak = BF16_PEAK_OPS if q.dtype == torch.bfloat16 else F32_PEAK_OPS
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), {
        "bytes": n_bytes, "ops": n_ops, "tokens": tokens}


def sdpa_forms(args, kwargs) -> dict:
    """The selected straps' tokens gathered as SDPA operands, gathered
    outside the library call's timing, in the forms SDPA's backends take:
    q (B, Hq, 1, D) and K, V (B, Hkv, S*blk, D) under a boolean valid-token
    mask with `enable_gqa`; K and V repeated per query head under an
    additive float mask; and, where the valid tokens are one common prefix
    of every row (exact mode with equal lengths), K and V cut to it with no
    mask.  Returns {form: (operands, keyword arguments)}."""
    import torch

    q, k_pages, v_pages, strap_ids, g = args
    lengths = kwargs["lengths"]
    b, p, page, hkv, d = k_pages.shape
    grp = q.shape[1] // hkv
    blk = g * page
    ids = strap_ids.long()
    valid = (ids >= 0) & (ids < p // g)
    safe = torch.where(valid, ids, 0)
    rows = torch.arange(b, device=q.device)[:, None]
    gather = lambda x: x.reshape(b, p // g, blk, hkv, d)[rows, safe].reshape(
        b, -1, hkv, d).transpose(1, 2).contiguous()
    tok = safe[..., None] * blk + torch.arange(blk, device=q.device)
    ok = (valid[..., None] & (tok < lengths.long()[:, None, None])).reshape(
        b, 1, 1, -1)
    qs, ks, vs = q[:, :, None, :].contiguous(), gather(k_pages), gather(v_pages)
    additive = torch.zeros(ok.shape, dtype=q.dtype, device=q.device)
    forms = {
        "bool_mask_gqa": ((qs, ks, vs), {"attn_mask": ok, "enable_gqa": True}),
        "float_mask_repeated_kv": (
            (qs, ks.repeat_interleave(grp, 1), vs.repeat_interleave(grp, 1)),
            {"attn_mask": additive.masked_fill(~ok, float("-inf"))})}
    n_valid = ok.reshape(b, -1).sum(-1)
    cut = int(n_valid[0].item())
    if bool((n_valid == cut).all().item()) and bool(ok[..., :cut].all().item()):
        forms["valid_prefix_gqa"] = ((qs, ks[:, :, :cut], vs[:, :, :cut]),
                                     {"enable_gqa": True})
    return forms


def sdpa_library(calls, outs) -> dict:
    """`F.scaled_dot_product_attention` on the gathered selected tokens of
    `calls`, in each operand form (`sdpa_forms`) under each backend forced
    in turn (`sdpa_kernel`): ms per call (the device time of its kernels,
    and CUDA events around the calls), max |SDPA - kernel| and whether
    it is within the reference's bf16 bar, or why the backend refused the
    form.  Also the form the dispatcher gets by default, with the kernels
    a profiled call of it runs, which name the backend it picked."""
    import warnings

    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from repro_torch.kernels.bench import cuda_ms, device_ms, profile

    n = len(calls)
    per_call = [sdpa_forms(a, kw) for a, kw in calls]
    res = {}
    for form in per_call[0]:
        def run(form=form):
            return [F.scaled_dot_product_attention(*x[form][0], **x[form][1])
                    for x in per_call]

        for backend in SDPA_BACKENDS:
            key = f"{form}/{backend.lower()}"
            try:
                with warnings.catch_warnings(), sdpa_kernel(
                        getattr(SDPBackend, backend)):
                    warnings.simplefilter("ignore")
                    got = run()                           # also the warm-up
                    ms = cuda_ms(run, 5)[0] / n
            except RuntimeError as exc:                   # form not taken
                res[key] = {"runs": False,
                            "why": (str(exc).splitlines() or [""])[0][:160]}
                continue
            errs = [(x[:, :, 0].float() - o.float()).abs()
                    for x, o in zip(got, outs)]
            within = all(bool((e <= STRAP_BF16_TOL + STRAP_BF16_TOL
                               * o.float().abs()).all().item())
                         for e, o in zip(errs, outs))
            with warnings.catch_warnings(), sdpa_kernel(
                    getattr(SDPBackend, backend)):
                warnings.simplefilter("ignore")
                dev_ms = device_ms(run, n)
            res[key] = {"runs": True, "ms": dev_ms, "ms_events": ms,
                        "max_abs_err": max(e.max().item() for e in errs),
                        "within_bf16_bar": within}
    default = per_call[-1]["bool_mask_gqa"]
    res["default_dispatch"] = {
        "form": "bool_mask_gqa",
        "ms": cuda_ms(lambda: [F.scaled_dot_product_attention(
            *x["bool_mask_gqa"][0], **x["bool_mask_gqa"][1])
            for x in per_call], 5)[0] / n,
        "profile": profile(lambda: F.scaled_dot_product_attention(
            *default[0], **default[1]))}
    return res


def strap_line(kernel, ops_mod, backend_calls, launches, max_err,
               registers) -> dict:
    """The kernels-line entry of strap_attend, timed at the full-width
    path's last exact-mode decode step: its calls for all layers in turn
    (28 distinct caches, 0.5 GB, so L2 holds none of them between
    launches, as on the path).  `library_ms` is the fastest SDPA backend
    and operand form that agrees with the kernel at the bf16 bar; the
    kernel is also timed on the first 1, 2, 4 and 8 rows of the batch
    (36 to 288 split blocks) and at the gated engine's last step.  Times
    are the device time of the kernels (torch.profiler), beside CUDA
    events around the calls, which on a slow host measure the host."""
    from repro_torch.kernels import strap_gather
    from repro_torch.kernels.bench import (cuda_ms, device_ms,
                                           device_ms_by_kernel)

    layer_calls = backend_calls["strap_exact"]
    calls = [(a, kw) for a, kw, _ in layer_calls]
    n = len(calls)

    def each(fn):
        return lambda: [fn(a, kw) for a, kw in calls]

    run_kernel = each(lambda a, kw: kernel(*a, lengths=kw["lengths"]))
    run_plain = each(lambda a, kw: ops_mod.strap_attend(
        *a, **{**kw, "backend": "ref"}))
    ms_events = cuda_ms(run_kernel, 5)[0] / n
    ms_by_kernel = device_ms_by_kernel(run_kernel, n)
    ms = sum(ms_by_kernel.values())
    plain_events = cuda_ms(run_plain, 2)[0] / n
    plain_ms = device_ms(run_plain, n)
    by_rows = {}
    for r in (1, 2, 4, 8):
        sub = [((a[0][:r], a[1][:r], a[2][:r], a[3][:r], a[4]),
                kw["lengths"][:r]) for a, kw in calls]
        by_rows[str(r)] = device_ms(lambda sub=sub: [
            kernel(*a, lengths=ln) for a, ln in sub], n)
    library = sdpa_library(calls, [out for _, _, out in layer_calls])
    agreeing = {k: v for k, v in library.items()
                if v.get("runs") and v.get("within_bf16_bar")}
    check(bool(agreeing), f"no SDPA backend computes strap_attend's "
          f"function within the bf16 bar: {library}")
    best = min(agreeing, key=lambda k: agreeing[k]["ms"])
    gated = [(a, kw) for a, kw, _ in backend_calls["strap_gated_top4"]]
    gated_ms = device_ms(lambda: [kernel(*a, lengths=kw["lengths"])
                                  for a, kw in gated], len(gated))
    ga, gkw = gated[-1]
    gated_bound = strap_bound_ms(ga[0], ga[1], ga[3], ga[4], gkw["lengths"])
    a, kw = calls[-1]
    b_ms, b_by, work = strap_bound_ms(a[0], a[1], a[3], a[4], kw["lengths"])
    plan = strap_gather.split_plan(a[1].shape, a[4], a[3].shape[1])
    return {"name": "strap_attend", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/strap_attend.cu",
            "replaces": "src/repro/kernels/strap_gather.py:101",
            "launches": launches, "max_abs_err": max_err,
            "max_abs_err_unit": "attention output (bf16 on the path)",
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": agreeing[best]["ms"],
            "timing": "ms, plain_ms, library_ms, ms_by_rows, gated_top4_ms: "
                      "device time of the call's kernels (torch.profiler); "
                      "*_events: CUDA events around the calls, which also "
                      "count the card's idle time while the host enqueues",
            "ms_events": ms_events, "plain_ms_events": plain_events,
            "library_ms_events": agreeing[best]["ms_events"],
            "ms_by_kernel": {k[:80]: v for k, v in ms_by_kernel.items()},
            "library_call": "F.scaled_dot_product_attention on the gathered "
                            f"selected tokens, {best}",
            "library_max_abs_err": agreeing[best]["max_abs_err"],
            "library_by_backend": library, "ms_by_rows": by_rows,
            "device_kernels_per_call": len(ms_by_kernel),
            "split_plan": plan._asdict(),
            "gated_top4_ms": gated_ms, "gated_top4_bound_ms": gated_bound[0],
            "gated_top4_work": gated_bound[2],
            "registers": {k: v for k, v in registers.items()
                          if "strap_" in k},
            "shape": {"q": list(a[0].shape), "pages": list(a[1].shape),
                      "strap_ids": list(a[3].shape)},
            "bound_work": work, "timed_calls": n}


def strap_kernel_phase(ops_mod, rng, dev) -> tuple[dict, float]:
    """strap_attend kernel vs plain version: float32 at every test shape,
    bf16 at Qwen2-1.5B's decode shape and at the shapes that reach the
    kernel's other branches, and both dtypes with pages off a 16-byte
    boundary (element copies)."""
    import torch

    from repro_torch.kernels import strap_gather

    res, worst = {}, 0.0
    f32, bf16 = (torch.float32, STRAP_F32_TOL), (torch.bfloat16,
                                                 STRAP_BF16_TOL)
    cases = [(shape, *f32, False) for shape in STRAP_SHAPES]
    cases.append(((8, 36, 64, 2, 128, 12, 4), *bf16, False))
    cases += [(shape, *bf16, False) for shape in STRAP_BRANCH_SHAPES]
    cases += [(STRAP_UNALIGNED_SHAPE, *dt, True) for dt in (f32, bf16)]
    for shape, dtype, tol, shift in cases:
        args, kw = strap_case(rng, *shape, dev, dtype, shift)
        vec = strap_gather.vector_loads(args[1], args[2])
        check(not (shift or shape[4] == 30) or not vec,
              f"strap case {shape}: expected element copies")
        out_k = ops_mod.strap_attend(*args, **kw, backend="cuda")
        cmp = strap_compare(ops_mod, args, kw, out_k, tol)
        if shape[0] > 1:
            check(not bool(out_k[1].any().item()),
                  "an all-masked row is not zeros")
        key = ("x".join(map(str, shape)) + "_" + str(dtype).split(".")[-1]
               + ("_unaligned" if shift else ""))
        res[key] = {**cmp, "vector_loads": vec}
        if dtype == torch.float32:
            worst = max(worst, cmp["max_abs_err"])
        log(f"[strap-vs-plain] {key}: {json.dumps(cmp)}")
    return res, worst


def smoke_engine_phase(dev) -> dict:
    """qwen2-1.5b-smoke (float32) on the card: the strap-exact engine gives
    the dense engine's greedy tokens (the reference's claim,
    tests/test_strap_cache.py)."""
    import numpy as np
    import torch

    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels import strap_gather
    from repro_torch.memory.strap_cache import StrapCacheConfig
    from repro_torch.models import registry as models
    from repro_torch.serving.engine import ServeEngine

    cfg = get_arch(LM_ARCH + "-smoke")
    params = models.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                                device=dev)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 32))
    out, launches = {}, {}
    for backend in ("dense", "strap"):
        eng = ServeEngine(cfg, params, max_tokens=48, cache_backend=backend,
                          strap_cfg=StrapCacheConfig(8, 2), device=dev)
        strap_gather.strap_attend_cuda.launches = 0
        eng.prefill(prompts)
        out[backend] = torch.cat([eng.step()[0] for _ in range(6)], 1)
        torch.cuda.synchronize()
        launches[backend] = strap_gather.strap_attend_cuda.launches
    check(launches == {"dense": 0, "strap": cfg.n_layers * 6},
          f"smoke engine launches {launches}")
    check(torch.equal(out["dense"], out["strap"]),
          "smoke: strap-exact tokens differ from dense")
    log(f"[serve-smoke] {cfg.name}: strap-exact == dense greedy tokens "
        f"{out['dense'].tolist()}; launches {launches}")
    return {"tokens": out["dense"].tolist(), "launches": launches}


def serve_phase(args, ops_mod, strap_kernel, dev) -> tuple[dict, dict]:
    """The LM server at full width: `ServeEngine.generate` with each
    backend (the main path, launches counted), every strap_attend call of
    it held against the plain version, a timed true-greedy decode
    (`step()` with no token), the strap engines teacher-forced with the
    dense engine's tokens, and one decode step under the profiler.
    Returns the record and each strap backend's calls of the last step."""
    import numpy as np
    import torch

    from repro_torch.configs.registry import get_arch
    from repro_torch.memory.strap_cache import StrapCacheConfig
    from repro_torch.models import registry as models
    from repro_torch.kernels.bench import cuda_ms, profile
    from repro_torch.models.common import lm_logits
    from repro_torch.serving.engine import ServeEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    precision = {
        "matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
        "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
        "matmul.allow_bf16_reduced_precision_reduction":
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction}
    log(f"[serve] precision: {json.dumps(precision)}")
    cfg = get_arch(LM_ARCH)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = models.init_params(
        cfg, torch.Generator(device=dev).manual_seed(args.seed), device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    leaves = [params["embed"], params["final_w"],
              *params["layers"].values()]
    n_params = sum(t.numel() for t in leaves)
    param_bytes = sum(t.numel() * t.element_size() for t in leaves)
    check(params["embed"].dtype == torch.bfloat16, "params are not bf16")
    log(f"[serve] {cfg.name}: {n_params:,} params ({param_bytes / 1e9:.3f} "
        f"GB bf16) initialised on the card in {init_s:.2f} s")
    prompts = np.random.default_rng(args.seed).integers(
        0, cfg.vocab_size, (LM_B, LM_PROMPT)).astype(np.int32)
    record = {"arch": cfg.name, "precision": precision, "init_s": init_s,
              "n_params": n_params, "param_bytes": param_bytes,
              "batch": LM_B, "prompt": LM_PROMPT, "new_tokens": LM_NEW,
              "max_tokens": LM_MAX, "backends": {}}
    sync = torch.cuda.synchronize
    dense_tokens = dense_logits = None
    line_calls = {}
    worst = 0.0
    for label, backend, top in LM_BACKENDS:
        eng = ServeEngine(cfg, params, max_tokens=LM_MAX,
                          cache_backend=backend,
                          strap_cfg=StrapCacheConfig(top_straps=top),
                          device=dev)
        # the main path: generate, through the entry point, launches counted
        strap_kernel.launches = 0
        with recording(ops_mod, "strap_attend", outputs=True) as calls:
            sync()
            t0 = time.perf_counter()
            out = eng.generate(prompts, LM_NEW)
            sync()
            gen_s = time.perf_counter() - t0
        launches = strap_kernel.launches
        want = cfg.n_layers * LM_NEW if backend == "strap" else 0
        check(launches == want == len(calls),
              f"{label}: {launches} strap_attend launches, {len(calls)} "
              f"calls, expected {want}")
        check(tuple(out.shape) == (LM_B, LM_NEW) and int(out.min()) >= 0
              and int(out.max()) < cfg.vocab_size, f"{label}: tokens {out}")
        stats = dataclasses.asdict(eng.stats)
        stats["traffic_reduction"] = eng.stats.traffic_reduction
        check(stats["tokens_decoded"] == LM_B * LM_NEW, f"{label}: {stats}")
        cmps = [strap_compare(ops_mod, a, kw, o, STRAP_BF16_TOL)
                for a, kw, o in calls]
        call_err = max((c["max_abs_err"] for c in cmps), default=0.0)
        plain_scale = {
            "abs_max": max((c["plain_abs_max"] for c in cmps), default=None),
            "rms_min": min((c["plain_rms"] for c in cmps), default=None),
            "rms_max": max((c["plain_rms"] for c in cmps), default=None)}
        worst = max(worst, call_err)
        if backend == "strap":
            line_calls[label] = calls[-cfg.n_layers:]
        del calls
        # a true greedy decode (step() with no token), timed step by step
        sync()
        t0 = time.perf_counter()
        eng.prefill(prompts)
        sync()
        prefill_s = time.perf_counter() - t0
        steps, toks, logits = [], [], []
        for _ in range(LM_NEW):
            t0 = time.perf_counter()
            tok, lg = eng.step()
            sync()
            steps.append((time.perf_counter() - t0) * 1e3)
            toks.append(tok)
            logits.append(lg)
        toks = torch.cat(toks, 1)
        check(all(bool(torch.isfinite(x).all().item()) for x in logits),
              f"{label}: non-finite logits")
        step_ms = statistics.median(steps)
        res = {"generate_s": gen_s, "launches": launches, "stats": stats,
               "max_abs_err_vs_plain": call_err if backend == "strap"
               else None, "plain_output_scale": plain_scale if
               backend == "strap" else None, "prefill_s": prefill_s,
               "decode_step_ms_median": step_ms, "decode_step_ms": steps,
               "decode_tokens_per_s": LM_B / (step_ms / 1e3),
               "generate_tokens_per_s": LM_B * LM_NEW / gen_s,
               "generate_tokens": out[:, 0].tolist()}
        # one decode step under the profiler (two more steps of room)
        res["profile"] = profile(lambda: eng.step())
        if backend == "dense":
            dense_tokens, dense_logits = toks, logits
        else:
            eng.prefill(prompts)
            d_max, agree = [], []
            for i in range(LM_NEW):
                _, lg = eng.step(dense_tokens[:, i:i + 1])
                d_max.append((lg - dense_logits[i]).abs().max().item())
                agree.append((lg.argmax(-1) == dense_logits[i].argmax(-1))
                             .float().mean().item())
            res["teacher_forced_vs_dense"] = {
                "max_abs_dlogits": max(d_max), "per_step": d_max,
                "greedy_agreement": statistics.mean(agree),
                "logit_scale": dense_logits[0].abs().max().item()}
            res["free_greedy_agreement_vs_dense"] = (
                toks == dense_tokens).float().mean().item()
        record["backends"][label] = res
        log(f"[serve] {label}: " + json.dumps(
            {k: v for k, v in res.items() if k not in ("decode_step_ms",)}))
        del eng
    # what lm_logits' float32 cast of the tied table costs a step
    h = torch.zeros(LM_B, 1, cfg.d_model, dtype=torch.bfloat16, device=dev)
    record["lm_logits_ms"] = cuda_ms(lambda: lm_logits(cfg, params, h), 10)[0]
    record["embed_cast_ms"] = cuda_ms(lambda: params["embed"].float(), 10)[0]
    record["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    record["max_abs_err_vs_plain"] = worst
    log(f"[serve] lm_logits {record['lm_logits_ms']:.3f} ms a step, of which "
        f"the float32 cast of the table {record['embed_cast_ms']:.3f} ms; "
        f"peak memory {record['peak_memory_gb']:.2f} GB")
    del params
    return record, line_calls


# --------------------------------------------------------------------------
# main
# --------------------------------------------------------------------------

# --------------------------------------------------------------------------
# the co-design service, its CLI and the example twin
# --------------------------------------------------------------------------

def load_example():
    """`examples/dram_codesign_torch.py` as a module (examples/ is not a
    package)."""
    import importlib.util

    path = ROOT / "examples" / "dram_codesign_torch.py"
    check(path.is_file(), f"{path} is missing")
    spec = importlib.util.spec_from_file_location("dram_codesign_torch", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def captured(fn) -> tuple[object, str]:
    """`fn()` with its standard output captured: (result, text)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn()
    return out, buf.getvalue()


def sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def example_phase(dev, kernel) -> dict:
    """`examples/dram_codesign_torch.py --smoke` on the card: the paper's
    selected design, through the row-cycle kernel."""
    example = load_example()
    kernel.launches = 0
    t0 = time.perf_counter()
    rc, text = captured(lambda: example.main(["--smoke", "--device",
                                              dev.type]))
    sync(dev)
    wall_s = time.perf_counter() - t0
    launches = kernel.launches
    check(rc == 0, f"the example twin returned {rc}")
    check(launches > 0, "the example twin launched no row-cycle kernel")
    selected = [ln.strip() for ln in text.splitlines()
                if ln.strip().startswith("aos / sel_strap @ 87 layers")]
    check(selected and selected[0].startswith(
        "aos / sel_strap @ 87 layers -> 2.60 Gb/mm2, tRC 10.50 ns"),
        f"the example twin selected {selected}")
    check("sweeping design space (25 design points" in text,
          "the example twin's smoke grid is not 25 points")
    log(f"[example] dram_codesign_torch.py --smoke: {launches} row-cycle "
        f"launch(es), {wall_s:.2f} s; selected {selected[0]}")
    return {"launches": launches, "wall_s": wall_s, "selected": selected[0]}


def service_phase(dev, kernel, mc_space) -> dict:
    """The co-design service on the card (the slice's main path): two
    concurrent clients (a sweep and a yield query) in one window, one
    dispatch and one row-cycle launch, the responses bit-identical to
    direct sweeps; a repeat answered from the memo with no launch; the
    background dispatcher; a 6 x 4 client stress run; `sweep_stream` of
    the paper grid; and the 299,008-row yield query served in one window,
    bit-identical to the direct sweep."""
    import threading

    import torch

    from repro_torch.core import calibration as cal
    from repro_torch.core import dse
    from repro_torch.core.batch import DesignBatch
    from repro_torch.core.space import DesignSpace
    from repro_torch.kernels.bench import profile
    from repro_torch.launch.serve import _batches_identical
    from repro_torch.serving.dse_service import DSEService

    out: dict = {}

    def join_all(threads):
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120.0)
        check(not any(t.is_alive() for t in threads), "a client hung")

    svc = DSEService(window_ms=3.0, device=dev)
    t0 = time.perf_counter()
    svc.warm()
    sync(dev)
    out["warm_s"] = time.perf_counter() - t0

    # two concurrent clients, one window
    s_sweep = DesignSpace.product(techs=["aos"], layers=(4, 8, 16))
    s_yield = DesignSpace.paper_targets().with_mc(samples=32, key=1)
    before = svc.stats()
    barrier = threading.Barrier(2)
    futures = {}

    def client(name, submit):
        barrier.wait(timeout=60.0)
        futures[name] = submit()

    join_all([threading.Thread(target=client, args=(
                  "sweep", lambda: svc.submit(s_sweep))),
              threading.Thread(target=client, args=(
                  "yield", lambda: svc.submit(
                      s_yield, kind="yield", spec={"margin_mv": 5.0})))])
    check(len(futures) == 2, "a client did not submit")
    sync(dev)
    kernel.launches = 0
    t0 = time.perf_counter()
    served = svc.flush()
    sync(dev)
    window_ms = (time.perf_counter() - t0) * 1e3
    window_launches = kernel.launches
    after = svc.stats()
    check(served == 2, f"the window served {served} requests")
    check(after["windows"] - before["windows"] == 1, "expected one window")
    check(after["dispatches"] - before["dispatches"] == 1,
          "two concurrent clients did not share one dispatch")
    check(window_launches == 1, f"the window launched the row-cycle kernel "
          f"{window_launches} times, expected 1")
    r_sweep = futures["sweep"].result(timeout=60.0)
    r_yield = futures["yield"].result(timeout=60.0)
    check(_batches_identical(r_sweep.batch, dse.sweep(s_sweep, device=dev)),
          "served sweep differs from the direct sweep")
    check(_batches_identical(r_yield.batch, dse.sweep(s_yield, device=dev)),
          "served yield batch differs from the direct sweep")
    check(r_yield.summary is not None
          and "yield_frac" in r_yield.summary.corners,
          "the yield query returned no summary")
    rows = after["rows"]["dispatched"] - before["rows"]["dispatched"]
    log(f"[service] 2 clients: 1 window, 1 dispatch, {window_launches} "
        f"row-cycle launch, {rows} packed rows, {window_ms:.3f} ms "
        "(host clock, synchronized); responses == direct sweeps, bit for bit")
    out["window"] = {"launches": window_launches, "rows": rows,
                     "ms": window_ms}

    # a repeat: answered from the memo, no launch
    kernel.launches = 0
    f_again = svc.submit(s_sweep)
    svc.flush()
    sync(dev)
    r_again = f_again.result(timeout=60.0)
    check(r_again.memo_hit and kernel.launches == 0,
          f"repeat: memo_hit {r_again.memo_hit}, {kernel.launches} launches")
    check(svc.stats()["dispatches"] == after["dispatches"],
          "the repeat re-dispatched")
    check(_batches_identical(r_again.batch, r_sweep.batch),
          "the memo hit returned a different batch")
    log("[service] repeat: memo hit, 0 launches")
    out["repeat_launches"] = kernel.launches

    # the background dispatcher, live
    with DSEService(window_ms=3.0, device=dev) as bg:
        live = bg.sweep(s_sweep, timeout=60.0)
        check(bg._dispatcher_running(), "the dispatcher is not running")
    check(_batches_identical(live, r_sweep.batch),
          "the dispatcher thread's result differs")
    log("[service] background dispatcher served a blocking client")

    # 6 clients x 4 queries against the live dispatcher
    spaces = (DesignSpace.product(techs=["aos"], layers=(87, 137)),
              DesignSpace.product(techs=["si"], layers=(87,)),
              DesignSpace.product(techs=["d1b"], layers=(87,)))
    golden = [dse.sweep(s, device=dev) for s in spaces]
    n_clients, n_iters = 6, 4
    results = [[] for _ in range(n_clients)]
    errors = []
    barrier = threading.Barrier(n_clients)

    def hammer(i, service):
        try:
            barrier.wait(timeout=60.0)
            for j in range(n_iters):
                k = (i + j) % len(spaces)
                results[i].append((k, service.sweep(spaces[k],
                                                    timeout=120.0)))
        except Exception as e:
            errors.append(repr(e))

    t0 = time.perf_counter()
    with DSEService(window_ms=2.0, memo_entries=64, device=dev) as stress:
        join_all([threading.Thread(target=hammer, args=(i, stress))
                  for i in range(n_clients)])
        st = stress.stats()
    stress_s = time.perf_counter() - t0
    check(errors == [], f"stress errors {errors}")
    check(all(_batches_identical(b, golden[k])
              for per in results for k, b in per)
          and all(len(per) == n_iters for per in results),
          "a stress response differs from the direct sweep")
    total = n_clients * n_iters
    memo = st["memo"]
    check(st["requests"] == total
          and memo["hits"] + memo["misses"] + memo["coalesced"] == total
          and memo["misses"] >= len(spaces) and st["queued"] == 0
          and st["errors"] == 0 and st["dispatches"] >= 1,
          f"stress counters do not reconcile: {json.dumps(st)}")
    log(f"[service] stress {n_clients}x{n_iters}: {json.dumps(st)} "
        f"({stress_s:.2f} s)")
    out["stress"] = st

    # sweep_stream of the paper grid concatenates to the monolithic sweep
    grid = DesignSpace.paper_grid()
    chunks = list(svc.sweep_stream(grid, chunk_rows=16))
    merged = DesignBatch.concat([c.response.batch for c in chunks])
    check(len(chunks) > 1 and _batches_identical(
        merged, dse.sweep(grid, device=dev)),
        "sweep_stream of the paper grid differs from the monolithic sweep")
    log(f"[service] sweep_stream(paper_grid, 16 rows): {len(chunks)} "
        "chunks == the monolithic sweep, bit for bit")
    out["stream_chunks"] = len(chunks)

    # the 299,008-row yield query, served in one window, against the
    # direct sweep of the same space, in turns (served, direct, ...)
    spec = {"margin_mv": cal.MIN_FUNCTIONAL_MARGIN_MV}
    runs = {"served": [], "direct": []}
    served_launches, windows = [], []
    rows = len(mc_space)
    for _ in range(REPEATS):
        fresh = DSEService(window_ms=0.0, device=dev)
        sync(dev)
        kernel.launches = 0
        t0 = time.perf_counter()
        resp = fresh.query_yield(mc_space, timeout=600.0, **spec)
        sync(dev)
        runs["served"].append((time.perf_counter() - t0) * 1e3)
        served_launches.append(kernel.launches)
        st = fresh.stats()
        windows.append((st["windows"], st["dispatches"]))
        t0 = time.perf_counter()
        want = dse.sweep(mc_space, device=dev)
        want_summary = want.mc_summary(**spec)
        sync(dev)
        runs["direct"].append((time.perf_counter() - t0) * 1e3)
        check(len(resp.batch) == rows and _batches_identical(resp.batch,
                                                             want),
              "the served 299,008-row batch differs from the direct sweep")
        check(_batches_identical(resp.summary, want_summary),
              "the served yield summary differs from the direct one")
        check(bool(torch.isfinite(resp.summary.corners["yield_frac"]).all()),
              "a non-finite yield fraction")
        del resp, want, want_summary
    check(served_launches == [1] * REPEATS and windows == [(1, 1)] * REPEATS,
          f"the {rows}-row query: launches {served_launches}, "
          f"(windows, dispatches) {windows}")

    def served_once():
        return DSEService(window_ms=0.0, device=dev).query_yield(
            mc_space, timeout=600.0, **spec)

    def direct_once():
        return dse.sweep(mc_space, device=dev).mc_summary(**spec)

    out["mc_yield"] = {"rows": rows, "launches": served_launches,
                       "served_ms": runs["served"],
                       "direct_ms": runs["direct"],
                       "served_profile": profile(served_once),
                       "direct_profile": profile(direct_once)}
    log(f"[service] {rows}-row yield query: 1 window, 1 launch each; "
        "served " + " / ".join(f"{x:.2f}" for x in runs["served"])
        + " ms, direct sweep + mc_summary "
        + " / ".join(f"{x:.2f}" for x in runs["direct"])
        + " ms (in turns, host clock, synchronized); batch and summary "
        "bit-identical")
    for key in ("served_profile", "direct_profile"):
        log(f"[profile] {key}: {json.dumps(out['mc_yield'][key])}")
    out["stats"] = svc.stats()
    log(f"[service] stats(): {json.dumps(out['stats'])}")
    return out


def cli_phase(dev, kernel) -> dict:
    """`python -m repro_torch.launch.serve --smoke` on the card, in this
    process (`serve.main`)."""
    from repro_torch.launch import serve

    kernel.launches = 0
    t0 = time.perf_counter()
    rc, text = captured(lambda: serve.main(["--smoke", "--device",
                                            dev.type]))
    sync(dev)
    wall_s = time.perf_counter() - t0
    launches = kernel.launches
    check(rc == serve.EXIT_OK, f"serve --smoke returned {rc}")
    check(text.rstrip().endswith("serve smoke: OK"),
          f"serve --smoke printed {text[-200:]!r}")
    check(launches > 0, "serve --smoke launched no row-cycle kernel")
    for line in text.splitlines():
        log(f"[cli] {line}")
    log(f"[cli] {launches} row-cycle launch(es), {wall_s:.2f} s")
    return {"launches": launches, "wall_s": wall_s}


# --------------------------------------------------------------------------
# the sweep fabric
# --------------------------------------------------------------------------

def fabric_phase(dev, kernel, mc_space, mc_batch, mc_mask) -> dict:
    """The multi-GPU sweep fabric on the card (`launch.mesh`, `.shard`,
    `.elastic`, `.multiproc`), every result held bit for bit (int32
    views) against phase 5's 299,008-row batch and Pareto mask or against
    the sequential sweep of its space: the sweep over every card's slot
    and over 4 slots on one card (one launch a slot, timed in turns with
    the direct sweep), a replica MC space over 3 slots, the Pareto mask
    over 4 slots, the elastic host drop and fault pile-up over 8 slots,
    an NCCL group of one rank, two gloo processes sharing the card, and
    the shard and example CLIs."""
    import os
    import tempfile

    import torch
    import torch.distributed as dist

    from repro_torch.core import dse
    from repro_torch.core.space import DesignSpace
    from repro_torch.launch import elastic, shard
    from repro_torch.launch.mesh import make_sweep_mesh, make_test_mesh
    from repro_torch.runtime.fault import FailureInjector

    out: dict = {}
    rows = len(mc_space)

    def equal(batch, want, what):
        bad = shard.batch_mismatches(batch, want)
        check(bad == [], f"{what}: differs from the sequential sweep in {bad}")

    def timed(fn):
        sync(dev)
        kernel.launches = 0
        t0 = time.perf_counter()
        res = fn()
        sync(dev)
        return (time.perf_counter() - t0) * 1e3, kernel.launches, res

    # 1-2. the 299,008-row sweep over every card's slot and over 4 slots
    #      on one card, in turns with the direct sweep (the first round
    #      warms up)
    mesh_all = make_sweep_mesh(device=dev)
    mesh4 = make_test_mesh((4,), ("batch",), device=dev)
    modes = {"direct": lambda: dse.sweep(mc_space, device=dev),
             "sharded_1slot": lambda: dse.sweep(mc_space, sharding=mesh_all,
                                                device=dev),
             "sharded_4slot": lambda: dse.sweep(mc_space, sharding=mesh4,
                                                device=dev)}
    runs = {m: [] for m in modes}
    launches = {m: [] for m in modes}
    for rep_i in range(REPEATS + 1):
        for mode, fn in modes.items():
            ms, n, batch = timed(fn)
            equal(batch, mc_batch, f"{mode} sweep of {rows} rows")
            del batch
            if rep_i:
                runs[mode].append(ms)
                launches[mode].append(n)
    want = {"direct": 1, "sharded_1slot": mesh_all.size, "sharded_4slot": 4}
    for mode, n in want.items():
        check(launches[mode] == [n] * REPEATS, f"{mode}: {launches[mode]} "
              f"row-cycle launches a run, expected {n}")
    out["mesh_all_slots"] = mesh_all.size
    out["sweeps"] = {m: {"ms": runs[m], "median_ms": statistics.median(
        runs[m]), "launches": launches[m][0]} for m in modes}
    log(f"[fabric] {rows}-row sweep, in turns (host clock, synchronized): "
        + "; ".join(f"{m} " + " / ".join(f"{x:.2f}" for x in runs[m])
                    + f" ms, {launches[m][0]} launch(es)" for m in modes)
        + "; every batch == phase 5's, bit for bit")
    if dev.type == "cuda":
        from repro_torch.kernels.bench import profile
        for mode, fn in modes.items():
            out["sweeps"][mode]["profile"] = profile(fn)
            log(f"[profile] {mode} sweep: "
                + json.dumps(out["sweeps"][mode]["profile"]))

    # 3. a replica MC space over 3 slots
    rep_space = DesignSpace.paper_targets().with_replica().with_mc(16, key=0)
    ms, n, batch = timed(lambda: dse.sweep(
        rep_space, sharding=make_test_mesh((3,), ("batch",), device=dev),
        device=dev))
    equal(batch, dse.sweep(rep_space, device=dev), "replica MC, 3 slots")
    check(n == 3, f"replica MC over 3 slots: {n} launches")
    out["replica_3slot"] = {"rows": len(batch), "launches": n, "ms": ms}
    log(f"[fabric] replica MC ({len(batch)} points) over 3 slots: {n} "
        f"launches, {ms:.2f} ms, == its sequential sweep")

    # 4. the Pareto mask over 4 slots
    ms, _, mask = timed(lambda: dse.pareto_mask(mc_batch, sharding=mesh4))
    check(torch.equal(mask, mc_mask), "the 4-slot Pareto mask differs from "
          "phase 5's")
    out["pareto_4slot_ms"] = ms
    log(f"[fabric] pareto_mask over 4 slots: {ms:.1f} ms, == phase 5's "
        f"mask ({int(mask.sum())} points)")

    # 5. the elastic sweep over 8 slots: one host dropped, then the
    #    reference's pile-up
    mesh8 = make_test_mesh((8,), ("batch",), device=dev)
    cases = {"drop": ({1: "drop:host3"}, 1, ["host3"], 7),
             "pileup": ({0: "crash", 1: "drop:host0", 2: "nan",
                         3: "drop:host5"}, 4, ["host0", "host5"], 6)}
    out["elastic"] = {}
    for name, (schedule, restarts, dropped, last) in cases.items():
        ms, n, (batch, rep) = timed(lambda schedule=schedule: (
            elastic.elastic_sweep(mc_space, mesh8, device=dev,
                                  injector=FailureInjector(
                                      schedule=dict(schedule)))))
        equal(batch, mc_batch, f"elastic {name}")
        del batch
        check((rep.restarts, rep.dropped_hosts) == (restarts, dropped)
              and rep.device_history[0] == 8
              and rep.device_history[-1] == last,
              f"elastic {name}: {rep}")
        check(n == sum(rep.device_history), f"elastic {name}: {n} launches "
              f"for slab runs on {rep.device_history} slots")
        out["elastic"][name] = {
            "ms": ms, "launches": n, "restarts": rep.restarts,
            "dropped": rep.dropped_hosts, "slots": rep.device_history,
            "resume_overhead_frac": rep.resume_overhead_frac}
        log(f"[fabric] elastic {name}: " + json.dumps(out["elastic"][name]))
    check(out["elastic"]["drop"]["resume_overhead_frac"] == 0.25,
          "elastic drop: resume overhead is not 0.25")

    # 6. a process group of one rank (NCCL on the card), file rendezvous
    backend = "nccl" if dev.type == "cuda" else "gloo"
    with tempfile.TemporaryDirectory(prefix="fabric-") as tmp:
        t0 = time.perf_counter()
        dist.init_process_group(backend, init_method=f"file://{tmp}/rv",
                                world_size=1, rank=0)
        try:
            group_mesh = make_sweep_mesh(device=dev, group=dist.group.WORLD)
            first_ms = []
            for _ in range(2):               # the first sets up the group
                ms, n, batch = timed(lambda: dse.sweep(
                    mc_space, sharding=group_mesh, device=dev))
                equal(batch, mc_batch, f"the {backend} group's sweep")
                first_ms.append(ms)
                del batch
            grid = dse.sweep(DesignSpace.paper_grid(), device=dev)
            check(torch.equal(dse.pareto_mask(grid, sharding=group_mesh),
                              dse.pareto_mask(grid)),
                  f"the {backend} group's Pareto mask differs")
        finally:
            dist.destroy_process_group()
        group_s = time.perf_counter() - t0
    check(n == 1, f"the {backend} group's sweep: {n} launches")
    out["group"] = {"backend": backend, "world": 1, "sweep_ms": ms,
                    "first_sweep_ms": first_ms[0], "launches": n,
                    "wall_s": group_s}
    log(f"[fabric] {backend} group of 1 rank: the {rows}-row sweep in "
        f"{ms:.2f} ms ({first_ms[0]:.2f} the first, with the group's "
        f"setup; {n} launch), == phase 5's; the paper grid's Pareto mask "
        f"through all_reduce == sequential; {group_s:.2f} s in all")

    # 7. two gloo processes sharing the card
    env = dict(os.environ, PYTHONPATH=str(SRC))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.multiproc", "--smoke",
         "--device", dev.type, "--timeout", "400"],
        capture_output=True, text=True, env=env, timeout=450, check=False)
    mp_s = time.perf_counter() - t0
    for line in proc.stdout.splitlines():
        log(f"[multiproc] {line}")
    check(proc.returncode == 0 and proc.stdout.rstrip().splitlines()[-1]
          .startswith("multiproc smoke: OK"),
          f"multiproc --smoke: rc {proc.returncode}\n{proc.stderr[-3000:]}")
    out["multiproc_wall_s"] = mp_s
    log(f"[fabric] multiproc --smoke (2 gloo processes x 2 slots on "
        f"{dev.type}): {mp_s:.1f} s")

    # 8. the shard CLI's smoke and the example twin's --sharded
    rc, text = captured(lambda: shard.main(
        ["--smoke", "--device", dev.type, "--expect-devices",
         str(mesh_all.size)]))
    for line in text.splitlines():
        log(f"[shard-cli] {line}")
    check(rc == 0 and text.rstrip().endswith("shard smoke: OK"),
          "shard --smoke failed")
    example = load_example()
    _, plain = captured(lambda: example.main(["--smoke", "--device",
                                              dev.type]))
    kernel.launches = 0
    _, sharded = captured(lambda: example.main(["--smoke", "--sharded",
                                                "--device", dev.type]))
    sync(dev)
    head, rest = sharded.split("\n", 1)
    check(head.startswith("sharding the sweep over") and rest == plain,
          "the example's --sharded output differs from its unsharded run")
    check(kernel.launches == mesh_all.size,
          f"example --sharded: {kernel.launches} launches")
    out["example_sharded_launches"] = kernel.launches
    log(f"[fabric] example --smoke --sharded: '{head}', then the unsharded "
        f"report line for line ({kernel.launches} launch)")
    return out


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
    if not all((SRC / "repro_torch" / "kernels" / "csrc" / f).is_file()
               for f in ("row_cycle.cu", "rc_multistep.cu", "strap_attend.cu")):
        raise SmokeFailure(f"the port's sources are not next to {__file__} "
                           "(run it from a checkout of the repository)")
    sys.path.insert(0, str(SRC))

    import numpy as np

    from repro_torch.core import calibration as cal
    from repro_torch.core import dse, report, transient
    from repro_torch.core.space import DEFAULT_LAYER_GRID, DesignSpace
    from repro_torch.kernels import (build, ops, rc_transient, row_cycle,
                                     strap_gather)
    from repro_torch.kernels.bench import (count_syncs, cuda_ms, profile,
                                           rc_adversarial_ladders)

    wall0 = time.perf_counter()
    record: dict = {"seed": args.seed}
    dev = torch.device("cuda")
    kernel = row_cycle.row_cycle_fused_cuda
    rc_kernel = rc_transient.rc_multistep_cuda
    strap_kernel = strap_gather.strap_attend_cuda
    dt = transient.DT_NS
    caps = (transient.N_ACT_STEPS, transient.N_RESTORE_STEPS,
            transient.N_PRE_STEPS)

    # 1. the card
    card = card_line()
    name = torch.cuda.get_device_name(0)
    log(f"[card] {card} | torch {torch.__version__} cuda {torch.version.cuda}")
    record["card"] = card

    # 2. build the three kernels, one nvcc each, started together
    t0 = time.perf_counter()
    kernel_modules = (row_cycle, rc_transient, strap_gather)
    with ThreadPoolExecutor(max_workers=len(kernel_modules)) as pool:
        libs = list(pool.map(lambda m: m.build(), kernel_modules))
    build_s = time.perf_counter() - t0
    log(f"[build] {', '.join(lib.name for lib in libs)} in {build_s:.2f} s")
    registers = {}
    for lib in libs:
        for entry, used in build.ptxas_registers(lib).items():
            registers[entry] = used
            log(f"[build] ptxas: {entry}: {used}")
    record["build_s"] = build_s
    record["registers"] = registers

    # 3. kernel vs plain version on the card
    rng = np.random.default_rng(args.seed)
    comparisons, max_err_ns, max_steps = {}, 0.0, 0
    cases = [(2048, 4, True, False), (2048, 6, True, False),
             (2048, 8, True, False), (2048, 6, False, True)]
    for b, n, replica, legacy in cases:
        host = random_operands(rng, b, n, replica=replica, legacy=legacy)
        tens = [torch.as_tensor(x, device=dev) for x in host]
        res, _, _ = kernel_vs_plain(ops, tens, dt, caps)
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
    res, plain_full_ms, mc_plain = kernel_vs_plain(ops, mc_ops, dt, caps)
    comparisons[f"mc{MC_SAMPLES}_B{rows}_N6"] = res
    max_err_ns = max(max_err_ns, res["t_err_ns"])
    max_steps = max(max_steps, res["t_err_steps"])
    log(f"[kernel-vs-plain] mc{MC_SAMPLES}_B{rows}_N6: {json.dumps(res)} "
        f"plain {plain_full_ms:.1f} ms")
    rep_plan = dse.plan_sweep(DesignSpace.paper_grid().with_replica(),
                              device=dev)
    rep_ops = transient._pad_operands(rep_plan.operands[:6], 192 - 146)
    res, _, _ = kernel_vs_plain(ops, [x.contiguous() for x in rep_ops], dt,
                                caps)
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

    # 5. the sized run: 299,008 design rows through the path (one launch)
    #    and through explicit per-chunk kernel calls (the earlier dispatch)
    sized: dict = {}
    b_chunk = transient.DEFAULT_B_CHUNK
    padded_rows, slices = transient.fused_launch_plan(rows, b_chunk,
                                                      one_launch=False)

    def per_chunk(operands):
        padded = transient._pad_operands(operands[:6], padded_rows - rows)
        outs = [kernel(*[x[lo:hi].contiguous() for x in padded], dt, *caps)
                for lo, hi in slices]
        return (torch.cat([e for e, _ in outs])[:rows],
                torch.cat([v for _, v in outs])[:rows])

    modes = {"path": lambda plan: transient.row_cycle_events(plan.operands),
             f"per_chunk_{b_chunk}": lambda plan: per_chunk(plan.operands)[0]}
    for mode, run in modes.items():
        runs = []
        for rep_i in range(REPEATS + 1):            # the first is the warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            plan = dse.plan_sweep(mc_space, device=dev)
            torch.cuda.synchronize()
            plan_ms = (time.perf_counter() - t0) * 1e3
            kernel.launches = 0
            kernel_ms, evt = cuda_ms(lambda: run(plan))
            launches = kernel.launches
            score_ms, mc_batch = cuda_ms(lambda: dse.finalize_sweep(
                plan, transient.result_from_events(plan.operands, evt)))
            pareto_ms, mask = cuda_ms(lambda: dse.pareto_mask(mc_batch))
            if rep_i:
                runs.append((plan_ms, kernel_ms, score_ms, pareto_ms))
        med = [statistics.median(r[k] for r in runs) for k in range(4)]
        sweep_ms = med[0] + med[1] + med[2]
        sized[mode] = {
            "rows": len(mc_batch), "launches": launches,
            "plan_ms": med[0], "kernel_ms": med[1], "score_ms": med[2],
            "pareto_ms": med[3], "ms_per_launch": med[1] / launches,
            "sweep_designs_per_s": len(mc_batch) / (sweep_ms / 1e3),
            "with_pareto_designs_per_s": len(mc_batch) / (
                (sweep_ms + med[3]) / 1e3),
            "feasible": int(mc_batch.feasible.sum()),
            "pareto": int(mask.sum()), "runs_ms": runs}
        log(f"[sized] {mode}: " + json.dumps(
            {k: v for k, v in sized[mode].items() if k != "runs_ms"}))
    check([sized[m]["launches"] for m in modes] == [1, len(slices)],
          f"launch counts {[s['launches'] for s in sized.values()]}, "
          f"expected 1 (the path) and {len(slices)} (per chunk)")
    kernel.launches = 0
    evt_one, v_one = transient._row_cycle_fused_chunked(
        list(mc_plan.operands[:6]), "auto", b_chunk)
    check(kernel.launches == 1, "the sized path launched the kernel "
          f"{kernel.launches} times")
    evt_pc, v_pc = per_chunk(mc_plan.operands)
    check(events_identical(evt_one, evt_pc) and bool(torch.equal(v_one, v_pc)),
          "one launch and per-chunk launches are not bit-identical")
    check(events_identical(evt_one, mc_plain[0])
          and bool(torch.equal(v_one, mc_plain[1])),
          "the one-launch path and the plain version are not bit-identical")
    log(f"[sized] one launch == {len(slices)} per-chunk launches == plain "
        "version, bit for bit (events, NaN pattern, v_end)")
    record["sized"] = sized

    # 6. rc_multistep kernel vs its plain version, bit for bit, on random
    #    ladders and on ladders at the edges of its exact quotient form;
    #    the branch-free reciprocal against IEEE division on every float32
    #    of its range
    rc_cmp, rc_err = {}, 0.0
    cases = {f"random_B{b}_N{n}_T{t}": random_ladder(rng, b, n, t)
             for b, n, t in ((1000, 4, 64), (1025, 6, 800), (129, 8, 100))}
    cases.update(rc_adversarial_ladders(rng))
    for key, host_args in cases.items():
        res = rc_compare(ops, [torch.as_tensor(x, device=dev)
                               for x in host_args], dt)
        rc_cmp[key] = res
        rc_err = max(rc_err, res["max_abs_err"])
        log(f"[rc-vs-plain] {key}: {json.dumps(res)}")
    t0 = time.perf_counter()
    recip_bad = rc_transient.reciprocal_mismatches(dev)
    record["rc_reciprocal_mismatches"] = recip_bad
    log(f"[rc-vs-plain] branch-free reciprocal vs 1.0f / b over |b| in "
        f"2^{rc_transient.RECIPROCAL_EXPONENTS}: {recip_bad} mismatches "
        f"({time.perf_counter() - t0:.3f} s)")
    check(recip_bad == 0, f"the kernel's reciprocal differs from IEEE "
          f"division for {recip_bad} float32 values")

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
        check(all(bitwise_equal(tr, plain.traces[key])
                  for key, tr in res.traces.items()),
              f"phased {mode}: traces through the kernel and through the "
              "plain version differ")
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
            check(all(bitwise_equal(tr, plain.traces[key])
                      for key, tr in res.traces.items()),
                  f"grid {tech_name}/{scheme}: kernel and plain phased "
                  "traces differ")
            bars = events_within_bars(transient.simulate_row_cycle(
                tech, scheme, lay, replica=replica, device=dev), res, dt)
            for k, v in bars.items():
                grid_worst[k] = max(grid_worst.get(k, 0.0), v)
    log(f"[phased] full grid ({len(combos)} combos x fixed/replica): kernel "
        f"== plain (events and traces bit for bit); worst fused vs phased "
        f"{json.dumps(grid_worst)}")
    syncs = {}
    for replica in (False, True):
        mode = "replica" if replica else "fixed"

        def call(replica=replica):
            return transient.simulate_row_cycle(si, "sel_strap", layers,
                                                traces=True, replica=replica,
                                                device=dev)

        n_sync, sites = count_syncs(call)
        torch.cuda.set_sync_debug_mode("error")
        try:
            call()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        syncs[mode] = {"syncs_per_call": n_sync, "sites": sites}
        log(f"[phased] {mode} B={PHASED_B}: {n_sync} synchronizing call(s) "
            f"{json.dumps(sites)}; ran under set_sync_debug_mode('error')")
        check(n_sync == 0, f"phased {mode}: {n_sync} host-device syncs")
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
        timing[f"{name_}_kernel_ms"] = statistics.median(
            cuda_ms(lambda a=a: rc_kernel(*a), 20, 2)[0]
            for _ in range(REPEATS))
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
                        "syncs": syncs, "rc_vs_plain": rc_cmp}

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

    # 10. strap_attend kernel vs its plain version
    strap_cmp, strap_f32_err = strap_kernel_phase(ops, rng, dev)
    record["strap_vs_plain"] = strap_cmp

    # 11. the LM server at smoke size, strap-exact vs dense
    record["serve_smoke"] = smoke_engine_phase(dev)

    # 12. the LM server at full width: the slice's main path
    record["serve"], strap_calls = serve_phase(args, ops, strap_kernel, dev)
    strap_err = max(strap_f32_err, record["serve"]["max_abs_err_vs_plain"])

    # 13. the co-design example's twin, --smoke, on the card
    record["example"] = example_phase(dev, kernel)

    # 14. the co-design service: the slice's main path
    record["service"] = service_phase(dev, kernel, mc_space)

    # 15. the service's CLI smoke
    record["cli"] = cli_phase(dev, kernel)

    # 16. the sweep fabric, against phase 5's batch and mask
    record["fabric"] = fabric_phase(dev, kernel, mc_space, mc_batch, mask)

    # 17. the kernels line: row_cycle at the sized path's one launch over
    #    299,008 rows and at one 2048-row chunk; rc_multistep at the phased
    #    path's ACT call; strap_attend at the full-width path's last
    #    exact-mode (and gated) step
    full = [x.contiguous() for x in transient._pad_operands(
        mc_plan.operands[:6], padded_rows - rows)]
    kernel_ms, (evt_full, _) = cuda_ms(lambda: kernel(*full, dt, *caps), 10)
    chunk = [x[:b_chunk].contiguous() for x in full]
    chunk_ms, (evt, _) = cuda_ms(lambda: kernel(*chunk, dt, *caps), 20)
    sm_clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,"
         "nounits"], capture_output=True, text=True, timeout=60,
        check=True).stdout.split()[0])
    b_ms, b_by, b_work = bound_ms(evt_full, full[5], 6, dt, caps)
    chunk_bound_ms, _, chunk_work = bound_ms(evt, chunk[5], 6, dt, caps)
    line = {"kernels": [{
        "name": "row_cycle_fused",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/row_cycle.cu",
        "replaces": "src/repro/kernels/row_cycle.py:181",
        "launches": main_launches,
        "launches_by_path": {
            "sweep_paper_grid": main_launches,
            "example_smoke": record["example"]["launches"],
            "service_two_client_window": record["service"]["window"][
                "launches"],
            "service_repeat_memo_hit": record["service"]["repeat_launches"],
            "service_mc_yield_window": record["service"]["mc_yield"][
                "launches"][0],
            "cli_smoke": record["cli"]["launches"],
            "sharded_1slot": record["fabric"]["sweeps"]["sharded_1slot"][
                "launches"],
            "sharded_4slot": record["fabric"]["sweeps"]["sharded_4slot"][
                "launches"],
            "elastic_drop": record["fabric"]["elastic"]["drop"]["launches"]},
        "max_abs_err": max_err_ns,
        "max_abs_err_unit": "ns (event times; events, NaN pattern and v_end "
                            "bit-identical to the plain version)",
        "max_err_steps": max_steps,
        "ms": kernel_ms,
        "plain_ms": plain_full_ms,
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": None,
        "shape": list(full[0].shape),
        "bound_work": b_work,
        "mc_sweep_launches": sized["path"]["launches"],
        "mc_sweep_kernel_ms": {k: v["kernel_ms"] for k, v in sized.items()},
        "chunk_2048_ms": chunk_ms,
        "chunk_2048_bound_ms": chunk_bound_ms,
        "chunk_2048_work": chunk_work,
        "chunk_2048_cycles_per_step": chunk_ms * 1e3 * sm_clock_mhz
        / chunk_work["max_row_steps"],
        "sm_clock_mhz": sm_clock_mhz,
        "registers": {k: v for k, v in registers.items() if "row_cycle" in k},
    }, rc_line(rc_kernel, ops, phased_calls[0][0], phased_launches["fixed"],
               rc_err, registers),
        strap_line(strap_kernel, ops, strap_calls,
                   record["serve"]["backends"]["strap_exact"]["launches"],
                   strap_err, registers)]}
    log("[kernels] row_cycle_fused: " + json.dumps(line["kernels"][0]))
    log("[kernels] rc_multistep: " + json.dumps(line["kernels"][1]))
    log("[kernels] strap_attend: " + json.dumps(line["kernels"][2]))
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
