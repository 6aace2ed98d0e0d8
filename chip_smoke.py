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
17. Pixtral-12B at full width and depth (VLM, 40 layers, GQA 32/8 heads
   of 128, bf16, seeded weights): 8 requests of 2048-token prompts, 16
   new tokens, through `ServeEngine.generate` with the dense, strap-exact
   and strap-gated (top 4) backends, every strap_attend call (group 4)
   held against the plain version; a direct prefill with stub vision
   embeddings and a decode step against the prefill of one more token
   (the reference's 2e-2 relative bar); the gated HLO decode
   (`strap_decode`, 256-token straps, top 4 of 16 over a 4096-token
   cache) and, with every strap selected, against the dense step (bf16
   bar); strap_attend at this decode shape timed against its bound and
   SDPA;
18. Phi-3.5-MoE at full width, 16 of its 32 layers (16 experts top 2):
   `generate` on the dense backend; layer 0's `moe_apply` at the
   prefill's tokens in float32 against the per-pair loop, its dropped
   pairs counted; the MoE layer timed; the strap backend's refusal;
19. Arctic-480B at full width, one of its 35 layers (128 experts and the
   dense residual): one prefill and one decode step, and the same
   per-pair check;
20. OLMo-1B in full (MHA, non-parametric LN): dense and strap-exact
   engines (strap_attend at group 1, every call held against the plain
   version), strap exact teacher-forced with the dense greedy tokens;
   strap_attend at this shape timed;
21. Mamba2-780M in full (48 layers, d 1536, state 128, bf16, seeded
   weights): 8 requests of 2048-token prompts, 32 new tokens, through
   `ServeEngine.generate` on the dense backend (strap_attend's launches
   counted: none); a decode step after a 2047-token prefill (chunks of 89)
   against the prefill of 2048 (2e-2 relative); one layer's
   `ssd_chunked` in float32 at its widths (B 8, L 1024) against a float64
   per-token recurrence on the card (rtol / atol 2e-4), and the scan timed
   at the prefill's length; the whole model in float32 with
   `ssm_split_proj` and the weights re-partitioned against the fused
   layout (1e-4); the strap backend's refusal;
22. Zamba2-7B in full (81 layers: 13 groups of 6 Mamba2 layers, each
   followed by the shared attention+MLP block, then 3 trailing; bf16): 8
   x 2048 prompts, 16 new tokens on the dense backend; decode vs the
   prefill of one more token; the engine's cache after prefill (the
   shared block's K/V grown on the sequence axis only, every SSM state
   unchanged); the strap backend's refusal;
23. Whisper-tiny in full (4 + 4 layers, d 384, bf16): 8 sequences of
   1,500 encoder frames (stub embeddings from the seed) and 128 decoder
   tokens through `models.registry.prefill`, 32 greedy steps through
   `registry.decode_step`, the cross cache bit for bit unchanged; decode
   vs the prefill of one more token; the engine's refusal of enc-dec;
24. training, card against CPU: one `train.step.make_train_step` step
   of each of the ten smoke configs in float32 (and one with
   microbatch=2 on qwen2-1.5b-smoke) on the card and on the CPU from the
   same weights and batch: loss and grad_norm within 2e-5 relative, every
   parameter after the step within 2e-5 of max(max|cpu|, lr) (2e-4 on
   the ssm and hybrid configs), every parameter moved and finite;
25. OLMo-1B at full width and depth (16 x 2048, bf16, remat on): 8 x
   2048 tokens a step from `SyntheticSource`, 12 AdamW steps, then 12
   AdamW8bit steps from the same weights; every loss finite, AdamW's
   falling (AdamW8bit's recorded: the reference's int8 moments can step
   by m / eps, ROADMAP queue 3); median step time, tokens/s, train_mfu
   (6 N T plus the attention's 12 L S d a token, over the bf16 peak),
   peak memory, each optimizer's state bytes, one profiled step (idle
   share, kernels);
26. Mamba2-780M at full width and depth (48 layers, bf16): the SSD
   scan's gradients in float32 against float64 on the card (2 x 1024,
   2e-4), 6 AdamW steps of 8 x 2048 tokens (losses finite and falling),
   the scan's share of the step (one layer's scan timed by the profiler,
   times the layers, forward twice under remat);
27. `examples/train_lm_torch.py` at its defaults (200 steps of 8 x 256,
   a checkpoint every 100, a crash at 150): one restart with its
   exception text, the loss falling, train tokens/s, the step-100
   checkpoint restored on the CPU bit for bit against the card's state;
28. `python -m repro_torch.launch.train --arch qwen2-1.5b --smoke
   --steps 25 --batch 4 --seq 64 --ckpt-every 8 --inject-crash 12` in a
   subprocess: its `done:` line, 1 restart, the loss falling; the wall
   time of phases 24-28 and the ported kernels' launches there (none of
   them lies on the training path) on a log line;
29. distributed training, NCCL at world size 1, mesh (1, 1, 1): OLMo-1B
   at full width and depth, 8 x 2048 from `SyntheticSource`, three
   `make_sharded_train_step` steps against three `make_train_step` steps
   from the same weights and batches (`OptConfig(lr=3e-4)`, its 100
   warm-up steps): parameters, AdamW state, losses and grad norms bit for
   bit; both step times;
30. two gloo processes sharing the card (`launch.group.run_group`; NCCL
   refuses two ranks on one GPU), mesh (1, 2, 1), ZeRO over "data":
   OLMo-1B in full, 8 x 2048 global, 3 AdamW steps on phase 29's weights
   and batches (losses finite and falling, and beside phase 29's; per
   rank the step time, the host-clock time of the parameter gather and
   of the gradient psum, peak memory, optimizer-state bytes);
   one float32 step of each smoke config (and qwen2-1.5b-smoke with
   microbatch=2) against the single-process step on the card, phase 24's
   bars; qwen2-1.5b-smoke's state saved sharded and restored whole and on
   mesh (1, 1, 2), bit for bit;
31. expert parallelism, two gloo processes on the card, mesh (1, 1, 2):
   one Phi-3.5-MoE layer at full width (d 4096, 16 experts, top 2),
   4 x 512 tokens, `moe_apply_ep` forward and backward in float32 and
   bf16 against `moe_apply` on each rank's own tokens (2e-5 of max in
   float32, 3e-2 in bf16), four all-to-alls (no fallback), the pairs
   dropped and the times; the wall time of phases 29-31 and the ported
   kernels' launches there, this process's and each member's (its
   counts zeroed on entry and returned), summed and required to be 0
   (none lies on the path), on a log line;
32. the dry run held against the card: OLMo-1B in full, 8 x 2048 with
   AdamW (phase 25's run) on a mesh of one rank, dry-run on a fake
   group (`launch.dryrun.run`) and then run for real on an NCCL group of
   one rank: the dry run's counted FLOPs equal `FlopCounterMode` around
   the real step exactly, its fake peak lies within 15% of the real
   step's `max_memory_allocated`, and the H100 roofline's
   `step_time_est` does not exceed the measured step; then `python -m
   repro_torch.launch.dryrun --arch olmo-1b --cell train_4k --mesh
   single` in a subprocess (`ok: true`; its FLOPs, collective bytes and
   peak a rank logged); none of the ported kernels launched;
33. `examples/quickstart_torch.py` and `examples/serve_lm_torch.py` in
   subprocesses on the card: `quickstart OK` and `strap-exact == dense:
   True`;
34. one JSON line listing the ported kernels (row_cycle at the sweep's
   one launch over 299,008 rows and at one 2048-row chunk, with the
   cycles of a step; rc_multistep at the phased path's ACT call, with
   cycles a step, its block as the library reports it and, in its
   `bound_work`, the chain model beside the byte bound;
   strap_attend at the full-width path's last exact-mode and gated
   steps, on 1 to 8 rows, and SDPA on the same tokens, with
   `launches_by_path` (each served path's launches, 0 on the ssm,
   hybrid and enc-dec paths) and `by_shape` (the Pixtral and OLMo decode
   shapes); row_cycle's `launches_by_path` counts each path's launches,
   read around it; every entry's `launches_by_path` has `dist_train`,
   its launches in phases 29-31, this process's and the four members'
   summed), then the card line, then the result line
   {"ok": true, "device": {...}}.

It imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager
from pathlib import Path
from typing import NamedTuple

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
               registers, launches_by_path, by_shape) -> dict:
    """The kernels-line entry of strap_attend, timed at the full-width
    path's last exact-mode decode step: its calls for all layers in turn
    (28 distinct caches, 0.5 GB, so L2 holds none of them between
    launches, as on the path).  `library_ms` is the fastest SDPA backend
    and operand form that agrees with the kernel at the bf16 bar; the
    kernel is also timed on the first 1, 2, 4 and 8 rows of the batch
    (36 to 288 split blocks) and at the gated engine's last step.  Times
    are the device time of the kernels (torch.profiler), beside CUDA
    events around the calls, which on a slow host measure the host.
    `launches_by_path` counts each served path's launches (read around
    its `generate`); `by_shape` times the other families' decode shapes
    (`strap_shape_timing`)."""
    from repro_torch.kernels import strap_gather
    from repro_torch.kernels.bench import cuda_ms, device_ms

    layer_calls = backend_calls["strap_exact"]
    timing, library = strap_shape_timing(kernel, ops_mod, layer_calls)
    calls = [(a, kw) for a, kw, _ in layer_calls]
    n = len(calls)

    def each(fn):
        return lambda: [fn(a, kw) for a, kw in calls]

    ms_events = cuda_ms(each(lambda a, kw: kernel(
        *a, lengths=kw["lengths"])), 5)[0] / n
    plain_events = cuda_ms(each(lambda a, kw: ops_mod.strap_attend(
        *a, **{**kw, "backend": "ref"})), 2)[0] / n
    by_rows = {}
    for r in (1, 2, 4, 8):
        sub = [((a[0][:r], a[1][:r], a[2][:r], a[3][:r], a[4]),
                kw["lengths"][:r]) for a, kw in calls]
        by_rows[str(r)] = device_ms(lambda sub=sub: [
            kernel(*a, lengths=ln) for a, ln in sub], n)
    best = library[timing["library_call"]]
    gated = [(a, kw) for a, kw, _ in backend_calls["strap_gated_top4"]]
    gated_ms = device_ms(lambda: [kernel(*a, lengths=kw["lengths"])
                                  for a, kw in gated], len(gated))
    ga, gkw = gated[-1]
    gated_bound = strap_bound_ms(ga[0], ga[1], ga[3], ga[4], gkw["lengths"])
    a = calls[-1][0]
    plan = strap_gather.split_plan(a[1].shape, a[4], a[3].shape[1])
    return {"name": "strap_attend", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/strap_attend.cu",
            "replaces": "src/repro/kernels/strap_gather.py:101",
            "launches": launches, "launches_by_path": launches_by_path,
            "max_abs_err": max_err,
            "max_abs_err_unit": "attention output (bf16 on the path)",
            "ms": timing["ms"], "plain_ms": timing["plain_ms"],
            "bound_ms": timing["bound_ms"], "bound_by": timing["bound_by"],
            "library_ms": timing["library_ms"],
            "timing": "ms, plain_ms, library_ms, ms_by_rows, gated_top4_ms: "
                      "device time of the call's kernels (torch.profiler), "
                      "library_ms by CUDA events where the profiler reads "
                      "it below bound_ms (library_ms_from); "
                      "*_events: CUDA events around the calls, which also "
                      "count the card's idle time while the host enqueues",
            "ms_events": ms_events, "plain_ms_events": plain_events,
            "library_ms_from": timing["library_ms_from"],
            "library_ms_events": timing["library_ms_events"],
            "ms_by_kernel": timing["ms_by_kernel"],
            "library_call": "F.scaled_dot_product_attention on the gathered "
                            f"selected tokens, {timing['library_call']}",
            "library_max_abs_err": best["max_abs_err"],
            "library_by_backend": library, "ms_by_rows": by_rows,
            "device_kernels_per_call": len(timing["ms_by_kernel"]),
            "split_plan": plan._asdict(),
            "gated_top4_ms": gated_ms, "gated_top4_bound_ms": gated_bound[0],
            "gated_top4_work": gated_bound[2],
            "registers": {k: v for k, v in registers.items()
                          if "strap_" in k},
            "shape": timing["shape"], "bound_work": timing["bound_work"],
            "timed_calls": n, "by_shape": by_shape}


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


def set_precision() -> dict:
    """TF32 and reduced-precision bf16 reductions off (a top-k choice of
    the MoE router or the strap selector must not flip); returns the
    settings as read back."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return {
        "matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
        "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
        "matmul.allow_bf16_reduced_precision_reduction":
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction}


def param_tensors(params) -> list:
    """Every tensor of a parameter tree."""
    if isinstance(params, dict):
        return [t for v in params.values() for t in param_tensors(v)]
    return [params]


def init_reckoning(cfg) -> dict:
    """What the seeded init must hold at its peak, reckoned from the
    schema before the draw: the bf16 params, and the float32 draw of the
    largest stacked tensor with its bf16 cast (`init_from_schema` draws a
    leaf in float32, then casts)."""
    from repro_torch.models import registry as models
    from repro_torch.models.common import schema_leaves

    sizes = [math.prod(spec.shape) for _, spec in
             schema_leaves(models.schema(cfg))]
    return {"n_params": sum(sizes), "param_gb": 2 * sum(sizes) / 1e9,
            "largest_leaf_float32_gb": 4 * max(sizes) / 1e9}


class ServeSpec(NamedTuple):
    """One LM-server workload: the config, batch, prompt and new tokens,
    the backends (label, cache backend, top straps) and a depth cut."""
    arch: str
    batch: int
    prompt: int
    new: int
    backends: tuple
    n_layers: int | None = None        # None: the config's own depth


def serve_phase(args, ops_mod, strap_kernel, dev, spec=None,
                extra=None) -> tuple[dict, dict]:
    """The LM server at full width (`spec`, Qwen2-1.5B by default):
    `ServeEngine.generate` with each backend (the main path, launches
    counted), every strap_attend call of it held against the plain
    version, a timed true-greedy decode (`step()` with no token), the
    strap engines teacher-forced with the dense engine's tokens, and one
    decode step under the profiler; then `extra(cfg, params, prompts)`,
    whose record joins this one, before the params are freed.  Returns
    the record and each strap backend's calls of the last step."""
    import numpy as np
    import torch

    from repro_torch.configs.registry import get_arch
    from repro_torch.memory.strap_cache import StrapCacheConfig
    from repro_torch.models import registry as models
    from repro_torch.kernels.bench import cuda_ms, profile
    from repro_torch.models.common import lm_logits
    from repro_torch.serving.engine import ServeEngine

    spec = spec or ServeSpec(LM_ARCH, LM_B, LM_PROMPT, LM_NEW, LM_BACKENDS)
    precision = set_precision()
    log(f"[serve] precision: {json.dumps(precision)}")
    cfg = full = get_arch(spec.arch)
    if spec.n_layers is not None:
        cfg = dataclasses.replace(full, n_layers=spec.n_layers)
    reckoned = init_reckoning(cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = models.init_params(
        cfg, torch.Generator(device=dev).manual_seed(args.seed), device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    leaves = param_tensors(params)
    n_params = sum(t.numel() for t in leaves)
    param_bytes = sum(t.numel() * t.element_size() for t in leaves)
    check(params["embed"].dtype == torch.bfloat16, "params are not bf16")
    log(f"[serve] {cfg.name}: {n_params:,} params ({param_bytes / 1e9:.3f} "
        f"GB bf16) initialised on the card in {init_s:.2f} s")
    check(n_params == reckoned["n_params"],
          f"{cfg.name}: {n_params} params, the schema {reckoned['n_params']}")
    # max_tokens as examples/serve_lm.py sets it: PROMPT + NEW + 16
    b, new, max_tokens = spec.batch, spec.new, spec.prompt + spec.new + 16
    prompts = np.random.default_rng(args.seed).integers(
        0, cfg.vocab_size, (b, spec.prompt)).astype(np.int32)
    record = {"arch": cfg.name, "precision": precision, "init_s": init_s,
              "n_params": n_params, "param_bytes": param_bytes,
              "reckoned_init": reckoned, "init_peak_gb": init_peak_gb,
              "batch": b, "prompt": spec.prompt, "new_tokens": new,
              "max_tokens": max_tokens, "backends": {}}
    if spec.n_layers is not None:
        record["reduced"] = {"n_layers": [full.n_layers, cfg.n_layers],
                             "n_params_full": full.param_count()}
    sync = torch.cuda.synchronize
    dense_tokens = dense_logits = None
    line_calls = {}
    worst = 0.0
    for label, backend, top in spec.backends:
        eng = ServeEngine(cfg, params, max_tokens=max_tokens,
                          cache_backend=backend,
                          strap_cfg=StrapCacheConfig(top_straps=top),
                          device=dev)
        # the main path: generate, through the entry point, launches counted
        strap_kernel.launches = 0
        with recording(ops_mod, "strap_attend", outputs=True) as calls:
            sync()
            t0 = time.perf_counter()
            out = eng.generate(prompts, new)
            sync()
            gen_s = time.perf_counter() - t0
        launches = strap_kernel.launches
        want = cfg.n_layers * new if backend == "strap" else 0
        check(launches == want == len(calls),
              f"{label}: {launches} strap_attend launches, {len(calls)} "
              f"calls, expected {want}")
        check(tuple(out.shape) == (b, new) and int(out.min()) >= 0
              and int(out.max()) < cfg.vocab_size, f"{label}: tokens {out}")
        stats = dataclasses.asdict(eng.stats)
        stats["traffic_reduction"] = eng.stats.traffic_reduction
        check(stats["tokens_decoded"] == b * new, f"{label}: {stats}")
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
        for _ in range(new):
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
               "decode_tokens_per_s": b / (step_ms / 1e3),
               "generate_tokens_per_s": b * new / gen_s,
               "generate_tokens": out[:, 0].tolist()}
        # one decode step under the profiler (two more steps of room)
        res["profile"] = profile(lambda: eng.step())
        if backend == "dense":
            dense_tokens, dense_logits = toks, logits
        else:
            eng.prefill(prompts)
            d_max, agree = [], []
            for i in range(new):
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
        log(f"[serve] {cfg.name} {label}: " + json.dumps(
            {k: v for k, v in res.items() if k not in ("decode_step_ms",)}))
        del eng
    # what lm_logits' float32 cast of the tied table costs a step
    h = torch.zeros(b, 1, cfg.d_model, dtype=torch.bfloat16, device=dev)
    record["lm_logits_ms"] = cuda_ms(lambda: lm_logits(cfg, params, h), 10)[0]
    record["embed_cast_ms"] = cuda_ms(lambda: params["embed"].float(), 10)[0]
    record["max_abs_err_vs_plain"] = worst
    if extra is not None:
        record.update(extra(cfg, params, prompts))
    record["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log(f"[serve] lm_logits {record['lm_logits_ms']:.3f} ms a step, of which "
        f"the float32 cast of the table {record['embed_cast_ms']:.3f} ms; "
        f"peak memory {record['peak_memory_gb']:.2f} GB")
    del params, leaves
    torch.cuda.empty_cache()
    return record, line_calls


# --------------------------------------------------------------------------
# the other attention families: VLM, MoE, MHA, and the gated HLO decode
# --------------------------------------------------------------------------

PIXTRAL_SPEC = ServeSpec("pixtral-12b", 8, 2048, 16, LM_BACKENDS)
PHI_SPEC = ServeSpec("phi3.5-moe-42b-a6.6b", 4, 512, 16,
                     (("dense", "dense", 0),), n_layers=16)
OLMO_SPEC = ServeSpec("olmo-1b", 8, 2048, 16,
                      (("dense", "dense", 0), ("strap_exact", "strap", 0)))
ARCTIC_ARCH, ARCTIC_B, ARCTIC_PROMPT = "arctic-480b", 2, 256
VLM_B, VLM_TEXT = 2, 1024            # direct prefill + decode, Pixtral
GATED_STRAP, GATED_CACHE = 256, 4096  # 16 straps of 256 tokens
GATED_TOP = 4
VLM_REL_BAR = 2e-2      # tests/test_models.py: decode vs forward, relative
BF16_BAR = 3e-2         # tests/test_torch_lm.py: the port's bf16 bar
F32_BAR = 2e-5          # tests/test_torch_lm.py's TOL


def strap_shape_timing(kernel, ops_mod, layer_calls) -> tuple[dict, dict]:
    """strap_attend at one decode step of a full-width path (`layer_calls`:
    its calls for every layer, with outputs, each layer's cache distinct
    so L2 holds none between launches, as on the path): the kernel's and
    the plain version's device time a call (torch.profiler), which must
    not lie below the bound, the bound, and the fastest SDPA backend and
    operand form that agrees at the bf16 bar, by its device time or, where
    the profiler reads that below the bound, by CUDA events around the
    calls.  Returns the summary and SDPA's results by form and backend."""
    from repro_torch.kernels.bench import device_ms, device_ms_by_kernel

    calls = [(a, kw) for a, kw, _ in layer_calls]
    n = len(calls)
    ms_by_kernel = device_ms_by_kernel(lambda: [
        kernel(*a, lengths=kw["lengths"]) for a, kw in calls], n)
    plain_ms = device_ms(lambda: [ops_mod.strap_attend(
        *a, **{**kw, "backend": "ref"}) for a, kw in calls], n)
    a, kw = calls[-1]
    b_ms, b_by, work = strap_bound_ms(a[0], a[1], a[3], a[4], kw["lengths"])
    ms = sum(ms_by_kernel.values())
    check(ms >= b_ms and plain_ms >= b_ms,
          f"strap_attend's device time {ms} ms (plain {plain_ms} ms) lies "
          f"below its bound {b_ms} ms: the profiler missed work")
    library = sdpa_library(calls, [out for _, _, out in layer_calls])
    for v in library.values():
        if not v.get("runs"):
            continue
        v["ms_from"] = "device"
        if v["ms"] < b_ms:
            # a reading below the least time the bytes take: the profiler
            # missed part of the call's work (seen for cuDNN), so the time
            # is the CUDA events' around the calls
            v["ms_profiler"], v["ms"] = v["ms"], v["ms_events"]
            v["ms_from"] = "events, the profiler's reading is below the bound"
    agreeing = {k: v for k, v in library.items()
                if v.get("runs") and v.get("within_bf16_bar")}
    check(bool(agreeing), f"no SDPA backend computes strap_attend's "
          f"function within the bf16 bar: {library}")
    best = min(agreeing, key=lambda k: agreeing[k]["ms"])
    hkv = a[1].shape[3]
    return {"ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": agreeing[best]["ms"], "library_call": best,
            "library_ms_from": agreeing[best]["ms_from"],
            "library_ms_events": agreeing[best]["ms_events"],
            "ms_by_kernel": {k[:80]: v for k, v in ms_by_kernel.items()},
            "launches_a_step": n, "group": a[0].shape[1] // hkv,
            "kv_heads": hkv,
            "shape": {"q": list(a[0].shape), "pages": list(a[1].shape),
                      "strap_ids": list(a[3].shape)},
            "bound_work": work}, library


def moe_layer_input(cfg, params, tokens):
    """Layer 0's MoE input at `tokens`: the prefill's own activations up to
    the block's second norm."""
    from repro_torch.models.attention import causal_attention
    from repro_torch.models.common import apply_norm, embed_tokens, torch_dtype
    from repro_torch.models.lm import layer_params

    lp = layer_params(params, 0)
    h = embed_tokens(params, tokens, torch_dtype(cfg.compute_dtype))
    h = h + causal_attention(cfg, lp, apply_norm(cfg, h, lp, "ln1"))[0]
    return apply_norm(cfg, h, lp, "ln2")


def moe_vs_pairs(cfg, lp32, x32) -> dict:
    """`moe_apply` in float32 on the card against the plain per-pair
    version, at rtol = atol = 2e-5; the pairs dropped."""
    import torch

    from repro_torch.models import moe

    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 is on")
    y, aux = moe.moe_apply(cfg, lp32, x32)
    want, info = moe.moe_apply_pairs(cfg, lp32, x32)
    err = (y - want).abs()
    res = {"max_abs_err": err.max().item(),
           "out_abs_max": want.abs().max().item(), "aux": aux.item(),
           "tokens": x32.shape[0] * x32.shape[1], "experts": cfg.n_experts,
           **info}
    check(bool(torch.isfinite(y).all().item()), f"{cfg.name}: MoE not finite")
    check(bool((err <= F32_BAR + F32_BAR * want.abs()).all().item()),
          f"{cfg.name}: moe_apply outside 2e-5 of the per-pair loop {res}")
    return res


def vlm_checks(args, dev):
    """Pixtral-12B beyond the engine (`extra` of its serve phase): a direct
    prefill with stub vision embeddings and a decode step on the padded
    dense cache, against the prefill over one more token (the reference's
    2e-2 relative bar); the gated decode step (256-token straps, top 4 of
    16) and, with every strap selected, against the dense step at the bf16
    bar."""
    import numpy as np
    import torch

    from repro_torch.models import registry as models

    def run(cfg, params, prompts):
        rng = np.random.default_rng(args.seed)
        nv = cfg.n_vision_tokens
        vision = lambda b: torch.as_tensor(
            (rng.normal(size=(b, nv, cfg.d_model)) * 0.02).astype(np.float32),
            device=dev)
        tok = lambda b, s: torch.as_tensor(
            rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
            device=dev)
        out = {}
        # decode after a vision prefill vs the prefill of one more token
        emb, toks = vision(VLM_B), tok(VLM_B, VLM_TEXT + 1)
        sync = torch.cuda.synchronize
        sync()
        t0 = time.perf_counter()
        full, _ = models.prefill(cfg, params, {"tokens": toks,
                                               "vision_embeds": emb})
        sync()
        prefill_s = time.perf_counter() - t0
        _, cache = models.prefill(cfg, params, {"tokens": toks[:, :-1],
                                                "vision_embeds": emb})
        held = nv + VLM_TEXT
        cache = pad_kv(cache, held + 16)
        pos = torch.full((VLM_B,), held, dtype=torch.int32, device=dev)
        step, _ = models.decode_step(cfg, params, cache, toks[:, -1:], pos)
        rel_err = ((step - full).abs().max() / full.abs().max()).item()
        check(bool(torch.isfinite(step).all().item())
              and rel_err < VLM_REL_BAR,
              f"pixtral decode vs prefill: relative {rel_err}")
        out["vlm_decode_vs_prefill"] = {
            "batch": VLM_B, "vision_tokens": nv, "text_tokens": VLM_TEXT,
            "rel_err": rel_err, "bar": VLM_REL_BAR,
            "greedy_agree": (step.argmax(-1) == full.argmax(-1)).float()
            .mean().item(), "prefill_s": prefill_s}
        log(f"[vlm] decode after a {nv}+{VLM_TEXT}-token vision prefill vs "
            f"prefill of one more token: relative {rel_err:.3e} "
            f"(bar {VLM_REL_BAR})")
        del cache
        # the gated decode over a 4096-token cache of 16 straps
        text = GATED_CACHE - nv - GATED_STRAP
        emb, toks = vision(VLM_B), tok(VLM_B, text + 1)
        _, cache = models.prefill(cfg, params, {"tokens": toks[:, :-1],
                                                "vision_embeds": emb})
        cache = pad_kv(cache, GATED_CACHE)
        nst = GATED_CACHE // GATED_STRAP
        ksum = cache["k"].reshape(cfg.n_layers, VLM_B, nst, GATED_STRAP,
                                  cfg.n_kv_heads, cfg.head_dim_).float().sum(3)
        held = nv + text
        pos = torch.full((VLM_B,), held, dtype=torch.int32, device=dev)
        logits = {}
        for top in (GATED_TOP, nst):
            gcfg = dataclasses.replace(cfg, strap_decode=True,
                                       decode_strap_tokens=GATED_STRAP,
                                       decode_top_straps=top)
            c = {"k": cache["k"].clone(), "v": cache["v"].clone(),
                 "ksum": ksum.clone()}
            sync()
            t0 = time.perf_counter()
            logits[top], c = models.decode_step(gcfg, params, c,
                                                toks[:, -1:], pos)
            sync()
            ms = (time.perf_counter() - t0) * 1e3
            check(torch.equal(c["k"][:, :, :held], cache["k"][:, :, :held])
                  and bool((c["k"][:, :, held] != 0).any().item())
                  and not torch.equal(c["ksum"][:, :, held // GATED_STRAP],
                                      ksum[:, :, held // GATED_STRAP]),
                  f"gated top {top}: the cache update is wrong")
            out[f"gated_top{top}_step_ms"] = ms
            del c
        dense, _ = models.decode_step(cfg, params, cache, toks[:, -1:], pos)
        diff = (logits[nst] - dense).abs()
        within = bool((diff <= BF16_BAR + BF16_BAR * dense.abs()).all()
                      .item())
        sel_rel = ((logits[GATED_TOP] - dense).abs().max()
                   / dense.abs().max()).item()
        out["gated"] = {
            "cache_tokens": GATED_CACHE, "strap_tokens": GATED_STRAP,
            "straps": nst, "valid_tokens": held + 1, "top": GATED_TOP,
            "all_straps_vs_dense_max_abs": diff.max().item(),
            "all_straps_within_bf16_bar": within,
            "logit_abs_max": dense.abs().max().item(),
            "top4_vs_dense_rel": sel_rel,
            "top4_greedy_agree": (logits[GATED_TOP].argmax(-1)
                                  == dense.argmax(-1)).float().mean().item(),
            "all_finite": all(bool(torch.isfinite(x).all().item())
                              for x in logits.values())}
        check(within and out["gated"]["all_finite"],
              f"gated decode with every strap vs dense: {out['gated']}")
        log(f"[vlm] gated decode over {GATED_CACHE} tokens: "
            + json.dumps(out["gated"]))
        return out

    return run


def moe_checks(dev):
    """Phi-3.5-MoE beyond the engine (`extra` of its serve phase): layer
    0's `moe_apply` at the prefill's tokens in float32 against the
    per-pair loop, the MoE layer timed in bf16 at the prefill's and a
    decode step's tokens, and the strap backend's refusal."""
    import torch

    from repro_torch.kernels.bench import cuda_ms
    from repro_torch.models import moe
    from repro_torch.models.lm import layer_params

    def run(cfg, params, prompts):
        tokens = torch.as_tensor(prompts, device=dev)
        x = moe_layer_input(cfg, params, tokens)
        lp = layer_params(params, 0)
        keys = [k for k in lp if k == "router" or k.startswith(("we_",
                                                                "res_"))]
        lp32 = {k: lp[k].float() for k in keys}
        res = {"moe_vs_pairs": moe_vs_pairs(cfg, lp32, x.float())}
        del lp32
        res["moe_ms"] = {
            "prefill_tokens": x.shape[0] * x.shape[1],
            "prefill": cuda_ms(lambda: moe.moe_apply(cfg, lp, x), 3, 1)[0],
            "decode_tokens": x.shape[0],
            "decode": cuda_ms(lambda: moe.moe_apply(cfg, lp, x[:, -1:]), 10,
                              2)[0]}
        res["strap_backend_refusal"] = engine_refusal(cfg, params, dev)
        log(f"[moe] {cfg.name}: " + json.dumps(res))
        return res

    return run


def arctic_phase(args, dev) -> dict:
    """Arctic-480B at full width, one layer of 35 (128 experts top 2 and
    the dense residual MLP): one prefill and one decode step through the
    engine, then layer 0's `moe_apply` at the prefill's tokens in float32
    against the per-pair loop (the bf16 params freed as the expert weights
    are cast, to fit the card)."""
    import numpy as np
    import torch

    from repro_torch.configs.registry import get_arch
    from repro_torch.models import registry as models
    from repro_torch.serving.engine import ServeEngine

    set_precision()
    full = get_arch(ARCTIC_ARCH)
    cfg = dataclasses.replace(full, n_layers=1)
    reckoned = init_reckoning(cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = models.init_params(
        cfg, torch.Generator(device=dev).manual_seed(args.seed), device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_params = sum(t.numel() for t in param_tensors(params))
    check(n_params == reckoned["n_params"],
          f"arctic: {n_params} params, the schema {reckoned['n_params']}")
    prompts = np.random.default_rng(args.seed).integers(
        0, cfg.vocab_size, (ARCTIC_B, ARCTIC_PROMPT)).astype(np.int32)
    eng = ServeEngine(cfg, params, max_tokens=ARCTIC_PROMPT + 16, device=dev)
    sync = torch.cuda.synchronize
    sync()
    t0 = time.perf_counter()
    logits = eng.prefill(prompts)
    sync()
    prefill_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tok, step = eng.step()
    sync()
    step_ms = (time.perf_counter() - t0) * 1e3
    check(tuple(step.shape) == (ARCTIC_B, cfg.padded_vocab)
          and bool(torch.isfinite(step).all().item())
          and bool(torch.isfinite(logits).all().item()),
          "arctic: prefill / decode logits")
    x32 = moe_layer_input(cfg, params,
                          torch.as_tensor(prompts, device=dev)).float()
    del eng, logits, step
    # the layer's float32 MoE weights, each cast as its bf16 stack goes
    layers = params.pop("layers")
    del params
    lp32 = {}
    for k in sorted(layers):
        if k == "router" or k.startswith(("we_", "res_")):
            lp32[k] = layers.pop(k)[0].float()
    del layers
    res = moe_vs_pairs(cfg, lp32, x32)
    del lp32, x32
    record = {"arch": cfg.name, "reduced": {"n_layers": [full.n_layers, 1],
                                            "n_params_full":
                                                full.param_count()},
              "n_params": n_params, "reckoned_init": reckoned,
              "init_s": init_s, "init_peak_gb": init_peak_gb,
              "batch": ARCTIC_B, "prompt": ARCTIC_PROMPT,
              "prefill_s": prefill_s, "decode_step_ms": step_ms,
              "token": tok[:, 0].tolist(), "moe_vs_pairs": res,
              "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    torch.cuda.empty_cache()
    log("[arctic] " + json.dumps(record))
    return record


# --------------------------------------------------------------------------
# the SSM, hybrid and enc-dec families
# --------------------------------------------------------------------------

MAMBA_SPEC = ServeSpec("mamba2-780m", 8, 2048, 32, (("dense", "dense", 0),))
ZAMBA_SPEC = ServeSpec("zamba2-7b", 8, 2048, 16, (("dense", "dense", 0),))
NEXT_B = 2              # decode after prefill(T) vs prefill(T + 1)
SSD_SHAPE = (8, 1024, 48, 64, 128)   # B, L (4 chunks), nh, hp, st
SSD_BAR = 2e-4          # tests/test_models.py TestSSD: chunked vs recurrence
SPLIT_BAR = 1e-4        # tests/test_perf_features.py: split vs fused
SPLIT_B, SPLIT_T = 2, 512
KV_CHECK_T, KV_CHECK_MAX = 256, 320
BF16_DEPTHS = (4, 12, 24)   # Mamba2-780M cut to its first n layers
WHISPER_ARCH = "whisper-tiny"
WHISPER_B, WHISPER_FRAMES, WHISPER_TOKENS, WHISPER_NEW = 8, 1500, 128, 32


def pad_kv(cache, to):
    """Grow the K/V's seq axis to `to`; SSM, conv and cross caches keep
    their shapes (the engine's dense padding)."""
    import torch

    return {k: (torch.nn.functional.pad(v, (0, 0, 0, 0, 0, to - v.shape[2]))
                if k in ("k", "v") else v) for k, v in cache.items()}


def engine_refusal(cfg, params, dev, backend: str = "strap") -> str:
    """The engine's refusal of `cfg` on `backend`; fails if it serves
    it."""
    from repro_torch.serving.engine import ServeEngine

    try:
        ServeEngine(cfg, params, cache_backend=backend, device=dev)
    except ValueError as exc:
        return str(exc)
    raise SmokeFailure(f"the {backend} backend served {cfg.name}")


def as_float32(cfg, params):
    """The model in float32: the config's dtypes and every weight cast
    (exactly) from its bf16 draw."""
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                compute_dtype="float32")
    return cfg32, {k: ({kk: vv.float() for kk, vv in v.items()}
                       if isinstance(v, dict) else v.float())
                   for k, v in params.items()}


def decode_vs_next_prefill(cfg, params, batch, gate: bool = True) -> dict:
    """A decode step after the prefill of T tokens against the prefill of
    T + 1 (`batch["tokens"]` holds T + 1; an enc-dec batch its
    `enc_embeds` too): the last logits' relative difference, held within
    2e-2 (the reference's bar, tests/test_models.py, set on float32
    configs) when `gate`, else recorded."""
    import torch

    from repro_torch.models import registry as models

    toks = batch["tokens"]
    b, held = toks.shape[0], toks.shape[1] - 1
    sync = torch.cuda.synchronize
    sync()
    t0 = time.perf_counter()
    full, _ = models.prefill(cfg, params, batch)
    sync()
    prefill_s = time.perf_counter() - t0
    _, cache = models.prefill(cfg, params, dict(batch, tokens=toks[:, :-1]))
    cache = pad_kv(cache, held + 16)
    pos = torch.full((b,), held, dtype=torch.int32, device=toks.device)
    step, _ = models.decode_step(cfg, params, cache, toks[:, -1:], pos)
    rel_err = ((step - full).abs().max() / full.abs().max()).item()
    res = {"dtype": cfg.compute_dtype, "batch": b, "prefill_tokens": held,
           "rel_err": rel_err, "bar": VLM_REL_BAR, "gated": gate,
           "logit_abs_max": full.abs().max().item(), "prefill_s": prefill_s,
           "greedy_agree": (step.argmax(-1) == full.argmax(-1)).float()
           .mean().item()}
    check(bool(torch.isfinite(step).all().item()),
          f"{cfg.name}: decode vs prefill, non-finite logits {res}")
    check(not gate or rel_err < VLM_REL_BAR,
          f"{cfg.name}: decode vs prefill of one more token {res}")
    log(f"[{cfg.name}] {cfg.compute_dtype}: decode after a {held}-token "
        f"prefill vs prefill of one more token: relative {rel_err:.3e} "
        + (f"(bar {VLM_REL_BAR})" if gate else "(recorded)"))
    return res


def ssd_recurrence64(x, bmat, cmat, dt, a_neg):
    """The SSD token by token in float64 on the card (tests/test_models.py's
    recurrence, head h reading B/C group h // (nh // ng))."""
    import torch

    b, l, nh, hp = x.shape
    rep = nh // bmat.shape[2]
    x, dt, a = x.double(), dt.double(), a_neg.double()
    bh = bmat.double().repeat_interleave(rep, dim=2)
    ch = cmat.double().repeat_interleave(rep, dim=2)
    h = torch.zeros(b, nh, hp, bmat.shape[-1], dtype=torch.float64,
                    device=x.device)
    ys = torch.empty(b, l, nh, hp, dtype=torch.float64, device=x.device)
    for t in range(l):
        dtx = x[:, t] * dt[:, t][..., None]
        h = (h * torch.exp(dt[:, t] * a)[..., None, None]
             + dtx[..., :, None] * bh[:, t][:, :, None, :])
        ys[:, t] = torch.einsum("bhpn,bhn->bhp", h, ch[:, t])
    return ys, h


def ssd_vs_recurrence(cfg, dev, seed) -> dict:
    """One layer's `ssd_chunked` in float32 at Mamba2-780M's widths (B 8,
    L 1024: 4 chunks of 256) against the float64 recurrence on the card,
    at the reference's rtol / atol 2e-4; the reference test's draw.  Then
    the scan timed at the prefill's length (2048, bf16 inputs)."""
    import numpy as np
    import torch

    from repro_torch.kernels.bench import cuda_ms
    from repro_torch.models import ssm

    b, l, nh, hp, st = SSD_SHAPE
    check((nh, hp, st) == (cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state),
          f"SSD_SHAPE {SSD_SHAPE} is not {cfg.name}'s")
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 is on")
    rng = np.random.default_rng(seed)

    def draw(*shape):
        return torch.as_tensor(rng.standard_normal(shape, dtype=np.float32),
                               device=dev)

    x, bm, cm = draw(b, l, nh, hp), draw(b, l, 1, st) * 0.5, \
        draw(b, l, 1, st) * 0.5
    dt, a_neg = draw(b, l, nh).abs() * 0.1, -draw(nh).abs()
    y, h = ssm.ssd_chunked(cfg, x, bm, cm, dt, a_neg)
    y_ref, h_ref = ssd_recurrence64(x, bm, cm, dt, a_neg)
    res = {"shape": list(SSD_SHAPE), "chunk": ssm.chunk_size(cfg, l),
           "bar": SSD_BAR}
    for name, got, want in (("y", y, y_ref), ("h", h, h_ref)):
        err = (got.double() - want).abs()
        res[name] = {"max_abs_err": err.max().item(),
                     "ref_abs_max": want.abs().max().item(),
                     "within": bool((err <= SSD_BAR + SSD_BAR * want.abs())
                                    .all().item())}
    check(res["y"]["within"] and res["h"]["within"],
          f"ssd_chunked vs the float64 recurrence: {res}")
    del y, h, y_ref, h_ref
    # the scan at the prefill's length, as a layer runs it
    xb, bb, cb = (torch.cat([t, t], 1).to(torch.bfloat16) for t in (x, bm, cm))
    dt2 = torch.cat([dt, dt], 1)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    res["prefill_scan_ms"] = cuda_ms(
        lambda: ssm.ssd_chunked(cfg, xb, bb, cb, dt2, a_neg), 5, 1)[0]
    res["prefill_scan_shape"] = [b, 2 * l, nh, hp, st]
    res["prefill_scan_peak_gb"] = (torch.cuda.max_memory_allocated()
                                   - base) / 1e9
    log("[ssm] ssd_chunked vs the float64 recurrence: " + json.dumps(res))
    return res


def split_layer(cfg, lp):
    """Fused Mamba2 weights re-partitioned into the split layout (views):
    the same linear map (tests/test_perf_features.py's `_split_params`)."""
    di, gs = cfg.d_inner, cfg.ssm_ngroups * cfg.ssm_state
    w, cw, cb = lp["in_proj"], lp["conv_w"], lp["conv_b"]
    out = {k: v for k, v in lp.items()
           if k not in ("in_proj", "conv_w", "conv_b")}
    out.update(in_z=w[..., :di], in_x=w[..., di:2 * di],
               in_B=w[..., 2 * di:2 * di + gs],
               in_C=w[..., 2 * di + gs:2 * di + 2 * gs],
               in_dt=w[..., 2 * di + 2 * gs:],
               conv_x_w=cw[..., :di], conv_x_b=cb[..., :di],
               conv_B_w=cw[..., di:di + gs], conv_B_b=cb[..., di:di + gs],
               conv_C_w=cw[..., di + gs:], conv_C_b=cb[..., di + gs:])
    return out


def split_vs_fused(cfg32, p32, prompts) -> dict:
    """The whole model in float32 (TF32 off) with `ssm_split_proj` and the
    weights re-partitioned (views) against the fused layout: prefill
    logits over 2 x 512 tokens and a decode step, within the reference's
    1e-4."""
    import torch

    from repro_torch.models import registry as models

    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 is on")
    cfg_split = dataclasses.replace(cfg32, ssm_split_proj=True)
    p_split = dict(p32, layers=split_layer(cfg32, p32["layers"]))
    toks = prompts[:SPLIT_B, :SPLIT_T + 1]
    pos = torch.full((SPLIT_B,), SPLIT_T, dtype=torch.int32,
                     device=toks.device)
    out = {}
    for name, c, p in (("fused", cfg32, p32), ("split", cfg_split, p_split)):
        logits, cache = models.prefill(c, p, {"tokens": toks[:, :-1]})
        step, _ = models.decode_step(c, p, cache, toks[:, -1:], pos)
        out[name] = (logits, step)
    res = {"batch": SPLIT_B, "tokens": SPLIT_T, "bar": SPLIT_BAR}
    for i, what in enumerate(("prefill", "decode")):
        a, b = out["split"][i], out["fused"][i]
        err = (a - b).abs()
        res[what] = {"max_abs_err": err.max().item(),
                     "logit_abs_max": b.abs().max().item(),
                     "within": bool((err <= SPLIT_BAR + SPLIT_BAR * b.abs())
                                    .all().item())}
    check(res["prefill"]["within"] and res["decode"]["within"],
          f"split vs fused layout: {res}")
    log("[ssm] split vs fused layout, float32: " + json.dumps(res))
    return res


def decode_checks(cfg, params, toks) -> tuple[dict, tuple]:
    """Decode vs the prefill of one more token, held at 2e-2 on the model
    in float32 (the same weights; the dtype of the reference's test) and
    recorded in bf16, where the reference's own numerics exceed the bar
    at these depths (ROADMAP.md, queue 3).  Returns the records and the
    float32 model, for further checks."""
    cfg32, p32 = as_float32(cfg, params)
    batch = {"tokens": toks[:NEXT_B]}
    return {"decode_vs_prefill": decode_vs_next_prefill(cfg32, p32, batch),
            "decode_vs_prefill_bf16": decode_vs_next_prefill(
                cfg, params, batch, gate=False)}, (cfg32, p32)


def ssm_checks(args, dev):
    """Mamba2-780M beyond the engine (`extra` of its serve phase): decode
    after a 2047-token prefill (chunks of 89) vs the prefill of 2048
    (`decode_checks`), and in bf16 at the depths `BF16_DEPTHS`; the split
    layout against the fused, in float32; the SSD against the float64
    recurrence; the strap backend's refusal."""
    import torch

    def run(cfg, params, prompts):
        toks = torch.as_tensor(prompts, device=dev)
        res, (cfg32, p32) = decode_checks(cfg, params, toks)
        res["split_vs_fused"] = split_vs_fused(cfg32, p32, toks)
        del p32
        # the bf16 gap's growth with depth: the first n layers' weights
        res["decode_vs_prefill_bf16_by_depth"] = {
            n: decode_vs_next_prefill(
                dataclasses.replace(cfg, n_layers=n),
                dict(params, layers={k: v[:n] for k, v in
                                     params["layers"].items()}),
                {"tokens": toks[:NEXT_B]}, gate=False)["rel_err"]
            for n in BF16_DEPTHS}
        res["ssd_vs_recurrence"] = ssd_vs_recurrence(cfg, dev, args.seed)
        res["strap_backend_refusal"] = engine_refusal(cfg, params, dev)
        return res

    return run


def hybrid_checks(args, dev):
    """Zamba2-7B beyond the engine (`extra` of its serve phase): decode
    after a 2047-token prefill vs the prefill of 2048 (`decode_checks`:
    the float32 copy of its 6.6 B weights takes 26.5 GB); the engine's
    cache
    after prefill, the shared block's K/V grown on its sequence axis only
    and every SSM state as prefill left it; the strap backend's
    refusal."""
    import torch

    from repro_torch.models import registry as models
    from repro_torch.serving.engine import ServeEngine

    def run(cfg, params, prompts):
        toks = torch.as_tensor(prompts, device=dev)
        res = decode_checks(cfg, params, toks)[0]
        torch.cuda.empty_cache()
        _, cache = models.prefill(cfg, params,
                                  {"tokens": toks[:NEXT_B, :KV_CHECK_T]})
        eng = ServeEngine(cfg, params, max_tokens=KV_CHECK_MAX, device=dev)
        eng.prefill(toks[:NEXT_B, :KV_CHECK_T])
        want = {k: v.shape for k, v in
                models.cache_schema(cfg, NEXT_B, KV_CHECK_MAX).items()}
        got = {k: tuple(v.shape) for k, v in eng._cache.items()}
        grown = {k: [list(cache[k].shape), list(eng._cache[k].shape)]
                 for k in cache}
        same = all(torch.equal(eng._cache[k], cache[k]) for k in cache
                   if k not in ("k", "v"))
        kv_held = all(torch.equal(eng._cache[k][:, :, :KV_CHECK_T], cache[k])
                      and not eng._cache[k][:, :, KV_CHECK_T:].any()
                      for k in ("k", "v"))
        res["engine_cache"] = {"prefill_to_engine": grown,
                               "states_unchanged": same,
                               "kv_prefix_held": kv_held}
        check(got == want and same and kv_held,
              f"{cfg.name}: the engine's cache {res['engine_cache']}, "
              f"schema {want}")
        log(f"[hybrid] engine cache: " + json.dumps(res["engine_cache"]))
        del eng, cache
        res["strap_backend_refusal"] = engine_refusal(cfg, params, dev)
        return res

    return run


def whisper_phase(args, dev, strap_kernel) -> dict:
    """Whisper-tiny in full (4 + 4 layers, d 384, bf16, seeded weights):
    8 sequences of 1,500 encoder frames (stub embeddings from the seed)
    and 128 decoder tokens through `models.registry.prefill`, then 32
    greedy decode steps through `registry.decode_step` (the main path,
    strap_attend's launches counted: none), the cross cache bit for bit
    unchanged across them; one step profiled; decode vs the prefill of
    one more token; the engine's refusal."""
    import numpy as np
    import torch

    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels.bench import profile
    from repro_torch.models import registry as models

    set_precision()
    cfg = get_arch(WHISPER_ARCH)
    reckoned = init_reckoning(cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = models.init_params(
        cfg, torch.Generator(device=dev).manual_seed(args.seed), device=dev)
    n_params = sum(t.numel() for t in param_tensors(params))
    check(n_params == reckoned["n_params"],
          f"whisper: {n_params} params, the schema {reckoned['n_params']}")
    rng = np.random.default_rng(args.seed)
    b, t_dec, new = WHISPER_B, WHISPER_TOKENS, WHISPER_NEW
    enc = torch.as_tensor((rng.normal(size=(b, WHISPER_FRAMES, cfg.d_model))
                           * 0.02).astype(np.float32), device=dev)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (b, t_dec + 1)),
                           dtype=torch.int32, device=dev)
    batch = {"enc_embeds": enc, "tokens": toks[:, :t_dec]}
    refusal = engine_refusal(cfg, params, dev, "dense")
    sync = torch.cuda.synchronize
    models.prefill(cfg, params, batch)                       # warm-up
    # the main path: prefill, then greedy decode steps, launches counted
    strap_kernel.launches = 0
    sync()
    t0 = time.perf_counter()
    logits, cache = models.prefill(cfg, params, batch)
    sync()
    prefill_s = time.perf_counter() - t0
    cache = pad_kv(cache, t_dec + new + 16)
    xk, xv = cache["xk"].clone(), cache["xv"].clone()
    pos = torch.full((b,), t_dec, dtype=torch.int32, device=dev)
    steps, finite = [], bool(torch.isfinite(logits).all().item())
    for _ in range(new):
        tok = logits.argmax(-1)[:, None].to(torch.int32)
        t0 = time.perf_counter()
        logits, cache = models.decode_step(cfg, params, cache, tok, pos)
        sync()
        steps.append((time.perf_counter() - t0) * 1e3)
        finite = finite and bool(torch.isfinite(logits).all().item())
        pos = pos + 1
    launches = strap_kernel.launches
    check(launches == 0, f"whisper: {launches} strap_attend launches")
    cross_same = (torch.equal(cache["xk"], xk)
                  and torch.equal(cache["xv"], xv))
    check(finite and cross_same and tuple(logits.shape) == (
        b, cfg.padded_vocab), f"whisper: finite {finite}, cross cache "
        f"unchanged {cross_same}, logits {tuple(logits.shape)}")
    tok = logits.argmax(-1)[:, None].to(torch.int32)
    step_ms = statistics.median(steps)
    record = {"arch": cfg.name, "n_params": n_params,
              "reckoned_init": reckoned, "batch": b,
              "encoder_frames": WHISPER_FRAMES, "decoder_tokens": t_dec,
              "new_tokens": new, "launches": launches,
              "prefill_s": prefill_s, "decode_step_ms_median": step_ms,
              "decode_step_ms": steps,
              "decode_tokens_per_s": b / (step_ms / 1e3),
              "cross_cache_bitwise_unchanged": cross_same,
              "profile": profile(lambda: models.decode_step(
                  cfg, params, cache, tok, pos)),
              "decode_vs_prefill": decode_vs_next_prefill(
                  cfg, params, {"enc_embeds": enc, "tokens": toks}),
              "engine_refusal": refusal,
              "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    log("[whisper] " + json.dumps({k: v for k, v in record.items()
                                   if k != "decode_step_ms"}))
    del params, cache
    torch.cuda.empty_cache()
    return record


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


# --------------------------------------------------------------------------
# training: card vs CPU, OLMo-1B and Mamba2-780M at full width, the example
# twin's config with a crash, the CLI
# --------------------------------------------------------------------------

TRAIN_B, TRAIN_S = 4, 64            # phase 24's batch (tests' smoke size)
TRAIN_BAR = 2e-5                    # tests/test_torch_train_step.py
TRAIN_SSD_BAR = 2e-4                # the reference's SSD bar
OLMO_TRAIN = ("olmo-1b", 8, 2048, 12)         # arch, batch, seq, steps
MAMBA_TRAIN = ("mamba2-780m", 8, 2048, 6)
SSD_GRAD_SHAPE = (2, 1024)          # B, L of the float64 gradient check
BF16_PEAK_FLOPS = 989e12            # H100 SXM dense bf16, data sheet
TRAIN_CLI_ARGS = ["--arch", "qwen2-1.5b", "--smoke", "--steps", "25",
                  "--batch", "4", "--seq", "64", "--ckpt-every", "8",
                  "--inject-crash", "12"]


def tree_bytes(tree) -> int:
    from repro_torch.tree import leaves

    return sum(t.numel() * t.element_size() for t in leaves(tree))


def train_batch(cfg, rng, b, s, dev) -> dict:
    """Tokens and next-token targets (and the stub vision / encoder
    embeddings a VLM / enc-dec takes) from a numpy generator."""
    import numpy as np
    import torch

    toks = rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    if cfg.n_vision_tokens:
        batch["vision_embeds"] = rng.standard_normal(
            (b, cfg.n_vision_tokens, cfg.d_model), dtype=np.float32)
    if cfg.is_encdec:
        batch["enc_embeds"] = rng.standard_normal((b, s // 2, cfg.d_model),
                                                  dtype=np.float32)
    return {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}


def train_parity_phase(args, dev) -> dict:
    """Phase 24: one `make_train_step` step of every smoke config, float32,
    on the card and on the CPU from the same weights and batch (and one
    with microbatch=2 on qwen2-1.5b-smoke): loss and grad_norm within 2e-5
    relative, every parameter after the step within 2e-5 of max(max|cpu|,
    lr) (2e-4 on the ssm and hybrid configs), every parameter moved and
    finite.  Adam's eps is 1e-3, as in tests/test_torch_train_step.py:
    with 1e-8 the first step is the sign of the gradient, and an element
    whose gradient is rounding noise moves by +-lr on a coin flip."""
    import numpy as np
    import torch

    from repro_torch.configs.registry import get_arch, list_archs
    from repro_torch.models import registry as models
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.step import make_train_step
    from repro_torch.tree import leaves_with_paths, tree_map

    set_precision()
    cpu = torch.device("cpu")
    oc = OptConfig(lr=1e-3, eps=1e-3, warmup_steps=1, total_steps=10)
    cases = [(n + "-smoke", None) for n in list_archs()]
    cases.append(("qwen2-1.5b-smoke", 2))
    out = {}
    for name, microbatch in cases:
        cfg = get_arch(name)
        tol = TRAIN_SSD_BAR if cfg.family in ("ssm", "hybrid") else TRAIN_BAR
        params = models.init_params(
            cfg, torch.Generator().manual_seed(args.seed), "cpu")
        start = tree_map(torch.clone, params)
        batch = train_batch(cfg, np.random.default_rng(args.seed), TRAIN_B,
                            TRAIN_S, cpu)
        res = {}
        for d in (cpu, dev):
            p = tree_map(lambda t: t.to(d, copy=True), start)
            fn, opt = make_train_step(cfg, oc, microbatch)
            p, _, m = fn(p, opt.init(p),
                         {k: v.to(d) for k, v in batch.items()})
            res[d.type] = (p, {k: v.item() for k, v in m.items()})
        (pc, mc), (pg, mg) = res["cpu"], res[dev.type]
        worst = 0.0
        for (path, want), (_, got), (_, old) in zip(
                leaves_with_paths(pc), leaves_with_paths(pg),
                leaves_with_paths(start)):
            got = got.detach().cpu()
            check(bool(torch.isfinite(got).all()),
                  f"{name}: {path} not finite after the step")
            check(not torch.equal(got, old), f"{name}: {path} did not move")
            scale = max(want.abs().max().item(), oc.lr)
            err = (got - want).abs().max().item() / scale
            worst = max(worst, err)
            check(err <= tol, f"{name}: {path} card vs cpu {err:.3e} of "
                  f"max(max|cpu|, lr), bar {tol}")
        rel = {k: abs(mg[k] - mc[k]) / abs(mc[k]) for k in mc}
        check(all(r <= TRAIN_BAR for r in rel.values()),
              f"{name}: card vs cpu metrics {mg} vs {mc}")
        key = name + (f"/microbatch{microbatch}" if microbatch else "")
        out[key] = {"loss": mg["loss"], "grad_norm": mg["grad_norm"],
                    "loss_rel_err": rel["loss"],
                    "grad_norm_rel_err": rel["grad_norm"],
                    "param_worst_err": worst, "bar": tol}
        log(f"[train-parity] {key}: loss {mg['loss']:.6f} (cpu "
            f"{mc['loss']:.6f}), grad_norm rel {rel['grad_norm']:.2e}, "
            f"worst parameter {worst:.2e} of max(max|cpu|, lr) (bar {tol})")
    return out


def train_flops(cfg, n_params: int, b: int, s: int) -> float:
    """6 N T + the attention's 12 L S d per token (0 for the SSM)."""
    attn = 12 * cfg.n_layers * s * cfg.d_model if cfg.n_heads else 0
    return (6 * n_params + attn) * b * s


def timed_steps(step_fn, params, state, loader, steps, dev):
    """`steps` train steps on `loader.batch_at(i)`: (params, state,
    losses, step ms each: host clock around the step and a sync, with the
    batch already on the card)."""
    import torch

    losses, ms = [], []
    for i in range(steps):
        batch = {k: torch.as_tensor(v, device=dev)
                 for k, v in loader.batch_at(i).items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, m = step_fn(params, state, batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(m["loss"].item())
    return params, state, losses, ms


def full_train_run(cfg, oc, spec, dev, seed, start,
                   must_fall: bool = True) -> dict:
    """`spec` steps of `cfg` from the weights `start` (cloned), the last
    under the profiler (its time left out of the median): losses (finite;
    the last below the first when `must_fall`), median step ms, tokens/s,
    train_mfu, peak memory, optimizer-state bytes and the profiled
    step."""
    import torch

    from repro_torch.data.pipeline import (DataLoader, LoaderConfig,
                                           SyntheticSource)
    from repro_torch.kernels.bench import profile
    from repro_torch.train.step import make_train_step
    from repro_torch.tree import leaves, tree_map

    _, b, s, steps = spec
    params = tree_map(torch.clone, start)
    fn, opt = make_train_step(cfg, oc)
    state = opt.init(params)
    loader = DataLoader(SyntheticSource(cfg.vocab_size, seed),
                        LoaderConfig(batch_size=b, seq_len=s, seed=seed))
    try:
        t0 = time.perf_counter()
        loader.batch_at(0)
        batch_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        params, state, losses, ms = timed_steps(fn, params, state, loader,
                                                steps - 1, dev)
        batch = {k: torch.as_tensor(v, device=dev)
                 for k, v in loader.batch_at(steps - 1).items()}
        last = []
        prof = profile(lambda: last.append(fn(params, state, batch)),
                       warmup=False)
        losses.append(last[0][2]["loss"].item())
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
    finally:
        loader.close()
    n_params = sum(t.numel() for t in leaves(params))
    step_ms = statistics.median(ms)
    check(all(math.isfinite(x) for x in losses),
          f"{cfg.name}/{cfg.optimizer}: non-finite losses {losses}")
    check(losses[-1] < losses[0] or not must_fall,
          f"{cfg.name}/{cfg.optimizer}: the loss did not fall {losses}")
    moments = {k: v for k, v in state.items() if k != "count"}
    res = {"optimizer": cfg.optimizer, "batch": b, "seq": s, "steps": steps,
           "losses": losses, "fell": losses[-1] < losses[0],
           "step_ms": ms, "median_step_ms": step_ms,
           "tokens_per_s": b * s / (step_ms / 1e3),
           "train_flops": train_flops(cfg, n_params, b, s),
           "n_params": n_params, "peak_gb": peak_gb,
           "param_bytes": tree_bytes(params),
           "opt_state_bytes": tree_bytes(moments),
           "host_batch_ms": batch_ms, "profile": prof}
    res["train_mfu"] = (res["train_flops"] / (step_ms / 1e3)
                        / BF16_PEAK_FLOPS)
    del params, state
    return res


def olmo_train_phase(args, dev, card) -> dict:
    """Phase 25: OLMo-1B at full width and depth (16 x 2048, MHA 16 heads,
    vocab 50304, bf16 weights, remat on), 8 x 2048 tokens a step from
    `SyntheticSource`, 12 AdamW steps and then 12 AdamW8bit steps from
    the same start; every loss finite, AdamW's falling.  AdamW8bit's are
    recorded, not held to fall: the reference's int8 moments step by
    m / eps where a row's v quantizes to zero, and its loss spikes (the
    port takes the reference's updates; ROADMAP queue 3)."""
    import dataclasses as dc

    import torch

    from repro_torch.configs.registry import get_arch
    from repro_torch.models import registry as models
    from repro_torch.train.optimizer import OptConfig

    cfg = get_arch(OLMO_TRAIN[0])
    check(cfg.remat and cfg.param_dtype == "bfloat16", f"{cfg}")
    oc = OptConfig(lr=3e-4, warmup_steps=2, total_steps=12)
    start = models.init_params(
        cfg, torch.Generator(dev).manual_seed(args.seed), dev)
    out = {"arch": cfg.name, "card": card}
    for name in ("adamw", "adamw8bit"):
        res = full_train_run(dc.replace(cfg, optimizer=name), oc,
                             OLMO_TRAIN, dev, args.seed, start,
                             must_fall=name == "adamw")
        out[name] = res
        torch.cuda.empty_cache()
        log(f"[train-olmo] {name}: losses "
            + " ".join(f"{x:.4f}" for x in res["losses"])
            + f"; median step "
            f"{res['median_step_ms']:.1f} ms, {res['tokens_per_s']:,.0f} "
            f"tokens/s, train_mfu {res['train_mfu']:.3f}, peak "
            f"{res['peak_gb']:.1f} GB, optimizer state "
            f"{res['opt_state_bytes'] / 1e9:.2f} GB; profiled step: idle "
            f"{res['profile']['idle_share']:.3f}, "
            f"{res['profile']['device_kernels']} kernels, top "
            f"{json.dumps(res['profile']['top'][:4])} ({card})")
    ratio = out["adamw8bit"]["opt_state_bytes"] / out["adamw"][
        "opt_state_bytes"]
    check(0.25 <= ratio < 0.3, f"AdamW8bit / AdamW state bytes {ratio}")
    out["opt_state_ratio_8bit"] = ratio
    return out


def ssd_grad_check(cfg, dev, seed) -> dict:
    """`ssd_chunked`'s gradients (x, B, C, dt, A) at Mamba2-780M's widths,
    B 2 x L 1024 (4 chunks of 256), in float32 on the card against the
    same function run in float64 on the card: |g32 - g64| <= 2e-4 *
    max|g64| per input.  Two draws: the reference test's (dt ~ 0.1 |N|,
    A = -|N|) and the model's (dt = softplus(N), A = -exp(0.5 N)), whose
    chunks' decay sums pass exp's float32 range in the masked triangle."""
    import numpy as np
    import torch

    from repro_torch.models import ssm

    b, l = SSD_GRAD_SHAPE
    nh, hp, st = cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state
    rng = np.random.default_rng(seed)
    draw = lambda *shape: rng.standard_normal(shape)     # noqa: E731
    x, bm, cm = draw(b, l, nh, hp), draw(b, l, 1, st) * 0.5, \
        draw(b, l, 1, st) * 0.5
    draws = {"test": (np.abs(draw(b, l, nh)) * 0.1, -np.abs(draw(nh))),
             "model": (np.logaddexp(draw(b, l, nh), 0.0),
                       -np.exp(0.5 * draw(nh)))}
    wy = torch.as_tensor(draw(b, l, nh, hp), device=dev)
    q = ssm.chunk_size(cfg, l)
    res = {"shape": [b, l, nh, hp, st], "chunk": q, "bar": TRAIN_SSD_BAR}
    for label, (dt, a_neg) in draws.items():
        inputs = [np.asarray(t, np.float32) for t in (x, bm, cm, dt, a_neg)]

        def grads(dtype):
            ts = [torch.tensor(t, dtype=dtype, device=dev,
                               requires_grad=True) for t in inputs]
            y, _ = ssm.ssd_chunked(cfg, *ts)
            return torch.autograd.grad((y * wy.to(dtype)).sum(), ts)

        decay_sum = float((inputs[3].reshape(b, l // q, q, nh)
                           * -inputs[4]).sum(2).max())
        out = {"max_chunk_decay_sum": decay_sum}
        for name, g32, g64 in zip(("x", "B", "C", "dt", "A"),
                                  grads(torch.float32),
                                  grads(torch.float64)):
            check(bool(torch.isfinite(g32).all()),
                  f"ssd_chunked d/d{name} ({label} draw): not finite")
            err = ((g32.double() - g64).abs().max()
                   / g64.abs().max()).item()
            out[name] = err
            check(err <= TRAIN_SSD_BAR, f"ssd_chunked d/d{name} ({label} "
                  f"draw): float32 vs float64 {err:.3e}")
        res[label] = out
    return res


def ssd_share(cfg, dev, b, s) -> dict:
    """One layer's scan at the step's shapes (bf16 x / B / C as the layer
    gives them), device time by the profiler: the forward alone and the
    forward with its backward.  A remat step runs each layer's scan
    forward twice and backward once."""
    import torch

    from repro_torch.kernels.bench import device_ms
    from repro_torch.models import ssm

    g = torch.Generator(dev).manual_seed(0)
    nh, hp, st = cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state

    def rand(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g, device=dev).to(dtype) \
            .requires_grad_(True)

    x, bm, cm = rand(b, s, nh, hp), rand(b, s, 1, st), rand(b, s, 1, st)
    dt = (rand(b, s, nh, dtype=torch.float32).detach().abs() * 0.1) \
        .requires_grad_(True)
    a_neg = (-rand(nh, dtype=torch.float32).detach().abs()) \
        .requires_grad_(True)
    gy = torch.randn((b, s, nh, hp), generator=g, device=dev)
    ins = (x, bm, cm, dt, a_neg)
    fwd = device_ms(lambda: ssm.ssd_chunked(cfg, *ins), 1)
    both = device_ms(lambda: torch.autograd.grad(
        ssm.ssd_chunked(cfg, *ins)[0], ins, gy), 1)
    return {"layer_fwd_ms": fwd, "layer_fwd_bwd_ms": both,
            "step_scan_ms": cfg.n_layers * (fwd + both)}


def mamba_train_phase(args, dev, card) -> dict:
    """Phase 26: Mamba2-780M at full width and depth (48 layers, bf16,
    remat on), 8 x 2048 tokens, 6 AdamW steps: losses finite and falling,
    step time, peak memory, the SSD scan's share of the step; the scan's
    gradients in float32 against float64 on the card."""
    import torch

    from repro_torch.configs.registry import get_arch
    from repro_torch.models import registry as models
    from repro_torch.train.optimizer import OptConfig

    set_precision()
    cfg = get_arch(MAMBA_TRAIN[0])
    grad = ssd_grad_check(cfg, dev, args.seed)
    log("[train-mamba] ssd_chunked gradients, float32 vs float64 on the "
        "card: " + json.dumps(grad))
    oc = OptConfig(lr=3e-4, warmup_steps=2, total_steps=12)
    start = models.init_params(
        cfg, torch.Generator(dev).manual_seed(args.seed), dev)
    res = full_train_run(cfg, oc, MAMBA_TRAIN, dev, args.seed, start)
    del start
    torch.cuda.empty_cache()
    share = ssd_share(cfg, dev, MAMBA_TRAIN[1], MAMBA_TRAIN[2])
    share["share_of_step"] = share["step_scan_ms"] / res["median_step_ms"]
    share["share_of_busy"] = (share["step_scan_ms"]
                              / res["profile"]["device_busy_ms"])
    out = {"arch": cfg.name, "card": card, "adamw": res, "ssd_grad": grad,
           "ssd_share": share}
    log(f"[train-mamba] adamw: losses "
        + " ".join(f"{x:.4f}" for x in res["losses"])
        + f"; median step {res['median_step_ms']:.1f} "
        f"ms, {res['tokens_per_s']:,.0f} tokens/s, train_mfu "
        f"{res['train_mfu']:.3f}, peak {res['peak_gb']:.1f} GB; idle "
        f"{res['profile']['idle_share']:.3f}; the SSD scan "
        f"{share['step_scan_ms']:.1f} ms a step = "
        f"{share['share_of_step']:.3f} of the step; top "
        f"{json.dumps(res['profile']['top'][:4])} ({card})")
    return out


def load_module(file_name: str):
    """`examples/<file_name>` as a module (examples/ is not a package)."""
    import importlib.util

    path = ROOT / "examples" / file_name
    check(path.is_file(), f"{path} is missing")
    spec = importlib.util.spec_from_file_location(path.stem, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def int_bits(t):
    """A tensor's raw bits as an integer tensor of its width, on its
    device."""
    import torch

    return t.detach().view({1: torch.int8, 2: torch.int16, 4: torch.int32}[
        t.element_size()])


def example_train_phase(dev, card) -> dict:
    """Phase 27: `examples/train_lm_torch.py` on the card at its defaults
    (OLMo-1B cut to d 512, 8 layers, float32; 200 steps of 8 x 256;
    checkpoints every 100; a crash injected at 150): one restart, the
    loss falling, tokens/s; the step-100 checkpoint restored on the CPU
    equals, bit for bit (integer views), the state the card saved."""
    import re
    import tempfile

    import torch

    from repro_torch.ckpt.manager import CheckpointManager
    from repro_torch.tree import leaves_with_paths, tree_map

    example = load_module("train_lm_torch.py")
    saved = {}
    real_save = CheckpointManager.save

    def save(self, step, tree, blocking=True):
        if step == 100:
            saved["tree"] = tree_map(torch.clone, tree)
        return real_save(self, step, tree, blocking)

    with tempfile.TemporaryDirectory() as tmp:
        CheckpointManager.save = save
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out, text = captured(lambda: example.main(
                ["--device", dev.type, "--ckpt-dir", tmp]))
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
        finally:
            CheckpointManager.save = real_save
        check(out["restarts"] == 1 and out["faults"] == [
            "RuntimeError: injected crash at step 150"],
            f"example: restarts {out['restarts']}, faults {out['faults']}")
        check(out["final_loss"] < out["first_loss"], "example: no progress")
        check("tree" in saved, "example: no step-100 checkpoint was saved")
        restored, step = CheckpointManager(tmp).restore(
            100, like=saved["tree"], device="cpu")
        mismatched = [
            "/".join(p) for (p, a), (_, b) in zip(
                leaves_with_paths(saved["tree"]),
                leaves_with_paths(restored))
            if a.dtype != b.dtype or not torch.equal(int_bits(a.cpu()),
                                                     int_bits(b))]
        check(step == 100 and not mismatched,
              f"the step-100 checkpoint differs from the card's state: "
              f"{mismatched[:5]}")
    lines = text.splitlines()
    for line in lines[:1] + [ln for ln in lines if ln.startswith(
            ("[fault]", "final:"))]:
        log(f"[train-example] {line}")
    shape = re.search(r"steps x (\d+)x(\d+) tokens", lines[0])
    check(shape is not None, f"example: first line {lines[0]!r}")
    ran = len(out["losses"])                 # replayed steps included
    tokens = ran * int(shape[1]) * int(shape[2])
    res = {"card": card, "restarts": out["restarts"],
           "faults": out["faults"], "first_loss": out["first_loss"],
           "final_loss": out["final_loss"], "steps_run": ran,
           "wall_s": wall_s, "tokens_per_s": tokens / wall_s,
           "ckpt_leaves": len(leaves_with_paths(saved["tree"])),
           "step100_bit_identical": True}
    log(f"[train-example] {ran} steps run (200 + the 50 replayed) in "
        f"{wall_s:.1f} s, {res['tokens_per_s']:,.0f} train tokens/s "
        f"(checkpoints and the restart included); the step-100 checkpoint "
        f"({res['ckpt_leaves']} leaves) restores on the CPU bit for bit "
        f"({card})")
    return res


def train_cli_phase(dev) -> dict:
    """Phase 28: `python -m repro_torch.launch.train --arch qwen2-1.5b
    --smoke --steps 25 --batch 4 --seq 64 --ckpt-every 8 --inject-crash
    12` in a subprocess on the card: its `done:` line shows 1 restart and
    a falling loss."""
    import os
    import re
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        env = dict(os.environ, PYTHONPATH=str(SRC))
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train",
             *TRAIN_CLI_ARGS, "--ckpt-dir", tmp, "--device", dev.type],
            capture_output=True, text=True, env=env, timeout=300,
            check=False)
        wall_s = time.perf_counter() - t0
    for line in proc.stdout.splitlines():
        log(f"[train-cli] {line}")
    check(proc.returncode == 0, f"launch.train: rc {proc.returncode}\n"
          f"{proc.stderr[-3000:]}")
    done = re.fullmatch(r"done: first loss ([\d.]+) -> final ([\d.]+) "
                        r"\((\d+) restarts\)",
                        proc.stdout.rstrip().splitlines()[-1])
    check(done is not None, f"launch.train printed {proc.stdout[-300:]!r}")
    first, final, restarts = (float(done[1]), float(done[2]),
                              int(done[3]))
    check(restarts == 1 and final < first,
          f"launch.train: {restarts} restarts, loss {first} -> {final}")
    return {"first_loss": first, "final_loss": final, "restarts": restarts,
            "wall_s": wall_s}


# --------------------------------------------------------------------------
# distributed training: NCCL at world size 1, two gloo processes sharing the
# card (ZeRO over "data"; expert parallelism over "model")
# --------------------------------------------------------------------------

DIST_OLMO = ("olmo-1b", 8, 2048)          # arch, global batch, seq (A, B)
DIST_A_STEPS, DIST_B_STEPS = 3, 3
DIST_LR = 3e-4          # OptConfig's defaults: 100 warm-up steps from 0
DIST_B_MESH, DIST_B_RESTORE_MESH = (1, 2, 1), (1, 1, 2)
EP_ARCH, EP_MESH = "phi3.5-moe-42b-a6.6b", (1, 1, 2)
EP_TOKENS = (4, 512)                      # phase 18's shape
EP_BAR = 2e-5                             # tests/test_torch_moe_ep.py
EP_BF16_BAR = 3e-2                        # the port's bf16 bar
DIST_TIMEOUT_S = 600.0


def olmo_batches(cfg, b, s, seed, steps, dev) -> list:
    """`steps` batches of b x s tokens from `SyntheticSource` (phase 25's
    source), on `dev`."""
    import torch

    from repro_torch.data.pipeline import (DataLoader, LoaderConfig,
                                           SyntheticSource)

    loader = DataLoader(SyntheticSource(cfg.vocab_size, seed),
                        LoaderConfig(batch_size=b, seq_len=s, seed=seed))
    try:
        return [{k: torch.as_tensor(v, device=dev)
                 for k, v in loader.batch_at(i).items()}
                for i in range(steps)]
    finally:
        loader.close()


def timed_run(fn, params, state, batches) -> tuple:
    """The steps of `fn` over `batches`: (params, state, [loss, grad_norm
    per step], step ms each: host clock around the step and a sync)."""
    metrics, ms = [], []
    for batch in batches:
        dev = next(iter(batch.values())).device
        sync(dev)
        t0 = time.perf_counter()
        params, state, m = fn(params, state, batch)
        sync(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
        metrics += [m["loss"], m["grad_norm"]]
    return params, state, metrics, ms


def dist_world1_phase(args, dev, card) -> dict:
    """Phase 29 (A): an NCCL group of one rank, mesh (1, 1, 1).  OLMo-1B at
    full width and depth (bf16, remat), 8 x 2048 from `SyntheticSource`:
    DIST_A_STEPS `make_sharded_train_step` steps against as many
    `make_train_step` steps from the same weights and batches
    (`OptConfig(lr=DIST_LR)`).  The parameters, the AdamW state, the
    losses and the grad norms must match bit for bit."""
    import tempfile

    import torch
    import torch.distributed as dist

    from repro_torch.configs.registry import get_arch
    from repro_torch.distributed.sharding import shard_tree
    from repro_torch.launch.mesh import make_train_mesh
    from repro_torch.models import registry as models
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.step import (make_sharded_train_step,
                                        make_train_step, train_specs)
    from repro_torch.tree import leaves, tree_map

    set_precision()
    arch, b, s = DIST_OLMO
    cfg = get_arch(arch)
    oc = OptConfig(lr=DIST_LR)
    start = models.init_params(
        cfg, torch.Generator(dev).manual_seed(args.seed), dev)
    batches = olmo_batches(cfg, b, s, args.seed, DIST_A_STEPS, dev)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    out = {"arch": cfg.name, "card": card, "mesh": [1, 1, 1],
           "backend": backend, "batch": [b, s]}
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(backend, init_method=f"file://{tmp}/rdv",
                                world_size=1, rank=0)
        try:
            mesh = make_train_mesh((1, 1, 1), device=dev.type)
            for name in ("single", "sharded"):
                params = tree_map(torch.clone, start)
                if name == "single":
                    fn, opt = make_train_step(cfg, oc)
                else:
                    params = shard_tree(params, train_specs(cfg, mesh)[0],
                                        mesh)
                    fn, opt = make_sharded_train_step(cfg, mesh, oc)
                state = opt.init(params)
                if dev.type == "cuda":
                    torch.cuda.reset_peak_memory_stats()
                params, state, metrics, ms = timed_run(fn, params, state,
                                                       batches)
                runs[name] = leaves({"o": state, "p": params}) + metrics
                out[name] = {"step_ms": ms,
                             "losses": [m.item() for m in metrics[::2]],
                             "peak_gb": _peak_gb(dev)}
                del params, state
        finally:
            dist.destroy_process_group()
    same = [a.dtype == b.dtype and bool(torch.equal(int_bits(a),
                                                   int_bits(b)))
            for a, b in zip(runs["single"], runs["sharded"])]
    del runs, start
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out["leaves_compared"] = len(same)
    out["bit_identical"] = all(same)
    check(out["bit_identical"], f"A: {same.count(False)} of {len(same)} "
          "leaves / metrics of the sharded step differ from the train step")
    log(f"[dist-A] {backend} world 1, mesh (1, 1, 1), {cfg.name} {b} x {s}: "
        f"sharded == make_train_step bit for bit over {len(same)} leaves "
        f"and metrics; step ms single {out['single']['step_ms']}, sharded "
        f"{out['sharded']['step_ms']}; losses {out['sharded']['losses']}; "
        f"peak {out['single']['peak_gb']} / {out['sharded']['peak_gb']} GB "
        f"({card})")
    return out


def _timing_wrapper(fn, spent: dict, key: str, dev):
    """`fn` with its host-clock time, between two syncs, added to
    `spent[key]`."""
    def wrapper(*a, **k):
        sync(dev)
        t0 = time.perf_counter()
        res = fn(*a, **k)
        sync(dev)
        spent[key] += (time.perf_counter() - t0) * 1e3
        return res
    return wrapper


def _local_batch(batch, mesh) -> dict:
    from repro_torch.distributed.sharding import batch_specs, local_block

    specs = batch_specs(batch, mesh)
    return {k: local_block(v, specs[k], mesh).contiguous()
            for k, v in batch.items()}


def _smoke_steps_vs_single(mesh, seed, dev) -> dict:
    """One float32 sharded step of every smoke config (and of
    qwen2-1.5b-smoke with microbatch=2) at 4 x 64 against the
    single-process step on the card: phase 24's bars.  Returns the
    results and qwen2-1.5b-smoke's state (local blocks) and specs."""
    import numpy as np
    import torch

    from repro_torch.configs.registry import get_arch, list_archs
    from repro_torch.distributed.sharding import gather_tree, shard_tree
    from repro_torch.models import registry as models
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.step import (make_sharded_train_step,
                                        make_train_step, train_specs)
    from repro_torch.tree import leaves, leaves_with_paths, tree_map

    oc = OptConfig(lr=1e-3, eps=1e-3, warmup_steps=1, total_steps=10)
    cases = [(n + "-smoke", None) for n in list_archs()]
    cases.append(("qwen2-1.5b-smoke", 2))
    out, kept = {}, None
    for name, microbatch in cases:
        cfg = get_arch(name)
        tol = TRAIN_SSD_BAR if cfg.family in ("ssm", "hybrid") else TRAIN_BAR
        start = models.init_params(cfg, torch.Generator().manual_seed(seed),
                                   "cpu")
        batch = train_batch(cfg, np.random.default_rng(seed), TRAIN_B,
                            TRAIN_S, dev)
        fn, opt = make_train_step(cfg, oc, microbatch)
        single = tree_map(lambda t: t.to(dev, copy=True), start)
        single, _, ms = fn(single, opt.init(single), batch)
        p_specs, o_specs = train_specs(cfg, mesh)
        params = tree_map(torch.clone, shard_tree(
            tree_map(lambda t: t.to(dev), start), p_specs, mesh))
        sfn, sopt = make_sharded_train_step(cfg, mesh, oc, microbatch)
        state = sopt.init(params)
        params, state, m = sfn(params, state, _local_batch(batch, mesh))
        worst = 0.0
        for (path, want), got in zip(leaves_with_paths(single),
                                     leaves(gather_tree(params, p_specs,
                                                        mesh))):
            scale = max(want.abs().max().item(), oc.lr)
            err = (got - want).abs().max().item() / scale
            worst = max(worst, err)
            check(err <= tol, f"B: {name}: {path} sharded vs single "
                  f"{err:.3e} of max(max|single|, lr), bar {tol}")
        rel_err = {k: rel(m[k].item(), ms[k].item()) for k in ms}
        check(all(r <= TRAIN_BAR for r in rel_err.values()),
              f"B: {name}: sharded metrics {m} vs single {ms}")
        key = name + (f"/microbatch{microbatch}" if microbatch else "")
        out[key] = {"optimizer": cfg.optimizer, "loss": m["loss"].item(),
                    "loss_rel_err": rel_err["loss"],
                    "grad_norm_rel_err": rel_err["grad_norm"],
                    "param_worst_err": worst, "bar": tol}
        if name == "qwen2-1.5b-smoke" and microbatch is None:
            kept = (cfg, {"opt": state, "params": params},
                    {"opt": o_specs, "params": p_specs})
    return out, kept


def _restore_checks(kept, mesh, ckpt_dir, dev) -> dict:
    """`kept` saved sharded from `mesh`; restored whole on rank 0 and on
    mesh DIST_B_RESTORE_MESH, each gathered tree against the saved one,
    bit for bit."""
    import torch
    import torch.distributed as dist

    from repro_torch.ckpt.manager import CheckpointManager
    from repro_torch.distributed.sharding import gather_tree
    from repro_torch.launch.mesh import make_train_mesh
    from repro_torch.train.step import train_specs
    from repro_torch.tree import leaves

    cfg, tree, specs = kept
    mgr = CheckpointManager(ckpt_dir)
    mgr.save(1, tree, mesh=mesh, specs=specs)
    want = gather_tree(tree, specs, mesh)
    res = {"arch": cfg.name, "saved_on": list(DIST_B_MESH)}
    if dist.get_rank() == 0:
        whole, _ = mgr.restore(1, like=want, device=dev)
        res["whole_bit_identical"] = all(
            torch.equal(int_bits(a), int_bits(b))
            for a, b in zip(leaves(whole), leaves(want)))
        check(res["whole_bit_identical"], "B: the whole restore differs")
    mesh_b = make_train_mesh(DIST_B_RESTORE_MESH, device=dev.type)
    pb, ob = train_specs(cfg, mesh_b)
    specs_b = {"opt": ob, "params": pb}
    got, _ = mgr.restore(1, like=want, device=dev, mesh=mesh_b,
                         specs=specs_b)
    res["restored_on"] = list(DIST_B_RESTORE_MESH)
    res["resharded_bit_identical"] = all(
        torch.equal(int_bits(a), int_bits(b)) for a, b in
        zip(leaves(gather_tree(got, specs_b, mesh_b)), leaves(want)))
    check(res["resharded_bit_identical"], "B: the resharded restore differs")
    return res


def _kernel_wrappers() -> dict:
    """The three ported kernels' wrappers, by name (their `launches`
    counts are per process)."""
    from repro_torch.kernels import rc_transient, row_cycle, strap_gather

    return {"row_cycle_fused": row_cycle.row_cycle_fused_cuda,
            "rc_multistep": rc_transient.rc_multistep_cuda,
            "strap_attend": strap_gather.strap_attend_cuda}


def _zero_launches() -> dict:
    wrappers = _kernel_wrappers()
    for k in wrappers.values():
        k.launches = 0
    return wrappers


def _member_device(device: str):
    """This member's device: the card (cuda:0, which both members share)
    or the CPU."""
    import torch

    if device == "cuda":
        torch.cuda.set_device(0)
        return torch.device("cuda", 0)
    return torch.device(device)


def _peak_gb(dev):
    import torch

    return torch.cuda.max_memory_allocated() / 1e9 \
        if dev.type == "cuda" else None


def dist_member_zero(seed: int, ckpt_dir: str, arch: str, batch: int,
                     seq: int, steps: int, lr: float, device: str) -> dict:
    """Phase 30 (B), in each of two gloo processes sharing cuda:0, mesh
    (1, 2, 1): OLMo-1B at full width, 8 x 2048 global (4 x 2048 a rank),
    DIST_B_STEPS AdamW steps (losses finite and falling; step time, the
    host-clock time of the parameter gather and of the gradient psum,
    peak memory and optimizer-state bytes); one float32 step of each smoke
    config against the single-process step; qwen2-1.5b-smoke's state saved
    sharded and restored whole and on (1, 1, 2), bit for bit."""
    import torch
    import torch.distributed as dist

    import repro_torch.train.step as step_mod
    from repro_torch.configs.registry import get_arch
    from repro_torch.distributed.sharding import shard_tree
    from repro_torch.launch.mesh import make_train_mesh
    from repro_torch.models import registry as models
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.tree import tree_map

    wrappers = _zero_launches()
    set_precision()
    dev = _member_device(device)
    mesh = make_train_mesh(DIST_B_MESH, device=device)
    rank = dist.get_rank()
    cfg = get_arch(arch)
    oc = OptConfig(lr=lr)
    p_specs, _ = step_mod.train_specs(cfg, mesh)
    full = models.init_params(cfg, torch.Generator(dev).manual_seed(seed),
                              dev)
    params = tree_map(torch.clone, shard_tree(full, p_specs, mesh))
    del full
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    spent = {"gather_ms": 0.0, "psum_ms": 0.0}
    step_mod.gather_block = _timing_wrapper(step_mod.gather_block, spent,
                                            "gather_ms", dev)
    step_mod.hierarchical_psum_tree = _timing_wrapper(
        step_mod.hierarchical_psum_tree, spent, "psum_ms", dev)
    fn, opt = step_mod.make_sharded_train_step(cfg, mesh, oc)
    state = opt.init(params)
    batches = [_local_batch(b, mesh) for b in
               olmo_batches(cfg, batch, seq, seed, steps, dev)]
    params, state, metrics, ms = timed_run(fn, params, state, batches)
    losses = [m.item() for m in metrics[::2]]
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
          f"B: rank {rank}: losses {losses}")
    olmo = {"arch": cfg.name, "mesh": list(DIST_B_MESH),
            "local_batch": list(batches[0]["tokens"].shape),
            "losses": losses, "step_ms": ms,
            "gather_ms": spent["gather_ms"] / len(ms),
            "psum_ms": spent["psum_ms"] / len(ms),
            "peak_gb": _peak_gb(dev),
            "param_bytes": tree_bytes(params),
            "opt_state_bytes": tree_bytes({k: v for k, v in state.items()
                                           if k != "count"})}
    del params, state, batches
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    smoke, kept = _smoke_steps_vs_single(mesh, seed, dev)
    restore = _restore_checks(kept, mesh, ckpt_dir, dev)
    return {"rank": rank, "olmo": olmo, "smoke": smoke, "restore": restore,
            "kernel_launches": {n: k.launches for n, k in wrappers.items()}}


def _dropped_pairs(cfg, p, xs) -> int:
    """Pairs beyond the capacity of the tokens `xs` routed alone."""
    import torch

    from repro_torch.models import moe

    xf = xs.reshape(-1, xs.shape[-1])
    _, _, idx = moe._route(cfg, p, xf)
    counts = torch.bincount(idx.reshape(-1), minlength=cfg.n_experts)
    return int((counts - moe._capacity(cfg, xf.shape[0])).clamp(min=0)
               .sum().item())


def dist_member_ep(seed: int, arch: str, batch: int, seq: int,
                   device: str) -> dict:
    """Phase 31 (C), in each of two gloo processes sharing cuda:0, mesh
    (1, 1, 2): one Phi-3.5-MoE layer at full width (d 4096, 16 experts,
    top 2), tokens 4 x 512.  `moe_apply_ep` forward and backward, in
    float32 and bf16, against `moe_apply` on this rank's own sequence
    slice (no mesh): outputs and the input's gradient within EP_BAR of
    max|ref| in float32 (EP_BF16_BAR in bf16), the router's gradient and
    the first expert of each rank's block against the sum over the ranks
    of the local gradients; four all-to-alls a forward and backward (the
    EP path ran, no fallback); pairs dropped and times recorded."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs.registry import get_arch
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed import context as mesh_ctx
    from repro_torch.launch.mesh import make_train_mesh
    from repro_torch.models import moe
    from repro_torch.models.common import init_from_schema

    wrappers = _zero_launches()
    set_precision()
    dev = _member_device(device)
    mesh = make_train_mesh(EP_MESH, device=device)
    model = mesh.get_group("model")
    r, ep = mesh_ctx.mesh_coords(mesh)["model"], EP_MESH[2]
    cfg = get_arch(arch)
    b, s = batch, seq
    sl = s // ep
    p32 = init_from_schema(moe.moe_schema(cfg),
                           torch.Generator(dev).manual_seed(seed),
                           torch.float32, dev)
    gen = torch.Generator(dev).manual_seed(seed + 1)
    x32 = torch.randn((b, s, cfg.d_model), generator=gen, device=dev)
    wy = torch.randn((b, s, cfg.d_model), generator=gen, device=dev)
    keys = sorted(p32)
    el = cfg.n_experts // ep
    out = {"arch": cfg.name, "mesh": list(EP_MESH), "tokens": [b, s],
           "d_model": cfg.d_model, "n_experts": cfg.n_experts,
           "top_k": cfg.top_k, "rank": dist.get_rank(), "model_coord": r}
    for dtype, bar in ((torch.float32, EP_BAR), (torch.bfloat16, EP_BF16_BAR)):
        p = {k: v.to(dtype).requires_grad_() for k, v in p32.items()}
        x = x32.to(dtype).requires_grad_()
        before = C.counts["all_to_all"]
        sync(dev)
        t0 = time.perf_counter()
        with mesh_ctx.mesh_scope(mesh):
            y, aux = moe.moe_apply_ep(cfg, p, x)
            sync(dev)
            t1 = time.perf_counter()
            grads = torch.autograd.grad((y.float() * wy).sum(),
                                        [x] + [p[k] for k in keys])
        sync(dev)
        t2 = time.perf_counter()
        a2a = C.counts["all_to_all"] - before
        check(a2a == 4, f"C: {a2a} all-to-alls, expected 4 (EP fell back?)")
        # the reference semantics: moe_apply on this rank's tokens alone
        ps = {k: v.detach().requires_grad_() for k, v in p.items()}
        xs = x.detach()[:, r * sl:(r + 1) * sl].contiguous().requires_grad_()
        sync(dev)
        t3 = time.perf_counter()
        ys, _ = moe.moe_apply(cfg, ps, xs)
        sync(dev)
        t4 = time.perf_counter()
        gs = torch.autograd.grad((ys.float() * wy[:, r * sl:(r + 1) * sl])
                                 .sum(), [xs] + [ps[k] for k in keys])
        sync(dev)
        t5 = time.perf_counter()
        errs = {"y": (y.detach()[:, r * sl:(r + 1) * sl].float()
                      - ys.detach().float()).abs().max().item()
                / ys.detach().float().abs().max().item(),
                "grad_x": (grads[0][:, r * sl:(r + 1) * sl].float()
                           - gs[0].float()).abs().max().item()
                / gs[0].float().abs().max().item()}
        # the weights' gradients: summed over the "model" ranks' tokens
        for k, g_ep, g_loc in zip(keys, grads[1:], gs[1:]):
            if k == "router":
                want = C.all_reduce(g_loc.float(), model)
                got = g_ep.float()
            else:
                firsts = [j * el for j in range(ep)]
                want = C.all_reduce(g_loc[firsts].float(), model)
                got = g_ep[firsts].float()
            errs["grad_" + k] = ((got - want).abs().max().item()
                                 / want.abs().max().item())
        for k, e in errs.items():
            check(e <= bar, f"C: {dtype}: {k} EP vs local {e:.3e} of "
                  f"max|local| (bar {bar})")
        out[str(dtype).removeprefix("torch.")] = {
            "err_of_max": errs, "bar": bar, "all_to_all": a2a,
            "aux": aux.item(),
            "dropped_pairs_local": _dropped_pairs(cfg, p, xs.detach()),
            "pairs_local": b * sl * cfg.top_k,
            "capacity_local": moe._capacity(cfg, b * sl),
            "ep_forward_ms": (t1 - t0) * 1e3,
            "ep_backward_ms": (t2 - t1) * 1e3,
            "local_forward_ms": (t4 - t3) * 1e3,
            "local_backward_ms": (t5 - t4) * 1e3}
        del p, x, y, grads, ps, xs, ys, gs
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    out["kernel_launches"] = {n: k.launches for n, k in wrappers.items()}
    return out


def dist_gloo_phase(args, dev, target: str, card: str, **kwargs) -> list:
    """Two gloo processes sharing the card (`dev`) run `target` of this
    module (`launch.group.run_group`, file rendezvous, its own timeout);
    their results in rank order.  NCCL refuses two ranks on one GPU."""
    import torch

    from repro_torch.launch.group import run_group

    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    results = run_group(f"chip_smoke:{target}", 2,
                        dict(seed=args.seed, device=dev.type, **kwargs),
                        timeout_s=DIST_TIMEOUT_S, pythonpath=[ROOT])
    for res in results:
        res["card"] = card
        res["group_wall_s"] = time.perf_counter() - t0
    return results


def dist_zero_phase(args, dev, card, single_losses) -> list:
    """Phase 30 (B) from the parent; `single_losses`: phase 29's
    single-process losses on the same weights and batches, which the
    sharded losses are recorded against."""
    import tempfile

    arch, b, s = DIST_OLMO
    with tempfile.TemporaryDirectory() as tmp:
        results = dist_gloo_phase(args, dev, "dist_member_zero", card,
                                  ckpt_dir=tmp, arch=arch, batch=b, seq=s,
                                  steps=DIST_B_STEPS, lr=DIST_LR)
    for res in results:
        o = res["olmo"]
        o["loss_rel_vs_single"] = [rel(x, y) for x, y in
                                   zip(o["losses"], single_losses)]
        log(f"[dist-B] rank {res['rank']} of 2 gloo on the card, mesh "
            f"{tuple(o['mesh'])}, {o['arch']} {o['local_batch']} a rank: "
            f"losses {[round(x, 4) for x in o['losses']]}, step ms "
            f"{[round(x, 1) for x in o['step_ms']]} (losses vs phase 29's "
            f"{[f'{x:.1e}' for x in o['loss_rel_vs_single']]}), gather "
            f"{o['gather_ms']:.1f} ms + psum {o['psum_ms']:.1f} ms a step "
            f"(host clock), peak {o['peak_gb']} GB, optimizer state "
            f"{o['opt_state_bytes'] / 1e9:.3f} GB; smoke configs "
            f"{len(res['smoke'])} within the bars (worst "
            f"{max(v['param_worst_err'] for v in res['smoke'].values()):.2e}"
            f"); restore {res['restore']} ({card})")
    return results


def dist_ep_phase(args, dev, card) -> list:
    results = dist_gloo_phase(args, dev, "dist_member_ep", card,
                              arch=EP_ARCH, batch=EP_TOKENS[0],
                              seq=EP_TOKENS[1])
    for res in results:
        for dt in ("float32", "bfloat16"):
            e = res[dt]
            log(f"[dist-C] rank {res['rank']} (model {res['model_coord']}) "
                f"{res['arch']} layer {dt}: EP vs local worst "
                f"{max(e['err_of_max'].values()):.2e} of max (bar "
                f"{e['bar']}), {e['all_to_all']} all-to-alls, dropped "
                f"{e['dropped_pairs_local']} of {e['pairs_local']} pairs "
                f"(cap {e['capacity_local']}), EP fwd "
                f"{e['ep_forward_ms']:.1f} / bwd {e['ep_backward_ms']:.1f} "
                f"ms, local fwd {e['local_forward_ms']:.1f} / bwd "
                f"{e['local_backward_ms']:.1f} ms ({card})")
    return results


# --------------------------------------------------------------------------
# the dry run held against the card; the example twins on the card
# --------------------------------------------------------------------------

DRY_OLMO = ("olmo-1b", 8, 2048)     # phase 25's run: arch, batch, seq
DRY_PEAK_BAR = 0.15                 # fake peak vs max_memory_allocated
DRY_CLI_ARGS = ["--arch", "olmo-1b", "--cell", "train_4k", "--mesh",
                "single"]
TWIN_TIMEOUT_S = 600


def dryrun_phase(args, dev, card) -> dict:
    """Phase 32: the dry run held against the card.  OLMo-1B in full, 8 x
    2048 with AdamW (phase 25's run) on a mesh of one rank (1, 1, 1): the
    dry run on a fake group of one rank in this process, then the same
    `make_sharded_train_step` step for real on an NCCL group of one rank
    (phase 29's).  The dry run's counted FLOPs must equal
    `FlopCounterMode` around the real step exactly; its peak must lie
    within DRY_PEAK_BAR of the real step's `max_memory_allocated` (both
    over what was allocated before the arguments were made); the H100
    roofline's `step_time_est` of the dry run's record must not exceed
    the measured step (the second step, host clock + sync).  Beside all
    that (it needs only the host's CPU), `python -m
    repro_torch.launch.dryrun --arch olmo-1b --cell train_4k --mesh
    single` in a subprocess: `ok: true`, its FLOPs, collective bytes and
    peak logged."""
    import os

    set_precision()
    t0 = time.perf_counter()
    cli_proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *DRY_CLI_ARGS],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=str(SRC)), cwd=str(ROOT))
    try:
        out = _dryrun_vs_card(args, dev, card)
        stdout, stderr = cli_proc.communicate(timeout=TWIN_TIMEOUT_S)
    finally:
        if cli_proc.poll() is None:
            cli_proc.kill()
            cli_proc.communicate()
    check(cli_proc.returncode == 0, f"launch.dryrun: rc "
          f"{cli_proc.returncode}\n{stderr[-3000:]}")
    cli = json.loads(stdout.strip().splitlines()[-1])
    check(cli.get("ok") is True, f"launch.dryrun printed {cli}")
    out["cli"] = dict(cli, wall_s=time.perf_counter() - t0)
    log(f"[dryrun] launch.dryrun {' '.join(DRY_CLI_ARGS)}: ok, "
        f"{cli['flops_per_device']:.6e} FLOPs, "
        f"{cli['collective_bytes']:.6e} collective bytes, peak "
        f"{cli['peak_memory_in_bytes'] / 1e9:.3f} GB a rank "
        f"({out['cli']['wall_s']:.1f} s, beside the rest of the phase)")
    return out


def _dryrun_vs_card(args, dev, card) -> dict:
    """Phase 32's comparison: the one-rank dry run against the same step
    on the card (see `dryrun_phase`)."""
    import tempfile

    import torch
    import torch.distributed as dist
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs.registry import get_arch
    from repro_torch.distributed.sharding import shard_tree
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_train_mesh
    from repro_torch.models import registry as models
    from repro_torch.roofline.analyze import H100_SXM, analyze_one
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.step import make_sharded_train_step, train_specs

    arch, b, s = DRY_OLMO
    cfg = get_arch(arch)
    fake = dryrun.run(cfg, "train_4k", "one-rank", (1, 1, 1), b=b, s=s)
    roof = analyze_one(fake)
    out = {"arch": cfg.name, "card": card, "batch": [b, s],
           "mesh": [1, 1, 1], "target": H100_SXM.name,
           "dry": {k: fake[k] for k in ("flops_per_device", "memory",
                                        "collectives", "t_run_s")},
           "roofline": roof.row()}
    with tempfile.TemporaryDirectory() as tmp:
        backend = "nccl" if dev.type == "cuda" else "gloo"
        dist.init_process_group(backend, init_method=f"file://{tmp}/rdv",
                                world_size=1, rank=0)
        try:
            mesh = make_train_mesh((1, 1, 1), device=dev.type)
            sync(dev)
            if dev.type == "cuda":
                torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated() if dev.type == "cuda" \
                else 0
            params = models.init_params(
                cfg, torch.Generator(dev).manual_seed(args.seed), dev)
            params = shard_tree(params, train_specs(cfg, mesh)[0], mesh)
            fn, opt = make_sharded_train_step(cfg, mesh,
                                              OptConfig(lr=DIST_LR))
            state = opt.init(params)
            batches = olmo_batches(cfg, b, s, args.seed, 2, dev)
            sync(dev)
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats()
            with FlopCounterMode(display=False) as flops:
                params, state, _ = fn(params, state, batches[0])
            sync(dev)
            real_peak = (torch.cuda.max_memory_allocated() - base
                         if dev.type == "cuda" else None)
            params, state, _, ms = timed_run(fn, params, state, batches[1:])
            del params, state, batches
        finally:
            dist.destroy_process_group()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    real_flops = float(flops.get_total_flops())
    fake_peak = fake["memory"]["peak_memory_in_bytes"]
    out.update(real_flops=real_flops, real_peak_bytes=real_peak,
               step_ms=ms[0], step_time_est_ms=roof.step_time_est * 1e3,
               est_over_measured=roof.step_time_est * 1e3 / ms[0])
    check(real_flops == fake["flops_per_device"],
          f"dry run: {fake['flops_per_device']} FLOPs counted, the card's "
          f"step {real_flops}")
    if real_peak is not None:
        out["peak_rel_err"] = abs(fake_peak - real_peak) / real_peak
        check(out["peak_rel_err"] <= DRY_PEAK_BAR,
              f"dry run: fake peak {fake_peak} B against the card's "
              f"{real_peak} B ({out['peak_rel_err']:.3f} > {DRY_PEAK_BAR})")
    check(roof.step_time_est * 1e3 <= ms[0],
          f"dry run: the roofline's {roof.step_time_est * 1e3:.1f} ms "
          f"exceeds the measured step {ms[0]:.1f} ms")
    log(f"[dryrun] {cfg.name} {b} x {s}, mesh (1, 1, 1): FLOPs dry "
        f"{fake['flops_per_device']:.6e} == card {real_flops:.6e}; peak "
        f"dry {fake_peak / 1e9:.3f} GB, card {(real_peak or 0) / 1e9:.3f} "
        f"GB (rel {out.get('peak_rel_err')}); roofline "
        f"{roof.step_time_est * 1e3:.1f} ms ({roof.dominant}) vs measured "
        f"{ms[0]:.1f} ms (ratio {out['est_over_measured']:.4f}; {card})")
    return out


def twins_phase(dev) -> dict:
    """Phase 33: `examples/quickstart_torch.py` and
    `examples/serve_lm_torch.py` in subprocesses on the card: the first
    must print `quickstart OK`, the second `strap-exact == dense: True`."""
    import os

    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = {}
    for name, want in (("quickstart_torch.py", "quickstart OK"),
                       ("serve_lm_torch.py", "strap-exact == dense: True")):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, str(ROOT / "examples" / name), "--device",
             dev.type], capture_output=True, text=True, env=env,
            cwd=str(ROOT), timeout=TWIN_TIMEOUT_S, check=False)
        wall_s = time.perf_counter() - t0
        for line in proc.stdout.splitlines():
            log(f"[twins] {name}: {line}")
        check(proc.returncode == 0, f"{name}: rc {proc.returncode}\n"
              f"{proc.stderr[-3000:]}")
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith(want)]
        check(bool(lines), f"{name} printed no {want!r} line")
        out[name] = {"line": lines[0], "wall_s": wall_s}
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

    # 17-20. the other attention families at full width: Pixtral-12B (VLM,
    #    GQA group 4) served through strap_attend, its vision prefill and
    #    its gated HLO decode; Phi-3.5-MoE (16 of 32 layers) on the dense
    #    backend; Arctic-480B (one layer, 128 experts); OLMo-1B (MHA, group
    #    1) strap-exact against dense
    record["pixtral"], pix_calls = serve_phase(
        args, ops, strap_kernel, dev, PIXTRAL_SPEC, vlm_checks(args, dev))
    record["pixtral"]["strap_timing"] = strap_shape_timing(
        strap_kernel, ops, pix_calls["strap_exact"])[0]
    del pix_calls
    record["phi_moe"], _ = serve_phase(args, ops, strap_kernel, dev, PHI_SPEC,
                                       moe_checks(dev))
    record["arctic"] = arctic_phase(args, dev)
    record["olmo"], olmo_calls = serve_phase(args, ops, strap_kernel, dev,
                                             OLMO_SPEC)
    record["olmo"]["strap_timing"] = strap_shape_timing(
        strap_kernel, ops, olmo_calls["strap_exact"])[0]
    del olmo_calls
    strap_err = max(strap_err, record["pixtral"]["max_abs_err_vs_plain"],
                    record["olmo"]["max_abs_err_vs_plain"])

    # 21-23. the SSM, hybrid and enc-dec families at full width: Mamba2-780M
    #    and Zamba2-7B served on the dense backend (the strap backend
    #    refuses them), Whisper-tiny through the model functions
    record["mamba2"], _ = serve_phase(args, ops, strap_kernel, dev,
                                      MAMBA_SPEC, ssm_checks(args, dev))
    record["zamba2"], _ = serve_phase(args, ops, strap_kernel, dev,
                                      ZAMBA_SPEC, hybrid_checks(args, dev))
    record["whisper"] = whisper_phase(args, dev, strap_kernel)
    strap_paths = {
        f"{record[key]['arch']}/{label}": res["launches"]
        for key in ("serve", "pixtral", "phi_moe", "olmo", "mamba2",
                    "zamba2")
        for label, res in record[key]["backends"].items()}
    strap_paths[f"{record['whisper']['arch']}/decode"] = record["whisper"][
        "launches"]
    strap_shapes = {record[key]["arch"]: record[key]["strap_timing"]
                    for key in ("pixtral", "olmo")}

    # 24-28. training: one step of every smoke config on the card against
    #    the CPU; OLMo-1B (AdamW, then AdamW8bit) and Mamba2-780M at full
    #    width and depth; the example twin's config with an injected
    #    crash and its step-100 checkpoint; the training CLI
    t_train = time.perf_counter()
    for k in (kernel, rc_kernel, strap_kernel):
        k.launches = 0
    record["train_parity"] = train_parity_phase(args, dev)
    record["train_olmo"] = olmo_train_phase(args, dev, card)
    record["train_mamba"] = mamba_train_phase(args, dev, card)
    record["train_example"] = example_train_phase(dev, card)
    record["train_cli"] = train_cli_phase(dev)
    record["train_wall_s"] = time.perf_counter() - t_train
    record["train_kernel_launches"] = {
        "row_cycle_fused": kernel.launches,
        "rc_multistep": rc_kernel.launches,
        "strap_attend": strap_kernel.launches}
    log(f"[train] phases 24-28 wall time {record['train_wall_s']:.1f} s; "
        f"ported kernels launched there (none lies on the training path): "
        f"{record['train_kernel_launches']}")

    # 29-31. distributed training: NCCL at world size 1 (bit for bit the
    #    train step), two gloo processes sharing the card (ZeRO over
    #    "data"; expert parallelism over "model")
    t_dist = time.perf_counter()
    for k in (kernel, rc_kernel, strap_kernel):
        k.launches = 0
    record["dist_world1"] = dist_world1_phase(args, dev, card)
    record["dist_zero"] = dist_zero_phase(
        args, dev, card, record["dist_world1"]["single"]["losses"])
    record["dist_ep"] = dist_ep_phase(args, dev, card)
    record["dist_wall_s"] = time.perf_counter() - t_dist
    # phase 29 ran here; phases 30 and 31 ran in two processes each,
    # whose counts come back in their results
    dist_launches = {"row_cycle_fused": kernel.launches,
                     "rc_multistep": rc_kernel.launches,
                     "strap_attend": strap_kernel.launches}
    for res in record["dist_zero"] + record["dist_ep"]:
        for n, c in res["kernel_launches"].items():
            dist_launches[n] += c
    record["dist_kernel_launches"] = dist_launches
    check(not any(dist_launches.values()),
          f"phases 29-31 launched a ported kernel: {dist_launches}")
    log(f"[dist] phases 29-31 wall time {record['dist_wall_s']:.1f} s; "
        f"ported kernels launched there, this process and the four "
        f"members summed (none lies on the distributed training path): "
        f"{dist_launches}")

    # 32. the dry run held against the card: FLOPs, peak and the H100
    #    roofline of OLMo-1B's one-rank step; the dry-run CLI at the
    #    production "single" mesh (none of the ported kernels lies on it)
    t_dry = time.perf_counter()
    for k in (kernel, rc_kernel, strap_kernel):
        k.launches = 0
    record["dryrun"] = dryrun_phase(args, dev, card)
    dry_launches = {"row_cycle_fused": kernel.launches,
                    "rc_multistep": rc_kernel.launches,
                    "strap_attend": strap_kernel.launches}
    record["dryrun"]["kernel_launches"] = dry_launches
    check(not any(dry_launches.values()),
          f"phase 32 launched a ported kernel: {dry_launches}")
    log(f"[dryrun] ported kernels launched in phase 32 (none lies on the "
        f"dry run's path or the step it is held against): {dry_launches}")

    # 33. the example twins on the card, in subprocesses
    record["twins"] = twins_phase(dev)
    record["dryrun_twins_wall_s"] = time.perf_counter() - t_dry
    log(f"[twins] phases 32-33 wall time "
        f"{record['dryrun_twins_wall_s']:.1f} s")

    # 34. the kernels line: row_cycle at the sized path's one launch over
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
                   strap_err, registers, strap_paths, strap_shapes)]}
    for entry in line["kernels"]:
        entry.setdefault("launches_by_path", {})["dist_train"] = \
            dist_launches[entry["name"]]
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
