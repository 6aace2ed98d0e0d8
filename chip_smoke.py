#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU, end to end.

    python3 chip_smoke.py [--seed 0] [--out results.json]

Phases (any failure exits non-zero and prints no result line):

1. the card's name and power limit (nvidia-smi);
2. build the row-cycle CUDA kernel from src/repro_torch/kernels/csrc/
   with nvcc into build/;
3. hold the kernel (backend="cuda") against its plain PyTorch version
   (backend="ref") on the card: N = 4, 6, 8, replica pairs, padding rows,
   timed-out rows, legacy (B, 5) params, B = 2048 and the full 299,008-row
   Monte-Carlo operand batch;
4. the main path: `dse.sweep(DesignSpace.paper_grid())` on the card, with
   the kernel's launch count read around it, the paper's goldens, the same
   sweep through the plain version, and the replica-timed sweep;
5. the sized run: `paper_grid().with_mc(samples=4096, key=0)` (299,008
   design rows, the `--mc-tail` default of examples/dram_codesign.py),
   timed per phase (plan, kernel, score, pareto) at b_chunk=2048 and at
   b_chunk=299008, median of 3 after a warm-up;
6. one JSON line listing the ported kernels, then the card line, then the
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
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

MC_SAMPLES = 4096
REPEATS = 3
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
    from repro_torch.core import dse, transient
    from repro_torch.core.space import DesignSpace
    from repro_torch.kernels import ops, row_cycle

    record: dict = {"seed": args.seed}
    dev = torch.device("cuda")
    kernel = row_cycle.row_cycle_fused_cuda
    dt = transient.DT_NS
    caps = (transient.N_ACT_STEPS, transient.N_RESTORE_STEPS,
            transient.N_PRE_STEPS)

    # 1. the card
    card = card_line()
    name = torch.cuda.get_device_name(0)
    log(f"[card] {card} | torch {torch.__version__} cuda {torch.version.cuda}")
    record["card"] = card

    # 2. build
    t0 = time.perf_counter()
    lib = row_cycle.build()
    build_s = time.perf_counter() - t0
    ptxas = Path(f"{lib}.ptxas.txt")
    report = [ln.strip() for ln in ptxas.read_text().splitlines()
              if any(k in ln for k in ("entry function", "registers"))
              ] if ptxas.exists() else []
    log(f"[build] {lib.name} in {build_s:.2f} s")
    for ln in report:
        log(f"[build] ptxas: {ln}")
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

    # 6. the kernels line: one 2048-row chunk of the sized run, the path's
    #    default shape
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
    }]}
    record["kernels"] = line["kernels"]
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(record, indent=1))
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
