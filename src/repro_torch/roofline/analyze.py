"""Three-term roofline from the dry run's results, on an NVIDIA H100
(port of `repro.roofline.analyze`, whose chip it replaces by a `Target`).

  compute    = matmul FLOPs total  / (chips * peak FLOP/s)
  memory     = analytic HBM bytes  / HBM B/s           (per device)
  collective = near bytes / near B/s + far bytes / far B/s   (per device)

The FLOPs and collective bytes are the ones `roofline.counts` recorded
around the port's step (`counts` in a result of `launch.dryrun`), or, in
a result of the reference's form, its loop-corrected `hlo_exact` or its
legacy `flops_per_device` / `collectives`.  The memory term recomputes
the analytic model (`roofline.analytic`) through `apply_opt_level`, so a
baseline and its opt-level variants share one traffic model.  The
target's `domain` says which split of the collective bytes rides its near
links: "node" (8 consecutive ranks, NVLink on an H100 board) or "pod"
(256 ranks, the reference's split).

Also records MODEL_FLOPS (6*N*D dense / 6*N_active*D MoE; decode counts
D = global_batch tokens) and the useful-compute ratio.  Every time here
is a prediction from a spec sheet, not a measurement.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

RESULTS = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"


@dataclass(frozen=True)
class Target:
    name: str
    peak_flops: float   # dense bf16 FLOP/s a chip
    hbm_bw: float       # HBM bytes/s a chip
    near_bw: float      # collective bytes/s a chip inside a `domain`
    far_bw: float       # collective bytes/s a chip across domains
    domain: str         # "node" or "pod": which split rides `near_bw`
    memory_bytes: float  # device memory a chip


H100_SXM = Target(
    name="NVIDIA H100 SXM5 80GB",
    peak_flops=989e12,  # H100 SXM5 data sheet: bf16 tensor core, dense
    hbm_bw=3.35e12,     # H100 SXM5 data sheet: HBM3
    near_bw=450e9,      # H100 SXM5: NVLink 4, 900 GB/s total, 450 each way
    far_bw=50e9,        # H100 node: one InfiniBand NDR 400 Gb/s NIC a GPU
    domain="node",
    memory_bytes=80e9)  # H100 SXM5 data sheet: 80 GB HBM3


@dataclass
class Roofline:
    arch: str
    cell: str
    mesh: str
    opt_level: int
    t_compute: float
    t_memory: float
    t_collective: float
    dominant: str
    model_flops: float
    hlo_flops_total: float
    useful_ratio: float
    bytes_per_device: float
    coll_bytes_total: float
    cross_pod_bytes: float
    step_time_est: float
    mfu_bound: float
    peak_memory_bytes: float = 0.0   # the result's peak a device
    fits_memory: bool = True         # peak <= the target's memory

    def row(self) -> dict:
        return self.__dict__.copy()


def model_flops_for(d: dict) -> float:
    """6*N*D where D = trained/processed tokens of the cell."""
    b, s = d["global_batch"], d["seq_len"]
    n = d["active_params"]
    if d["kind"] == "train":
        return 6.0 * n * b * s
    if d["kind"] == "prefill":
        return 2.0 * n * b * s          # forward only
    return 2.0 * n * b                   # decode: 1 token per sequence


def _analytic_bytes(d: dict, chips: int) -> float:
    """The analytic HBM bytes a device of the result's arch, cell shape
    and opt level; a result whose arch the port does not know keeps the
    bytes it carries."""
    from ..configs.registry import get_arch
    from ..launch.optlevels import apply_opt_level
    from .analytic import hbm_bytes
    try:
        cfg = get_arch(d["arch"])
    except KeyError:
        return d.get("analytic_hbm_bytes_per_device",
                     d.get("bytes_accessed_per_device", 0.0))
    cfg = apply_opt_level(cfg, d["cell"], d.get("opt_level", 0))
    return hbm_bytes(cfg, d["kind"], d["global_batch"], d["seq_len"], chips)


def analyze_one(d: dict, target: Target = H100_SXM) -> Roofline:
    chips = d["devices"]
    near_key = f"in_{target.domain}_bytes"
    far_key = f"cross_{target.domain}_bytes"
    exact = d.get("counts") or d.get("hlo_exact")
    if exact:
        # matmul FLOPs a device counted around the step (or the
        # reference's loop-corrected dot FLOPs)
        flops_total = exact["dot_flops_per_device"] * chips
        near = exact[near_key]
        far = exact[far_key]
        cross = exact["cross_pod_bytes"]
        coll_total = exact["collective_bytes_total"]
    else:  # the reference's legacy form (uncorrected)
        flops_total = d["flops_per_device"] * chips
        coll = d.get("collectives", {})
        near = coll.get(near_key, 0.0)
        far = coll.get(far_key, 0.0)
        cross = coll.get("cross_pod_bytes", 0.0)
        coll_total = coll.get("total_bytes", 0.0)
    bytes_dev = _analytic_bytes(d, chips)
    t_comp = flops_total / (chips * target.peak_flops)
    t_mem = bytes_dev / target.hbm_bw
    # per-op collective bytes are per-device payloads
    t_coll = near / target.near_bw + far / target.far_bw

    terms = {"compute": t_comp, "memory": t_mem, "collective": t_coll}
    dominant = max(terms, key=terms.get)
    mf = d.get("model_flops") or model_flops_for(d)
    useful = mf / flops_total if flops_total else 0.0
    # perfect-overlap step estimate: max of the three engines
    t_step = max(terms.values())
    mfu = (mf / (chips * target.peak_flops)) / t_step if t_step else 0.0
    peak = float(d.get("memory", {}).get("peak_memory_in_bytes", 0.0))
    return Roofline(
        arch=d["arch"], cell=d["cell"], mesh=d["mesh"],
        opt_level=d.get("opt_level", 0),
        t_compute=t_comp, t_memory=t_mem, t_collective=t_coll,
        dominant=dominant, model_flops=mf, hlo_flops_total=flops_total,
        useful_ratio=useful, bytes_per_device=bytes_dev,
        coll_bytes_total=coll_total,
        cross_pod_bytes=cross, step_time_est=t_step, mfu_bound=mfu,
        peak_memory_bytes=peak, fits_memory=peak <= target.memory_bytes)


def load_all(mesh: str | None = "single", opt_level: int | None = 0,
             results: Path = RESULTS, target: Target = H100_SXM
             ) -> list[Roofline]:
    out = []
    for f in sorted(results.glob("*.json")):
        d = json.loads(f.read_text())
        if not d.get("ok"):
            continue
        if mesh and d["mesh"] != mesh:
            continue
        if opt_level is not None and d.get("opt_level", 0) != opt_level:
            continue
        out.append(analyze_one(d, target))
    return out


def table(rows: list[Roofline]) -> str:
    hdr = (f"{'arch':22s} {'cell':12s} {'mesh':6s} {'comp(ms)':>9s} "
           f"{'mem(ms)':>9s} {'coll(ms)':>9s} {'dominant':>10s} "
           f"{'useful':>7s} {'MFU-bnd':>8s} {'peak(GB)':>9s} {'fits':>4s}")
    lines = [hdr, "-" * len(hdr)]
    for r in sorted(rows, key=lambda r: (r.arch, r.cell)):
        lines.append(
            f"{r.arch:22s} {r.cell:12s} {r.mesh:6s} "
            f"{1e3 * r.t_compute:9.3f} {1e3 * r.t_memory:9.3f} "
            f"{1e3 * r.t_collective:9.3f} {r.dominant:>10s} "
            f"{r.useful_ratio:7.3f} {r.mfu_bound:8.3f} "
            f"{r.peak_memory_bytes / 1e9:9.2f} "
            f"{'yes' if r.fits_memory else 'no':>4s}")
    return "\n".join(lines)


def interesting_cells(rows: list[Roofline]) -> dict:
    """Hillclimb candidates: worst roofline fraction, most collective-bound,
    most paper-representative (largest decode memory term = the StrapCache /
    C_BL analogue)."""
    trains = [r for r in rows if r.cell == "train_4k"]
    worst = min(trains, key=lambda r: r.mfu_bound) if trains else None
    coll = max(rows, key=lambda r: (r.t_collective /
                                    max(r.step_time_est, 1e-12)))
    decodes = [r for r in rows if "decode" in r.cell or "long" in r.cell]
    paper = max(decodes, key=lambda r: r.t_memory) if decodes else None
    return dict(worst_mfu=worst, most_collective=coll, paper_rep=paper)


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mesh", default="single",
                    help="single, multi, or '' for both")
    ap.add_argument("--opt-level", type=int, default=0)
    ap.add_argument("--results", type=Path, default=RESULTS)
    args = ap.parse_args(argv)
    rows = load_all(args.mesh or None, args.opt_level, args.results)
    print(f"target: {H100_SXM.name} (spec sheet; predictions, not "
          "measurements)")
    print(table(rows))
    print()
    if not rows:
        return
    picks = interesting_cells(rows)
    for k, r in picks.items():
        if r:
            print(f"{k}: {r.arch} / {r.cell} (dominant={r.dominant}, "
                  f"MFU-bound={r.mfu_bound:.3f})")


if __name__ == "__main__":
    main()
