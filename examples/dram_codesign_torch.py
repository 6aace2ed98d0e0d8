"""End-to-end design-space exploration on the GPU — the PyTorch port of
`examples/dram_codesign.py` (same flow, same output).

Declare a `DesignSpace`, score it in ONE vectorized `dse.sweep` (density,
margins, energy, bonding geometry, and the fused row-cycle tRC through the
CUDA kernel `csrc/row_cycle.cu` on the card), then extract the Pareto
front and the selected design with masked tensor ops.

Run:  PYTHONPATH=src python examples/dram_codesign_torch.py [--smoke]
          [--mc [N]] [--mc-key K] [--mc-tail [N]] [--mc-tail-shift S]
          [--replica] [--device cuda|cpu]

`--smoke` sweeps a reduced layer grid.  `--mc [N]` fans the same space
out to N Monte-Carlo samples per design point (still ONE fused transient
batch) and reports margin/tRC yield; `--mc-tail [N]` adds the
importance-sampled deep-tail (ppm) margin yield.  `--replica` closes the
SA-enable timing with a replica bitline per design point.  `--device`
defaults to cuda and raises without a GPU; `--device cpu` runs the plain
PyTorch path.  `--sharded` is not ported yet (it lands with the multi-GPU
fabric, ROADMAP queue 1) and raises.
"""

import argparse
import sys

import numpy as np

from repro_torch.core import calibration as cal
from repro_torch.core import dse
from repro_torch.core.space import DesignSpace
from repro_torch.device import resolve_device, to_host


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser()
    parser.add_argument("--smoke", action="store_true",
                        help="reduced layer grid (fast smoke mode)")
    parser.add_argument("--mc", type=int, nargs="?", const=128, default=0,
                        metavar="SAMPLES",
                        help="Monte-Carlo samples per design point (default "
                             "128 when the flag is given without a value)")
    parser.add_argument("--mc-key", type=int, default=0,
                        help="seed of the Monte-Carlo draws")
    parser.add_argument("--mc-tail", type=int, nargs="?", const=4096,
                        default=0, metavar="SAMPLES",
                        help="importance-sampled deep-tail (ppm) "
                             "margin-yield estimate under correlated "
                             "within-die variation (default 4096 samples "
                             "when the flag is given without a value)")
    parser.add_argument("--mc-tail-shift", type=float, default=4.0,
                        help="proposal shift (sigmas) of the SA-offset tail "
                             "draws")
    parser.add_argument("--sharded", action="store_true",
                        help="shard the fused sweep over every GPU (not "
                             "ported yet: raises)")
    parser.add_argument("--replica", action="store_true",
                        help="replica-bitline timing closure: the SA enable "
                             "fires on a per-point replica column's crossing "
                             "instead of the fixed own-90%% window")
    parser.add_argument("--device", default="cuda",
                        help="device of the sweep (default cuda; cpu runs "
                             "the plain PyTorch path)")
    return parser.parse_args(argv)


def codesign(args: argparse.Namespace) -> dict:
    """Run the co-design flow of `args` and print its report; returns the
    scored batch, its Pareto front and the selected design (and, with
    `--mc`, the yield summary and its selection)."""
    if args.sharded:
        raise NotImplementedError(
            "--sharded is not ported yet; it lands with the multi-GPU "
            "fabric (ROADMAP queue 1)")
    device = resolve_device(args.device)
    out = {}

    grid = (64, 87, 137) if args.smoke else None
    space = DesignSpace.paper_grid(layer_grid=grid)
    if args.replica:
        space = space.with_replica()
        print("replica-closed SA-enable timing (per-point replica bitline)")
    print(f"sweeping design space ({len(space)} design points, one fused "
          "transient batch)...")
    batch = dse.sweep(space, device=device)
    out["batch"] = batch

    n_feas = int(batch.feasible.sum())
    print(f"\n{len(batch)} design points, {n_feas} feasible "
          f"(margin nominal>={cal.MIN_FUNCTIONAL_MARGIN_MV:.0f} mV, "
          f"disturbed>={cal.MIN_DISTURBED_MARGIN_MV:.0f} mV, "
          f"pitch>={cal.HCB_MIN_MANUFACTURABLE_PITCH_UM} um)")

    front = dse.pareto_front(batch)      # DesignBatch -> DesignBatch
    out["front"] = front
    print(f"\nPareto front ({len(front)} points):")
    print(f"{'tech':5s} {'scheme':10s} {'L':>4s} {'Gb/mm2':>7s} "
          f"{'dV(mV)':>7s} {'dV+dist':>8s} {'tRC(ns)':>8s} {'Erd(fJ)':>8s} "
          f"{'pitch':>6s}")
    cols = {f: to_host(getattr(front, f)) for f in (
        "layers", "density_gb_mm2", "margin_mv", "margin_disturbed_mv",
        "trc_ns", "e_read_fj", "hcb_pitch_um")}
    order = np.argsort(-cols["density_gb_mm2"])[:12]
    for i in order:
        print(f"{front.tech_col[i]:5s} {front.scheme_col[i]:10s} "
              f"{int(cols['layers'][i]):4d} "
              f"{float(cols['density_gb_mm2'][i]):7.2f} "
              f"{float(cols['margin_mv'][i]):7.0f} "
              f"{float(cols['margin_disturbed_mv'][i]):8.0f} "
              f"{float(cols['trc_ns'][i]):8.2f} "
              f"{float(cols['e_read_fj'][i]):8.2f} "
              f"{float(cols['hcb_pitch_um'][i]):6.2f}")

    best = dse.best_design(batch)        # paper's selection rule
    out["best"] = best
    print(f"\nselected design (paper's rule: hit "
          f"{cal.DENSITY_TARGET_GB_MM2} Gb/mm2, min tRC):")
    print(f"  {best.tech} / {best.scheme} @ {best.layers} layers -> "
          f"{best.density_gb_mm2:.2f} Gb/mm2, tRC {best.trc_ns:.2f} ns, "
          f"margin {best.margin_mv:.0f} mV ({best.margin_disturbed_mv:.0f} "
          f"mV w/ FBE+RH), E_rd {best.e_read_fj:.2f} fJ, "
          f"HCB pitch {best.hcb_pitch_um:.2f} um")

    # Table-1 anchors, read straight off the batch columns
    tech_col, scheme_col = batch.tech_col, batch.scheme_col
    layers_col = to_host(batch.layers)
    bcols = {f: to_host(getattr(batch, f)) for f in (
        "density_gb_mm2", "trc_ns", "e_write_fj", "e_read_fj")}

    def row(tech, scheme, layers):
        (i,) = [i for i in range(len(batch))
                if tech_col[i] == tech and scheme_col[i] == scheme
                and int(layers_col[i]) == layers]
        return i

    print("\nTable I anchors (from the DesignBatch):")
    for tech, scheme, n_layers in (("si", "sel_strap", 137),
                                   ("aos", "sel_strap", 87),
                                   ("d1b", "direct", 1)):
        i = row(tech, scheme, n_layers)
        print(f"  {tech:4s} {scheme:10s} @{n_layers:3d}L: "
              f"{float(bcols['density_gb_mm2'][i]):4.2f} Gb/mm2  "
              f"tRC {float(bcols['trc_ns'][i]):5.2f} ns  "
              f"E_wr {float(bcols['e_write_fj'][i]):5.2f} fJ  "
              f"E_rd {float(bcols['e_read_fj'][i]):4.2f} fJ")

    # Replica timing closure (--replica): fixed t_sense vs replica-closed
    # on the Table-1 anchors
    if args.replica:
        from repro_torch.core.report import replica_timing_table
        cmp = replica_timing_table(device=device)
        print("\nfixed t_sense vs replica-closed (Table-1 anchors):")
        print(f"  {'tech':4s} {'cells':>5s} {'tRC fix':>8s} {'tRC clo':>8s} "
              f"{'dtRC':>6s} {'fire fix':>8s} {'fire clo':>8s} "
              f"{'mrg@fire':>9s}")
        for tech, r in cmp.items():
            print(f"  {tech:4s} {r['replica_cells']:5.1f} "
                  f"{r['trc_fixed_ns']:8.2f} {r['trc_closed_ns']:8.2f} "
                  f"{r['trc_delta_ns']:6.2f} {r['t_fire_fixed_ns']:8.2f} "
                  f"{r['t_fire_closed_ns']:8.2f} "
                  f"{r['margin_fire_closed_mv']:9.1f}")

    i_d1b = row("d1b", "direct", 1)
    d1b_trc = float(bcols["trc_ns"][i_d1b])
    d1b_erd = float(bcols["e_read_fj"][i_d1b])
    d1b_dens = float(bcols["density_gb_mm2"][i_d1b])
    print(f"\nvs D1b baseline: density x{best.density_gb_mm2 / d1b_dens:.1f}, "
          f"tRC x{d1b_trc / best.trc_ns:.2f} faster, "
          f"E_rd x{d1b_erd / best.e_read_fj:.2f} lower")

    # Monte-Carlo yield (--mc): same space, fanned out to N samples per
    # point, still ONE fused row-cycle launch
    if args.mc:
        print(f"\n== Monte-Carlo yield: {args.mc} samples/design "
              f"(key {args.mc_key}, {len(space) * args.mc} rows, one fused "
              "batch) ==")
        mc_batch = dse.sweep(space.with_mc(samples=args.mc, key=args.mc_key),
                             device=device)
        trc_ceiling = 1.1 * d1b_trc / 2.0    # spec: comfortably beat D1b/2
        summary = mc_batch.mc_summary(margin_mv=cal.MIN_FUNCTIONAL_MARGIN_MV,
                                      trc_ns=trc_ceiling)
        yf = to_host(summary.corners["yield_frac"])
        p05_margin = to_host(mc_batch.quantile(0.05, "margin_mv"))
        p95_trc = to_host(mc_batch.quantile(0.95, "trc_ns"))
        out["mc_summary"] = summary

        print(f"spec: margin>={cal.MIN_FUNCTIONAL_MARGIN_MV:.0f} mV & "
              f"tRC<={trc_ceiling:.1f} ns")
        print("Table I anchors (yield over samples, p05 margin, p95 tRC):")
        for tech, scheme, n_layers in (("si", "sel_strap", 137),
                                       ("aos", "sel_strap", 87),
                                       ("d1b", "direct", 1)):
            i = row(tech, scheme, n_layers)  # summary keeps the base layout
            print(f"  {tech:4s} {scheme:10s} @{n_layers:3d}L: "
                  f"yield {yf[i]:5.1%}  "
                  f"margin_p05 {p05_margin[i]:6.1f} mV  "
                  f"tRC_p95 {p95_trc[i]:5.2f} ns")

        best_y = dse.best_design(summary, min_yield=0.9)
        out["best_yield"] = best_y
        if best_y is None:
            print("no design meets the density target at >=90% yield")
        else:
            i = row(best_y.tech, best_y.scheme, best_y.layers)
            print(f"highest-yield selection (>=90% yield, paper's rule): "
                  f"{best_y.tech} / {best_y.scheme} @ {best_y.layers} "
                  f"layers -> yield {yf[i]:.1%}, "
                  f"median tRC {best_y.trc_ns:.2f} ns")

    # Deep-tail ppm yield (--mc-tail): importance-sampled margin-tail
    # estimate of the Table-1 target points under correlated within-die
    # variation; exact per-row log-weights ride the batch as the reserved
    # mc_log_w channel
    if args.mc_tail:
        shift = args.mc_tail_shift
        print(f"\n== ppm-tail yield: {args.mc_tail} importance "
              f"samples/design (SA proposal shifted {shift:.1f} sigma, "
              "correlated within-die draws) ==")
        tail_space = DesignSpace.paper_targets().with_mc(
            samples=args.mc_tail, key=args.mc_key, corr=1.0,
            tail_shift=(shift, 0.0), tail_scale=(1.2, 1.0))
        tail_batch = dse.sweep(tail_space, with_transient=False,
                               device=device)
        floor = cal.MIN_FUNCTIONAL_MARGIN_MV
        ppm = {k: to_host(v)
               for k, v in tail_batch.yield_ppm(margin_mv=floor).items()}
        out["tail_ppm"] = ppm
        base = tail_batch.base_len
        tail_layers = to_host(tail_batch.layers)
        print(f"spec: margin>={floor:.0f} mV; failure rate in ppm "
              "(95% CI, tail ESS):")
        for i, tech in enumerate(tail_batch.tech_col[:base]):
            est = float(ppm["fail_ppm"][i])
            lo = float(ppm["fail_ppm_lo"][i])
            hi = float(ppm["fail_ppm_hi"][i])
            ess = float(ppm["ess"][i])
            n_layers = int(tail_layers[i])
            if np.isnan(est):
                print(f"  {tech:4s} @{n_layers:3d}L: no estimate "
                      f"(tail ESS {ess:.1f} too low — raise --mc-tail or "
                      "retune --mc-tail-shift)")
            else:
                print(f"  {tech:4s} @{n_layers:3d}L: {est:10.3f} ppm "
                      f"[{lo:.3f}, {hi:.3f}]  ESS {ess:.0f}")
    return out


def main(argv=None) -> int:
    codesign(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
