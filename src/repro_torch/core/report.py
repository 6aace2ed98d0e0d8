"""Paper-table generators: the paper's tables and figures from sweeps.

Port of `repro.core.report`.  Each function corresponds to a paper
artifact:
  fig3_routing_comparison  -> Fig. 3(c): four schemes, quantitative
  fig9a_stack_height       -> Fig. 9(a): height vs density
  fig9b_margin_vs_density  -> Fig. 9(b): margin w/ FBE+RH vs density
  fig9c_spec_table         -> Fig. 9(c): this-work vs D1b spec comparison
  table1_summary           -> Table I "This Work" column quantities

Yield-aware variants (Monte-Carlo through the same fused sweep):
  mc_yield_table           -> Table-1/Fig-9c points as margin/tRC *yield*
  fig9b_margin_yield_vs_density -> Fig. 9(b) with a per-density yield
  mc_tail_yield_table      -> deep-tail (ppm) spec-failure estimates of
                              the Table-1 points via importance sampling
  fig_tail_probability     -> failure probability vs margin floor
  replica_timing_table     -> fixed vs replica-closed SA-enable timing

Every table comes from `dse.sweep` over a declarative `DesignSpace` on
`device` (default "cuda": the fused row-cycle kernel on the GPU) and the
`DesignBatch` reductions; the results are plain Python dicts and lists of
floats, ints, bools and strings, as in the reference.
"""

from __future__ import annotations

import itertools

import numpy as np

from ..device import resolve_device, to_host
from . import calibration as cal
from . import dse
from .batch import ARRAY_FIELDS
from .calibration import TECHS
from .density import layers_for_density, stack_height_um
from .routing import SCHEMES
from .space import DesignSpace


def _non_baseline_techs():
    return [t for t in TECHS.values() if not t.baseline_2d]


def _columns(batch) -> dict:
    """Every (B,) column of a batch as a host numpy array."""
    return {f: to_host(getattr(batch, f)) for f in ARRAY_FIELDS}


def _density_space(densities, scheme: str, device) -> DesignSpace:
    """One (tech, scheme, layers) point per 3D tech and target density."""
    space = DesignSpace(entries=())
    for tech in _non_baseline_techs():
        layers = to_host(layers_for_density(tech, densities, device=device))
        space = space + DesignSpace.points(
            [(tech.name, scheme, int(l)) for l in layers])
    return space


def _tail_space(samples, key, corr, tail_shift, tail_scale) -> DesignSpace:
    return DesignSpace.paper_targets().with_mc(
        samples=samples, key=key, corr=corr,
        tail_shift=(tail_shift, 0.0), tail_scale=(tail_scale, 1.0))


def fig3_routing_comparison(with_transient: bool = True,
                            device="cuda") -> list[dict]:
    """Four routing schemes on every 3D tech at its target layer count,
    plus the D1b reference row — one batched sweep."""
    space = DesignSpace.points(
        [(t.name, s, t.layers_target)
         for t in _non_baseline_techs() for s in SCHEMES])
    space = space + DesignSpace.points(
        [(t.name, (t.allowed_schemes or ("direct",))[0], t.layers_target)
         for t in TECHS.values() if t.baseline_2d])
    batch = dse.sweep(space, with_transient=with_transient, device=device)
    col = _columns(batch)

    rows = []
    for i, (tech, scheme) in enumerate(zip(batch.tech_col, batch.scheme_col)):
        cal_t = TECHS[tech]
        baseline = cal_t.baseline_2d
        row = dict(
            tech=tech, scheme=scheme,
            label=(cal_t.baseline_label or f"{tech} 2D baseline") if baseline
            else SCHEMES[scheme].label,
            cbl_ff=float(col["cbl_ff"][i]),
            margin_mv=float(col["margin_mv"][i]),
            hcb_pitch_um=float(col["hcb_pitch_um"][i]),
            blsa_area_um2=(cal_t.fixed_blsa_area_um2 if baseline
                           else float(col["blsa_area_um2"][i])),
            manufacturable=bool(col["manufacturable"][i]),
        )
        if with_transient:
            row["trc_ns"] = float(col["trc_ns"][i])
            row["t_sense_ns"] = float(col["t_sense_ns"][i])
        rows.append(row)
    return rows


def fig9a_stack_height(densities=None, device="cuda") -> list[dict]:
    device = resolve_device(device)
    if densities is None:
        densities = np.linspace(0.5, 3.5, 13)
    rows = []
    for tech in _non_baseline_techs():
        layers = layers_for_density(tech, densities, device=device)
        heights = to_host(stack_height_um(tech, layers, device=device))
        for d, l, h in zip(densities, to_host(layers), heights):
            rows.append(dict(tech=tech.name, density_gb_mm2=float(d),
                             layers=int(l), height_um=float(h)))
    return rows


def fig9b_margin_vs_density(densities=None, scheme: str = "sel_strap",
                            device="cuda") -> list[dict]:
    if densities is None:
        densities = np.linspace(0.5, 3.5, 13)
    batch = dse.sweep(_density_space(densities, scheme, device),
                      with_transient=False, device=device)
    col = _columns(batch)

    rows = []
    for i, (tech, d) in enumerate(itertools.product(_non_baseline_techs(),
                                                    densities)):
        md = float(col["margin_disturbed_mv"][i])
        rows.append(dict(
            tech=tech.name, density_gb_mm2=float(d),
            layers=int(col["layers"][i]),
            margin_mv=float(col["margin_mv"][i]),
            margin_with_fbe_rh_mv=md,
            functional=bool(md >= cal.MIN_DISTURBED_MARGIN_MV)))
    return rows


def fig9c_spec_table(with_transient: bool = True, device="cuda") -> dict:
    """This-work (Si/AOS @ 2.6 Gb/mm^2, sel_strap) vs D1b — one sweep of
    the Table-1 target points."""
    batch = dse.sweep(DesignSpace.paper_targets(),
                      with_transient=with_transient, device=device)
    col = _columns(batch)
    out = {}
    for i, tname in enumerate(batch.tech_col):
        tech = TECHS[tname]
        entry = dict(
            layers=int(col["layers"][i]),
            bit_density_gb_mm2=float(col["density_gb_mm2"][i]),
            stack_height_um=float(col["height_um"][i]),
            cbl_ff=float(col["cbl_ff"][i]),
            sense_margin_mv=float(col["margin_mv"][i]),
            sense_margin_disturbed_mv=float(col["margin_disturbed_mv"][i]),
            e_write_fj=float(col["e_write_fj"][i]),
            e_read_fj=float(col["e_read_fj"][i]),
            vpp=tech.vpp,
        )
        if not tech.baseline_2d:
            entry["hcb_pitch_um"] = float(col["hcb_pitch_um"][i])
            entry["blsa_area_um2"] = float(col["blsa_area_um2"][i])
        else:
            entry["blsa_area_um2"] = tech.fixed_blsa_area_um2
        if with_transient:
            entry["trc_ns"] = float(col["trc_ns"][i])
        out[tname] = entry
    # headline ratios
    if with_transient:
        out["ratios"] = dict(
            density_x=out["si"]["bit_density_gb_mm2"] / cal.D1B_BIT_DENSITY_GB_MM2,
            trc_speedup_si=out["d1b"]["trc_ns"] / out["si"]["trc_ns"],
            trc_speedup_aos=out["d1b"]["trc_ns"] / out["aos"]["trc_ns"],
            write_energy_reduction=1 - out["si"]["e_write_fj"] / out["d1b"]["e_write_fj"],
            read_energy_reduction=1 - out["si"]["e_read_fj"] / out["d1b"]["e_read_fj"],
        )
    return out


def mc_yield_table(samples: int = 256, key=0,
                   margin_floor_mv: float | None = None,
                   trc_ceiling_ns: float | None = None,
                   with_transient: bool = True, device="cuda") -> dict:
    """Yield-aware Table-1/Fig-9c variant: the paper's target design
    points under SA-offset + Vth Monte-Carlo, one fused sweep.

    Per tech: nominal-spec yield fractions (functional margin floor, and
    the disturbed floor on the disturbed margin), tail quantiles of the
    sampled metrics, and the spec-yield against an optional tRC ceiling.
    `margin_floor_mv` defaults to the paper's functional threshold.
    """
    if margin_floor_mv is None:
        margin_floor_mv = cal.MIN_FUNCTIONAL_MARGIN_MV
    space = DesignSpace.paper_targets().with_mc(samples=samples, key=key)
    batch = dse.sweep(space, with_transient=with_transient, device=device)

    y_margin = to_host(batch.yield_fraction(margin_mv=margin_floor_mv))
    y_dist = to_host(batch.yield_fraction(
        margin_mv=cal.MIN_DISTURBED_MARGIN_MV, disturbed=True))
    y_spec = to_host(batch.yield_fraction(
        margin_mv=margin_floor_mv, trc_ns=trc_ceiling_ns))
    p05_margin = to_host(batch.quantile(0.05, "margin_mv"))
    med_margin = to_host(batch.quantile(0.5, "margin_mv"))
    if with_transient:
        med_trc = to_host(batch.quantile(0.5, "trc_ns"))
        p95_trc = to_host(batch.quantile(0.95, "trc_ns"))

    out = {"samples": samples,
           "margin_floor_mv": float(margin_floor_mv),
           "trc_ceiling_ns": trc_ceiling_ns}
    base = batch.base_len
    tech_col = batch.tech_col[:base]       # sample 0 carries the row labels
    layers = to_host(batch.layers)[:base]
    for i, tname in enumerate(tech_col):
        entry = dict(
            layers=int(layers[i]),
            yield_margin=float(y_margin[i]),
            yield_margin_disturbed=float(y_dist[i]),
            yield_spec=float(y_spec[i]),
            margin_mv_p05=float(p05_margin[i]),
            margin_mv_median=float(med_margin[i]),
        )
        if with_transient:
            entry["trc_ns_median"] = float(med_trc[i])
            entry["trc_ns_p95"] = float(p95_trc[i])
        out[tname] = entry
    return out


def _ppm_row(ppm: dict, i: int) -> dict:
    return dict(fail_ppm=float(ppm["fail_ppm"][i]),
                fail_ppm_lo=float(ppm["fail_ppm_lo"][i]),
                fail_ppm_hi=float(ppm["fail_ppm_hi"][i]),
                tail_ess=float(ppm["ess"][i]))


def mc_tail_yield_table(samples: int = 4096, key=0,
                        margin_floor_mv: float | None = None,
                        tail_shift: float = 4.0, tail_scale: float = 1.2,
                        corr: float = 1.0, min_ess: float = 8.0,
                        device="cuda") -> dict:
    """Deep-tail (ppm) spec-failure table of the paper's target points.

    Importance-sampled margin-tail estimate under correlated within-die
    variation: the SA-offset channel's local draws are shifted
    `tail_shift` sigmas into the failure tail (the Vth channel stays
    target-distributed), and `DesignBatch.yield_ppm` turns the weighted
    failures into a ppm estimate with a confidence interval and a
    tail-ESS diagnostic.  `margin_floor_mv` defaults to the paper's
    functional threshold; a tech whose tail ESS lands below `min_ess`
    reports NaN (no estimate).
    """
    if margin_floor_mv is None:
        margin_floor_mv = cal.MIN_FUNCTIONAL_MARGIN_MV
    batch = dse.sweep(_tail_space(samples, key, corr, tail_shift, tail_scale),
                      with_transient=False, device=device)
    ppm = {k: to_host(v) for k, v in batch.yield_ppm(
        margin_mv=margin_floor_mv, min_ess=min_ess).items()}

    out = {"samples": samples,
           "margin_floor_mv": float(margin_floor_mv),
           "tail_shift": float(tail_shift),
           "tail_scale": float(tail_scale),
           "corr": float(corr)}
    base = batch.base_len
    layers = to_host(batch.layers)
    for i, tname in enumerate(batch.tech_col[:base]):
        out[tname] = dict(layers=int(layers[i]), **_ppm_row(ppm, i))
    return out


def fig_tail_probability(floors_mv=None, samples: int = 4096, key=0,
                         tail_shift: float = 4.0, tail_scale: float = 1.2,
                         corr: float = 1.0, min_ess: float = 8.0,
                         device="cuda") -> list[dict]:
    """Tail-probability curve: margin-spec failure probability vs the
    margin floor, per Table-1 tech — ONE importance-sampled sweep reused
    for every floor (the spec threshold is a reduction argument, not a
    sweep input)."""
    if floors_mv is None:
        floors_mv = np.linspace(20.0, 120.0, 11)
    batch = dse.sweep(_tail_space(samples, key, corr, tail_shift, tail_scale),
                      with_transient=False, device=device)
    tech_col = batch.tech_col[:batch.base_len]

    rows = []
    for floor in floors_mv:
        ppm = {k: to_host(v) for k, v in batch.yield_ppm(
            margin_mv=float(floor), min_ess=min_ess).items()}
        for i, tname in enumerate(tech_col):
            rows.append(dict(tech=tname, margin_floor_mv=float(floor),
                             **_ppm_row(ppm, i)))
    return rows


def fig9b_margin_yield_vs_density(densities=None, scheme: str = "sel_strap",
                                  samples: int = 128, key=0,
                                  device="cuda") -> list[dict]:
    """Fig. 9(b) yield variant: per (tech, density) the fraction of MC
    samples whose disturbed margin clears the functional floor — the
    binary `functional` line of `fig9b_margin_vs_density` becomes a
    yield curve."""
    if densities is None:
        densities = np.linspace(0.5, 3.5, 13)
    batch = dse.sweep(_density_space(densities, scheme, device).with_mc(
        samples=samples, key=key), with_transient=False, device=device)
    y_dist = to_host(batch.yield_fraction(
        margin_mv=cal.MIN_DISTURBED_MARGIN_MV, disturbed=True))
    p05 = to_host(batch.quantile(0.05, "margin_disturbed_mv"))
    med = to_host(batch.quantile(0.5, "margin_disturbed_mv"))
    layers = to_host(batch.layers)

    rows = []
    for i, (tech, d) in enumerate(itertools.product(_non_baseline_techs(),
                                                    densities)):
        rows.append(dict(
            tech=tech.name, density_gb_mm2=float(d),
            layers=int(layers[i]),
            margin_with_fbe_rh_mv_median=float(med[i]),
            margin_with_fbe_rh_mv_p05=float(p05[i]),
            yield_disturbed=float(y_dist[i])))
    return rows


def replica_timing_table(device="cuda") -> dict:
    """Fixed t_sense vs replica-closed timing on the Table-1 target points.

    Two sweeps of `DesignSpace.paper_targets()` — one nominal (fixed
    own-90% SA-enable timing) and one `with_replica()` (the SA enable
    fires on the replica bitline's own crossing) — read off as per-tech
    tRC / fire-time / margin-at-fire comparisons.
    """
    space = DesignSpace.paper_targets()
    fixed = dse.sweep(space, with_transient=True, device=device)
    closed = dse.sweep(space.with_replica(), with_transient=True,
                       device=device)
    f, c = _columns(fixed), _columns(closed)

    out = {}
    for i, tname in enumerate(fixed.tech_col):
        tech = TECHS[tname]
        trc_f = float(f["trc_ns"][i])
        trc_c = float(c["trc_ns"][i])
        out[tname] = dict(
            layers=int(f["layers"][i]),
            replica_cells=float(tech.replica_cells),
            trc_fixed_ns=trc_f,
            trc_closed_ns=trc_c,
            trc_delta_ns=trc_f - trc_c,
            t_fire_fixed_ns=float(f["t_fire_ns"][i]),
            t_fire_closed_ns=float(c["t_fire_ns"][i]),
            margin_fire_fixed_mv=float(f["margin_fire_mv"][i]),
            margin_fire_closed_mv=float(c["margin_fire_mv"][i]),
            feasible_fixed=bool(f["feasible"][i]),
            feasible_closed=bool(c["feasible"][i]),
        )
    return out


def table1_summary(device="cuda") -> dict:
    spec = fig9c_spec_table(with_transient=True, device=device)
    return dict(
        cell_structure="GAA, line-type isolation",
        channel=("epitaxial Si (Si-SiGe) & AOS (Si deposition)"),
        array_direction="VBL",
        wl_bl_routing="HCB CBA: BL/WL selector, strap",
        bit_density="2.6 Gb/mm^2: %dL (Si), %dL (AOS)" % (
            spec["si"]["layers"], spec["aos"]["layers"]),
        sense_margin_mv=dict(si=spec["si"]["sense_margin_mv"],
                             aos=spec["aos"]["sense_margin_mv"],
                             d1b=spec["d1b"]["sense_margin_mv"]),
        trc_ns=dict(si=spec["si"]["trc_ns"], aos=spec["aos"]["trc_ns"],
                    d1b=spec["d1b"]["trc_ns"]),
        energy_fj=dict(
            write_si=spec["si"]["e_write_fj"], write_aos=spec["aos"]["e_write_fj"],
            read_si=spec["si"]["e_read_fj"], read_aos=spec["aos"]["e_read_fj"]),
    )
