"""The comparison that decides `correct`: what the timed path produced,
held to the plain reference recomputed from the same declaration.

Numbers (each beside the limit its mix's file gives; `ops` adds those of
the ops a mix runs):

    rows_off      rows whose identity or flag columns differ (tech,
                  scheme, layers, manufacturable, feasible, valid), or
                  where one side is NaN and the other is not
    time_gap_dt   the widest gap of tRC, t_sense or the SA-fire time, in
                  engine steps of 0.02 ns
    value_gap     the widest gap of any other scored column or MC
                  channel, as a share of that column's largest |value|
    mask_off      rows where the Pareto mask is not the front of the
                  columns it was taken from (the program's own columns,
                  which the numbers above hold to the reference's)
    reduce_off    reduction rows (per design) that differ in a flag or in
                  being NaN
    reduce_gap    the widest gap of a reduction, as a share of the
                  larger of |reference| and a thousandth of its column's
                  largest |value|
"""

from __future__ import annotations

import torch

from .reference import engine, reduce, score

EXACT = ("tech_idx", "scheme_idx", "layers", "manufacturable", "feasible",
         "valid")
TIMES = ("trc_ns", "t_sense_ns", "t_fire_ns")


def columns(batch) -> dict:
    """A program `DesignBatch` (or a reference column dict) as a column
    dict with `corners`."""
    if isinstance(batch, dict):
        return batch
    out = {f: getattr(batch, f) for f in reduce.ARRAY_FIELDS}
    out["corners"] = dict(batch.corners)
    return out


def _flat(cols: dict) -> dict:
    out = {k: v for k, v in cols.items()
           if isinstance(v, torch.Tensor)}
    out.update({f"corners.{k}": v for k, v in cols["corners"].items()})
    return out


def _off(p, r):
    if p.dtype.is_floating_point:
        both = torch.isnan(p) & torch.isnan(r)
        return ~((p == r) | both)
    return p != r


def _gap(p, r, scale):
    ok = torch.isfinite(p) & torch.isfinite(r)
    d = torch.where(ok, (p.double() - r.double()).abs() / scale, 0.0)
    return float(d.max()) if d.numel() else 0.0


def compare_rows(prog: dict, ref: dict) -> dict:
    """rows_off, time_gap_dt and value_gap of two column dicts."""
    p, r = _flat(prog), _flat(ref)
    n = r["valid"].shape[0]
    if p["valid"].shape[0] != n or set(p) != set(r):
        return {"rows_off": n, "time_gap_dt": 0.0, "value_gap": 0.0}
    dev = r["valid"].device
    off = torch.zeros(n, dtype=torch.bool, device=dev)
    time_gap = value_gap = 0.0
    for name, rv in r.items():
        pv = p[name].to(dev)
        if name in EXACT:
            off |= _off(pv, rv)
            continue
        off |= torch.isnan(pv) != torch.isnan(rv)
        if name in TIMES:
            time_gap = max(time_gap, _gap(pv, rv, engine.DT_NS))
        else:
            big = torch.where(torch.isfinite(rv), rv.abs(), 0.0).max()
            value_gap = max(value_gap, _gap(pv, rv, max(float(big), 1e-30)))
    return {"rows_off": int(off.sum()), "time_gap_dt": time_gap,
            "value_gap": value_gap}


def compare_reduction(prog: dict, ref: dict) -> dict:
    """reduce_off and reduce_gap of two reductions (dicts of per-design
    columns, `corners` flattened in)."""
    p = _flat(prog) if "corners" in prog else prog
    r = _flat(ref) if "corners" in ref else ref
    if set(p) != set(r):
        return {"reduce_off": max(v.shape[0] for v in r.values()),
                "reduce_gap": 0.0}
    rows_off, gap = 0, 0.0
    for name, rv in r.items():
        pv = p[name].to(rv.device)
        if pv.shape != rv.shape:
            rows_off += rv.shape[0]
            continue
        if not rv.dtype.is_floating_point:
            rows_off += int((pv != rv).sum())
            continue
        rows_off += int((torch.isnan(pv) != torch.isnan(rv)).sum())
        big = torch.where(torch.isfinite(rv), rv.abs(), 0.0).max()
        floor = max(float(big) * 1e-3, 1e-30)
        gap = max(gap, _gap(pv, rv, torch.clamp_min(rv.double().abs(),
                                                     floor)))
    return {"reduce_off": rows_off, "reduce_gap": gap}


def combine(nums: dict, new: dict) -> dict:
    """Fold one answer's numbers into the run's: counts (`*_off`) add up,
    gaps take the widest."""
    for k, v in new.items():
        if k.endswith("_off"):
            nums[k] = nums.get(k, 0) + v
        else:
            nums[k] = max(nums.get(k, 0.0), v)
    return nums


def judge(kept: list, device) -> dict:
    """The numbers of every kept answer.  `kept` holds dicts with the
    declaration (`decl`), the sweep's keyword arguments (`sweep`), the
    program's batch (`batch`), the ops the client ran (`ops`) and their
    answers (`outs`, by op name); the reference recomputes each
    declaration in float32."""
    from .spaces import reference_space

    nums = {}
    for item in kept:
        ref = score.sweep(reference_space(item["decl"]), device,
                          **item.get("sweep", {}))
        prog = columns(item["batch"])
        combine(nums, compare_rows(prog, ref))
        for op in item["ops"]:
            combine(nums, op.judge(item["outs"][op.name], ref, prog, device))
        del ref
    return nums


def verdict(nums: dict, limits: dict) -> tuple[bool, dict]:
    """Whether every number is within its limit, and the numbers beside
    their limits in the order of `limits`.  A number the answers do not
    give reads None and fails; a number with no limit is an error of the
    mix's file."""
    unlimited = sorted(set(nums) - set(limits))
    if unlimited:
        raise KeyError(f"numbers with no limit: {unlimited}")
    shown = {k: {"value": nums.get(k), "limit": limits[k]} for k in limits}
    ok = all(v["value"] is not None and v["value"] <= v["limit"]
             for v in shown.values())
    return ok, shown
