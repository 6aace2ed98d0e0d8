"""Monte-Carlo reductions over a reference sweep's columns.

Frozen copy of the reductions of `src/repro_torch/core/batch.py`
(`yield_fraction`, `quantile`, `ess`, `yield_ppm`, `mc_summary`) as
functions of the column dict `score.sweep` returns.  Sample s of base
design i sits at row `s * base + i`.
"""

from __future__ import annotations

import numpy as np
import torch

ARRAY_FIELDS = (
    "tech_idx", "scheme_idx", "layers",
    "density_gb_mm2", "height_um", "cbl_ff",
    "margin_mv", "margin_disturbed_mv",
    "trc_ns", "t_sense_ns", "t_fire_ns", "margin_fire_mv",
    "e_write_fj", "e_read_fj",
    "hcb_pitch_um", "blsa_area_um2",
    "manufacturable", "feasible", "valid",
)
MC_SAMPLED_FIELDS = ("margin_mv", "margin_disturbed_mv",
                     "trc_ns", "t_sense_ns", "t_fire_ns", "margin_fire_mv")
_INTERP_EPS = float(np.spacing(np.finfo(np.float32).eps))


def _segment_sum(x, ids, base):
    return x.new_zeros((base,)).index_add_(0, ids, x)


def _interp_columns(x, xp, fp):
    xp_t = xp.t().contiguous()
    fp_t = fp.t().contiguous()
    xs = x[None, :].expand(xp_t.shape[0], -1).contiguous()
    s = xp_t.shape[1]
    hi = torch.clamp(torch.searchsorted(xp_t, xs, right=True), 1, s - 1)
    lo = torch.clamp_min(hi - 1, 0)
    xp_lo, xp_hi = xp_t.gather(1, lo), xp_t.gather(1, hi)
    fp_lo, fp_hi = fp_t.gather(1, lo), fp_t.gather(1, hi)
    df = fp_hi - fp_lo
    dx = xp_hi - xp_lo
    delta = xs - xp_lo
    dx0 = torch.abs(dx) <= _INTERP_EPS
    f = torch.where(dx0, fp_lo,
                    fp_lo + (delta / torch.where(dx0, 1.0, dx)) * df)
    f = torch.where(xs < xp_t[:, :1], fp_t[:, :1], f)
    f = torch.where(xs > xp_t[:, -1:], fp_t[:, -1:], f)
    return f.t()


def _ids(cols):
    n = cols["valid"].shape[0]
    return torch.arange(n, device=cols["valid"].device) % cols["base_len"]


def _weights(cols):
    log_w = cols["corners"].get("mc_log_w")
    if log_w is None:
        return None
    log_w = torch.where(cols["valid"], log_w.to(torch.float32), -torch.inf)
    peak = torch.max(log_w)
    peak = torch.where(torch.isfinite(peak), peak, 0.0)
    return torch.exp(log_w - peak)


def _segment_frac(cols, ok, weights):
    ids, base, valid = _ids(cols), cols["base_len"], cols["valid"]
    if weights is None:
        hits = _segment_sum((ok & valid).to(torch.float32), ids, base)
        tot = _segment_sum(valid.to(torch.float32), ids, base)
        return torch.where(tot > 0.0, hits / torch.clamp_min(tot, 1.0),
                           torch.nan)
    hits = _segment_sum(weights * (ok & valid), ids, base)
    tot = _segment_sum(weights, ids, base)
    return torch.where(tot > 0.0, hits / torch.where(tot > 0.0, tot, 1.0),
                       torch.nan)


def _spec_ok(cols, margin_mv, trc_ns, disturbed):
    ok = cols["valid"]
    if margin_mv is not None:
        col = cols["margin_disturbed_mv"] if disturbed else cols["margin_mv"]
        ok = ok & (col >= margin_mv)
    if trc_ns is not None:
        ok = ok & (cols["trc_ns"] <= trc_ns)
    return ok


def yield_fraction(cols, margin_mv=None, trc_ns=None, disturbed=False):
    return _segment_frac(cols, _spec_ok(cols, margin_mv, trc_ns, disturbed),
                         _weights(cols))


def quantile(cols, q, field="trc_ns"):
    base, s = cols["base_len"], cols["samples"]
    n = s * base
    dev = cols["valid"].device
    vals = cols[field].to(torch.float32)[:n]
    valid = cols["valid"][:n].reshape(s, base)
    q_arr = torch.as_tensor(np.asarray(q, np.float32), device=dev)
    weights = _weights(cols)
    if weights is None:
        vals = torch.where(valid, vals.reshape(s, base), torch.nan)
        return torch.nanquantile(vals, q_arr, dim=0)
    vals = vals.reshape(s, base)
    w = weights[:n].reshape(s, base)
    usable = torch.isfinite(vals) & valid
    w = torch.where(usable, w, 0.0)
    sortkey = torch.where(usable, vals, torch.inf)
    order = torch.argsort(sortkey, dim=0, stable=True)
    v = torch.take_along_dim(sortkey, order, dim=0)
    ww = torch.take_along_dim(w, order, dim=0)
    tot = ww.sum(dim=0)
    vmax = torch.amax(torch.where(usable & (w > 0.0), vals, -torch.inf),
                      dim=0)
    v = torch.where(torch.isfinite(v), v, vmax[None, :])
    midpts = torch.cumsum(ww, dim=0) - 0.5 * ww
    cdf = midpts / torch.clamp_min(tot, 1e-30)[None, :]
    out = _interp_columns(torch.atleast_1d(q_arr), cdf, v)
    out = torch.where(tot[None, :] > 0.0, out, torch.nan)
    return out[0] if q_arr.ndim == 0 else out


def ess(cols):
    w = _weights(cols)
    if w is None:
        w = cols["valid"].to(torch.float32)
    ids, base = _ids(cols), cols["base_len"]
    s1 = _segment_sum(w, ids, base)
    s2 = _segment_sum(w * w, ids, base)
    return torch.where(s2 > 0.0, s1 * s1 / torch.where(s2 > 0.0, s2, 1.0),
                       0.0)


def yield_ppm(cols, margin_mv=None, trc_ns=None, disturbed=False,
              z_conf=1.959964, min_ess=8.0) -> dict:
    ok = _spec_ok(cols, margin_mv, trc_ns, disturbed)
    valid = cols["valid"]
    fail = (valid & ~ok).to(torch.float32)
    log_w = cols["corners"].get("mc_log_w")
    if log_w is None:
        wf = fail
    else:
        w = torch.exp(log_w.to(torch.float32))
        wf = torch.where(valid, w, 0.0) * fail
    ids, base = _ids(cols), cols["base_len"]
    n = _segment_sum(valid.to(torch.float32), ids, base)
    n_safe = torch.clamp_min(n, 1.0)
    s1 = _segment_sum(wf, ids, base)
    s2 = _segment_sum(wf * wf, ids, base)
    p_fail = s1 / n_safe
    var = torch.clamp_min(s2 / n_safe - p_fail * p_fail, 0.0) / n_safe
    sd = torch.sqrt(var)
    e = torch.where(s2 > 0.0, s1 * s1 / torch.where(s2 > 0.0, s2, 1.0), 0.0)
    good = (n > 0.0) & (e >= min_ess)
    to_ppm = lambda p: torch.clamp(p, 0.0, 1.0) * 1e6
    return {
        "fail_ppm": torch.where(good, to_ppm(p_fail), torch.nan),
        "fail_ppm_lo": torch.where(good, to_ppm(p_fail - z_conf * sd),
                                   torch.nan),
        "fail_ppm_hi": torch.where(good, to_ppm(p_fail + z_conf * sd),
                                   torch.nan),
        "ess": e,
    }


def mc_summary(cols, margin_mv=None, trc_ns=None, disturbed=False, q=0.5,
               min_feasible_frac=0.5) -> dict:
    """One row per base design: sampled fields at their `q`-quantile, the
    others at the first sample, `feasible` as a share of feasible samples,
    `corners` with `yield_frac` and `ess`."""
    base = cols["base_len"]
    yf = yield_fraction(cols, margin_mv, trc_ns, disturbed)
    out = {f: cols[f][:base] for f in ARRAY_FIELDS}
    for f in MC_SAMPLED_FIELDS:
        out[f] = quantile(cols, q, f).to(torch.float32)
    feas = _segment_frac(cols, cols["feasible"], _weights(cols))
    out["feasible"] = (feas >= min_feasible_frac) & out["valid"]
    corners = {k: v[:base] for k, v in cols["corners"].items()
               if not k.startswith("mc_")}
    corners["yield_frac"] = yf.to(torch.float32)
    corners["ess"] = ess(cols).to(torch.float32)
    out["corners"] = corners
    return out
