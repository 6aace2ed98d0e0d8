"""Structure-of-arrays design batches — the result half of the DSE API.

Port of `repro.core.batch`.  A `DesignBatch` holds every scored metric
of a sweep as one flat (B,) tensor per field plus a validity mask; the
batch axis is the only axis.  Monte-Carlo sweeps keep the same flat
layout: sample s of base design i sits at row `s * base_len + i`, and
the Monte-Carlo reductions (`yield_fraction`, `quantile`, `ess`,
`yield_ppm`, `mc_summary`) are masked segment reductions over that axis.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass, fields, replace

import numpy as np
import torch

from ..device import as_bool, as_f32, as_i32, resolve_device
from ..runtime import trace


@dataclass(frozen=True)
class DesignPoint:
    """Scalar view of one design point."""
    tech: str
    scheme: str
    layers: int
    density_gb_mm2: float
    height_um: float
    cbl_ff: float
    margin_mv: float
    margin_disturbed_mv: float
    trc_ns: float
    e_write_fj: float
    e_read_fj: float
    hcb_pitch_um: float
    blsa_area_um2: float
    feasible: bool


# Tensor fields, all shaped (B,) on the single batch axis.
ARRAY_FIELDS = (
    "tech_idx", "scheme_idx", "layers",
    "density_gb_mm2", "height_um", "cbl_ff",
    "margin_mv", "margin_disturbed_mv",
    "trc_ns", "t_sense_ns", "t_fire_ns", "margin_fire_mv",
    "e_write_fj", "e_read_fj",
    "hcb_pitch_um", "blsa_area_um2",
    "manufacturable", "feasible", "valid",
)
INDEX_FIELDS = ("tech_idx", "scheme_idx")                   # int32
MASK_FIELDS = ("manufacturable", "feasible", "valid")       # bool

# Columns a with_mc sweep actually perturbs (per-sample SA offset enters
# the margins; the Vth draw enters the access conductance, hence timing).
MC_SAMPLED_FIELDS = ("margin_mv", "margin_disturbed_mv",
                     "trc_ns", "t_sense_ns", "t_fire_ns", "margin_fire_mv")

# jnp.interp's "dx is zero" bound (np.spacing of float32 eps)
_INTERP_EPS = float(np.spacing(np.finfo(np.float32).eps))


def _segment_sum(x: torch.Tensor, ids: torch.Tensor,
                 base: int) -> torch.Tensor:
    """Sum of `x` over rows with equal `ids` -> (base,)."""
    return x.new_zeros((base,)).index_add_(0, ids, x)


def _interp_columns(x: torch.Tensor, xp: torch.Tensor,
                    fp: torch.Tensor) -> torch.Tensor:
    """`jnp.interp(x, xp[:, j], fp[:, j])` for every column j at once.

    x: (Q,) points; xp, fp: (S, base) with each xp column sorted.
    Returns (Q, base).  Clamped to fp's first / last value outside xp, as
    jnp.interp is.
    """
    xp_t = xp.t().contiguous()                       # (base, S)
    fp_t = fp.t().contiguous()
    xs = x[None, :].expand(xp_t.shape[0], -1).contiguous()   # (base, Q)
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


@dataclass(frozen=True)
class DesignBatch:
    """One design-space sweep as a structure of (B,) tensors.

    `tech_idx`/`scheme_idx` index the `tech_names`/`scheme_names` tables.
    `valid` masks padding rows added by `pad_to`; every reduction in the
    DSE layer respects it.
    """

    tech_idx: torch.Tensor            # (B,) int32 into tech_names
    scheme_idx: torch.Tensor          # (B,) int32 into scheme_names
    layers: torch.Tensor              # (B,) float32
    density_gb_mm2: torch.Tensor      # (B,) float32
    height_um: torch.Tensor           # (B,) float32
    cbl_ff: torch.Tensor              # (B,) float32
    margin_mv: torch.Tensor           # (B,) float32
    margin_disturbed_mv: torch.Tensor # (B,) float32
    trc_ns: torch.Tensor              # (B,) float32 (NaN when transient off)
    t_sense_ns: torch.Tensor          # (B,) float32 (NaN when transient off)
    t_fire_ns: torch.Tensor           # (B,) float32 SA-enable fire time
    margin_fire_mv: torch.Tensor      # (B,) float32 margin at the SA fire
    e_write_fj: torch.Tensor          # (B,) float32
    e_read_fj: torch.Tensor           # (B,) float32
    hcb_pitch_um: torch.Tensor        # (B,) float32
    blsa_area_um2: torch.Tensor       # (B,) float32
    manufacturable: torch.Tensor      # (B,) bool
    feasible: torch.Tensor            # (B,) bool
    valid: torch.Tensor               # (B,) bool
    corners: dict                     # axis name -> (B,) float32
    tech_names: tuple = ()
    scheme_names: tuple = ()
    n_samples: int = 1                # MC sample fan-out (1 = nominal sweep)
    base_len: int = 0                 # design points per sample (0 = len)

    def _map(self, fn) -> "DesignBatch":
        """Apply `fn` to every (B,) tensor, corners included."""
        return replace(self, corners={k: fn(v) for k, v in self.corners.items()},
                       **{f: fn(getattr(self, f)) for f in ARRAY_FIELDS})

    # ------------------------------------------------------------- shape --
    def __len__(self) -> int:
        return int(self.tech_idx.shape[0])

    @property
    def device(self) -> torch.device:
        return self.tech_idx.device

    @property
    def n_valid(self) -> int:
        return int(self.valid.sum())

    @property
    def tech_col(self) -> list:
        """Per-row tech names (host-side convenience)."""
        return [self.tech_names[i] for i in self.tech_idx.tolist()]

    @property
    def scheme_col(self) -> list:
        """Per-row scheme names (host-side convenience)."""
        return [self.scheme_names[i] for i in self.scheme_idx.tolist()]

    def select(self, where) -> "DesignBatch":
        """Rows selected by a boolean mask or index array.

        Selecting rows of a Monte-Carlo batch destroys the sample-major
        layout, so the MC aux is cleared to the `n_samples=0` sentinel.
        """
        if isinstance(where, torch.Tensor):
            idx = where.to(self.device)
        else:
            arr = np.asarray(where)
            idx = (as_bool(arr, self.device) if arr.dtype == bool
                   else as_i32(arr, self.device))
        if idx.dtype == torch.bool:
            idx = torch.nonzero(idx).reshape(-1)
        out = self._map(lambda a: a[idx.long()])
        return replace(out, n_samples=0 if self.n_samples != 1 else 1,
                       base_len=0)

    def slice_rows(self, start: int, stop: int) -> "DesignBatch":
        """Contiguous row slice [start:stop); clears the MC layout like
        `select` unless the batch is a plain (n_samples == 1) sweep."""
        start, stop = int(start), int(stop)
        if not 0 <= start <= stop <= len(self):
            raise ValueError(
                f"slice_rows [{start}:{stop}) out of range for a "
                f"{len(self)}-row batch")
        out = self._map(lambda a: a[start:stop])
        return replace(out, n_samples=0 if self.n_samples != 1 else 1,
                       base_len=0)

    @classmethod
    def concat(cls, batches) -> "DesignBatch":
        """Merge plain (n_samples == 1) batches row-wise; name tables are
        unioned and indices remapped per input batch."""
        batches = list(batches)
        if not batches:
            raise ValueError("concat needs at least one batch")
        corner_keys = set(batches[0].corners)
        for b in batches[1:]:
            if set(b.corners) != corner_keys:
                raise ValueError(
                    "concat needs identical corner channels on every "
                    f"batch (got {sorted(corner_keys)} vs "
                    f"{sorted(b.corners)})")
        if any(b.n_samples != 1 for b in batches):
            raise ValueError(
                "concat only composes plain (n_samples == 1) batches; "
                "concatenating sample-major layouts would interleave their "
                "segments")
        tech_names: list = []
        scheme_names: list = []
        for b in batches:
            tech_names += [n for n in b.tech_names if n not in tech_names]
            scheme_names += [n for n in b.scheme_names if n not in scheme_names]
        parts = []
        for b in batches:
            remap = lambda names, table: as_i32(
                [table.index(n) for n in names] or [0], b.device)
            parts.append(replace(
                b,
                tech_idx=remap(b.tech_names, tech_names)[b.tech_idx.long()],
                scheme_idx=remap(b.scheme_names, scheme_names)[
                    b.scheme_idx.long()]))
        kwargs = {f: torch.cat([getattr(p, f) for p in parts])
                  for f in ARRAY_FIELDS}
        corners = {k: torch.cat([p.corners[k] for p in parts])
                   for k in batches[0].corners}
        return cls(corners=corners, tech_names=tuple(tech_names),
                   scheme_names=tuple(scheme_names),
                   n_samples=1, base_len=0, **kwargs)

    def pad_to(self, multiple: int) -> "DesignBatch":
        """Pad the batch axis up to a multiple; padding rows have
        `valid=False` and zeros elsewhere."""
        pad = (-len(self)) % multiple
        if not pad:
            return self
        return self._map(lambda a: torch.cat([a, a.new_zeros((pad,))]))

    # -------------------------------------------------- Monte-Carlo views --
    # Sample-major layout contract (dse.sweep on a with_mc space): sample s
    # of base design i is flat row `s * base_len + i`; pad_to may append
    # invalid rows at the end.  Every reduction below is a masked segment
    # reduction over the flat batch axis — `select()`ed batches lose the
    # layout and are rejected.
    #
    # Importance sampling: a space lowered with a shifted/scaled tail
    # proposal carries per-row log-weights in `corners["mc_log_w"]`; every
    # reduction consumes them (self-normalized estimators).  Without the
    # channel each reduction takes the plain unweighted path.

    def _mc_base(self) -> int:
        if self.n_samples == 0:
            raise ValueError(
                "MC reductions need the sweep's sample-major layout, which "
                "select() destroys — reduce first (mc_summary) and select "
                "the per-design summary batch instead")
        base = self.base_len or len(self)
        if len(self) < self.n_samples * base:
            raise ValueError(
                "MC reductions need the sweep's sample-major layout "
                f"({self.n_samples} samples x {base} designs), but the "
                f"batch has only {len(self)} rows — was it select()ed?")
        return base

    def _segment_ids(self, base: int) -> torch.Tensor:
        return torch.arange(len(self), device=self.device) % base

    def _mc_weights(self) -> torch.Tensor | None:
        """Per-row importance weights from the reserved `mc_log_w`
        channel, max-stabilized and zeroed on invalid rows — or None when
        the batch carries no weights (uniform)."""
        log_w = self.corners.get("mc_log_w")
        if log_w is None:
            return None
        log_w = torch.where(self.valid, log_w.to(torch.float32), -torch.inf)
        peak = torch.max(log_w)
        peak = torch.where(torch.isfinite(peak), peak, 0.0)
        return torch.exp(log_w - peak)      # exp(-inf) == 0 on invalid rows

    def _segment_frac(self, ok: torch.Tensor, base: int,
                      weights: torch.Tensor | None = None) -> torch.Tensor:
        ids = self._segment_ids(base)
        # A design with ZERO valid samples (or zero total weight) has no
        # yield estimate at all: NaN, not 0.0.
        if weights is None:
            hits = _segment_sum((ok & self.valid).to(torch.float32), ids,
                                base)
            tot = _segment_sum(self.valid.to(torch.float32), ids, base)
            return torch.where(tot > 0.0, hits / torch.clamp_min(tot, 1.0),
                               torch.nan)
        hits = _segment_sum(weights * (ok & self.valid), ids, base)
        tot = _segment_sum(weights, ids, base)
        return torch.where(tot > 0.0,
                           hits / torch.where(tot > 0.0, tot, 1.0),
                           torch.nan)

    def _spec_ok(self, margin_mv: float | None, trc_ns: float | None,
                 disturbed: bool) -> torch.Tensor:
        """Per-row spec pass mask (folded with validity)."""
        ok = self.valid
        if margin_mv is not None:
            col = self.margin_disturbed_mv if disturbed else self.margin_mv
            ok = ok & (col >= margin_mv)
        if trc_ns is not None:
            ok = ok & (self.trc_ns <= trc_ns)
        return ok

    def yield_fraction(self, margin_mv: float | None = None,
                       trc_ns: float | None = None,
                       disturbed: bool = False) -> torch.Tensor:
        """Per-design fraction of MC samples meeting the spec -> (base,).

        A sample passes when its sense margin is at least `margin_mv`
        (the disturbed margin when `disturbed=True`) AND its row-cycle
        time is at most `trc_ns`; criteria passed as None are skipped.
        NaN tRC never passes a tRC spec.  A design whose samples are ALL
        invalid yields NaN (distinct from true yield 0).  On an
        importance-sampled batch this is the self-normalized estimate.
        """
        base = self._mc_base()
        return self._segment_frac(self._spec_ok(margin_mv, trc_ns,
                                                disturbed),
                                  base, self._mc_weights())

    def quantile(self, q, field: str = "trc_ns") -> torch.Tensor:
        """Per-design quantile of a metric across MC samples -> (base,)
        (or (len(q), base) for a vector `q`).  Invalid rows are ignored.
        On an importance-sampled batch the quantile is read off the
        weighted empirical CDF (invalid/NaN rows carry zero weight)."""
        base = self._mc_base()
        s = self.n_samples
        n = s * base
        vals = getattr(self, field).to(torch.float32)[:n]
        valid = self.valid[:n].reshape(s, base)
        q_arr = as_f32(np.asarray(q, np.float32), self.device)
        weights = self._mc_weights()
        if weights is None:
            vals = torch.where(valid, vals.reshape(s, base), torch.nan)
            return torch.nanquantile(vals, q_arr, dim=0)
        vals = vals.reshape(s, base)
        w = weights[:n].reshape(s, base)
        # a row is a CDF knot only when valid AND finite
        usable = torch.isfinite(vals) & valid
        w = torch.where(usable, w, 0.0)
        sortkey = torch.where(usable, vals, torch.inf)
        order = torch.argsort(sortkey, dim=0, stable=True)
        v = torch.take_along_dim(sortkey, order, dim=0)
        ww = torch.take_along_dim(w, order, dim=0)
        tot = ww.sum(dim=0)
        # clamp the +inf sentinel rows to the column's largest usable
        # value so interpolation beyond the last weighted point saturates
        vmax = torch.amax(torch.where(usable & (w > 0.0), vals, -torch.inf),
                          dim=0)
        v = torch.where(torch.isfinite(v), v, vmax[None, :])
        midpts = torch.cumsum(ww, dim=0) - 0.5 * ww
        cdf = midpts / torch.clamp_min(tot, 1e-30)[None, :]
        out = _interp_columns(torch.atleast_1d(q_arr), cdf, v)
        out = torch.where(tot[None, :] > 0.0, out, torch.nan)
        return out[0] if q_arr.ndim == 0 else out

    def ess(self) -> torch.Tensor:
        """Per-design effective sample size (Kish) -> (base,):
        `(sum w)^2 / sum w^2` over each design's valid samples; uniform
        weights reduce it to the valid-sample count."""
        base = self._mc_base()
        w = self._mc_weights()
        if w is None:
            w = self.valid.to(torch.float32)
        ids = self._segment_ids(base)
        s1 = _segment_sum(w, ids, base)
        s2 = _segment_sum(w * w, ids, base)
        return torch.where(s2 > 0.0,
                           s1 * s1 / torch.where(s2 > 0.0, s2, 1.0), 0.0)

    def yield_ppm(self, margin_mv: float | None = None,
                  trc_ns: float | None = None, disturbed: bool = False,
                  z_conf: float = 1.959964, min_ess: float = 8.0) -> dict:
        """Deep-tail spec-FAILURE estimate per design, in parts per
        million -> dict of (base,) tensors.

        The *unnormalized* importance-sampling estimator
        `p = (1/N) sum_i w_i [fail_i]` with the exact density-ratio
        weights:

            fail_ppm            point estimate, failures per million
            fail_ppm_lo/hi      `z_conf`-sigma normal-approximation CI
                                bounds (clipped to [0, 1e6])
            ess                 per-design tail effective sample size
                                `(sum w f)^2 / sum (w f)^2`

        A design whose tail ESS is below `min_ess` (including zero
        observed failures) or with zero valid samples reports NaN.
        """
        with trace.span("batch.reduce"):
            base = self._mc_base()
            ok = self._spec_ok(margin_mv, trc_ns, disturbed)
            fail = (self.valid & ~ok).to(torch.float32)
            log_w = self.corners.get("mc_log_w")
            if log_w is None:
                wf = fail
            else:
                w = torch.exp(log_w.to(torch.float32))
                wf = torch.where(self.valid, w, 0.0) * fail
            ids = self._segment_ids(base)
            n = _segment_sum(self.valid.to(torch.float32), ids, base)
            n_safe = torch.clamp_min(n, 1.0)
            s1 = _segment_sum(wf, ids, base)
            s2 = _segment_sum(wf * wf, ids, base)
            p_fail = s1 / n_safe
            # unnormalized-IS variance:  Var(w f) / N
            var = torch.clamp_min(s2 / n_safe - p_fail * p_fail, 0.0) / n_safe
            sd = torch.sqrt(var)
            ess = torch.where(s2 > 0.0,
                              s1 * s1 / torch.where(s2 > 0.0, s2, 1.0), 0.0)
            good = (n > 0.0) & (ess >= min_ess)
            to_ppm = lambda p: torch.clamp(p, 0.0, 1.0) * 1e6
            return {
                "fail_ppm": torch.where(good, to_ppm(p_fail), torch.nan),
                "fail_ppm_lo": torch.where(good, to_ppm(p_fail - z_conf * sd),
                                           torch.nan),
                "fail_ppm_hi": torch.where(good, to_ppm(p_fail + z_conf * sd),
                                           torch.nan),
                "ess": ess,
            }

    def mc_summary(self, margin_mv: float | None = None,
                   trc_ns: float | None = None, disturbed: bool = False,
                   q: float = 0.5,
                   min_feasible_frac: float = 0.5) -> "DesignBatch":
        """Reduce an MC batch to one row per base design.

        Sampled metrics (`MC_SAMPLED_FIELDS`) collapse to their per-design
        `q`-quantile; deterministic columns take the first sample's value.
        `feasible` becomes "at least `min_feasible_frac` of samples
        feasible", `corners["yield_frac"]` records `yield_fraction(
        margin_mv, trc_ns, disturbed)` and `corners["ess"]` the effective
        sample size.  The raw `mc_*` channels never survive the reduction.
        """
        with trace.span("batch.reduce"):
            base = self._mc_base()
            yf = self.yield_fraction(margin_mv=margin_mv, trc_ns=trc_ns,
                                     disturbed=disturbed)
            kwargs = {f: getattr(self, f)[:base] for f in ARRAY_FIELDS}
            for f in MC_SAMPLED_FIELDS:
                kwargs[f] = self.quantile(q, f).to(torch.float32)
            feas_frac = self._segment_frac(self.feasible, base,
                                           self._mc_weights())
            kwargs["feasible"] = ((feas_frac >= min_feasible_frac)
                                  & kwargs["valid"])
            corners = {k: v[:base] for k, v in self.corners.items()
                       if not k.startswith("mc_")}
            corners["yield_frac"] = yf.to(torch.float32)
            corners["ess"] = self.ess().to(torch.float32)
            return DesignBatch(corners=corners, tech_names=self.tech_names,
                               scheme_names=self.scheme_names, **kwargs)

    # ------------------------------------------------------ legacy views --
    def point(self, i: int) -> DesignPoint:
        """Scalar `DesignPoint` view of row `i`."""
        col = lambda f: getattr(self, f)[i].item()
        return DesignPoint(
            tech=self.tech_names[int(col("tech_idx"))],
            scheme=self.scheme_names[int(col("scheme_idx"))],
            layers=int(col("layers")),
            density_gb_mm2=float(col("density_gb_mm2")),
            height_um=float(col("height_um")),
            cbl_ff=float(col("cbl_ff")),
            margin_mv=float(col("margin_mv")),
            margin_disturbed_mv=float(col("margin_disturbed_mv")),
            trc_ns=float(col("trc_ns")),
            e_write_fj=float(col("e_write_fj")),
            e_read_fj=float(col("e_read_fj")),
            hcb_pitch_um=float(col("hcb_pitch_um")),
            blsa_area_um2=float(col("blsa_area_um2")),
            feasible=bool(col("feasible")))

    def to_points(self) -> list:
        """Deprecated compatibility view: a `list[DesignPoint]` of the
        valid rows.  New code should read the tensor fields directly."""
        warnings.warn(
            "DesignBatch.to_points is deprecated; consume the DesignBatch "
            "tensor columns directly (point(i) for a single row)",
            DeprecationWarning, stacklevel=2)
        return [self.point(i) for i in torch.nonzero(self.valid).reshape(-1).tolist()]

    @classmethod
    def from_points(cls, points, device="cuda") -> "DesignBatch":
        """Bridge a legacy `list[DesignPoint]` into a batch on `device`
        (default "cuda"; raises without a GPU unless `device="cpu"`).
        `DesignPoint` records no manufacturability (only the combined
        `feasible` verdict), so `manufacturable` is a placeholder (all
        True); the timing fields it does not carry are NaN."""
        device = resolve_device(device)
        points = list(points)
        tech_names: list = []
        scheme_names: list = []
        for p in points:
            if p.tech not in tech_names:
                tech_names.append(p.tech)
            if p.scheme not in scheme_names:
                scheme_names.append(p.scheme)
        f32 = lambda vals: torch.tensor(vals, dtype=torch.float32, device=device)
        col = lambda f: f32([float(getattr(p, f)) for p in points])
        nan = f32([float("nan")] * len(points))
        feasible = torch.tensor([bool(p.feasible) for p in points],
                                dtype=torch.bool, device=device)
        point_fields = {f.name for f in fields(DesignPoint)}
        kwargs = {f: col(f) for f in ARRAY_FIELDS
                  if f in point_fields and f != "feasible"}
        kwargs.update(
            tech_idx=torch.tensor([tech_names.index(p.tech) for p in points],
                                  dtype=torch.int32, device=device),
            scheme_idx=torch.tensor(
                [scheme_names.index(p.scheme) for p in points],
                dtype=torch.int32, device=device),
            t_sense_ns=nan, t_fire_ns=nan, margin_fire_mv=nan,
            manufacturable=torch.ones_like(feasible), feasible=feasible,
            valid=torch.ones_like(feasible))
        return cls(corners={}, tech_names=tuple(tech_names),
                   scheme_names=tuple(scheme_names), **kwargs)
