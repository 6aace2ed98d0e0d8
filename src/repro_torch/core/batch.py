"""Structure-of-arrays design batches — the result half of the DSE API.

Port of `repro.core.batch`.  A `DesignBatch` holds every scored metric
of a sweep as one flat (B,) tensor per field plus a validity mask; the
batch axis is the only axis.  Monte-Carlo sweeps keep the same flat
layout: sample s of base design i sits at row `s * base_len + i`.  The
Monte-Carlo reductions (`yield_fraction`, `quantile`, `mc_summary`, ...)
are not ported yet.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass, fields, replace

import numpy as np
import torch


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

    def select(self, where) -> "DesignBatch":
        """Rows selected by a boolean mask or index array.

        Selecting rows of a Monte-Carlo batch destroys the sample-major
        layout, so the MC aux is cleared to the `n_samples=0` sentinel.
        """
        idx = torch.as_tensor(np.asarray(where) if not isinstance(
            where, torch.Tensor) else where).to(self.device)
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
            remap = lambda names, table: torch.as_tensor(
                [table.index(n) for n in names] or [0], dtype=torch.int32,
                device=b.device)
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
    def from_points(cls, points, device="cpu") -> "DesignBatch":
        """Bridge a legacy `list[DesignPoint]` into a batch on `device`.
        `DesignPoint` records no manufacturability (only the combined
        `feasible` verdict), so `manufacturable` is a placeholder (all
        True); the timing fields it does not carry are NaN."""
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
