"""Declarative design spaces and their lowering to flat operand arrays.

Port of `repro.core.space`.  The entry half of the array-native DSE API:

    space = DesignSpace.paper_grid()              # declarative builder
    batch = dse.sweep(space)                      # one vectorized pass
    front = dse.pareto_front(batch)               # masked array dominance

A `DesignSpace` is a *declaration* — which (tech, scheme, layer) points to
evaluate, plus optional corner axes — and `lower()` turns it into the
canonical structure-of-arrays form (`LoweredSpace`) every physics module
consumes.  Lowering is all numpy and matches the reference bit for bit,
Monte-Carlo draws included (int seeds only: a JAX PRNG key would need
JAX to read).

LoweredSpace protocol (duck-typed; physics modules take any `view` with):

    view.device          torch.device the per-point tensors live on
    view.layers          (B,) float32 tensor of layer counts
    view.valid           (B,) bool mask (False rows are padding)
    view.tech(field)     (B,) gather of a TechCal field per point
    view.scheme(field)   (B,) gather of a SchemeSpec field per point
    view.corner(name, d) (B,) float32 corner tensor, or the scalar default

`LoweredSpace` gathers on the host (numpy, float64 like the reference);
`SpaceView` gathers on the device (float32 / int32 / bool tensors, like
the reference's jnp view), and is what the scoring pass reads.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field, replace

import numpy as np
import torch

from ..device import resolve_device
from . import calibration as cal
from . import routing

# The paper's layer-count sweep grid (Figs. 9a/9b x-axis anchors).
DEFAULT_LAYER_GRID = (32, 48, 64, 87, 100, 120, 137, 160, 200)

# Reserved per-row channels injected by Monte-Carlo lowering; user corner
# axes must not collide with these (`with_corners` rejects the prefix).
MC_AXES = ("mc_sa_offset_mv", "mc_delta_vth_mv")

# Reserved per-row importance-sampling log-weight channel: present only
# when `with_mc` declares a shifted/scaled proposal (tail_shift/tail_scale).
MC_LOG_W = "mc_log_w"

# Rank of the low-rank factor basis behind the correlated mat/strap
# gradient (cosine features of a squared-exponential kernel).
MC_GRADIENT_FACTORS = 8


def _key_entropy(key) -> tuple:
    """An int MC seed as the entropy tuple of `np.random.default_rng`.

    The reference also takes a JAX PRNG key; reading one needs JAX, so the
    port accepts int seeds only (the same int lowers to the same draws).
    """
    if isinstance(key, (int, np.integer)) and not isinstance(key, bool):
        return (int(key),)
    raise TypeError(f"with_mc key must be an int seed, got {type(key).__name__}")


@dataclass(frozen=True)
class MCConfig:
    """Monte-Carlo sampling declaration attached by `with_mc`.

    `sa_offset_sigma_mv` / `vth_sigma_mv` of None mean "use each tech's
    calibrated sigma fields".  `corr` scales each tech's within-die
    correlation fractions (0 keeps the draws i.i.d.).  `tail_shift` /
    `tail_scale` declare an importance-sampling proposal on the local
    standardized draws, per channel (SA offset, Vth); its log-weights are
    lowered as the reserved `mc_log_w` channel.
    """
    samples: int
    entropy: tuple
    sa_offset_sigma_mv: float | None = None
    vth_sigma_mv: float | None = None
    corr: float = 0.0
    tail_shift: tuple = (0.0, 0.0)
    tail_scale: tuple = (1.0, 1.0)

    @property
    def is_active(self) -> bool:
        """Whether the proposal differs from the target (weights ride)."""
        return (any(s != 0.0 for s in self.tail_shift)
                or any(s != 1.0 for s in self.tail_scale))


@dataclass(frozen=True)
class LoweredSpace:
    """Canonical flat form of a DesignSpace: one row per design point.

    The arrays are host numpy; `layers` and `corner()` hand float32
    tensors on `device` to the physics modules.
    """

    tech_names: tuple
    scheme_names: tuple
    tech_idx: np.ndarray        # (B,) int32 into tech_names
    scheme_idx: np.ndarray      # (B,) int32 into scheme_names
    layers_np: np.ndarray       # (B,) float32
    valid: np.ndarray           # (B,) bool
    corners: dict = field(default_factory=dict)
    samples: int = 1            # MC fan-out (B = samples * base points)
    replica: bool = False       # replica-closed SA-enable timing: the
    #                             operand lowering adds one replica row
    #                             per design point (len(self) unchanged)
    device: torch.device = torch.device("cpu")

    def __len__(self) -> int:
        return int(self.tech_idx.shape[0])

    @property
    def base_len(self) -> int:
        """Design points per MC sample (== len(self) without `with_mc`)."""
        return len(self) // self.samples

    @property
    def layers(self) -> torch.Tensor:
        return torch.as_tensor(self.layers_np, dtype=torch.float32,
                               device=self.device)

    def tech(self, fieldname: str) -> np.ndarray:
        """Per-point gather of a TechCal field."""
        vals = [getattr(cal.get_tech(n), fieldname) for n in self.tech_names]
        return np.asarray(vals)[self.tech_idx]

    def scheme(self, fieldname: str) -> np.ndarray:
        """Per-point gather of a SchemeSpec field."""
        vals = [getattr(routing.scheme_spec(n), fieldname)
                for n in self.scheme_names]
        return np.asarray(vals)[self.scheme_idx]

    def corner(self, name: str, default):
        """Per-point corner-axis values, or the scalar default when the
        space declared no such axis."""
        if name in self.corners:
            return torch.as_tensor(self.corners[name], dtype=torch.float32,
                                   device=self.device)
        return default


def _table(vals: list, idx: torch.Tensor) -> torch.Tensor:
    """Gather a calibration table on the device with the reference's jnp
    dtypes: float -> float32, int -> int32, bool -> bool."""
    arr = np.asarray(vals)
    if arr.dtype.kind == "f":
        arr = arr.astype(np.float32)
    elif arr.dtype.kind in "iu":
        arr = arr.astype(np.int32)
    return torch.as_tensor(arr, device=idx.device)[idx]


@dataclass(frozen=True)
class SpaceView:
    """Device-side twin of `LoweredSpace`: the same duck-typed protocol,
    but every per-point array is a tensor on `device` and the calibration
    gathers run there.  The scoring pass (`dse.score_columns`) reads it.
    """

    tech_names: tuple
    scheme_names: tuple
    tech_idx: torch.Tensor      # (B,) int32 into tech_names
    scheme_idx: torch.Tensor    # (B,) int32 into scheme_names
    layers: torch.Tensor        # (B,) float32
    valid: torch.Tensor         # (B,) bool
    corners: dict
    samples: int = 1
    replica: bool = False

    @classmethod
    def from_lowered(cls, sp: LoweredSpace) -> "SpaceView":
        dev = sp.device
        return cls(
            tech_names=tuple(sp.tech_names),
            scheme_names=tuple(sp.scheme_names),
            tech_idx=torch.as_tensor(sp.tech_idx, dtype=torch.int32, device=dev),
            scheme_idx=torch.as_tensor(sp.scheme_idx, dtype=torch.int32,
                                       device=dev),
            layers=sp.layers,
            valid=torch.as_tensor(sp.valid, device=dev),
            corners={k: torch.as_tensor(v, dtype=torch.float32, device=dev)
                     for k, v in sp.corners.items()},
            samples=sp.samples, replica=bool(sp.replica))

    @property
    def device(self) -> torch.device:
        return self.layers.device

    def __len__(self) -> int:
        return int(self.tech_idx.shape[0])

    @property
    def base_len(self) -> int:
        return len(self) // self.samples

    def tech(self, fieldname: str) -> torch.Tensor:
        """Per-point gather of a TechCal field on the device."""
        return _table([getattr(cal.get_tech(n), fieldname)
                       for n in self.tech_names], self.tech_idx)

    def scheme(self, fieldname: str) -> torch.Tensor:
        """Per-point gather of a SchemeSpec field on the device."""
        return _table([getattr(routing.scheme_spec(n), fieldname)
                       for n in self.scheme_names], self.scheme_idx)

    def corner(self, name: str, default):
        if name in self.corners:
            return self.corners[name]
        return default

    def pad_to(self, total: int) -> "SpaceView":
        """Append inactive rows (valid=False) up to `total` — the view
        counterpart of `transient._pad_operands`, so a padded dispatch
        slab scores padding rows with benign finite inputs (tech/scheme 0,
        layers 1.0, corners 0.0) and drops them on the slice back."""
        pad = total - len(self)
        if pad < 0:
            raise ValueError(f"pad_to({total}) smaller than view ({len(self)})")
        if pad == 0:
            return self

        def pad1(x, v):
            return torch.cat([x, x.new_full((pad,), v)])

        return replace(
            self,
            tech_idx=pad1(self.tech_idx, 0), scheme_idx=pad1(self.scheme_idx, 0),
            layers=pad1(self.layers, 1.0), valid=pad1(self.valid, False),
            corners={k: pad1(v, 0.0) for k, v in self.corners.items()})

    def slice_rows(self, lo: int, hi: int) -> "SpaceView":
        """Contiguous row slab [lo, hi) — the elastic re-slabbing unit."""
        return replace(
            self,
            tech_idx=self.tech_idx[lo:hi], scheme_idx=self.scheme_idx[lo:hi],
            layers=self.layers[lo:hi], valid=self.valid[lo:hi],
            corners={k: v[lo:hi] for k, v in self.corners.items()})

    def to(self, device) -> "SpaceView":
        """The same view with every per-point tensor on `device` (a mesh
        slot's card)."""
        return replace(
            self,
            tech_idx=self.tech_idx.to(device),
            scheme_idx=self.scheme_idx.to(device),
            layers=self.layers.to(device), valid=self.valid.to(device),
            corners={k: v.to(device) for k, v in self.corners.items()})


def _gradient_basis(positions: np.ndarray, corr_length: np.ndarray,
                    n_factors: int = MC_GRADIENT_FACTORS) -> np.ndarray:
    """Low-rank basis of the correlated mat/strap gradient -> (b, K).

    Cosine features weighted by a squared-exponential spectrum and
    row-normalized to unit marginal variance: a gradient draw is
    `g[s] = basis @ w[s]` with `w ~ N(0, I_K)`, so `g` has unit variance
    per row and `corr(g_i, g_j) = basis_i . basis_j`, decaying with the
    row distance `|x_i - x_j|` on the scale of `corr_length` (both in
    die-span units).  In the long-correlation limit the k=0 (constant)
    feature dominates and the gradient degenerates into a shared offset.
    """
    x = np.asarray(positions, np.float64).reshape(-1, 1)        # (b, 1)
    ell = np.asarray(corr_length, np.float64).reshape(-1, 1)    # (b, 1)
    k = np.arange(n_factors, dtype=np.float64)[None, :]         # (1, K)
    lam = np.exp(-0.5 * (k * np.pi * np.maximum(ell, 1e-3)) ** 2)
    basis = np.sqrt(lam) * np.cos(k * np.pi * x)
    norm = np.sqrt((basis ** 2).sum(axis=1, keepdims=True))
    return basis / np.maximum(norm, 1e-30)


def _as_layer_tuple(layers) -> tuple:
    if np.isscalar(layers):
        return (float(layers),)
    return tuple(float(x) for x in np.asarray(layers).reshape(-1))


@dataclass(frozen=True)
class DesignSpace:
    """Declarative (tech x scheme x layers [x corners]) design space.

    Build with `paper_grid()` / `product()` / `points()`, compose with
    `+`, add Monte-Carlo-style axes with `with_corners()`, then hand to
    `dse.sweep` (which calls `lower()` internally).
    """

    entries: tuple = ()          # ((tech_name, scheme_name, layers), ...)
    corner_axes: tuple = ()      # ((axis_name, values), ...)
    mc: MCConfig | None = None   # Monte-Carlo sampling (with_mc)
    replica: bool = False        # replica-closed SA timing (with_replica)

    # ---------------------------------------------------------- builders --
    @classmethod
    def product(cls, techs=None, schemes=None, layers=None) -> "DesignSpace":
        """Cross product honouring per-tech capability flags.

        `techs=None` sweeps every registered technology.  For each tech:
        `schemes=None` uses its `allowed_schemes` declaration (or every
        registered scheme); an explicit `schemes` is *filtered* by
        `allowed_schemes`, so a 2D baseline never sweeps bonded routing.
        A declared per-tech `layer_grid` always wins over `layers` (a
        baseline is only valid at its own layer count); `layers=None`
        falls back to the tech's `layers_target`.
        """
        tech_names = tuple(techs) if techs is not None else tuple(cal.TECHS)
        entries = []
        for tname in tech_names:
            tech = cal.get_tech(tname)
            allowed = tech.allowed_schemes
            tech_schemes = (
                (allowed or tuple(routing.SCHEMES)) if schemes is None
                else tuple(s for s in schemes
                           if allowed is None or s in allowed))
            if tech.layer_grid is not None:
                grid = _as_layer_tuple(tech.layer_grid)
            elif layers is not None:
                grid = _as_layer_tuple(layers)
            else:
                grid = (float(tech.layers_target),)
            for sname in tech_schemes:
                routing.scheme_spec(sname)      # fail fast on unknown names
                entries.append((tname, sname, grid))
        return cls(entries=tuple(entries))

    @classmethod
    def paper_grid(cls, layer_grid=None) -> "DesignSpace":
        """The paper's full sweep: every registered tech x its allowed
        schemes x the layer grid (baselines contribute their own grid)."""
        grid = DEFAULT_LAYER_GRID if layer_grid is None else layer_grid
        return cls.product(layers=grid)

    @classmethod
    def paper_targets(cls) -> "DesignSpace":
        """One Table-1 point per registered tech: its target layer count on
        its flagship scheme (the first allowed scheme for constrained
        techs, selector+strap otherwise)."""
        pts = []
        for tech in cal.TECHS.values():
            scheme = (tech.allowed_schemes[0] if tech.allowed_schemes
                      else "sel_strap")
            pts.append((tech.name, scheme, tech.layers_target))
        return cls.points(pts)

    @classmethod
    def points(cls, pts) -> "DesignSpace":
        """Explicit design points: iterable of (tech, scheme, layers)."""
        entries = []
        for tname, sname, layers in pts:
            cal.get_tech(tname)
            routing.scheme_spec(sname)
            entries.append((tname, sname, _as_layer_tuple(layers)))
        return cls(entries=tuple(entries))

    # ------------------------------------------------------- composition --
    def __add__(self, other: "DesignSpace") -> "DesignSpace":
        if self.corner_axes != other.corner_axes:
            raise ValueError("cannot concatenate DesignSpaces with "
                             "different corner axes")
        if self.mc != other.mc:
            raise ValueError("cannot concatenate DesignSpaces with "
                             "different Monte-Carlo declarations")
        if self.replica != other.replica:
            raise ValueError("cannot concatenate DesignSpaces with "
                             "different replica-timing declarations")
        return replace(self, entries=self.entries + other.entries)

    def with_replica(self, enabled: bool = True) -> "DesignSpace":
        """Close the SA-enable timing with a replica bitline.

        Every design point gains a dummy replica column (same lowered
        parasitics, storage scaled by the tech's `replica_cells` field)
        whose own 90% crossing fires the main array's SA enable, so
        t_sense self-adjusts per corner and per MC sample instead of
        being the fixed own-crossing time.  The space's length and row
        order are unchanged — the replica rows live only inside the
        fused-engine operand batch — so `with_mc` and corner axes compose
        unchanged.
        """
        return replace(self, replica=bool(enabled))

    def with_corners(self, **axes) -> "DesignSpace":
        """Attach corner axes (e.g. disturb-duty distributions for the
        Monte-Carlo ROADMAP item).  Each axis multiplies the batch: corners
        are just more rows of the same flat sweep.

        Axis semantics are defined by the consuming model — `dse.sweep`
        currently understands `rh_toggles` and `trc_cycles` (disturb duty).
        """
        new = list(self.corner_axes)
        declared = {n for n, _ in new}
        for name, values in axes.items():
            if name.startswith("mc_"):
                raise ValueError(f"corner axis {name!r}: the 'mc_' prefix "
                                 "is reserved for with_mc sampling channels")
            if name in declared:
                raise ValueError(f"corner axis {name!r} already declared")
            vals = tuple(float(v) for v in np.asarray(values).reshape(-1))
            if not vals:
                raise ValueError(f"corner axis {name!r} has no values")
            new.append((name, vals))
            declared.add(name)
        return replace(self, corner_axes=tuple(new))

    def with_mc(self, samples: int, key=0,
                sa_offset_sigma_mv: float | None = None,
                vth_sigma_mv: float | None = None,
                corr: float = 0.0,
                tail_shift=0.0,
                tail_scale=1.0) -> "DesignSpace":
        """Declare Monte-Carlo variation sampling: every design point fans
        out to `samples` rows of the SAME flat batch (sample-major), each
        with a drawn BLSA offset and access-transistor Vth perturbation.

        Draws are deterministic in the int seed `key`: the same seed
        lowers to bit-identical sample rows (those of the reference), so
        downstream
        yield columns are reproducible.  Sigmas default to each tech's
        calibrated `sa_offset_sigma_mv` / `vth_sigma_mv` fields; explicit
        overrides apply to every tech (`sigma=0` with `samples=1`
        reproduces the nominal sweep exactly).

        `corr` in [0, 1] turns on correlated *within-die* variation: each
        standardized draw is composed as `global_die + mat_gradient +
        local` with the per-tech variance fractions (`mc_die_sigma_frac`,
        `mc_mat_sigma_frac`, scaled by `corr`) and a low-rank correlated
        gradient along the shared-mat axis (`mc_corr_length`).  `corr=0`
        (the default) reproduces the i.i.d. draws bit-for-bit.

        `tail_shift` / `tail_scale` declare an importance-sampling
        proposal for deep-tail (ppm) yield estimation: the local
        standardized draws come from N(tail_shift, tail_scale^2) — shifted
        toward the failure tail — and the exact per-row log-weights ride
        the batch as the reserved `mc_log_w` channel, which every
        DesignBatch reduction (`yield_fraction`/`quantile`/`mc_summary`/
        `yield_ppm`) consumes automatically.  Each accepts a scalar
        (applied to both channels) or a per-channel (SA offset, Vth)
        pair; shift only the channel(s) the target spec constrains — e.g.
        `tail_shift=(4.5, 0.0)` for a margin-only ppm floor — because an
        unconstrained shifted channel only adds weight variance.
        """
        samples = int(samples)
        if samples < 1:
            raise ValueError(f"with_mc needs samples >= 1, got {samples}")
        if self.mc is not None:
            raise ValueError("Monte-Carlo sampling already declared on "
                             "this space")
        corr = float(corr)
        if not 0.0 <= corr <= 1.0:
            raise ValueError(f"with_mc needs 0 <= corr <= 1, got {corr}")

        def per_channel(name, value):
            pair = (tuple(float(v) for v in value)
                    if np.ndim(value) else (float(value),) * 2)
            if len(pair) != 2:
                raise ValueError(f"with_mc {name} must be a scalar or a "
                                 f"(sa, vth) pair, got {value!r}")
            return pair

        shift = per_channel("tail_shift", tail_shift)
        scale = per_channel("tail_scale", tail_scale)
        if any(s <= 0.0 for s in scale):
            raise ValueError(f"with_mc needs tail_scale > 0, got {scale}")
        return replace(self, mc=MCConfig(
            samples=samples, entropy=_key_entropy(key),
            sa_offset_sigma_mv=sa_offset_sigma_mv,
            vth_sigma_mv=vth_sigma_mv, corr=corr,
            tail_shift=shift, tail_scale=scale))

    # ---------------------------------------------------------- lowering --
    def __len__(self) -> int:
        base = sum(len(grid) for _, _, grid in self.entries)
        reps = 1
        for _, vals in self.corner_axes:
            reps *= len(vals)
        if self.mc is not None:
            reps *= self.mc.samples
        return base * reps

    def lower(self, device="cuda") -> LoweredSpace:
        """Lower to the canonical flat structure-of-arrays form.

        Row order is entry-major (techs in declaration order, schemes and
        layers nested), with the corner-combo product outermost — so the
        first base-block of a cornered space is its first corner combo.
        Monte-Carlo sampling is outermost of all: sample s of base row i
        lands at flat row `s * base + i`, which is the layout the
        Monte-Carlo reductions assume.

        The arrays are numpy; `device` is where the lowered space hands
        its per-point tensors to the physics modules.
        """
        device = resolve_device(device)
        if not self.entries:
            raise ValueError(
                "design space is empty — note that product() filters "
                "explicit schemes by each tech's allowed_schemes, which can "
                "eliminate every (tech, scheme) pair")
        tech_names, scheme_names = [], []
        ti, si, ly = [], [], []
        for tname, sname, grid in self.entries:
            cal.get_tech(tname)
            routing.scheme_spec(sname)
            if tname not in tech_names:
                tech_names.append(tname)
            if sname not in scheme_names:
                scheme_names.append(sname)
            for layer in grid:
                ti.append(tech_names.index(tname))
                si.append(scheme_names.index(sname))
                ly.append(layer)
        tech_idx = np.asarray(ti, np.int32)
        scheme_idx = np.asarray(si, np.int32)
        layers = np.asarray(ly, np.float32)
        b = layers.shape[0]

        corners: dict = {}
        if self.corner_axes:
            names = [n for n, _ in self.corner_axes]
            combos = list(itertools.product(
                *[vals for _, vals in self.corner_axes]))
            reps = len(combos)
            tech_idx = np.tile(tech_idx, reps)
            scheme_idx = np.tile(scheme_idx, reps)
            layers = np.tile(layers, reps)
            for a, name in enumerate(names):
                corners[name] = np.repeat(
                    np.asarray([combo[a] for combo in combos], np.float32), b)

        samples = 1
        if self.mc is not None:
            mc = self.mc
            samples = mc.samples
            b0 = layers.shape[0]
            rng = np.random.default_rng(mc.entropy)

            def gather(fieldname):
                vals = [getattr(cal.get_tech(n), fieldname)
                        for n in tech_names]
                return np.asarray(vals, np.float64)[tech_idx]

            # The local i.i.d. component comes FIRST and in one draw:
            # with corr=0 and no tail proposal it is the entire draw and
            # consumes the rng stream exactly like the original
            # uncorrelated lowering — bit-for-bit the same samples.
            z = rng.standard_normal((2, samples, b0))
            log_w = None
            if mc.is_active:
                # Shifted/scaled proposal on the local standardized draws;
                # the reserved mc_log_w channel carries the exact per-row
                # density ratio  log N(z|0,1) - log N(z|shift, scale^2),
                # summed over the SA-offset and Vth channels (per-channel
                # shift/scale, so an unshifted channel contributes no
                # weight variance).  Only the local component is
                # reweighted; the correlated die/gradient components below
                # stay target-distributed, so per-design estimators over
                # the sample axis remain exact.
                shift = np.asarray(mc.tail_shift,
                                   np.float64).reshape(2, 1, 1)
                scale = np.asarray(mc.tail_scale,
                                   np.float64).reshape(2, 1, 1)
                z = shift + scale * z
                log_w = (-0.5 * z ** 2
                         + 0.5 * ((z - shift) / scale) ** 2
                         + np.log(scale)).sum(axis=0)
            if mc.corr > 0.0:
                # Correlated within-die decomposition: a die-level offset
                # shared by every base row of a sample, plus a low-rank
                # mat/strap gradient along the base-row axis (the lowering
                # order is the mat order along the die span).
                f_die = mc.corr * gather("mc_die_sigma_frac")
                f_mat = mc.corr * gather("mc_mat_sigma_frac")
                over = f_die + f_mat > 1.0 + 1e-9
                if over.any():
                    bad = sorted({tech_names[t] for t in tech_idx[over]})
                    raise ValueError(
                        f"correlated-MC variance fractions of {bad} exceed "
                        "1 (mc_die_sigma_frac + mc_mat_sigma_frac scaled "
                        f"by corr={mc.corr} must stay <= 1)")
                z_die = rng.standard_normal((2, samples, 1))
                w_fac = rng.standard_normal(
                    (2, samples, MC_GRADIENT_FACTORS))
                pos = np.arange(b0, dtype=np.float64) / max(b0 - 1, 1)
                basis = _gradient_basis(pos, gather("mc_corr_length"))
                grad = np.einsum("csk,bk->csb", w_fac, basis)
                # clamp the local remainder: the guard above grants a
                # 1e-9 tolerance, so a sum at 1.0+eps must not sqrt a
                # negative number into NaN draws
                f_loc = np.maximum(1.0 - f_die - f_mat, 0.0)
                z = (np.sqrt(f_loc)[None, None] * z
                     + np.sqrt(f_die)[None, None] * z_die
                     + np.sqrt(f_mat)[None, None] * grad)

            mu_sa = gather("sa_offset_mv")
            sig_sa = (gather("sa_offset_sigma_mv")
                      if mc.sa_offset_sigma_mv is None
                      else np.full(b0, float(mc.sa_offset_sigma_mv)))
            sig_vth = (gather("vth_sigma_mv")
                       if mc.vth_sigma_mv is None
                       else np.full(b0, float(mc.vth_sigma_mv)))
            # offset magnitudes: a sample below 0 has no physical meaning
            mc_sa = np.maximum(mu_sa[None] + sig_sa[None] * z[0], 0.0)
            mc_dvth = sig_vth[None] * z[1]

            tech_idx = np.tile(tech_idx, samples)
            scheme_idx = np.tile(scheme_idx, samples)
            layers = np.tile(layers, samples)
            corners = {k: np.tile(v, samples) for k, v in corners.items()}
            corners["mc_sa_offset_mv"] = mc_sa.reshape(-1).astype(np.float32)
            corners["mc_delta_vth_mv"] = mc_dvth.reshape(-1).astype(np.float32)
            if log_w is not None:
                corners[MC_LOG_W] = log_w.reshape(-1).astype(np.float32)

        return LoweredSpace(
            tech_names=tuple(tech_names), scheme_names=tuple(scheme_names),
            tech_idx=tech_idx, scheme_idx=scheme_idx, layers_np=layers,
            valid=np.ones(layers.shape[0], bool), corners=corners,
            samples=samples, replica=self.replica, device=device)
