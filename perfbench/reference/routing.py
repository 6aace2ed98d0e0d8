"""Frozen copy of `src/repro_torch/core/routing.py` for the benchmark's plain reference,
trimmed to the lowered path it takes (imports rewritten; nothing of the
program is imported).

BL routing schemes and CBA bonding geometry (Figs. 2-5).

Port of `repro.core.routing`.  The reference module imports
`jax.numpy`, so the port keeps its own `SchemeSpec` registry;
`tests/test_torch_registry.py` holds the two registries equal field by
field.

  pitch(direct)     = sqrt(cell_x * hcb_route_span)   # one bond per BL column
  pitch(strap-like) = pitch(direct) * sqrt(BLS_PER_STRAP)
  BLSA area         = 2 * pitch^2                      # open-BL, two bond rows
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from .device import as_bool, as_f32
from . import calibration as cal


@dataclass(frozen=True)
class SchemeSpec:
    """Structural description of a BL routing scheme.

    Every coefficient is consumed arithmetically by the parasitic and
    bonding models — adding a scheme never requires a new branch in the
    physics code.
    """

    name: str
    label: str
    # --- electrical structure (parasitic assembly, Fig. 2) ---
    sel_junction: bool          # selector/mux junction terminates the local BL
    straps_per_global: int      # local BLs electrically tied to one global line
    global_strap_metal: bool    # full-length global strap metal run
    c_global_fixed_ff: float    # extra fixed metal (e.g. core-mux short run)
    r_sel_in_path: bool         # selector/mux on-resistance in series
    r_global_in_path: bool      # global strap + bond resistance in series
    # --- disturb / bonding structure ---
    isolates_unselected: bool   # inactive BLs float at a refresh potential
    bond_shared: bool           # one HCB bond per strap group (not per BL)


# Live scheme registry (insertion-ordered, so sweep order is stable).
SCHEMES: dict = {}


def register_scheme(spec: SchemeSpec, overwrite: bool = False) -> SchemeSpec:
    """Register a BL routing scheme so sweeps and models can use it."""
    if not spec.name:
        raise ValueError("scheme must have a non-empty name")
    if spec.straps_per_global < 1:
        raise ValueError("straps_per_global must be >= 1")
    if spec.name in SCHEMES and not overwrite:
        raise ValueError(f"scheme {spec.name!r} is already registered "
                         "(pass overwrite=True to replace it)")
    SCHEMES[spec.name] = spec
    return spec


def scheme_spec(name: str) -> SchemeSpec:
    try:
        return SCHEMES[name]
    except KeyError:
        raise ValueError(f"unknown routing scheme: {name}") from None


register_scheme(SchemeSpec(
    name="direct", label="(a) Direct BLSA connection",
    sel_junction=False, straps_per_global=1, global_strap_metal=False,
    c_global_fixed_ff=0.0, r_sel_in_path=False, r_global_in_path=False,
    isolates_unselected=False, bond_shared=False))
register_scheme(SchemeSpec(
    name="strap", label="(b) BL strapping",
    sel_junction=False, straps_per_global=cal.STRAPS_PER_GLOBAL,
    global_strap_metal=True, c_global_fixed_ff=0.0,
    r_sel_in_path=False, r_global_in_path=True,
    isolates_unselected=False, bond_shared=True))
register_scheme(SchemeSpec(
    name="core_mux", label="(c) Core MUX",
    sel_junction=True, straps_per_global=1, global_strap_metal=False,
    c_global_fixed_ff=0.4, r_sel_in_path=True, r_global_in_path=False,
    isolates_unselected=False, bond_shared=False))
register_scheme(SchemeSpec(
    name="sel_strap", label="(d) BL Selector + Strap (this work)",
    sel_junction=True, straps_per_global=1, global_strap_metal=True,
    c_global_fixed_ff=0.0, r_sel_in_path=True, r_global_in_path=True,
    isolates_unselected=True, bond_shared=True))


@dataclass(frozen=True)
class BondingGeometry:
    hcb_pitch_um: torch.Tensor
    blsa_area_um2: torch.Tensor
    manufacturable: torch.Tensor     # pitch within the W2W HCB window
    bonds_per_mm2_m: torch.Tensor    # bond density (millions / mm^2)


def _assemble_geometry(cell_x_nm, hcb_route_span_um, bond_shared,
                       baseline_2d, device) -> BondingGeometry:
    """Coefficient-driven bonding geometry over per-point arrays.

    One bond per BL column gives pitch = sqrt(cell_x * route_span);
    strap-type schemes share that bond across the strap's BL group.  The
    2D baseline has no bonding at all (pitch 0).
    """
    direct = torch.sqrt(as_f32(cell_x_nm, device) * 1e-3
                        * as_f32(hcb_route_span_um, device))
    share = torch.where(as_bool(bond_shared, device),
                        math.sqrt(float(cal.BLS_PER_STRAP)), 1.0)
    pitch = torch.where(as_bool(baseline_2d, device), 0.0, direct * share)
    blsa_area = 2.0 * pitch * pitch
    ok = pitch >= cal.HCB_MIN_MANUFACTURABLE_PITCH_UM
    dens = torch.where(pitch > 0,
                       1.0 / torch.clamp_min(pitch * pitch, 1e-9) * 1e-6,
                       0.0)
    return BondingGeometry(pitch, blsa_area, ok, dens)


def bonding_geometry_lowered(view) -> BondingGeometry:
    """Array-native bonding geometry over a lowered design space.

    `manufacturable` folds in the 2D-baseline exemption (no bonding ->
    nothing to manufacture), which is the feasibility semantics the DSE
    uses.
    """
    baseline = as_bool(view.tech("baseline_2d"), view.device)
    geom = _assemble_geometry(view.tech("cell_x_nm"),
                              view.tech("hcb_route_span_um"),
                              view.scheme("bond_shared"), baseline,
                              view.device)
    return BondingGeometry(geom.hcb_pitch_um, geom.blsa_area_um2,
                           baseline | geom.manufacturable,
                           geom.bonds_per_mm2_m)
