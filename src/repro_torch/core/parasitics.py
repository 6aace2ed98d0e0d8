"""Array parasitic assembly (the paper's TCAD extraction layer).

Port of `repro.core.parasitics`: the effective bitline capacitance /
resistance decomposition per (technology, routing scheme, layer count).
With the BL selector only the selected strap's local BL hangs on the
global line; without it, every strap on the global line contributes its
local capacitance.

Calibration gathers arrive as numpy float64 (a `LoweredSpace`), Python
scalars (one tech) or float32 tensors (a `SpaceView`); they are combined
exactly where the reference combines them and turned into float32
tensors where the reference enters jnp (see `repro_torch.device`).
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch

from ..device import as_bool, as_f32, resolve_device
from ..runtime import trace
from . import routing
from .calibration import TechCal


@dataclass(frozen=True)
class BLParasitics:
    """Effective single-ended BL network as seen by the BLSA."""
    c_local_ff: torch.Tensor      # selected local (vertical) BL
    c_unselected_ff: torch.Tensor # unselected local BLs on the global line
    c_global_ff: torch.Tensor     # global strap metal + HCB pad
    c_sa_ff: torch.Tensor         # BLSA input
    r_path_kohm: torch.Tensor     # series resistance BLSA -> cell
    r_on_kohm: torch.Tensor       # access transistor effective on-resistance

    @property
    def c_bl_total_ff(self) -> torch.Tensor:
        """Effective C_BL (everything the sense node must charge except Cs)."""
        return (self.c_local_ff + self.c_unselected_ff + self.c_global_ff
                + self.c_sa_ff)


def local_bl_cap_ff(tech: TechCal, layers, device="cuda") -> torch.Tensor:
    """Vertical local BL: per-tier sidewall/fringe capacitance x tier count,
    plus the selector junction it terminates in."""
    layers = as_f32(layers, resolve_device(device))
    return (layers * as_f32(tech.c_bl_per_layer_ff, layers.device)
            + as_f32(tech.c_sel_junction_ff, layers.device))


def _assemble(layers: torch.Tensor, *, baseline_2d, fixed_c_bl_ff,
              c_bl_per_layer_ff, c_sel_junction_ff, c_global_strap_ff,
              c_hcb_pad_ff, c_blsa_in_ff, r_on_cell_kohm, r_sel_kohm,
              r_local_bl_kohm, r_global_kohm, sel_junction,
              straps_per_global, global_strap_metal, c_global_fixed_ff,
              r_sel_in_path, r_global_in_path) -> BLParasitics:
    """Coefficient-driven BL-network assembly (Fig. 2).

    Every coefficient may be a scalar (one tech/scheme, batched over
    layers) or a per-design-point array (the lowered DSE path).  A 2D
    baseline bypasses the stacked decomposition and uses its tabulated
    lateral C_BL.
    """
    dev = layers.device
    f = lambda x: as_f32(x, dev)
    base = as_bool(baseline_2d, dev)
    layers = f(layers)
    zero = torch.zeros_like(layers)
    c_vert = layers * f(c_bl_per_layer_ff)

    c_local_3d = c_vert + torch.where(as_bool(sel_junction, dev),
                                      f(c_sel_junction_ff), 0.0)
    c_unsel_3d = f(straps_per_global - 1) * c_vert
    c_glob_3d = (torch.where(as_bool(global_strap_metal, dev),
                             f(c_global_strap_ff), 0.0)
                 + f(c_global_fixed_ff) + f(c_hcb_pad_ff))
    r_path_3d = (f(r_local_bl_kohm)
                 + torch.where(as_bool(r_sel_in_path, dev), f(r_sel_kohm), 0.0)
                 + torch.where(as_bool(r_global_in_path, dev),
                               f(r_global_kohm), 0.0))

    return BLParasitics(
        c_local_ff=torch.where(base, f(fixed_c_bl_ff - c_blsa_in_ff),
                               c_local_3d) + zero,
        c_unselected_ff=torch.where(base, 0.0, c_unsel_3d) + zero,
        c_global_ff=torch.where(base, 0.0, c_glob_3d) + zero,
        c_sa_ff=zero + f(c_blsa_in_ff),
        r_path_kohm=torch.where(base, f(r_local_bl_kohm), r_path_3d) + zero,
        r_on_kohm=zero + f(r_on_cell_kohm),
    )


def bl_parasitics(tech: TechCal, scheme: str,
                  layers: torch.Tensor) -> BLParasitics:
    """Assemble the BL network for one (tech, scheme), batched over the
    float32 `layers` tensor (its device is the result's)."""
    spec = routing.scheme_spec(scheme)
    return _assemble(
        layers,
        baseline_2d=tech.baseline_2d, fixed_c_bl_ff=tech.fixed_c_bl_ff,
        c_bl_per_layer_ff=tech.c_bl_per_layer_ff,
        c_sel_junction_ff=tech.c_sel_junction_ff,
        c_global_strap_ff=tech.c_global_strap_ff,
        c_hcb_pad_ff=tech.c_hcb_pad_ff, c_blsa_in_ff=tech.c_blsa_in_ff,
        r_on_cell_kohm=tech.r_on_cell_kohm, r_sel_kohm=tech.r_sel_kohm,
        r_local_bl_kohm=tech.r_local_bl_kohm,
        r_global_kohm=tech.r_global_kohm,
        sel_junction=spec.sel_junction,
        straps_per_global=spec.straps_per_global,
        global_strap_metal=spec.global_strap_metal,
        c_global_fixed_ff=spec.c_global_fixed_ff,
        r_sel_in_path=spec.r_sel_in_path,
        r_global_in_path=spec.r_global_in_path,
    )


def bl_parasitics_lowered(view) -> BLParasitics:
    """Array-native BL networks over a lowered design space.

    Monte-Carlo spaces carry per-sample Vth perturbations
    (`mc_delta_vth_mv`); they fold into the access-transistor effective
    on-resistance: r_on scales inversely with the gate overdrive, so a
    +dVth sample conducts less and slows the row cycle.
    """
    with trace.span("parasitics"):
        par = _assemble(
            view.layers,
            baseline_2d=view.tech("baseline_2d"),
            fixed_c_bl_ff=view.tech("fixed_c_bl_ff"),
            c_bl_per_layer_ff=view.tech("c_bl_per_layer_ff"),
            c_sel_junction_ff=view.tech("c_sel_junction_ff"),
            c_global_strap_ff=view.tech("c_global_strap_ff"),
            c_hcb_pad_ff=view.tech("c_hcb_pad_ff"),
            c_blsa_in_ff=view.tech("c_blsa_in_ff"),
            r_on_cell_kohm=view.tech("r_on_cell_kohm"),
            r_sel_kohm=view.tech("r_sel_kohm"),
            r_local_bl_kohm=view.tech("r_local_bl_kohm"),
            r_global_kohm=view.tech("r_global_kohm"),
            sel_junction=view.scheme("sel_junction"),
            straps_per_global=view.scheme("straps_per_global"),
            global_strap_metal=view.scheme("global_strap_metal"),
            c_global_fixed_ff=view.scheme("c_global_fixed_ff"),
            r_sel_in_path=view.scheme("r_sel_in_path"),
            r_global_in_path=view.scheme("r_global_in_path"),
        )
        dvth_mv = view.corner("mc_delta_vth_mv", None)
        if dvth_mv is not None:
            # triode-region conductance ~ overdrive:
            # r_on' = r_on * Vov/(Vov-dVth), with dVth clamped inside the
            # overdrive so r_on stays finite/positive
            vov = as_f32(view.tech("vth_overdrive_v"), view.device)
            dvth_v = torch.clamp(as_f32(dvth_mv, view.device) * 1e-3,
                                 -0.5 * vov, 0.5 * vov)
            par = replace(par, r_on_kohm=par.r_on_kohm * vov / (vov - dvth_v))
        return par


def wl_parasitics(tech: TechCal):
    """WL loading seen by the sub-wordline driver (R in kOhm, C in fF)."""
    return tech.r_wl_kohm, tech.c_wl_ff
