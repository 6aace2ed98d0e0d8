"""Read/write energy model over a lowered design space (Fig. 9c).

Port of `repro.core.energy`:

  E_write = 1/2 (Cs + C_BL) VDD^2 * eta        full-swing write of cell+BL
  E_read  = 1/2 C_BL (VDD/2)^2 * eta + E_SA    half-swing develop + latch

The 2D baseline additionally swings its lateral IO routing (c_route_extra).
The scalar functions take one (tech, scheme) batched over `layers`; the
`*_lowered` functions work over a lowered design space.
"""

from __future__ import annotations

import torch

from ..device import as_f32
from . import calibration as cal
from .calibration import TechCal
from .netlist import effective_cbl_ff, effective_cbl_lowered


def write_energy_fj(tech: TechCal, scheme: str, layers,
                    device="cuda") -> torch.Tensor:
    cbl = effective_cbl_ff(tech, scheme, layers, device)
    cbl = cbl + as_f32(tech.c_route_extra_ff, cbl.device)
    v = cal.VDD_ARRAY
    return 0.5 * (cal.CS_FF + cbl) * v * v * cal.ENERGY_EFF


def read_energy_fj(tech: TechCal, scheme: str, layers,
                   device="cuda") -> torch.Tensor:
    cbl = effective_cbl_ff(tech, scheme, layers, device)
    cbl = cbl + as_f32(tech.c_route_extra_ff, cbl.device)
    v = cal.VDD_ARRAY / 2.0
    return (0.5 * cbl * v * v * cal.ENERGY_EFF
            + as_f32(tech.e_sa_fj, cbl.device))


def write_energy_lowered(view, cbl_ff: torch.Tensor | None = None) -> torch.Tensor:
    """Array-native write energy (fJ) over a lowered design space."""
    if cbl_ff is None:
        cbl_ff = effective_cbl_lowered(view)
    cbl = cbl_ff + as_f32(view.tech("c_route_extra_ff"), view.device)
    v = cal.VDD_ARRAY
    return 0.5 * (cal.CS_FF + cbl) * v * v * cal.ENERGY_EFF


def read_energy_lowered(view, cbl_ff: torch.Tensor | None = None) -> torch.Tensor:
    """Array-native read energy (fJ) over a lowered design space."""
    if cbl_ff is None:
        cbl_ff = effective_cbl_lowered(view)
    cbl = cbl_ff + as_f32(view.tech("c_route_extra_ff"), view.device)
    v = cal.VDD_ARRAY / 2.0
    return (0.5 * cbl * v * v * cal.ENERGY_EFF
            + as_f32(view.tech("e_sa_fj"), view.device))


def wl_energy_fj(tech: TechCal) -> float:
    """WL driver energy per activation (the 3D design's reduced VPP pays
    off); a Python float, as in the reference."""
    return 0.5 * tech.c_wl_ff * tech.vpp * tech.vpp
