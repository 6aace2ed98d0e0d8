"""Frozen copy of `src/repro_torch/core/energy.py` for the benchmark's plain reference,
trimmed to the lowered path it takes (imports rewritten; nothing of the
program is imported).

Read/write energy model over a lowered design space (Fig. 9c).

Port of `repro.core.energy`:

  E_write = 1/2 (Cs + C_BL) VDD^2 * eta        full-swing write of cell+BL
  E_read  = 1/2 C_BL (VDD/2)^2 * eta + E_SA    half-swing develop + latch

The 2D baseline additionally swings its lateral IO routing (c_route_extra).
The scalar functions take one (tech, scheme) batched over `layers`; the
`*_lowered` functions work over a lowered design space.
"""

from __future__ import annotations

import torch

from .device import as_f32
from . import calibration as cal
from .netlist import effective_cbl_lowered


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
