"""Frozen copy of `src/repro_torch/core/sense.py` for the benchmark's plain reference,
trimmed to the lowered path it takes (imports rewritten; nothing of the
program is imported).

Sense-margin model (full SWD + BLSA compact model, Fig. 3).

Port of `repro.core.sense`:

  dV_nominal = (VDD/2) * Cs/(Cs + C_BL)            charge sharing
             - (1 - writeback_eff) * (VDD/2)       incomplete restore level
             - V_offset_SA                         input-referred SA offset

  dV_disturbed = dV_nominal - disturb_loss(FBE+RH) (Fig. 9b)

All terms in mV.  The scalar functions take one (tech, scheme) batched
over `layers` and return float32 tensors on `device`; the `*_lowered`
function works over a lowered design space.
"""

from __future__ import annotations

import torch

from .device import as_f32, rdiv
from . import calibration as cal
from .disturb import disturb_loss_lowered
from .netlist import effective_cbl_lowered


def sense_margin_lowered(view, with_disturb: bool = False,
                         cbl_ff: torch.Tensor | None = None) -> torch.Tensor:
    """Array-native sense margin over a lowered design space.

    Pass `cbl_ff` to reuse an already-assembled parasitic decomposition.
    Monte-Carlo spaces carry per-sample SA offsets; nominal spaces use
    the calibrated per-tech corner value.
    """
    dev = view.device
    if cbl_ff is None:
        cbl_ff = effective_cbl_lowered(view)
    dv = rdiv(1e3 * (cal.VDD_ARRAY / 2.0) * cal.CS_FF, cal.CS_FF + cbl_ff)
    dv = dv - as_f32((1.0 - view.tech("writeback_eff"))
                     * (cal.VDD_ARRAY / 2.0) * 1e3, dev)
    sa_offset = view.corner("mc_sa_offset_mv", None)
    if sa_offset is None:
        sa_offset = view.tech("sa_offset_mv")
    dv = dv - as_f32(sa_offset, dev)
    if with_disturb:
        dv = dv - disturb_loss_lowered(view)
    return dv
