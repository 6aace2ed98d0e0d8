"""Frozen copy of `src/repro_torch/core/disturb.py` for the benchmark's plain reference,
trimmed to the lowered path it takes (imports rewritten; nothing of the
program is imported).

Disturb mechanisms: floating-body effect (FBE) and row hammer (RH).

Port of `repro.core.disturb`: the charge loss is an
equivalent cell-voltage loss that scales with the stack (coupling paths
grow with layer count) and with the assumed disturb duty.  AOS channels
have no floating body, so their FBE term is zero; schemes that do not
isolate unselected BLs see an extra BL-disturb term.
"""

from __future__ import annotations

import torch

from .device import as_bool, as_f32
from . import calibration as cal


def disturb_loss_lowered(view) -> torch.Tensor:
    """Array-native FBE+RH loss (mV) over a lowered design space.

    Disturb-duty corner axes (`with_corners(rh_toggles=...,
    trc_cycles=...)`) flow in per design point.
    """
    dev = view.device
    layer_scale = view.layers / torch.clamp_min(
        as_f32(view.tech("layers_target"), dev), 1.0)
    duty_rh = (view.corner("rh_toggles", cal.RH_TOGGLES_PER_64MS)
               / cal.RH_TOGGLES_PER_64MS)
    duty_fbe = (view.corner("trc_cycles", cal.TRC_CYCLES_PER_64MS)
                / cal.TRC_CYCLES_PER_64MS)

    fbe = as_f32(view.tech("fbe_loss_mv"), dev) * layer_scale * duty_fbe
    rh = as_f32(view.tech("rh_loss_mv"), dev) * layer_scale * duty_rh
    isolated = as_bool(view.scheme("isolates_unselected")
                       | view.tech("baseline_2d"), dev)
    bl_disturb = torch.where(isolated, 0.0, 15.0 * layer_scale * duty_fbe)
    return fbe + rh + bl_disturb
