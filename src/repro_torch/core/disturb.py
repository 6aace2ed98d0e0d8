"""Disturb mechanisms: floating-body effect (FBE) and row hammer (RH).

Port of `repro.core.disturb`: the charge loss is an
equivalent cell-voltage loss that scales with the stack (coupling paths
grow with layer count) and with the assumed disturb duty.  AOS channels
have no floating body, so their FBE term is zero; schemes that do not
isolate unselected BLs see an extra BL-disturb term.
"""

from __future__ import annotations

import torch

from ..device import as_bool, as_f32, resolve_device, scalar_f32
from . import calibration as cal
from . import routing
from .calibration import TechCal


def disturb_loss_mv(tech: TechCal, scheme: str, layers,
                    rh_toggles: float = cal.RH_TOGGLES_PER_64MS,
                    trc_cycles: float = cal.TRC_CYCLES_PER_64MS,
                    device="cuda") -> torch.Tensor:
    """Equivalent sense-voltage loss (mV) from FBE + RH at refresh time.

    Calibrated so that at the target layer count and nominal duty the Si
    sel_strap design loses 60 mV (130 -> 70 mV, Fig. 9b) and AOS loses
    25 mV (RH only).  An unregistered scheme counts as isolating, as in
    the reference.
    """
    layers = as_f32(layers, resolve_device(device))
    dev = layers.device
    # a 0-d divisor: a Python-scalar divisor is a reciprocal multiply on CUDA
    layer_scale = layers / scalar_f32(max(tech.layers_target, 1), dev)
    duty_rh = rh_toggles / cal.RH_TOGGLES_PER_64MS
    duty_fbe = trc_cycles / cal.TRC_CYCLES_PER_64MS

    fbe = tech.fbe_loss_mv * layer_scale * duty_fbe
    rh = tech.rh_loss_mv * layer_scale * duty_rh
    spec = routing.SCHEMES.get(scheme)
    isolated = (spec is None or spec.isolates_unselected
                or tech.baseline_2d)
    bl_disturb = (torch.zeros_like(layer_scale) if isolated
                  else 15.0 * layer_scale * duty_fbe)
    return fbe + rh + bl_disturb


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


def off_state_leakage_note(tech: TechCal) -> str:
    if tech.fbe_loss_mv == 0.0:
        return ("oxide channel: no floating body; retention limited only by "
                "~1e-19 A off-state leakage")
    return "Si floating body: FBE charge pumping under repeated cycling"
