"""Compact access-transistor / selector models (TCAD-calibrated surrogates).

Port of `repro.core.device_models`.  The paper extracts device
characteristics from TCAD: Si and AOS (IWO, W-doped In2O3 double-gate
[9]) cell access transistors, and the IGO BEOL selector [11] (Ion > 50 uA
@ 2 V, W/L = 70/50 nm, ~60 mV/dec SS).

Each device is a smooth EKV-style compact model that reproduces the
quoted anchor points (Ion at the quoted bias, subthreshold slope, Ioff).
The curves feed effective on-resistance extraction and retention
analysis (off-state leakage of the storage node).  Bias arguments may be
scalars or tensors; results are float32 tensors on `device`.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..device import as_f32, rdiv, resolve_device, scalar_f32
from .units import MA_TO_UA

KT_Q_MV = 26.0  # thermal voltage at 300 K, mV


@dataclass(frozen=True)
class DeviceParams:
    name: str
    vth: float            # threshold voltage (V)
    ss_mv_dec: float      # subthreshold slope (mV/dec)
    i_spec_ua: float      # specific current scaling (uA), sets Ion
    v_early: float        # output-conductance Early voltage (V)
    ioff_a: float         # off-state leakage at Vgs=0, Vds=VDD/2 (A)
    w_nm: float
    l_nm: float


# --- calibration anchors -------------------------------------------------
# IGO selector [11]: Ion > 50 uA @ Vgs=2 V (W/L = 70/50), SS ~ 60 mV/dec.
IGO_SELECTOR = DeviceParams(
    name="igo_selector", vth=0.55, ss_mv_dec=60.0, i_spec_ua=2.10,
    v_early=12.0, ioff_a=1e-15, w_nm=70.0, l_nm=50.0,
)
# Si access transistor (GAA, line-type iso, channel width 70 nm): decent
# drive, but a floating body and ~85 mV/dec (junction-limited).
SI_ACCESS = DeviceParams(
    name="si_access", vth=0.75, ss_mv_dec=85.0, i_spec_ua=1.30,
    v_early=10.0, ioff_a=3e-16, w_nm=70.0, l_nm=60.0,
)
# AOS (IWO [9]) access transistor: ultra-low leakage oxide channel, lower
# mobility -> lower drive, near-ideal SS, no floating body.
AOS_ACCESS = DeviceParams(
    name="aos_access", vth=0.60, ss_mv_dec=65.0, i_spec_ua=0.80,
    v_early=15.0, ioff_a=1e-19, w_nm=70.0, l_nm=60.0,
)

DEVICES = {d.name: d for d in (IGO_SELECTOR, SI_ACCESS, AOS_ACCESS)}


def ids_ua(dev: DeviceParams, vgs, vds, device="cuda") -> torch.Tensor:
    """Drain current (uA), smooth EKV-like interpolation.

    I = I0 * ln^2(1 + exp((Vgs-Vth)/(2nUt))) * sat(Vds) * (1 + Vds/VA)
    which gives exp subthreshold with slope SS and ~square-law/velocity-sat
    above threshold; anchored so Ion matches the quoted TCAD point.
    """
    device = resolve_device(device)
    vgs = as_f32(vgs, device)
    vds = as_f32(vds, device)
    # the reference's float32 log(10) and its one-rounding quotients
    n = rdiv(dev.ss_mv_dec, KT_Q_MV * torch.log(scalar_f32(10.0, device)))
    ut = KT_Q_MV * 1e-3
    x = (vgs - dev.vth) / (2.0 * n * ut)
    # softplus without overflow
    sp = torch.where(x > 30.0, x,
                     torch.log1p(torch.exp(torch.clamp_max(x, 30.0))))
    drive = sp * sp
    vdsat = torch.clamp_min(2.0 * n * ut * sp, 1e-6)
    sat = torch.tanh(vds / vdsat)
    i = (dev.i_spec_ua * (dev.w_nm / dev.l_nm) * drive * sat
         * (1.0 + vds / scalar_f32(dev.v_early, device)))
    return i + dev.ioff_a * 1e6  # leakage floor in uA


def r_on_eff_kohm(dev: DeviceParams, vgs: float, vswing: float,
                  device="cuda") -> torch.Tensor:
    """Effective large-signal on-resistance for (dis)charging through the
    device across a `vswing` excursion: R_eff = vswing / I(vgs, vswing/2)."""
    i_ua = ids_ua(dev, vgs, vswing / 2.0, device)
    return rdiv(vswing, i_ua) * MA_TO_UA  # V/uA -> kOhm


def subthreshold_swing_mv_dec(dev: DeviceParams, vds: float = 0.05,
                              device="cuda") -> torch.Tensor:
    """Numerically extracted SS around Vgs = Vth - 0.15 V (sanity check vs
    the calibration target)."""
    v0, v1 = dev.vth - 0.20, dev.vth - 0.10
    i0 = ids_ua(dev, v0, vds, device)
    i1 = ids_ua(dev, v1, vds, device)
    return rdiv((v1 - v0) * 1e3, torch.log10(i1) - torch.log10(i0))


def retention_time_ms(dev: DeviceParams, cs_ff: float,
                      dv_allow_v: float = 0.2) -> float:
    """Storage-node retention limited by off-state leakage:
    t_ret = Cs * dV_allow / Ioff.  Returns milliseconds (a Python float,
    as in the reference)."""
    return cs_ff * 1e-15 * dv_allow_v / dev.ioff_a * 1e3
