"""The fused row-cycle engine, plain PyTorch: operand lowering, the
implicit-Euler ACT / RESTORE / PRE state machine and the roll-up.

Frozen copy of the fused path of `src/repro_torch/core/transient.py`
(`lower_operands`, `lower_design_operands`, `_regen_and_totals`) and of
`src/repro_torch/kernels/ref.py` (`row_cycle_fused_ref`, the plain version
the CUDA kernel is held to).  Rows are independent, so the reference runs
them in blocks of `BLOCK_ROWS` (an even count: a [replica, main] pair
never splits).  `dtype` is the precision of the engine's state machine:
float32 is the reference, bfloat16 the control that must fail.
"""

from __future__ import annotations

import torch

from . import calibration as cal
from .device import as_f32, rdiv, row_sum
from .netlist import build_ladder_lowered, replica_ladder_arrays
from .units import tau_ns

DT_NS = 0.02
T_ACT_NS = 16.0
T_RESTORE_NS = 20.0
T_PRE_NS = 10.0
N_ACT_STEPS = int(T_ACT_NS / DT_NS)
N_RESTORE_STEPS = int(T_RESTORE_NS / DT_NS)
N_PRE_STEPS = int(T_PRE_NS / DT_NS)

(PAR_TAU_WL, PAR_THR_REL, PAR_VDD, PAR_VPRE, PAR_ACTIVE, PAR_ROLE) = range(6)
N_EVENTS = 4
RESTORE_FRAC = 0.95
EQUALIZE_TOL_V = 5e-3
ROLE_REPLICA = 1.0
ROLE_MAIN = 2.0

BLOCK_ROWS = 1 << 17


def regen_and_totals(tech_sa_tau, tech_overhead, t_dev, dv_sense,
                     t_res_dur, t_pre):
    """BLSA latch regeneration + phase roll-up."""
    vdd = cal.VDD_ARRAY
    ratio = rdiv(vdd / 2.0, torch.clamp_min(dv_sense, 1e-4))
    t_regen = tech_sa_tau * torch.log(torch.clamp_min(ratio, 1.001))
    t_sense = t_dev + t_regen
    t_restore = t_sense + t_res_dur
    trc = tech_overhead + t_restore + t_pre
    return t_sense, t_restore, trc


def lower_operands(c, g, *, r_sa_drive_kohm, r_pre_kohm, store_v, tau_wl_ns,
                   active=None, role=None):
    """Ladder tensors + drive parameters -> (c, g, gc_res, gc_pre, v0,
    params)."""
    b, n = c.shape
    dev = c.device
    vdd, vpre = cal.VDD_ARRAY, cal.VBL_PRE
    c = c.to(torch.float32)
    g = g.to(torch.float32)

    def vec(x):
        return as_f32(x, dev).expand(b)

    gc_res = torch.zeros((b, n), dtype=torch.float32, device=dev)
    gc_res[:, 0] = vec(1.0 / as_f32(r_sa_drive_kohm, dev))
    gc_pre = torch.zeros((b, n), dtype=torch.float32, device=dev)
    gc_pre[:, : n - 1] = vec(1.0 / as_f32(r_pre_kohm, dev))[:, None]
    store_v = vec(store_v)
    v0 = torch.full((b, n), vpre, dtype=torch.float32, device=dev)
    v0[:, n - 1] = store_v

    cbl = row_sum(c[:, : n - 1])
    cs = c[:, n - 1]
    dv_inf = (store_v - vpre) * cs / (cs + cbl)
    full = lambda x: torch.full((b,), x, dtype=torch.float32, device=dev)
    params = torch.stack([
        vec(tau_wl_ns),
        0.9 * dv_inf,
        full(vdd),
        full(vpre),
        full(1.0) if active is None else vec(active),
        full(0.0) if role is None else vec(role),
    ], dim=1)
    return c, g, gc_res, gc_pre, v0, params


def _interleave(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.stack([a, b], dim=1).reshape((-1,) + tuple(a.shape[1:]))


def lower_design_operands(view, par):
    """A lowered space -> (six engine operands, sa_tau, overhead); with
    `view.replica` every design point lowers to [replica, main] rows."""
    ladder_c, ladder_g = build_ladder_lowered(view, par)
    dev = ladder_c.device
    replica = bool(view.replica)
    b = ladder_c.shape[0]
    active = as_f32(view.valid, dev)
    sa_tau = as_f32(view.tech("sa_tau_ns"), dev).expand(b)
    overhead = as_f32(view.tech("t_overhead_ns"), dev).expand(b)
    tau_wl = tau_ns(view.tech("r_wl_kohm"), view.tech("c_wl_ff"))
    core = lower_operands(
        ladder_c, ladder_g,
        r_sa_drive_kohm=view.tech("r_sa_drive_kohm"),
        r_pre_kohm=view.tech("r_pre_kohm"),
        store_v=view.tech("writeback_eff") * cal.VDD_ARRAY,
        tau_wl_ns=tau_wl, active=active,
        role=ROLE_MAIN if replica else None)
    if replica:
        rep_c, rep_g = replica_ladder_arrays(
            ladder_c, ladder_g, view.tech("replica_cells"))
        rep = lower_operands(
            rep_c, rep_g,
            r_sa_drive_kohm=view.tech("r_sa_drive_kohm"),
            r_pre_kohm=view.tech("r_pre_kohm"),
            store_v=view.tech("replica_store_frac") * cal.VDD_ARRAY,
            tau_wl_ns=tau_wl, active=active, role=ROLE_REPLICA)
        core = tuple(_interleave(r, m) for r, m in zip(rep, core))
        sa_tau = _interleave(sa_tau, sa_tau)
        overhead = _interleave(overhead, overhead)
    return core, sa_tau.contiguous(), overhead.contiguous()


def _thomas_small(dl, d, du, rhs):
    n = d.shape[-1]
    cp = [None] * n
    dp = [None] * n
    cp[0] = du[..., 0] / d[..., 0]
    dp[0] = rhs[..., 0] / d[..., 0]
    for i in range(1, n):
        denom = d[..., i] - dl[..., i] * cp[i - 1]
        cp[i] = du[..., i] / denom
        dp[i] = (rhs[..., i] - dl[..., i] * dp[i - 1]) / denom
    x = [None] * n
    x[n - 1] = dp[n - 1]
    for i in range(n - 2, -1, -1):
        x[i] = dp[i] - cp[i] * x[i + 1]
    return torch.stack(x, dim=-1)


def row_cycle_fused(c, g_branch, gc_res, gc_pre, v0, params,
                    dt: float, n_act: int, n_res: int, n_pre: int,
                    dtype=torch.float32):
    """One pass over ACT / RESTORE / PRE for every row -> (B, 4) events
    [t_dev, dv_sense, t_res_dur, t_pre] in `dtype` (see the program's
    `kernels/ref.py` for the state machine)."""
    b, n = c.shape
    dev = c.device
    f = dtype
    c, g_branch, gc_res, gc_pre, v0, params = (
        x.to(f) for x in (c, g_branch, gc_res, gc_pre, v0, params))
    dt_t = torch.tensor(dt, dtype=f, device=dev)
    cdt = c / dt_t * 1e-3
    tau = torch.clamp_min(params[:, PAR_TAU_WL], 1e-3)
    thr_rel = params[:, PAR_THR_REL]
    vdd = params[:, PAR_VDD]
    vpre = params[:, PAR_VPRE]
    active = params[:, PAR_ACTIVE] > 0.5
    role = params[:, PAR_ROLE]
    is_rep = torch.abs(role - ROLE_REPLICA) < 0.5
    is_main = role > ROLE_MAIN - 0.5
    t_total = n_act + n_res + n_pre
    caps = torch.tensor([n_act, n_res, n_pre], dtype=torch.int32, device=dev)
    zeros = torch.zeros((b, 1), dtype=f, device=dev)
    nan = torch.tensor(float("nan"), dtype=f, device=dev)

    phase = torch.where(active, 0, 3).to(torch.int32)
    phase_inc = torch.where(is_rep, 3, 1).to(torch.int32)
    tin = torch.zeros((b,), dtype=torch.int32, device=dev)
    v = v0
    evt = torch.zeros((b, N_EVENTS), dtype=f, device=dev)
    t = 0
    while t < t_total and bool((phase < 3).any()):
        in_act = phase == 0
        in_res = phase == 1
        in_pre = phase == 2
        done = phase >= 3

        t_ns = (tin.to(f) + 1.0) * dt
        e = torch.exp(-t_ns / tau)
        s = torch.where(in_act, 1.0 - e,
                        torch.where(in_res, 1.0, torch.where(in_pre, e, 0.0)))
        gc = torch.where(in_res[:, None], gc_res,
                         torch.where(in_pre[:, None], gc_pre, 0.0))
        gcv = torch.where(in_res[:, None], gc_res * vdd[:, None],
                          torch.where(in_pre[:, None],
                                      gc_pre * vpre[:, None], 0.0))

        g = torch.cat([g_branch[:, : n - 2],
                       g_branch[:, n - 2:] * s[:, None]], dim=1)
        g_lo = torch.cat([zeros, g], dim=1)
        g_hi = torch.cat([g, zeros], dim=1)
        d = cdt + g_lo + g_hi + gc
        dl = torch.cat([zeros, -g], dim=1)
        du = torch.cat([-g, zeros], dim=1)
        v_sol = _thomas_small(dl, d, du, cdt * v + gcv)
        v_next = torch.where(done[:, None], v, v_sol)

        cross_own = v_next[:, 0] - vpre >= thr_rel
        cross_prev = torch.roll(cross_own, 1)
        cross = torch.stack([
            torch.where(is_main, cross_prev, cross_own),
            v_next[:, n - 1] >= RESTORE_FRAC * vdd,
            torch.amax(torch.abs(v_next[:, : n - 1] - vpre[:, None]),
                       dim=-1) <= EQUALIZE_TOL_V,
        ])
        tin1 = tin + 1
        phase_c = torch.clamp(phase, 0, 2).long()
        crossed = torch.gather(cross, 0, phase_c[None, :])[0]
        cap = caps[phase_c]
        advance = ~done & (crossed | (tin1 >= cap))
        t_evt = torch.where(crossed, tin1.to(f) * dt, nan)

        rec0 = advance & (phase == 0)
        evt[:, 0] = torch.where(rec0, t_evt, evt[:, 0])
        evt[:, 1] = torch.where(rec0, v_next[:, 0] - vpre, evt[:, 1])
        evt[:, 2] = torch.where(advance & (phase == 1), t_evt, evt[:, 2])
        evt[:, 3] = torch.where(advance & (phase == 2), t_evt, evt[:, 3])

        phase = torch.where(advance, phase + phase_inc, phase)
        tin = torch.where(advance, 0, torch.where(done, tin, tin1))
        v = v_next
        t += 1
    return evt


def events(operands, dtype=torch.float32) -> torch.Tensor:
    """(B, 4) float32 events of the six operands, in blocks of rows."""
    b = operands[0].shape[0]
    out = []
    for lo in range(0, b, BLOCK_ROWS):
        part = [x[lo:lo + BLOCK_ROWS].contiguous() for x in operands]
        out.append(row_cycle_fused(*part, DT_NS, N_ACT_STEPS,
                                   N_RESTORE_STEPS, N_PRE_STEPS,
                                   dtype=dtype).to(torch.float32))
    return torch.cat(out)
