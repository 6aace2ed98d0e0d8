"""Plain PyTorch versions of the kernels.

Port of the row-cycle half of `repro.kernels.ref`.  `row_cycle_fused_ref`
is what the CUDA kernel `csrc/row_cycle.cu` computes, `rc_multistep_ref`
what `csrc/rc_multistep.cu` computes: the CPU path runs them, and
`chip_smoke.py` holds each kernel against its plain version on the card.
They follow the reference oracles operation for operation, in float32.
"""

from __future__ import annotations

import torch

# params / events column layouts (shared with kernels.row_cycle)
(PAR_TAU_WL, PAR_THR_REL, PAR_VDD, PAR_VPRE, PAR_ACTIVE, PAR_ROLE) = range(6)
N_PARAMS = 6
N_EVENTS = 4
RESTORE_FRAC = 0.95      # cell restored when v_cell >= RESTORE_FRAC * VDD
EQUALIZE_TOL_V = 5e-3    # BL equalized when max |v - vpre| <= 5 mV

# PAR_ROLE values: how a row's SA enable is timed during ACT.
ROLE_STANDALONE = 0.0    # fixed timing: fires on the row's own 0.9 crossing
ROLE_REPLICA = 1.0       # replica bitline: fires the SA enable of row+1,
                         # then jumps straight to DONE (no RESTORE/PRE)
ROLE_MAIN = 2.0          # main array row: SA enable fired by the replica
                         # at row-1 (rows are interleaved [replica, main])


def tridiag_solve_ref(dl: torch.Tensor, d: torch.Tensor, du: torch.Tensor,
                      b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b for tridiagonal A, batched over leading dims.

    dl: (..., N) sub-diagonal, dl[..., 0] ignored
    d : (..., N) main diagonal
    du: (..., N) super-diagonal, du[..., N-1] ignored
    b : (..., N) right-hand side
    """
    n = d.shape[-1]
    cp = [du[..., 0] / d[..., 0]]
    dp = [b[..., 0] / d[..., 0]]
    for i in range(1, n):
        denom = d[..., i] - dl[..., i] * cp[i - 1]
        cp.append(du[..., i] / denom)
        dp.append((b[..., i] - dl[..., i] * dp[i - 1]) / denom)
    x = [dp[n - 1]]
    for i in range(n - 2, -1, -1):
        x.append(dp[i] - cp[i] * x[-1])
    return torch.stack(x[::-1], dim=-1)


def rc_multistep_ref(c: torch.Tensor, g_branch: torch.Tensor,
                     g_clamp: torch.Tensor, v_clamp: torch.Tensor,
                     v0: torch.Tensor, ramp: torch.Tensor,
                     dt: float) -> torch.Tensor:
    """Simulate T implicit-Euler steps of a batched RC ladder, plain version.

    The ladder has N nodes; branch i connects node i and i+1 with
    conductance g_branch[..., i].  The LAST branch (index N-2, the cell
    access transistor) is scaled by `ramp[t]` at step t (WL ramp).  Each
    node may additionally be clamped toward v_clamp through g_clamp.

    c        : (B, N)   node capacitances            [fF]
    g_branch : (B, N-1) branch conductances          [1/kOhm]
    g_clamp  : (B, N)   clamp conductances           [1/kOhm]
    v_clamp  : (B, N)   clamp target voltages        [V]
    v0       : (B, N)   initial node voltages        [V]
    ramp     : (T,)     access-branch scale per step (0..1)
    dt       : step     [ns]    (fF/kOhm -> ps, so G uses 1e-3 factor)

    Returns trace: (T, B, N) node voltages after each step.
    """
    # divide by a 0-d tensor: a true division, as in the reference
    dt_t = torch.tensor(dt, dtype=c.dtype, device=c.device)
    cdt = c / dt_t * 1e-3  # fF/ns = uS; G is in 1/kOhm = mS -> scale by 1e-3
    zeros = torch.zeros_like(c[..., :1])
    clamp_v = g_clamp * v_clamp
    v = v0
    trace = []
    for t in range(ramp.shape[0]):
        g = torch.cat([g_branch[..., :-1], g_branch[..., -1:] * ramp[t]],
                      dim=-1)
        g_lo = torch.cat([zeros, g], dim=-1)        # g[i-1] at row i
        g_hi = torch.cat([g, zeros], dim=-1)        # g[i]   at row i
        d = cdt + g_lo + g_hi + g_clamp
        dl = torch.cat([zeros, -g], dim=-1)
        du = torch.cat([-g, zeros], dim=-1)
        v = tridiag_solve_ref(dl, d, du, cdt * v + clamp_v)
        trace.append(v)
    return torch.stack(trace) if trace else c.new_empty((0, *c.shape))


def _thomas_small(dl, d, du, rhs):
    """Thomas solve unrolled over the last (static, small) axis."""
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


def row_cycle_fused_ref(c: torch.Tensor, g_branch: torch.Tensor,
                        gc_res: torch.Tensor, gc_pre: torch.Tensor,
                        v0: torch.Tensor, params: torch.Tensor,
                        dt: float, n_act: int, n_res: int, n_pre: int):
    """Fused row-cycle engine, plain version: one pass over ACT/RESTORE/PRE.

    Each design point runs its own phase state machine
    (0=ACT, 1=RESTORE, 2=PRE, 3=DONE):

      ACT    : access branch scaled by the rising WL ramp 1 - e^{-t/tau};
               advances when v[0] - vpre >= thr_rel or after n_act steps.
      RESTORE: access branch fully on, clamp (gc_res -> vdd);
               advances when v[N-1] >= 0.95 * vdd or after n_res steps.
      PRE    : falling WL ramp e^{-t/tau}, clamp (gc_pre -> vpre);
               done when max |v[:N-1] - vpre| <= 5 mV or after n_pre steps.

    Event times are first-crossing times (idx+1)*dt from the phase start,
    or NaN when the phase timed out.  `params` is (B, 6)
    [tau_wl_ns, thr_rel_v, vdd, vpre, active, role] or the legacy (B, 5)
    without the role column (role 0).  Replica-closed timing interleaves
    rows as [replica, main] pairs: the replica's ACT crossing fires the SA
    enable of the main row after it, and the replica then skips RESTORE/PRE.

    Returns (events, v_end): (B, 4) [t_dev, dv_sense, t_res_dur, t_pre]
    and (B, N) final node voltages.
    """
    b, n = c.shape
    dev = c.device
    f32 = torch.float32
    # divide by a 0-d tensor: a Python-scalar divisor becomes a multiply by
    # its reciprocal on CUDA, which is not the reference's division
    dt_t = torch.tensor(dt, dtype=f32, device=dev)
    cdt = c / dt_t * 1e-3          # fF/ns = uS; G in 1/kOhm = mS -> 1e-3
    tau = torch.clamp_min(params[:, PAR_TAU_WL], 1e-3)
    thr_rel = params[:, PAR_THR_REL]
    vdd = params[:, PAR_VDD]
    vpre = params[:, PAR_VPRE]
    active = params[:, PAR_ACTIVE] > 0.5
    role = (params[:, PAR_ROLE] if params.shape[1] > PAR_ROLE
            else torch.zeros_like(tau))
    is_rep = torch.abs(role - ROLE_REPLICA) < 0.5
    is_main = role > ROLE_MAIN - 0.5
    t_total = n_act + n_res + n_pre
    caps = torch.tensor([n_act, n_res, n_pre], dtype=torch.int32, device=dev)
    zeros = torch.zeros((b, 1), dtype=f32, device=dev)
    nan = torch.tensor(float("nan"), dtype=f32, device=dev)

    phase = torch.where(active, 0, 3).to(torch.int32)
    phase_inc = torch.where(is_rep, 3, 1).to(torch.int32)
    tin = torch.zeros((b,), dtype=torch.int32, device=dev)
    v = v0.to(f32)
    evt = torch.zeros((b, N_EVENTS), dtype=f32, device=dev)
    t = 0
    while t < t_total and bool((phase < 3).any()):
        in_act = phase == 0
        in_res = phase == 1
        in_pre = phase == 2
        done = phase >= 3

        t_ns = (tin.to(f32) + 1.0) * dt
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

        # SA-enable coupling: a main row's ACT crossing is the crossing of
        # the replica at row-1 (pairs run ACT in lockstep)
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
        t_evt = torch.where(crossed, tin1.to(f32) * dt, nan)

        rec0 = advance & (phase == 0)
        evt[:, 0] = torch.where(rec0, t_evt, evt[:, 0])
        evt[:, 1] = torch.where(rec0, v_next[:, 0] - vpre, evt[:, 1])
        evt[:, 2] = torch.where(advance & (phase == 1), t_evt, evt[:, 2])
        evt[:, 3] = torch.where(advance & (phase == 2), t_evt, evt[:, 3])

        # replica rows are ACT-only: they jump straight to DONE
        phase = torch.where(advance, phase + phase_inc, phase)
        tin = torch.where(advance, 0, torch.where(done, tin, tin1))
        v = v_next
        t += 1
    return evt, v
