"""Plain PyTorch versions of the kernels.

Port of `repro.kernels.ref`.  `row_cycle_fused_ref` is what the CUDA
kernel `csrc/row_cycle.cu` computes, `rc_multistep_ref` what
`csrc/rc_multistep.cu` computes, `strap_attend_ref` what
`csrc/strap_attend.cu` computes (`strap_attend_split_ref` computes it as
the kernel splits it), `pareto_dominated_ref` what `csrc/pareto.cu`
computes: the CPU path runs them, and `chip_smoke.py` holds
each kernel against its plain version on the card.
The row-cycle versions follow the reference oracles operation for
operation, in float32; `strap_attend_ref` follows the TPU kernel
(`strap_attend_pallas`) where the reference's oracle and kernel differ.
"""

from __future__ import annotations

import torch

from ..runtime.trace import count

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


# --------------------------------------------------------------------------
# Selector+strap gated KV gather + decode attention
# --------------------------------------------------------------------------

def strap_attend_ref(q: torch.Tensor, k_pages: torch.Tensor,
                     v_pages: torch.Tensor, strap_ids: torch.Tensor,
                     pages_per_strap: int, scale: float | None = None,
                     lengths: torch.Tensor | None = None) -> torch.Tensor:
    """Decode attention over the selected straps of a paged KV cache.

    q         : (B, Hq, D)                 one query token per sequence
    k_pages   : (B, P, page, Hkv, D)       paged keys (P a multiple of G)
    v_pages   : (B, P, page, Hkv, D)       paged values
    strap_ids : (B, S) int                 selected straps; strap s holds
                pages [s*G, (s+1)*G), i.e. tokens [s*G*page, (s+1)*G*page).
                An id < 0 (or >= P // G) is masked: it contributes nothing.
    lengths   : (B,) int, optional         tokens written per sequence;
                tokens at positions >= lengths[b] are masked out.
    Returns   : (B, Hq, D) in q's dtype; query heads h*grp .. h*grp+grp-1
                attend kv head h (grp = Hq // Hkv).

    It gathers the selected straps and takes one softmax over their valid
    tokens, as the TPU kernel's online softmax does over its strap steps.
    Where the reference's jnp oracle differs from that kernel, this follows
    the kernel: a row whose straps are all masked gives zeros (the oracle
    gives NaN), and a strap id listed twice is attended twice (the oracle's
    page mask counts it once).
    """
    b, p, page, hkv, d = k_pages.shape
    hq = q.shape[1]
    grp = hq // hkv
    g = pages_per_strap
    blk = g * page
    n_straps = p // g
    if scale is None:
        scale = 1.0 / (d ** 0.5)

    ids = strap_ids.long()
    valid = (ids >= 0) & (ids < n_straps)                       # (B, S)
    safe = torch.where(valid, ids, torch.zeros_like(ids))
    rows = torch.arange(b, device=q.device)[:, None]
    k = k_pages[:, : n_straps * g].reshape(b, n_straps, blk, hkv, d)[rows, safe]
    v = v_pages[:, : n_straps * g].reshape(b, n_straps, blk, hkv, d)[rows, safe]
    tok = safe[..., None] * blk + torch.arange(blk, device=q.device)
    ok = valid[..., None].expand(-1, -1, blk)                   # (B, S, blk)
    if lengths is not None:
        ok = ok & (tok < lengths.long()[:, None, None])
    ok = ok.reshape(b, -1)                                      # (B, S*blk)

    s_sel = ids.shape[1]
    k = k.reshape(b, s_sel * blk, hkv, d).float()
    v = v.reshape(b, s_sel * blk, hkv, d).float()
    qg = q.reshape(b, hkv, grp, d).float()
    logits = torch.einsum("bhgd,bthd->bhgt", qg, k) * scale
    logits = logits.masked_fill(~ok[:, None, None, :], float("-inf"))
    m = torch.amax(logits, dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    w = torch.exp(logits - m)                                   # masked -> 0
    l_sum = w.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhgt,bthd->bhgd", w, v)
    o = o / torch.where(l_sum > 0, l_sum, torch.ones_like(l_sum))
    return o.reshape(b, hq, d).to(q.dtype)


def strap_split_ranges(strap_ids: torch.Tensor, lengths: torch.Tensor | None,
                       blk: int, n_straps: int, chunk: int, n_tok: int):
    """Token ranges of the split kernel's blocks -> (start, count), each
    (B, S * n_chunks) int64: split s * n_chunks + c takes `count` tokens
    from flat token `start` on, chunk c of slot s's strap below lengths[b];
    a masked slot (id < 0 or >= n_straps) gets count 0.  The same
    arithmetic as `csrc/strap_attend.cu`'s `split_of`."""
    n_chunks = -(-blk // chunk)
    ids = strap_ids.long()
    b = ids.shape[0]
    dev = ids.device
    length = (torch.full((b,), n_tok, dtype=torch.long, device=dev)
              if lengths is None else lengths.long().to(dev))
    valid = (ids >= 0) & (ids < n_straps)                       # (B, S)
    c = torch.arange(n_chunks, device=dev)
    start = ids[..., None] * blk + c * chunk                    # (B, S, C)
    stop = torch.minimum(ids[..., None] * blk
                         + torch.clamp((c + 1) * chunk, max=blk),
                         length[:, None, None])
    count = torch.where(valid[..., None], (stop - start).clamp(min=0), 0)
    start = torch.where(valid[..., None], start, 0)
    return start.reshape(b, -1), count.reshape(b, -1)


def strap_attend_split_ref(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, strap_ids: torch.Tensor,
                           pages_per_strap: int, chunk: int,
                           scale: float | None = None,
                           lengths: torch.Tensor | None = None
                           ) -> torch.Tensor:
    """`strap_attend_ref`'s function computed as the CUDA kernels split it:
    a float32 partial (m, l, acc) per split of `strap_split_ranges` (the
    plan's `chunk`, from `strap_gather.split_plan`), merged with the
    log-sum-exp rule and divided by l (zeros where l = 0)."""
    b, p, page, hkv, d = k_pages.shape
    hq = q.shape[1]
    grp = hq // hkv
    blk = pages_per_strap * page
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    start, count = strap_split_ranges(strap_ids, lengths, blk,
                                      p // pages_per_strap, chunk, p * page)
    offs = torch.arange(chunk, device=q.device)
    ok = offs < count[..., None]                                # (B, N, C)
    tok = torch.where(ok, start[..., None] + offs, 0)
    rows = torch.arange(b, device=q.device)[:, None, None]
    k = k_pages.reshape(b, p * page, hkv, d)[rows, tok].float()  # B,N,C,H,D
    v = v_pages.reshape(b, p * page, hkv, d)[rows, tok].float()
    qg = q.reshape(b, hkv, grp, d).float()
    logits = torch.einsum("bhgd,bnchd->bhngc", qg, k) * scale
    logits = logits.masked_fill(~ok[:, None, :, None, :], float("-inf"))
    m = torch.amax(logits, dim=-1)                              # (B,H,N,G)
    m_use = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    w = torch.exp(logits - m_use[..., None])
    l_part = w.sum(-1)
    acc = torch.einsum("bhngc,bnchd->bhngd", w, v)
    mm = torch.amax(m, dim=2, keepdim=True)                     # (B,H,1,G)
    wt = torch.where(torch.isfinite(mm), torch.exp(m - mm),
                     torch.zeros_like(m))                       # empty -> 0
    l_sum = (wt * l_part).sum(2)
    o = (wt[..., None] * acc).sum(2)
    o = o / torch.where(l_sum > 0, l_sum, torch.ones_like(l_sum))[..., None]
    return o.reshape(b, hq, d).to(q.dtype)


# --------------------------------------------------------------------------
# Pareto dominance
# --------------------------------------------------------------------------

def pareto_dominated_ref(hi_d, lo_d, cand_d, hi, lo, cand,
                         block: int = 4096) -> torch.Tensor:
    """Which rows of (hi, lo, cand) some candidate dominator row of
    (hi_d, lo_d, cand_d) dominates -> (B,) bool, on hi's device.

    `hi` / `lo` are (B, K) maximized / minimized objective columns and
    `cand` the (B,) candidate mask; a candidate row a dominates a
    candidate row b where a >= b on every `hi` column, a <= b on every
    `lo` column, and strictly better on one.  NaN compares False, so a
    row with a NaN objective neither dominates nor is dominated.  The
    dominators run in blocks of `block` rows: each block is one masked
    broadcast against the whole batch, so peak memory is O(block * B).
    Counts its dominance tests (`pareto.pairs`: every dominator row
    against every row).
    """
    n_dom = hi_d.shape[0]
    count("pareto.pairs", n_dom * hi.shape[0])
    dominated = torch.zeros((hi.shape[0],), dtype=torch.bool,
                            device=hi.device)
    for i0 in range(0, n_dom, block):                  # dominator blocks
        hi_i, lo_i = hi_d[i0:i0 + block], lo_d[i0:i0 + block]
        cand_i = cand_d[i0:i0 + block]
        ge = ((hi_i[:, None, :] >= hi[None, :, :]).all(-1)
              & (lo_i[:, None, :] <= lo[None, :, :]).all(-1))
        gt = ((hi_i[:, None, :] > hi[None, :, :]).any(-1)
              | (lo_i[:, None, :] < lo[None, :, :]).any(-1))
        dominated |= (ge & gt & cand_i[:, None] & cand[None, :]).any(dim=0)
    return dominated
