"""Mamba2 (SSD — state-space duality) mixer: chunked prefill scan and the
one-token decode step.

Port of `repro.models.ssm`.  The sequence is split into chunks of Q
tokens; within a chunk the quadratic dual form runs as batched matrix
products, while a loop over chunks carries the (nh, headdim, state) SSM
state with each chunk's decay.  The reference writes the intra-chunk
products as three-operand einsums; here each is written out as an
elementwise product and one batched matmul, laid out (B, nc, nh, Q, S)
so the largest intermediate, the float32 decay (B, nc, nh, Q, Q), is
built once and scaled in place.

Decode keeps (conv_state, ssm_state) and advances one token in O(1).

Dtypes follow the reference: in prefill the conv output's `silu` is taken
in float32 and cast back to the stream's dtype before the scan, in decode
it stays float32; `dt` is `softplus` in float32; the SSM state is float32
and the conv tail keeps the stream's dtype.

Under a mesh (`distributed.tensor_parallel`) the mixer computes on the
"model" blocks it is given, as the reference's GSPMD program places them
(`in_proj` / `conv` / `ssm_norm_w` / `out_proj` on "ssm_out", the scan on
the heads):
  * split layout (opt level 7): `in_z` / `in_x` are the rank's heads,
    `in_B` / `in_C` are convolved on their blocks and gathered (every
    rank computes the C·Bᵀ scores: a repeated term, and a small one),
    `in_dt` is whole and the rank uses its heads' columns;
  * fused layout: the rank's uniform blocks of `in_proj`, `conv_w` and
    `conv_b`, whose boundaries fall across z / x / B / C / dt, are
    all-gathered (the weights, not the (B, L, d_in_proj) product) and
    re-cut as the split layout's blocks (`_fused_as_split`), which then
    run the split layout's schedule: one sharded schedule for both over
    a prompt.  The one-token decode step of the fused layout instead
    gathers its (B, d_in_proj) product, far smaller than the weights,
    and its conv output, the conv on the cache's channel block;
  * then the scan on the rank's heads, the D skip and the gate on its
    `d_inner` block, the gated RMSNorm over the whole `d_inner` (the
    rank's sum of squares summed over "model") and `out_proj` on its
    rows, summed over "model".  `A_log`, `D_skip`, `dt_bias` and `in_dt`
    are replicated; each rank reads its heads' part through
    `reduce_grad`, so that their gradient is summed over "model".
Under `seq_parallel` (opt level 8, the ssm family) the stream is the
rank's sequence block and the mixer runs whole on it: the conv reads the
previous rank's last K - 1 rows (a halo), the scan starts from the state
the earlier ranks' blocks leave (`ssd_chunked(seq_group=)`), and every
weight's gradient is the block's share, summed over "model".
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..distributed import tensor_parallel as tp
from ..distributed.collectives import (all_gather_cat, gather_dim,
                                       reduce_grad, sum_both)
from .common import ParamSpec, Schema, rmsnorm


def ssm_schema(cfg, layers: int | None = None) -> Schema:
    d, di = cfg.d_model, cfg.d_inner
    ng, st, nh = cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_nheads
    k = cfg.conv_kernel
    conv_dim = di + 2 * ng * st
    d_in_proj = 2 * di + 2 * ng * st + nh
    L = (layers,) if layers is not None else ()
    A = ("layers",) if layers is not None else ()
    if cfg.ssm_split_proj:
        # the fused in_proj / conv split into one projection per stream:
        # the same linear map (the reference's shard-aligned layout)
        gs = ng * st
        return {
            "in_z": ParamSpec(L + (d, di), A + ("dmodel", "ssm_out"), "fan_in"),
            "in_x": ParamSpec(L + (d, di), A + ("dmodel", "ssm_out"), "fan_in"),
            "in_B": ParamSpec(L + (d, gs), A + ("dmodel", "ssm_out"), "fan_in"),
            "in_C": ParamSpec(L + (d, gs), A + ("dmodel", "ssm_out"), "fan_in"),
            "in_dt": ParamSpec(L + (d, nh), A + ("dmodel", None), "fan_in"),
            "conv_x_w": ParamSpec(L + (k, di), A + (None, "ssm_out"), 0.2),
            "conv_B_w": ParamSpec(L + (k, gs), A + (None, "ssm_out"), 0.2),
            "conv_C_w": ParamSpec(L + (k, gs), A + (None, "ssm_out"), 0.2),
            "conv_x_b": ParamSpec(L + (di,), A + ("ssm_out",), "zeros"),
            "conv_B_b": ParamSpec(L + (gs,), A + ("ssm_out",), "zeros"),
            "conv_C_b": ParamSpec(L + (gs,), A + ("ssm_out",), "zeros"),
            "A_log": ParamSpec(L + (nh,), A + (None,), 0.5),
            "D_skip": ParamSpec(L + (nh,), A + (None,), "ones"),
            "dt_bias": ParamSpec(L + (nh,), A + (None,), "zeros"),
            "ssm_norm_w": ParamSpec(L + (di,), A + ("ssm_out",), "ones"),
            "out_proj": ParamSpec(L + (di, d), A + ("ssm_out", "dmodel"), "fan_in"),
        }
    return {
        "in_proj": ParamSpec(L + (d, d_in_proj), A + ("dmodel", "ssm_out"), "fan_in"),
        "conv_w": ParamSpec(L + (k, conv_dim), A + (None, "ssm_out"), 0.2),
        "conv_b": ParamSpec(L + (conv_dim,), A + ("ssm_out",), "zeros"),
        "A_log": ParamSpec(L + (nh,), A + (None,), 0.5),
        "D_skip": ParamSpec(L + (nh,), A + (None,), "ones"),
        "dt_bias": ParamSpec(L + (nh,), A + (None,), "zeros"),
        "ssm_norm_w": ParamSpec(L + (di,), A + ("ssm_out",), "ones"),
        "out_proj": ParamSpec(L + (di, d), A + ("ssm_out", "dmodel"), "fan_in"),
    }


def _split_proj(cfg, zxbcdt):
    di = cfg.d_inner
    gs = cfg.ssm_ngroups * cfg.ssm_state
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di: di + di + 2 * gs]
    dt = zxbcdt[..., di + di + 2 * gs:]
    return z, xbc, dt


def _causal_conv(xbc, w, b):
    """Depthwise causal conv along seq: xbc (B,L,C), w (K,C); products and
    sums in the stream's dtype, taps in order, as the reference's."""
    k = w.shape[0]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    out = sum(pad[:, i: i + xbc.shape[1], :] * w[i][None, None, :]
              for i in range(k))
    return out + b[None, None, :]


def _split_xbc(cfg, xbc):
    di, ng, st = cfg.d_inner, cfg.ssm_ngroups, cfg.ssm_state
    nh, hp = cfg.ssm_nheads, cfg.ssm_headdim
    b, l, _ = xbc.shape
    x = xbc[..., :di].reshape(b, l, nh, hp)
    bmat = xbc[..., di: di + ng * st].reshape(b, l, ng, st)
    cmat = xbc[..., di + ng * st:].reshape(b, l, ng, st)
    return x, bmat, cmat


def _softplus32(x):
    """`softplus` of float32 `x`.  The reference's `jax.nn.softplus` is
    `logaddexp(x, 0)`; `F.softplus` returns x itself above 20, where
    `logaddexp` adds log1p(exp(-x)) < 2.1e-9, below half an ulp of x: the
    two differ by less than 2e-9."""
    return F.softplus(x)


def chunk_size(cfg, l: int) -> int:
    """The largest divisor of `l` that is <= `cfg.ssm_chunk` (a 2047-token
    prompt runs in chunks of 89)."""
    q = min(cfg.ssm_chunk, l)
    while l % q:
        q -= 1
    return q


def ssd_chunked(cfg, x, bmat, cmat, dt, a_neg, h0=None, seq_group=None):
    """Chunked SSD scan.

    x    : (B, L, nh, hp)   (already conv'd + activated)
    bmat : (B, L, ng, st)
    cmat : (B, L, ng, st)
    dt   : (B, L, nh)       (softplus'd, fp32)
    a_neg: (nh,)            A = -exp(A_log), fp32
    h0   : optional (B, nh, hp, st) initial state
    Returns (y (B,L,nh,hp) float32, h_final (B,nh,hp,st) float32); float64
    inputs run in float64 (the gradient check's reference).

    Heads are grouped (ng, rep) with rep = nh // ng: head h reads B/C group
    h // rep, as the reference's `repeat` along the head axis.

    `seq_group` (`seq_parallel`): the L positions are this rank's block of
    a sequence split over the group's ranks in order; the scan starts
    from the state the earlier blocks leave (`_incoming_state`), and
    `h_final` is the state at the end of this rank's block.
    """
    b, l, nh, hp = x.shape
    ng, st = bmat.shape[2], bmat.shape[3]
    q = chunk_size(cfg, l)
    nc = l // q
    rep = nh // ng
    ct = torch.promote_types(x.dtype, torch.float32)   # float64 stays

    xq = x.reshape(b, nc, q, nh, hp).to(ct)
    bg = bmat.reshape(b, nc, q, ng, st).to(ct).permute(0, 1, 3, 2, 4)
    cg = cmat.reshape(b, nc, q, ng, st).to(ct).permute(0, 1, 3, 2, 4)
    dtq = dt.reshape(b, nc, q, nh)                    # (B,nc,Q,nh)
    cs = torch.cumsum(dtq * a_neg, dim=2)             # inclusive, negative
    total = cs[:, :, -1, :]                           # (B,nc,nh)
    dtx = xq * dtq[..., None]                         # (B,nc,Q,nh,hp)
    dtx_h = dtx.permute(0, 1, 3, 2, 4)                # (B,nc,nh,S,hp)
    cs_h = cs.transpose(2, 3)                         # (B,nc,nh,Q)

    # ---- intra-chunk (dual quadratic form) ------------------------------
    # decay(q, s) = exp(cs[q] - cs[s]) for q >= s, else 0.  Under no_grad
    # it is built in place.  When autograd records it is built out of
    # place (autograd saves the exp's output), and the upper triangle is
    # set to -inf before the exp rather than to 0 after it: the same
    # values, but there cs[q] - cs[s] > 0 overflows exp to inf once a
    # chunk's decay sums past ~88.7 (Mamba2-780M's chunks of 256 do), and
    # the backward would turn 0 * inf into NaN, as the reference's does
    decay = cs_h[..., :, None] - cs_h[..., None, :]   # (B,nc,nh,Q,S)
    upper = ~torch.ones(q, q, dtype=torch.bool, device=x.device).tril()
    scores = cg @ bg.transpose(-1, -2)                # (B,nc,ng,Q,S)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, bmat, cmat, dt, a_neg, h0)):
        decay = torch.exp(decay.masked_fill(upper, float("-inf")))
        decay = (decay.view(b, nc, ng, rep, q, q)
                 * scores[:, :, :, None]).reshape(b, nc, nh, q, q)
    else:
        decay.exp_()
        decay.masked_fill_(upper, 0.0)
        decay.view(b, nc, ng, rep, q, q).mul_(scores[:, :, :, None])
    y = decay @ dtx_h                                 # (B,nc,nh,Q,hp)
    del decay, scores

    # ---- chunk states ----------------------------------------------------
    decay_to_end = torch.exp(total[:, :, None, :] - cs)          # (B,nc,S,nh)
    w = (dtx * decay_to_end[..., None]).permute(0, 1, 3, 4, 2)  # (B,nc,nh,hp,S)
    s_chunk = (w.reshape(b, nc, ng, rep, hp, q)
               @ bg[:, :, :, None]).reshape(b, nc, nh, hp, st)

    # ---- inter-chunk scan -------------------------------------------------
    decay_chunk = torch.exp(total)                    # (B,nc,nh)
    if seq_group is not None:
        h0 = _incoming_state(s_chunk, total, decay_chunk, seq_group)
    h = (torch.zeros(b, nh, hp, st, dtype=ct, device=x.device)
         if h0 is None else h0)
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h)
        h = h * decay_chunk[:, c, :, None, None] + s_chunk[:, c]
    h_prev = torch.stack(h_prevs, dim=1)              # (B,nc,nh,hp,st)

    # ---- inter-chunk contribution -----------------------------------------
    y_off = (cg[:, :, :, None]
             @ h_prev.reshape(b, nc, ng, rep, hp, st).transpose(-1, -2))
    y_off = y_off.reshape(b, nc, nh, q, hp) * torch.exp(cs_h)[..., None]
    y = (y + y_off).permute(0, 1, 3, 2, 4).reshape(b, l, nh, hp)
    return y, h


def _incoming_state(s_chunk, total, decay_chunk, group):
    """The state entering this rank's block of a sequence split over
    `group`.  Each rank scans its block from zero, which gives its final
    state S_j and its total log decay T_j; these are all-gathered (one
    collective, differentiable: the rank's block of the summed gradient
    comes back) and folded in rank order, h0_r = sum over j < r of
    exp(sum of T_k over j < k < r) S_j.  The scan is linear in its
    initial state, so this is the sequential scan's state, rounded
    otherwise.  Rank 0 reads the gathered blocks times zero, so that
    every rank's backward runs the collective's."""
    b, nc, nh, hp, st = s_chunk.shape
    s_own = torch.zeros_like(s_chunk[:, 0])
    for c in range(nc):
        s_own = s_own * decay_chunk[:, c, :, None, None] + s_chunk[:, c]
    mine = torch.cat([s_own.reshape(b, nh, hp * st),
                      total.sum(dim=1)[..., None]], dim=-1)
    every = gather_dim(mine[None], group, 0)       # (m, B, nh, hp*st + 1)
    h = every[0, ..., :-1] * 0.0
    for j in range(dist.get_rank(group)):
        h = h * torch.exp(every[j, ..., -1:]) + every[j, ..., :-1]
    return h.reshape(b, nh, hp, st)


class _Heads(NamedTuple):
    """The heads a mixer computes: `group`, the "model" group whose ranks
    each take a block of them (None: all, on one rank or whole on every
    rank); `start` and `n`, this rank's first head and count."""
    group: object
    start: int
    n: int


def _heads(cfg, p) -> _Heads:
    """The rank's heads where `p` holds its blocks of the mixer
    (`tensor_parallel.model_split`), else every head."""
    group = tp.block_group(p["ssm_norm_w"], cfg.d_inner, -1)
    nh = cfg.ssm_nheads
    if group is None:
        return _Heads(None, 0, nh)
    n = nh // dist.get_world_size(group)
    return _Heads(group, dist.get_rank(group) * n, n)


def _head_leaf(p, key: str, hd: _Heads):
    """A replicated per-head leaf (`A_log`, `D_skip`, `dt_bias`, `in_dt`'s
    columns) as the rank's heads read it: its part, the gradient summed
    over "model" (`reduce_grad`)."""
    if hd.group is None:
        return p[key]
    return reduce_grad(p[key], hd.group).narrow(-1, hd.start, hd.n)


def _head_groups(cfg, t, hd: _Heads):
    """B or C (..., ng, st) -> the groups the rank's heads read: a
    contiguous range where its heads cover whole groups, else the one
    group they sit in (`tensor_parallel.module_split` admits no other
    case)."""
    if hd.group is None:
        return t
    rep = cfg.ssm_nheads // cfg.ssm_ngroups
    first = hd.start // rep
    return t.narrow(-2, first, max(hd.n // rep, 1))


def _gather_parts(parts, group):
    """Each rank's blocks `parts` (each of one shape on every rank, one
    dtype) -> each part whole, every rank's block concatenated along its
    last dim in rank order; one all-gather for all of them,
    differentiable."""
    every = gather_dim(torch.cat([t.reshape(-1) for t in parts])[None],
                       group, 0)
    out, at = [], 0
    for t in parts:
        piece = every[:, at:at + t.numel()].reshape(-1, *t.shape)
        out.append(torch.cat(piece.unbind(0), dim=-1))
        at += t.numel()
    return out


def _fused_as_split(cfg, p, hd: _Heads) -> dict:
    """The fused layout's blocks of `in_proj`, `conv_w` and `conv_b` (the
    rank's uniform 1/m of their columns) -> the split layout's leaves as
    the rank computes with them: its heads' columns of z, x and dt and
    its 1/m of B and C, the same blocks `ssm_split_proj` stores.  The
    three weights are all-gathered (one collective) and cut; each column
    goes to one rank, so the gather's backward (every rank's gradient
    summed, the rank's block kept) returns each block its own gradient."""
    di, hp = cfg.d_inner, cfg.ssm_headdim
    gs = cfg.ssm_ngroups * cfg.ssm_state
    w, cw, cb = _gather_parts([p["in_proj"], p["conv_w"], p["conv_b"]],
                              hd.group)
    gb = gs // dist.get_world_size(hd.group)
    at = {"x": hd.start * hp, "B": di + dist.get_rank(hd.group) * gb}
    at["C"] = at["B"] + gs
    width = {"x": hd.n * hp, "B": gb, "C": gb}
    out = {"in_z": w.narrow(-1, at["x"], width["x"]),
           "in_dt": w.narrow(-1, 2 * di + 2 * gs + hd.start, hd.n)}
    for s in "xBC":          # in_proj's x / B / C follow its di z columns
        out["in_" + s] = w.narrow(-1, di + at[s], width[s])
        out[f"conv_{s}_w"] = cw.narrow(-1, at[s], width[s])
        out[f"conv_{s}_b"] = cb.narrow(-1, at[s], width[s])
    return out


def _split_weights(cfg, p, hd: _Heads) -> dict:
    """`p` with the split layout's leaves as the rank computes with them,
    `in_dt` cut to its heads' columns: the stored split layout's (`in_dt`
    whole, its gradient summed over "model"), or the fused layout's
    blocks re-cut (`_fused_as_split`)."""
    if cfg.ssm_split_proj:
        return {**p, "in_dt": _head_leaf(p, "in_dt", hd)}
    return {**p, **_fused_as_split(cfg, p, hd)}


def _relay_tail(tails, hd: _Heads):
    """The split layout's conv tails, blocks (x: the rank's heads, B / C:
    its 1/m of each) -> the rank's uniform 1/m of the cache's [x | B |
    C] channels (the fused layout's conv block, the cache's "ssm_out"
    block).  Inference only: the tail is (B, K - 1, conv_dim)."""
    whole = torch.cat(_gather_parts(tails, hd.group), dim=-1)
    m, r = dist.get_world_size(hd.group), dist.get_rank(hd.group)
    step = whole.shape[-1] // m
    return whole[..., r * step:(r + 1) * step]


def _split_tail(cfg, conv0, hd: _Heads):
    """The cache's conv tail as the split layout's streams read it:
    (x, B, C) tails, each the rank's block where the mixer splits (the
    cached tail, the rank's uniform block, all-gathered and re-cut)."""
    if conv0 is None:
        return (None,) * 3
    di, gs = cfg.d_inner, cfg.ssm_ngroups * cfg.ssm_state
    if hd.group is not None:
        conv0 = all_gather_cat(conv0, hd.group, -1)
    parts = (conv0[..., :di], conv0[..., di:di + gs], conv0[..., di + gs:])
    if hd.group is None:
        return parts
    m, r = dist.get_world_size(hd.group), dist.get_rank(hd.group)
    return tuple(t[..., r * (t.shape[-1] // m):(r + 1) * (t.shape[-1] // m)]
                 for t in parts)


def _gated_norm(y, w, hd: _Heads, d_inner: int, eps=1e-6):
    """The gated RMSNorm over the whole `d_inner`: where `y` is the rank's
    block, its float32 sum of squares summed over "model" (`sum_both`:
    every rank's output reads the sum) over `d_inner`."""
    if hd.group is None:
        return rmsnorm(y, w, eps)
    y32 = y.float()
    ss = sum_both(torch.sum(y32 * y32, dim=-1, keepdim=True), hd.group)
    var = ss / torch.full((), d_inner, dtype=ss.dtype, device=ss.device)
    return (y32 * torch.rsqrt(var + eps) * w.float()).to(y.dtype)


def _mixer_out(cfg, p, xin, y, x, z, hd: _Heads = _Heads(None, 0, 0),
               st: tp.Stream = tp.WHOLE):
    """The scan's output to the block's: the D skip in float32, the gate
    `silu(z)`, the gated RMSNorm and `out_proj`, whose partial sums over
    the rank's rows leave through `tp.leave` where the mixer splits."""
    bsz, l = xin.shape[:2]
    y = y + _head_leaf(p, "D_skip", hd).float()[None, None, :, None] \
        * x.float()
    y = y.reshape(bsz, l, -1).to(xin.dtype)
    y = y * F.silu(z.float()).to(y.dtype)
    y = _gated_norm(y, p["ssm_norm_w"], hd, cfg.d_inner)
    out = y @ p["out_proj"]
    return out if hd.group is None else tp.leave(out, hd.group, st)


def _scan(cfg, p, xin, x, bmat, cmat, dt, z, h0, hd: _Heads, st: tp.Stream):
    """The rank's heads x (B, L, n, hp), every B / C (B, L, ng, st), its
    heads' projected dt and z -> (out, h_final)."""
    dt32 = _softplus32(dt.float() + _head_leaf(p, "dt_bias", hd).float())
    a_neg = -torch.exp(_head_leaf(p, "A_log", hd).float())
    y, h_final = ssd_chunked(cfg, x, _head_groups(cfg, bmat, hd),
                             _head_groups(cfg, cmat, hd), dt32, a_neg, h0,
                             st.group if st.seq else None)
    return _mixer_out(cfg, p, xin, y, x, z, hd, st), h_final


def _conv_with_state(cfg, stream, w, b, c0):
    """The causal conv of `stream` after the cached tail `c0` (or after
    zeros): (conv output, the new tail of K - 1 positions, a copy: a view
    would keep the whole projection of the prompt alive in the cache)."""
    k = cfg.conv_kernel - 1
    if c0 is not None:
        ctx = torch.cat([c0.to(stream.dtype), stream], dim=1)
        return (_causal_conv(ctx, w, b)[:, c0.shape[1]:],
                ctx[:, -k:, :].clone())
    return _causal_conv(stream, w, b), stream[:, -k:, :].clone()


def _halo(cfg, stream, st: tp.Stream):
    """Under `seq_parallel`: the previous rank's last K - 1 rows of
    `stream` (zeros on rank 0, its gathered rows times zero, so that its
    backward runs the collective's too), the conv's context before this
    rank's block; else None."""
    if not st.seq:
        return None
    k = cfg.conv_kernel - 1
    every = gather_dim(stream[:, -k:], st.group, 1)
    r = dist.get_rank(st.group)
    prev = every[:, max(r - 1, 0) * k:max(r, 1) * k]
    return prev if r else prev * 0.0


def ssm_apply(cfg, p, xin, h0=None, conv0=None, return_state: bool = False,
              st: tp.Stream = tp.WHOLE):
    """Full Mamba2 mixer on (B, L, D), the stream as `st` holds it.
    Optionally starts from the state (`h0` (B, nh, hp, st) float32,
    `conv0` (B, K-1, conv_dim): the rank's heads and its conv block where
    `p` holds its "model" blocks) and returns (out, h_final, conv_tail),
    the state likewise.  Under `seq_parallel` (`st.seq`, the mixer whole)
    the state is this rank's block's and no initial state is taken."""
    hd = _heads(cfg, p)
    if st.seq:
        if hd.group is not None or h0 is not None or conv0 is not None:
            raise ValueError(f"{cfg.name}: under seq_parallel the mixer "
                             "runs whole from the start of the sequence")
        mixer = ssm_schema(cfg)
        p = {k: tp.seq_param(v, st) if k in mixer else v
             for k, v in p.items()}
    if cfg.ssm_split_proj or hd.group is not None:
        x_in = tp.enter(xin, hd.group, st) if hd.group is not None else xin
        return _ssm_apply_split(cfg, _split_weights(cfg, p, hd), xin, x_in,
                                h0, conv0, return_state, hd, st)
    proj = xin @ p["in_proj"]
    z, xbc, dt = _split_proj(cfg, proj)
    c0 = conv0 if conv0 is not None else _halo(cfg, xbc, st)
    xbc_conv, conv_out = _conv_with_state(cfg, xbc, p["conv_w"], p["conv_b"],
                                          c0)
    xbc_act = F.silu(xbc_conv.float()).to(xin.dtype)
    x, bmat, cmat = _split_xbc(cfg, xbc_act)
    out, h_final = _scan(cfg, p, xin, x, bmat, cmat, dt, z, h0, hd, st)
    if return_state:
        return out, h_final, conv_out
    return out


def _ssm_apply_split(cfg, p, xin, x_in, h0, conv0, return_state, hd, st):
    """Split-projection forward (`p` from `_split_weights`): identical
    math, one stream each.  The conv state is [x | B | C] along channels,
    as the fused path's xbc, so decode caches stay compatible; where the
    mixer splits the rank's tail is re-laid as the cache's uniform
    channel block (`_relay_tail`)."""
    bsz, l, _ = xin.shape
    hp, st_ = cfg.ssm_headdim, cfg.ssm_state
    z = x_in @ p["in_z"]
    dt = x_in @ p["in_dt"]
    streams = [x_in @ p["in_" + s] for s in "xBC"]
    c0 = _split_tail(cfg, conv0, hd)
    if st.seq:                          # one halo for the three streams
        halo = _halo(cfg, torch.cat(streams, dim=-1), st)
        c0 = halo.split([t.shape[-1] for t in streams], dim=-1)
    convs = [_conv_with_state(cfg, t, p[f"conv_{s}_w"], p[f"conv_{s}_b"], c)
             for t, s, c in zip(streams, "xBC", c0)]
    xc, bc, cc = (c for c, _ in convs)
    if hd.group is not None:            # B and C whole
        bc, cc = _gather_parts([bc, cc], hd.group)
    x, bmat, cmat = (F.silu(c.float()).to(xin.dtype).reshape(bsz, l, -1, n)
                     for c, n in zip((xc, bc, cc), (hp, st_, st_)))
    out, h_final = _scan(cfg, p, xin, x, bmat, cmat, dt, z, h0, hd, st)
    if not return_state:
        return out
    tails = [t for _, t in convs]
    conv_out = (torch.cat(tails, dim=-1) if hd.group is None
                else _relay_tail(tails, hd))
    return out, h_final, conv_out


def _step_conv(stream, w, b, c0):
    """One token's conv over the cached tail: (B, C) output and the new
    (B, K-1, C) tail, in the stream's dtype."""
    ctx = torch.cat([c0.to(stream.dtype), stream], dim=1)     # (B, K, C)
    out = torch.einsum("bkc,kc->bc", ctx, w.to(ctx.dtype)) + b.to(ctx.dtype)
    return out, ctx[:, 1:, :]


def _step_state(cfg, p, xin, h, x, bmat, cmat, dt, z, hd: _Heads):
    """The recurrent update and output of one token from float32 x (B, n,
    hp) of the rank's heads, every B / C (B, ng, st) and its heads'
    projected dt and z."""
    bsz = xin.shape[0]
    if h.shape[1] != hd.n:
        raise ValueError(f"{cfg.name}: an SSM state of {h.shape[1]} heads "
                         f"for a mixer computing {hd.n}")
    bmat, cmat = _head_groups(cfg, bmat, hd), _head_groups(cfg, cmat, hd)
    rep = hd.n // bmat.shape[1]
    bh = torch.repeat_interleave(bmat, rep, dim=1)             # (B, n, st)
    chh = torch.repeat_interleave(cmat, rep, dim=1)
    dt32 = _softplus32(dt[:, 0, :].float()
                       + _head_leaf(p, "dt_bias", hd).float())  # (B, n)
    a_neg = -torch.exp(_head_leaf(p, "A_log", hd).float())
    da = torch.exp(dt32 * a_neg[None, :])
    dtx = x * dt32[..., None]                                  # (B, n, hp)
    h_new = h * da[..., None, None] + dtx[..., :, None] * bh[:, :, None, :]
    y = torch.einsum("bhpn,bhn->bhp", h_new, chh)
    y = y + _head_leaf(p, "D_skip", hd).float()[None, :, None] * x
    y = y.reshape(bsz, 1, -1).to(xin.dtype)
    y = y * F.silu(z.float()).to(y.dtype)
    y = _gated_norm(y, p["ssm_norm_w"], hd, cfg.d_inner)
    out = y @ p["out_proj"]
    if hd.group is not None:
        out = tp.leave(out, hd.group, tp.WHOLE)
    return out, h_new


def ssm_decode_step(cfg, p, xin, h, conv_state):
    """One-token recurrent step.

    xin        : (B, 1, D)
    h          : (B, nh, hp, st) fp32
    conv_state : (B, K-1, conv_dim)
    Returns (out (B, 1, D), h_new, conv_new); the caller writes the state.
    Where `p` holds the rank's "model" blocks the state is the rank's
    heads (B, nh / m, hp, st) and the tail its uniform block of the
    channels (B, K-1, conv_dim / m), as the cache's specs place them.
    """
    hd = _heads(cfg, p)
    if cfg.ssm_split_proj:
        return _ssm_decode_split(cfg, _split_weights(cfg, p, hd), xin, h,
                                 conv_state, hd)
    # the fused layout keeps its own blocks here: one token's product
    # (B, d_in_proj) is far smaller than the weights `_fused_as_split`
    # would gather, and the conv runs on the cache's own channel block
    bsz = xin.shape[0]
    nh, hp, st, ng = (cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state,
                      cfg.ssm_ngroups)
    di = cfg.d_inner
    proj = xin @ p["in_proj"]
    if hd.group is not None:
        proj = all_gather_cat(proj, hd.group, -1)
    z, xbc, dt = _split_proj(cfg, proj)
    if hd.group is not None:
        step = conv_state.shape[-1]
        xbc = xbc.narrow(-1, dist.get_rank(hd.group) * step, step)
    xbc_conv, conv_new = _step_conv(xbc, p["conv_w"], p["conv_b"], conv_state)
    if hd.group is not None:
        xbc_conv = all_gather_cat(xbc_conv, hd.group, -1)
    xbc_act = F.silu(xbc_conv.float())                         # (B, C) fp32
    x = xbc_act[:, :di].reshape(bsz, nh, hp).narrow(1, hd.start, hd.n)
    bmat = xbc_act[:, di: di + ng * st].reshape(bsz, ng, st)
    cmat = xbc_act[:, di + ng * st:].reshape(bsz, ng, st)
    out, h_new = _step_state(
        cfg, p, xin, h, x, bmat, cmat, dt.narrow(-1, hd.start, hd.n),
        z.narrow(-1, hd.start * hp, hd.n * hp), hd)
    return out, h_new, conv_new


def _ssm_decode_split(cfg, p, xin, h, conv_state, hd: _Heads):
    """One-token step for the split-projection layout (`p` from
    `_split_weights`).  Where the mixer splits, the cached tail (the
    rank's uniform block of [x | B | C]) is gathered and re-cut as the
    streams' blocks, and the new tails are re-laid as the uniform block
    (`_relay_tail`): the tail is small, (B, K - 1, conv_dim)."""
    bsz = xin.shape[0]
    hp, st = cfg.ssm_headdim, cfg.ssm_state
    z = xin @ p["in_z"]
    dt = xin @ p["in_dt"]
    convs = [_step_conv(xin @ p["in_" + s], p[f"conv_{s}_w"],
                        p[f"conv_{s}_b"], c)
             for s, c in zip("xBC", _split_tail(cfg, conv_state, hd))]
    xc, bc, cc = (c for c, _ in convs)
    tails = [t for _, t in convs]
    if hd.group is None:
        conv_new = torch.cat(tails, dim=-1)
    else:
        bc, cc = _gather_parts([bc, cc], hd.group)
        conv_new = _relay_tail(tails, hd)
    x, bmat, cmat = (F.silu(c.float()).reshape(bsz, -1, n)
                     for c, n in zip((xc, bc, cc), (hp, st, st)))
    out, h_new = _step_state(cfg, p, xin, h, x, bmat, cmat, dt, z, hd)
    return out, h_new, conv_new
