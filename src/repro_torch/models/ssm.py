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
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

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


def ssd_chunked(cfg, x, bmat, cmat, dt, a_neg, h0=None):
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
    h = (torch.zeros(b, nh, hp, st, dtype=ct, device=x.device)
         if h0 is None else h0)
    decay_chunk = torch.exp(total)                    # (B,nc,nh)
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


def _mixer_out(cfg, p, xin, y, x, z):
    """The scan's output to the block's: the D skip in float32, the gate
    `silu(z)`, the gated RMSNorm and `out_proj`."""
    bsz, l = xin.shape[:2]
    y = y + p["D_skip"].float()[None, None, :, None] * x.float()
    y = y.reshape(bsz, l, cfg.d_inner).to(xin.dtype)
    y = y * F.silu(z.float()).to(y.dtype)
    y = rmsnorm(y, p["ssm_norm_w"])
    return y @ p["out_proj"]


def _conv_with_state(cfg, stream, w, b, c0):
    """The causal conv of `stream` after the cached tail `c0` (or after
    zeros): (conv output, the new tail of K - 1 positions)."""
    if c0 is not None:
        ctx = torch.cat([c0.to(stream.dtype), stream], dim=1)
        return (_causal_conv(ctx, w, b)[:, c0.shape[1]:],
                ctx[:, -(cfg.conv_kernel - 1):, :])
    return _causal_conv(stream, w, b), stream[:, -(cfg.conv_kernel - 1):, :]


def ssm_apply(cfg, p, xin, h0=None, conv0=None, return_state: bool = False):
    """Full Mamba2 mixer on (B, L, D).  Optionally starts from the state
    (`h0` (B, nh, hp, st) float32, `conv0` (B, K-1, conv_dim)) and returns
    (out, h_final, conv_tail)."""
    if cfg.ssm_split_proj:
        return _ssm_apply_split(cfg, p, xin, h0, conv0, return_state)
    z, xbc, dt = _split_proj(cfg, xin @ p["in_proj"])
    xbc_conv, conv_out = _conv_with_state(cfg, xbc, p["conv_w"], p["conv_b"],
                                          conv0)
    xbc_act = F.silu(xbc_conv.float()).to(xin.dtype)
    x, bmat, cmat = _split_xbc(cfg, xbc_act)
    dt32 = _softplus32(dt.float() + p["dt_bias"].float())
    a_neg = -torch.exp(p["A_log"].float())
    y, h_final = ssd_chunked(cfg, x, bmat, cmat, dt32, a_neg, h0)
    out = _mixer_out(cfg, p, xin, y, x, z)
    if return_state:
        return out, h_final, conv_out
    return out


def _ssm_apply_split(cfg, p, xin, h0, conv0, return_state):
    """Split-projection forward: identical math, one stream each.  The
    conv state is [x | B | C] along channels, as the fused path's xbc, so
    decode caches stay compatible."""
    bsz, l, _ = xin.shape
    di, ng, st = cfg.d_inner, cfg.ssm_ngroups, cfg.ssm_state
    gs = ng * st
    nh, hp = cfg.ssm_nheads, cfg.ssm_headdim
    z = xin @ p["in_z"]
    dt = xin @ p["in_dt"]
    c0 = ((None,) * 3 if conv0 is None else
          (conv0[..., :di], conv0[..., di:di + gs], conv0[..., di + gs:]))
    convs = [_conv_with_state(cfg, xin @ p["in_" + s], p[f"conv_{s}_w"],
                              p[f"conv_{s}_b"], c)
             for s, c in zip("xBC", c0)]
    conv_out = torch.cat([tail for _, tail in convs], dim=-1)
    x, bmat, cmat = (F.silu(c.float()).to(xin.dtype).reshape(bsz, l, -1, n)
                     for (c, _), n in zip(convs, (hp, st, st)))
    dt32 = _softplus32(dt.float() + p["dt_bias"].float())
    a_neg = -torch.exp(p["A_log"].float())
    y, h_final = ssd_chunked(cfg, x, bmat, cmat, dt32, a_neg, h0)
    out = _mixer_out(cfg, p, xin, y, x, z)
    if return_state:
        return out, h_final, conv_out
    return out


def _step_conv(stream, w, b, c0):
    """One token's conv over the cached tail: (B, C) output and the new
    (B, K-1, C) tail, in the stream's dtype."""
    ctx = torch.cat([c0.to(stream.dtype), stream], dim=1)     # (B, K, C)
    out = torch.einsum("bkc,kc->bc", ctx, w.to(ctx.dtype)) + b.to(ctx.dtype)
    return out, ctx[:, 1:, :]


def _step_state(cfg, p, xin, h, x, bmat, cmat, dt, z):
    """The recurrent update and output of one token from float32 x (B, nh,
    hp), B/C (B, ng, st) and the projected dt and z."""
    bsz = xin.shape[0]
    rep = cfg.ssm_nheads // cfg.ssm_ngroups
    bh = torch.repeat_interleave(bmat, rep, dim=1)             # (B, nh, st)
    chh = torch.repeat_interleave(cmat, rep, dim=1)
    dt32 = _softplus32(dt[:, 0, :].float() + p["dt_bias"].float())  # (B, nh)
    a_neg = -torch.exp(p["A_log"].float())
    da = torch.exp(dt32 * a_neg[None, :])
    dtx = x * dt32[..., None]                                  # (B, nh, hp)
    h_new = h * da[..., None, None] + dtx[..., :, None] * bh[:, :, None, :]
    y = torch.einsum("bhpn,bhn->bhp", h_new, chh)
    y = y + p["D_skip"].float()[None, :, None] * x
    y = y.reshape(bsz, 1, cfg.d_inner).to(xin.dtype)
    y = y * F.silu(z.float()).to(y.dtype)
    y = rmsnorm(y, p["ssm_norm_w"])
    return y @ p["out_proj"], h_new


def ssm_decode_step(cfg, p, xin, h, conv_state):
    """One-token recurrent step.

    xin        : (B, 1, D)
    h          : (B, nh, hp, st) fp32
    conv_state : (B, K-1, conv_dim)
    Returns (out (B, 1, D), h_new, conv_new); the caller writes the state.
    """
    if cfg.ssm_split_proj:
        return _ssm_decode_split(cfg, p, xin, h, conv_state)
    bsz = xin.shape[0]
    nh, hp, st, ng = (cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state,
                      cfg.ssm_ngroups)
    di = cfg.d_inner
    z, xbc, dt = _split_proj(cfg, xin @ p["in_proj"])
    xbc_conv, conv_new = _step_conv(xbc, p["conv_w"], p["conv_b"], conv_state)
    xbc_act = F.silu(xbc_conv.float())                         # (B, C) fp32
    x = xbc_act[:, :di].reshape(bsz, nh, hp)
    bmat = xbc_act[:, di: di + ng * st].reshape(bsz, ng, st)
    cmat = xbc_act[:, di + ng * st:].reshape(bsz, ng, st)
    out, h_new = _step_state(cfg, p, xin, h, x, bmat, cmat, dt, z)
    return out, h_new, conv_new


def _ssm_decode_split(cfg, p, xin, h, conv_state):
    """One-token step for the split-projection layout."""
    bsz = xin.shape[0]
    di, ng, st = cfg.d_inner, cfg.ssm_ngroups, cfg.ssm_state
    gs = ng * st
    nh, hp = cfg.ssm_nheads, cfg.ssm_headdim
    z = xin @ p["in_z"]
    dt = xin @ p["in_dt"]
    c0 = (conv_state[..., :di], conv_state[..., di:di + gs],
          conv_state[..., di + gs:])
    convs = [_step_conv(xin @ p["in_" + s], p[f"conv_{s}_w"],
                        p[f"conv_{s}_b"], c) for s, c in zip("xBC", c0)]
    conv_new = torch.cat([tail for _, tail in convs], dim=-1)
    x, bmat, cmat = (F.silu(c.float()).reshape(bsz, -1, n)
                     for (c, _), n in zip(convs, (hp, st, st)))
    out, h_new = _step_state(cfg, p, xin, h, x, bmat, cmat, dt, z)
    return out, h_new, conv_new
