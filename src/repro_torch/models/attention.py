"""GQA attention: chunked-causal for prefill, cache-based for decode.

Port of `repro.models.attention` (self-attention of the decoder family).
The (S x S) score matrix is never materialized whole: queries are
processed in blocks of `cfg.attn_chunk`, as the reference's `lax.scan`
does.  Decode attends one token against the dense KV cache, or, with
`cfg.strap_decode`, against the straps a selector picks
(`decode_attention_gated`).  `prefix=` names a second attention beside
the first (enc-dec's cross-attention, "xwq", ...): `causal_attention`
with `causal=False` and `kv_override=` (the encoder's K/V), and
`decode_attention` with `cross=True` (a static cache, never written).
"""

from __future__ import annotations

import torch

from .common import ParamSpec, Schema, apply_rope

NEG_INF = -1e30


def attn_schema(cfg, layers: int | None = None, prefix: str = "") -> Schema:
    d, hd = cfg.d_model, cfg.head_dim_
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    L = (layers,) if layers is not None else ()
    A = ("layers",) if layers is not None else ()
    s: Schema = {
        prefix + "wq": ParamSpec(L + (d, hq * hd), A + ("dmodel", "qkv"),
                                 "fan_in"),
        prefix + "wk": ParamSpec(L + (d, hkv * hd), A + ("dmodel", "qkv"),
                                 "fan_in"),
        prefix + "wv": ParamSpec(L + (d, hkv * hd), A + ("dmodel", "qkv"),
                                 "fan_in"),
        prefix + "wo": ParamSpec(L + (hq * hd, d), A + ("qkv", "dmodel"),
                                 "fan_in"),
    }
    if cfg.qkv_bias:
        s[prefix + "bq"] = ParamSpec(L + (hq * hd,), A + ("qkv",), "zeros")
        s[prefix + "bk"] = ParamSpec(L + (hkv * hd,), A + ("qkv",), "zeros")
        s[prefix + "bv"] = ParamSpec(L + (hkv * hd,), A + ("qkv",), "zeros")
    return s


def _project_qkv(cfg, p, x, prefix: str = ""):
    b, s, _ = x.shape
    hd, hq, hkv = cfg.head_dim_, cfg.n_heads, cfg.n_kv_heads
    q = x @ p[prefix + "wq"]
    k = x @ p[prefix + "wk"]
    v = x @ p[prefix + "wv"]
    if cfg.qkv_bias:
        q = q + p[prefix + "bq"].to(q.dtype)
        k = k + p[prefix + "bk"].to(k.dtype)
        v = v + p[prefix + "bv"].to(v.dtype)
    return (q.reshape(b, s, hq, hd), k.reshape(b, s, hkv, hd),
            v.reshape(b, s, hkv, hd))


def _gqa_scores(q, k, scale):
    """q: (B,Sq,Hq,hd)  k: (B,Sk,Hkv,hd) -> (B,Hkv,grp,Sq,Sk) fp32."""
    b, sq, hq, hd = q.shape
    hkv = k.shape[2]
    grp = hq // hkv
    qg = q.reshape(b, sq, hkv, grp, hd)
    return torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * scale


def _gqa_out(w, v, out_dtype):
    """w: (B,Hkv,grp,Sq,Sk)  v: (B,Sk,Hkv,hd) -> (B,Sq,Hq,hd)."""
    b, hkv, grp, sq, sk = w.shape
    hd = v.shape[-1]
    o = torch.einsum("bhgqk,bkhd->bqhgd", w, v.float())
    return o.reshape(b, sq, hkv * grp, hd).to(out_dtype)


def _attend_block(q, k, v, scale, q_pos, k_pos, out_dtype, causal):
    logits = _gqa_scores(q, k, scale)
    if causal:
        mask = q_pos[:, None] >= k_pos[None, :]
        logits = torch.where(mask[None, None, None], logits, NEG_INF)
    return _gqa_out(torch.softmax(logits, dim=-1), v, out_dtype)


def causal_attention(cfg, p, x, positions=None, prefix: str = "",
                     causal: bool = True, kv_override=None):
    """Chunked (causal) attention for prefill.

    x: (B, S, D).  Returns (out (B,S,D), (k, v)) — the cache material.
    Query blocks of `cfg.attn_chunk`; a length that is not a multiple of
    the chunk is attended in one block, as in the reference.  With
    `kv_override=(k, v)` (cross-attention) the projected K/V are replaced
    and no RoPE is applied; `causal=False` drops the mask.
    """
    b, s, _ = x.shape
    hd = cfg.head_dim_
    scale = hd ** -0.5
    q, k, v = _project_qkv(cfg, p, x, prefix)
    if kv_override is not None:                 # cross-attention path
        k, v = kv_override
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    if cfg.rope_theta > 0 and kv_override is None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)

    chunk = min(cfg.attn_chunk, s)
    if s % chunk:
        chunk = s                     # non-divisible (odd test lengths): full
    k_pos = torch.arange(k.shape[1], device=x.device)
    q_pos = positions[0]
    out = torch.cat([
        _attend_block(q[:, i:i + chunk], k, v, scale, q_pos[i:i + chunk],
                      k_pos, x.dtype, causal)
        for i in range(0, s, chunk)], dim=1)
    o = out.reshape(b, s, -1)
    return o @ p[prefix + "wo"], (k, v)


def decode_attention(cfg, p, x, k_cache, v_cache, pos, prefix: str = "",
                     cross: bool = False):
    """One-token attention against the cache.

    x: (B, 1, D); k_cache/v_cache: (B, S, Hkv, hd); pos: (B,) current index.
    Returns (out (B,1,D), k_cache, v_cache).  The new token is written into
    the caches IN PLACE at `pos` (the reference rewrites the whole cache
    through a one-hot blend, `k * (1 - onehot) + onehot * k_new`, and
    returns new arrays; for finite values both give the same numbers).
    With `cross=True` (the encoder's K/V) every cached position is valid,
    the cache is not written and the return is (out, None, None).
    """
    b = x.shape[0]
    hd = cfg.head_dim_
    scale = hd ** -0.5
    q, k_new, v_new = _project_qkv(cfg, p, x, prefix)
    s_cache = k_cache.shape[1]
    if cross:
        valid = torch.ones((b, s_cache), dtype=torch.bool, device=x.device)
    else:
        if cfg.rope_theta > 0:
            q = apply_rope(q, pos[:, None], cfg.rope_theta)
            k_new = apply_rope(k_new, pos[:, None], cfg.rope_theta)
        rows = torch.arange(b, device=x.device)
        idx = pos.long()
        k_cache[rows, idx] = k_new[:, 0].to(k_cache.dtype)
        v_cache[rows, idx] = v_new[:, 0].to(v_cache.dtype)
        valid = (torch.arange(s_cache, device=x.device)[None, :]
                 <= pos[:, None])

    logits = _gqa_scores(q, k_cache, scale)[..., 0, :]      # (B,Hkv,grp,S)
    logits = torch.where(valid[:, None, None, :], logits, NEG_INF)
    w = torch.softmax(logits, dim=-1)
    o = torch.einsum("bhgk,bkhd->bhgd", w, v_cache.float())
    o = o.reshape(b, 1, -1).to(x.dtype)
    out = o @ p[prefix + "wo"]
    if cross:
        return out, None, None
    return out, k_cache, v_cache


def decode_attention_gated(cfg, p, x, k_cache, v_cache, ksum, pos):
    """Selector+strap gated decode (the paper's technique in the model).

    The KV cache is viewed as straps of `cfg.decode_strap_tokens` tokens.
    A selector scores straps with the running per-strap key sum (`ksum`),
    gathers only the top `cfg.decode_top_straps` straps (the newest always
    included), and attends over that subset.

    x: (B, 1, D); k_cache/v_cache: (B, S, Hkv, hd) with S a multiple of
    the strap; ksum: (B, n_straps, Hkv, hd) float32; pos: (B,).  Returns
    (out (B,1,D), k_cache, v_cache, ksum).  The new token's K/V and its
    key's float32 add to the newest strap's sum are written IN PLACE (the
    reference returns new arrays: a vmapped dynamic_update_slice and a
    one-hot blend, `ksum + onehot * k`, which for finite keys add 0 to
    every other strap and give the same numbers).
    """
    b = x.shape[0]
    hd = cfg.head_dim_
    scale = hd ** -0.5
    T = cfg.decode_strap_tokens
    q, k_new, v_new = _project_qkv(cfg, p, x)
    if cfg.rope_theta > 0:
        q = apply_rope(q, pos[:, None], cfg.rope_theta)
        k_new = apply_rope(k_new, pos[:, None], cfg.rope_theta)

    s_cache = k_cache.shape[1]
    if s_cache % T:
        raise ValueError(f"cache of {s_cache} tokens is not a multiple of "
                         f"decode_strap_tokens={T}")
    nst = s_cache // T

    # ---- write the new token (one row of one page) and its key sum ------
    rows = torch.arange(b, device=x.device)
    idx = pos.long()
    k_cache[rows, idx] = k_new[:, 0].to(k_cache.dtype)
    v_cache[rows, idx] = v_new[:, 0].to(v_cache.dtype)
    strap_idx = idx // T
    ksum[rows, strap_idx] += k_new[:, 0].float()

    # ---- selector: score straps by aggregated q . ksum ------------------
    hkv = k_cache.shape[2]
    grp = q.shape[2] // hkv
    qg = q.reshape(b, hkv, grp, hd).float()
    scores = torch.einsum("bhgd,bnhd->bn", qg, ksum)
    base = torch.arange(nst, device=x.device) * T
    valid = base[None, :] <= pos[:, None]
    scores = torch.where(valid, scores, float("-inf"))
    scores = scores + 1e30 * torch.nn.functional.one_hot(
        strap_idx, nst).float()                               # keep newest
    k_sel = min(cfg.decode_top_straps, nst)
    # where k_sel exceeds the valid straps, some picks score -inf; every
    # token of such a strap lies past `pos` and is masked by tok_valid
    _, ids = torch.topk(scores, k_sel, dim=-1)                # (B, K)

    # ---- gather ONLY the selected straps ---------------------------------
    kr = k_cache.reshape(b, nst, T, hkv, hd)
    vr = v_cache.reshape(b, nst, T, hkv, hd)
    k_g = kr[rows[:, None], ids].reshape(b, k_sel * T, hkv, hd)
    v_g = vr[rows[:, None], ids].reshape(b, k_sel * T, hkv, hd)
    gpos = (ids[:, :, None] * T
            + torch.arange(T, device=x.device)[None, None, :]).reshape(
                b, k_sel * T)
    tok_valid = gpos <= pos[:, None]

    logits = _gqa_scores(q, k_g, scale)[..., 0, :]           # (B,Hkv,grp,K*T)
    logits = torch.where(tok_valid[:, None, None, :], logits, NEG_INF)
    w = torch.softmax(logits, dim=-1)
    o = torch.einsum("bhgk,bkhd->bhgd", w, v_g.float())
    o = o.reshape(b, 1, -1).to(x.dtype)
    return o @ p["wo"], k_cache, v_cache, ksum
