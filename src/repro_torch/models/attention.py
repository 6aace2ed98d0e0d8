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

import contextlib

import torch
import torch.distributed as dist

from ..distributed import tensor_parallel as tp
from ..distributed.collectives import (all_gather_cat, all_reduce,
                                       gather_dim, gather_replicated,
                                       own_block)
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


def _project(cfg, p, x, prefix: str = "", names: str = "qkv") -> list:
    """x (B, S, D) projected by w<n> for each n of `names`, plus b<n> where
    `cfg.qkv_bias`: flat (B, S, C), C the rank's columns when `p` holds
    its "model" blocks."""
    out = []
    for n in names:
        t = x @ p[prefix + "w" + n]
        if cfg.qkv_bias:
            t = t + p[prefix + "b" + n].to(t.dtype)
        out.append(t)
    return out


def _heads(t, hd: int):
    b, s, c = t.shape
    return t.reshape(b, s, c // hd, hd)


def _project_q(cfg, p, x, prefix: str = ""):
    return _heads(_project(cfg, p, x, prefix, "q")[0], cfg.head_dim_)


def _project_qkv(cfg, p, x, prefix: str = ""):
    return tuple(_heads(t, cfg.head_dim_) for t in _project(cfg, p, x, prefix))


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


def _attend_chunks(cfg, q, k, v, positions, out_dtype, causal):
    """Query blocks of `cfg.attn_chunk` against the whole K/V: (B, S,
    Hq * hd).  A length that is not a multiple of the chunk is attended
    in one block, as in the reference."""
    b, s = q.shape[:2]
    scale = cfg.head_dim_ ** -0.5
    chunk = min(cfg.attn_chunk, s)
    if s % chunk:
        chunk = s                     # non-divisible (odd test lengths): full
    k_pos = torch.arange(k.shape[1], device=q.device)
    q_pos = positions[0]
    out = torch.cat([
        _attend_block(q[:, i:i + chunk], k, v, scale, q_pos[i:i + chunk],
                      k_pos, out_dtype, causal)
        for i in range(0, s, chunk)], dim=1)
    return out.reshape(b, s, -1)


def causal_attention(cfg, p, x, positions=None, prefix: str = "",
                     causal: bool = True, kv_override=None,
                     st: tp.Stream = tp.WHOLE):
    """Chunked (causal) attention for prefill.

    x: (B, S, D), the residual stream as `st` holds it.  Returns (out,
    (k, v)): out as `st` holds the stream; (k, v) the cache material,
    (B, S, Hkv, hd), or the rank's block of the heads when the heads
    split over "model" (`_attention_split`).  Query blocks of
    `cfg.attn_chunk`.  With `kv_override=(k, v)` (cross-attention: the
    encoder's K/V as heads (B, S_enc, Hkv, hd) or, under a mesh, as the
    rank's columns of the cross projection (B, S_enc, C)) the projected
    K/V are replaced and no RoPE is applied; `causal=False` drops the
    mask.
    """
    group = tp.block_group(p[prefix + "wq"], cfg.n_heads * cfg.head_dim_, -1)
    if group is not None:
        return _attention_split(cfg, p, x, positions, prefix, causal, st,
                                group, kv_override)
    x = tp.enter_whole(x, st)
    s = x.shape[1]
    if kv_override is not None:                 # cross-attention path
        # only the query is projected: the reference's K/V projections of
        # x here are dead code that XLA drops
        q, (k, v) = _project_q(cfg, p, x, prefix), kv_override
    else:
        q, k, v = _project_qkv(cfg, p, x, prefix)
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    if cfg.rope_theta > 0 and kv_override is None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    o = _attend_chunks(cfg, q, k, v, positions, x.dtype, causal)
    return tp.leave_whole(o @ p[prefix + "wo"], st), (k, v)


def _attention_split(cfg, p, x, positions, prefix, causal, st, group,
                     kv_override=None):
    """`causal_attention` on the rank's "model" blocks: the columns of
    wq / wk / wv (and their biases) and the rows of wo.

    A projection whose heads split over "model" at head boundaries stays
    the rank's heads; one that does not (K/V at 16 ranks for 8 KV heads,
    Qwen2-1.5B's 12 query heads, Whisper-tiny's 6) is all-gathered over
    "model" before attending, where the reference's `constrain` gives up
    on the split too.  With the query heads split the rank attends them
    against the K/V heads they read (a gathered K/V is used in part, so
    its gradient comes back summed, `gather_dim`); with the query
    gathered every rank attends every head and keeps its block of the
    output columns.  wo's partial products are summed over "model"
    (`tp.leave`).  Cross-attention (`kv_override`) projects only the
    query and takes the K/V as the rank's columns of the cross
    projection (or as the rank's heads), split or gathered as the self
    K/V are."""
    hd, hq, hkv = cfg.head_dim_, cfg.n_heads, cfg.n_kv_heads
    m, r = dist.get_world_size(group), dist.get_rank(group)
    x = tp.enter(x, group, st)
    s = x.shape[1]
    if kv_override is None:
        q, k, v = _project(cfg, p, x, prefix)
    else:
        q = _project(cfg, p, x, prefix, "q")[0]
        k, v = (t.flatten(2) for t in kv_override)
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    q_split, kv_split = hq % m == 0, hkv % m == 0
    if q_split:
        q = _heads(q, hd)
        if not kv_split:
            k, v = gather_dim(k, group, -1), gather_dim(v, group, -1)
    else:
        q = _heads(gather_replicated(q, group, -1), hd)
        k, v = gather_replicated(k, group, -1), gather_replicated(v, group, -1)
    k, v = _heads(k, hd), _heads(v, hd)
    if cfg.rope_theta > 0 and kv_override is None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    ka, va = k, v
    if q_split and not kv_split:
        ka, va = _kv_for_heads(k, r * (hq // m), hq // m, hq // hkv), \
            _kv_for_heads(v, r * (hq // m), hq // m, hq // hkv)
    o = _attend_chunks(cfg, q, ka, va, positions, x.dtype, causal)
    if not q_split:
        o = own_block(o, group, -1)
    return tp.leave(o @ p[prefix + "wo"], group, st), (k, v)


def _kv_for_heads(kv, q0: int, nq: int, grp: int):
    """The K or V heads (B, S, Hkv, hd) that query heads q0 .. q0 + nq - 1
    read (query head h reads KV head h // grp), laid out so that
    `_gqa_scores` pairs them: a contiguous range where the rank's query
    heads cover whole groups or sit in one, else one per query head."""
    if nq % grp == 0:
        return kv[:, :, q0 // grp: q0 // grp + nq // grp]
    if grp % nq == 0:
        return kv[:, :, q0 // grp: q0 // grp + 1]
    idx = torch.arange(q0, q0 + nq, device=kv.device) // grp
    return kv.index_select(2, idx)


def decode_attention(cfg, p, x, k_cache, v_cache, pos, prefix: str = "",
                     cross: bool = False, split: tp.CacheSplit = tp.NO_SPLIT):
    """One-token attention against the cache.

    x: (B, 1, D); k_cache/v_cache: (B, S, Hkv, hd); pos: (B,) current index.
    Returns (out (B,1,D), k_cache, v_cache).  The new token is written into
    the caches IN PLACE at `pos` (the reference rewrites the whole cache
    through a one-hot blend, `k * (1 - onehot) + onehot * k_new`, and
    returns new arrays; for finite values both give the same numbers).
    With `cross=True` (the encoder's K/V) every cached position is valid,
    the cache is not written and the return is (out, None, None).

    Under a mesh (inference only: these collectives carry no gradient):
    with the attention's "model" blocks (`tp.block_group`) the rank
    projects its columns, gathers q (and the new K/V) over "model", and
    sums wo's partial products; with the cache's sequence split
    (`split`, `tensor_parallel.cache_split`; the cross cache's too) the
    cache is the rank's block of positions, the new token is written by
    the rank that owns `pos`, and the partial softmax of each rank (its
    max, its sum of exponentials, its weighted V) is combined over the
    split axes (flash-decoding).
    """
    b = x.shape[0]
    hd = cfg.head_dim_
    scale = hd ** -0.5
    s_cache = k_cache.shape[1]
    group = tp.block_group(p[prefix + "wq"], cfg.n_heads * hd, -1)
    seq_groups, blk, _ = tp.cache_blocks(split)
    # the encoder's K/V are cached: cross-attention projects only q
    ts = _project(cfg, p, x, prefix, "q" if cross else "qkv")
    if group is not None:       # every head: the rank's columns gathered
        ts = _gather_columns(ts, group)
    q, *new = (_heads(t, hd) for t in ts)
    if cross:
        valid = torch.ones((b, s_cache), dtype=torch.bool, device=x.device)
    else:
        k_new, v_new = new
        if cfg.rope_theta > 0:
            q = apply_rope(q, pos[:, None], cfg.rope_theta)
            k_new = apply_rope(k_new, pos[:, None], cfg.rope_theta)
        s0 = blk * s_cache
        rows = torch.arange(b, device=x.device)
        idx = pos.long() - s0
        k_new, v_new = k_new[:, 0].to(k_cache.dtype), v_new[:, 0].to(
            v_cache.dtype)
        if seq_groups:          # only the rank that owns `pos` writes
            own = ((idx >= 0) & (idx < s_cache))[:, None, None]
            idx = idx.clamp(0, s_cache - 1)
            k_new = torch.where(own, k_new, k_cache[rows, idx])
            v_new = torch.where(own, v_new, v_cache[rows, idx])
        k_cache[rows, idx] = k_new
        v_cache[rows, idx] = v_new
        valid = (s0 + torch.arange(s_cache, device=x.device)[None, :]
                 <= pos[:, None])

    logits = _gqa_scores(q, k_cache, scale)[..., 0, :]      # (B,Hkv,grp,S)
    logits = torch.where(valid[:, None, None, :], logits, NEG_INF)
    if seq_groups:
        o = _combined_softmax_v(logits, v_cache, seq_groups)
    else:
        w = torch.softmax(logits, dim=-1)
        o = torch.einsum("bhgk,bkhd->bhgd", w, v_cache.float())
    o = o.reshape(b, 1, -1).to(x.dtype)
    out = _out_rows(o, p[prefix + "wo"], group)
    if cross:
        return out, None, None
    return out, k_cache, v_cache


def _gather_columns(ts, group) -> list:
    """The rank's column blocks of one token's projections -> the whole
    projections, in one all-gather over `group` of their concatenation
    (inference only)."""
    widths = [t.shape[-1] for t in ts]
    whole = all_gather_cat(torch.cat(ts, -1), group, -1)
    per_rank = whole.reshape(*whole.shape[:-1], -1, sum(widths))
    return [t.flatten(-2) for t in per_rank.split(widths, -1)]


def _out_rows(o, wo, group, own: bool = False):
    """o (B, 1, Hq * hd) through wo: whole, or under the "model" `group`
    the rank's rows of wo on its block of o's columns (`own`: o is that
    block already), the partial products summed over "model"."""
    if group is None:
        return o @ wo
    if not own:
        rows = wo.shape[0]
        o = o[..., dist.get_rank(group) * rows:][..., :rows]
    return all_reduce(o @ wo, group)


def _combined_softmax_v(logits, v, groups):
    """softmax(logits) @ V over positions split across `groups`: each
    rank's max, sum of exponentials and exp-weighted V over its block,
    rescaled to the global max and summed.  logits (B, Hkv, grp, S_rank)
    float32 (masked positions at NEG_INF; position 0 is valid on the
    first block, so the global max is finite), v (B, S_rank, Hkv, hd).
    -> (B, Hkv, grp, hd) float32."""
    top = torch.amax(logits, dim=-1, keepdim=True)
    for g in groups:
        top = all_reduce(top, g, dist.ReduceOp.MAX)
    e = torch.exp(logits - top)
    den = torch.sum(e, dim=-1, keepdim=True)
    num = torch.einsum("bhgk,bkhd->bhgd", e, v.float())
    both = torch.cat([num, den], dim=-1)
    for g in groups:
        both = all_reduce(both, g)
    return both[..., :-1] / both[..., -1:]


_selections: list | None = None


@contextlib.contextmanager
def recording_selections():
    """Within the block every `decode_attention_gated` call appends its
    selection to the list yielded: (strap ids (B, K) int64, the
    selector's scores (B, n_straps) float32, the newest strap's bonus
    included), on the CPU, in call order."""
    global _selections
    prev, _selections = _selections, []
    try:
        yield _selections
    finally:
        _selections = prev


def decode_attention_gated(cfg, p, x, k_cache, v_cache, ksum, pos,
                           split: tp.CacheSplit = tp.NO_SPLIT):
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

    Under a mesh that gives the rank its columns of the projections
    (`tp.block_group`; inference only) the caches are the rank's blocks
    along `split.gated_dim`, the sequence whole on every rank:
      * "kv": the rank projects its heads (whole) and attends them against
        its KV heads; the selector's per-strap scores, a sum over every
        head, are its partial sums, summed over "model" so that every rank
        takes the same top-k; wo's rows are its heads, the output summed;
      * "headdim" (the KV heads do not divide the ranks): q and the new
        K/V are gathered over "model" (RoPE needs the whole head) and cut
        to the rank's block of `head_dim`; the selector's scores and the
        attention logits are partial dot products over `head_dim`, each
        summed over "model" before the top-k and the softmax; w . v gives
        the rank's block of every head's output, gathered, and wo's rows
        take the rank's block of it, the output summed;
      * None (whole cache): every rank decodes every head on the gathered
        q / K / V and keeps its block of the output for wo's rows.
    The summed scores add in another order than the whole einsum, so a
    near-tie between the k-th and (k+1)-th strap may pick another strap.
    """
    b = x.shape[0]
    hd = cfg.head_dim_
    scale = hd ** -0.5
    T = cfg.decode_strap_tokens
    group = tp.block_group(p["wq"], cfg.n_heads * hd, -1)
    dim = split.gated_dim if group is not None else None
    ts = _project(cfg, p, x)
    if group is not None and dim != "kv":   # the rank's columns gathered
        ts = _gather_columns(ts, group)
    q, k_new, v_new = (_heads(t, hd) for t in ts)
    if cfg.rope_theta > 0:
        q = apply_rope(q, pos[:, None], cfg.rope_theta)
        k_new = apply_rope(k_new, pos[:, None], cfg.rope_theta)
    if dim == "headdim":
        d = hd // dist.get_world_size(group)
        q, k_new, v_new = (t.narrow(-1, dist.get_rank(group) * d, d)
                           for t in (q, k_new, v_new))

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
    hkv, dk = k_cache.shape[2], k_cache.shape[3]
    grp = q.shape[2] // hkv
    qg = q.reshape(b, hkv, grp, dk).float()
    scores = torch.einsum("bhgd,bnhd->bn", qg, ksum)
    if dim is not None:
        scores = all_reduce(scores, group)
    base = torch.arange(nst, device=x.device) * T
    valid = base[None, :] <= pos[:, None]
    scores = torch.where(valid, scores, float("-inf"))
    scores = scores + 1e30 * torch.nn.functional.one_hot(
        strap_idx, nst).float()                               # keep newest
    k_sel = min(cfg.decode_top_straps, nst)
    # where k_sel exceeds the valid straps, some picks score -inf; every
    # token of such a strap lies past `pos` and is masked by tok_valid
    _, ids = torch.topk(scores, k_sel, dim=-1)                # (B, K)
    if _selections is not None:
        _selections.append((ids.cpu(), scores.cpu()))

    # ---- gather ONLY the selected straps ---------------------------------
    kr = k_cache.reshape(b, nst, T, hkv, dk)
    vr = v_cache.reshape(b, nst, T, hkv, dk)
    k_g = kr[rows[:, None], ids].reshape(b, k_sel * T, hkv, dk)
    v_g = vr[rows[:, None], ids].reshape(b, k_sel * T, hkv, dk)
    gpos = (ids[:, :, None] * T
            + torch.arange(T, device=x.device)[None, None, :]).reshape(
                b, k_sel * T)
    tok_valid = gpos <= pos[:, None]

    logits = _gqa_scores(q, k_g, scale)[..., 0, :]           # (B,Hkv,grp,K*T)
    if dim == "headdim":
        logits = all_reduce(logits, group)
    logits = torch.where(tok_valid[:, None, None, :], logits, NEG_INF)
    w = torch.softmax(logits, dim=-1)
    o = torch.einsum("bhgk,bkhd->bhgd", w, v_g.float())
    if dim == "headdim":
        o = all_gather_cat(o.contiguous(), group, -1)
    o = o.reshape(b, 1, -1).to(x.dtype)
    out = _out_rows(o, p["wo"], group, own=dim == "kv")
    return out, k_cache, v_cache, ksum
