"""Whisper-style encoder-decoder backbone (port of `repro.models.encdec`).

The conv audio frontend is a stub: `enc_embeds` arrive precomputed, as in
the reference.  Sinusoidal positions, LayerNorm, GELU MLP, MHA (kv == q
heads).  Decoder layers carry both self-attention (causal, cached at
decode) and cross-attention over the encoder output (its K/V cached once
at prefill, never written at decode).

Under a registered mesh (the sharded steps of `train.step`) every layer
computes on the "model" blocks it is given, as the decoder-only
families' do (`distributed.tensor_parallel`): the heads of the self and
cross attention, the MLP's "ff" columns, the vocab-parallel embedding,
head and loss; the serve steps' self and cross caches are the rank's
blocks of positions.

Public entry points (functions of (cfg, params, ...)):
  init_params     -> params on the requested device
  encode          -> (B, S_enc, D) encoder output
  forward_train   -> (logits, aux_loss = 0.0)
  loss_fn         -> scalar loss
  prefill         -> (last_logits, cache {"k", "v", "xk", "xv"})
  decode_step     -> (logits, cache), "k"/"v" updated in place
  cache_schema    -> Schema of the decode cache (shapes + logical axes)
"""

from __future__ import annotations

import torch

from ..distributed import tensor_parallel as tp
from .attention import (_heads, _project, attn_schema, causal_attention,
                        decode_attention)
from .common import (ParamSpec, Schema, abstract_from_schema, add_norm,
                     apply_norm, axes_from_schema, cross_entropy,
                     embed_schema, embed_tokens, init_from_schema,
                     sinusoid_pos_emb, torch_dtype)
from .lm import _head, _vocab_group, layer_params
from .mlp import mlp_apply, mlp_schema


def _enc_layer_schema(cfg) -> Schema:
    s: Schema = {}
    add_norm(s, cfg, "ln1", cfg.d_model, cfg.n_enc_layers)
    s.update(attn_schema(cfg, cfg.n_enc_layers))
    add_norm(s, cfg, "ln2", cfg.d_model, cfg.n_enc_layers)
    s.update(mlp_schema(cfg, cfg.n_enc_layers))
    return s


def _dec_layer_schema(cfg) -> Schema:
    s: Schema = {}
    add_norm(s, cfg, "ln1", cfg.d_model, cfg.n_layers)
    s.update(attn_schema(cfg, cfg.n_layers))
    add_norm(s, cfg, "lnx", cfg.d_model, cfg.n_layers)
    s.update(attn_schema(cfg, cfg.n_layers, prefix="x"))
    add_norm(s, cfg, "ln2", cfg.d_model, cfg.n_layers)
    s.update(mlp_schema(cfg, cfg.n_layers))
    return s


def encdec_schema(cfg) -> Schema:
    s = embed_schema(cfg)
    s["enc_layers"] = _enc_layer_schema(cfg)
    s["dec_layers"] = _dec_layer_schema(cfg)
    add_norm(s, cfg, "enc_final", cfg.d_model)
    return s


def init_params(cfg, generator: torch.Generator, device="cuda") -> dict:
    """Parameters from `generator` on `device` (default "cuda"), in the
    config's `param_dtype`."""
    return init_from_schema(encdec_schema(cfg), generator,
                            torch_dtype(cfg.param_dtype), device)


def param_axes(cfg):
    return axes_from_schema(encdec_schema(cfg))


def abstract_params(cfg):
    return abstract_from_schema(encdec_schema(cfg),
                                torch_dtype(cfg.param_dtype))


# ---------------------------------------------------------------------------

def encode(cfg, params, enc_embeds):
    """(B, S_enc, D) frame embeddings -> the encoder's output, in the
    compute dtype; under a mesh each layer computes on the rank's heads
    and "ff" columns (`distributed.tensor_parallel`), the output whole
    on every "model" rank."""
    dtype = torch_dtype(cfg.compute_dtype)
    st = tp.stream(cfg)
    b, s, d = enc_embeds.shape
    h = (enc_embeds.to(dtype)
         + sinusoid_pos_emb(s, d, device=enc_embeds.device).to(dtype)[None])
    for li in range(cfg.n_enc_layers):
        lp = layer_params(params, li, key="enc_layers")
        a_in = apply_norm(cfg, h, lp, "ln1")
        h = h + causal_attention(cfg, lp, a_in, causal=False, st=st)[0]
        m_in = apply_norm(cfg, h, lp, "ln2")
        h = h + mlp_apply(cfg, lp, m_in, st=st)
    return apply_norm(cfg, h, params, "enc_final")


def _cross_kv(cfg, lp, enc_out):
    """Project encoder output to one decoder layer's cross K/V: (B, S_enc,
    Hkv, hd) each, or, where `lp` holds the rank's columns of xwk / xwv,
    those columns (B, S_enc, C), not always whole heads
    (`attention._attention_split` gathers them where the heads do not
    split)."""
    k, v = _project(cfg, lp, enc_out, "x", "kv")
    if tp.block_group(lp["xwk"], cfg.n_kv_heads * cfg.head_dim_, -1):
        return k, v
    return _heads(k, cfg.head_dim_), _heads(v, cfg.head_dim_)


def decode_train(cfg, params, tokens, enc_out, collect_cache: bool = False,
                 cache_split: tp.CacheSplit = tp.NO_SPLIT):
    """The decoder over `tokens` (B, S) against `enc_out`: (h after the
    final norm, cache {"k", "v", "xk", "xv"} stacked over layers when
    `collect_cache`, else None).  Under a mesh the layers compute on the
    rank's blocks; `enc_out`, whole on every "model" rank, is projected
    by each rank's cross columns, so its gradient is summed over "model"
    (once, for every layer); the cache holds the rank's blocks of a
    cache laid out by `cache_split` (the cross K/V the encoder's
    positions, not padded: every cached position is attended)."""
    dtype = torch_dtype(cfg.compute_dtype)
    st = tp.stream(cfg)
    b, s = tokens.shape
    h = embed_tokens(params, tokens, dtype, _vocab_group(cfg, params))
    h = h + sinusoid_pos_emb(s, cfg.d_model,
                             device=tokens.device).to(dtype)[None]
    positions = torch.arange(s, device=tokens.device)[None, :]
    group = tp.block_group(params["dec_layers"]["xwk"],
                           cfg.n_kv_heads * cfg.head_dim_, -1)
    if group is not None:
        enc_out = tp.enter(enc_out, group, st)
    cross_split = cache_split._replace(length=None)
    ys = []
    for li in range(cfg.n_layers):
        lp = layer_params(params, li, key="dec_layers")
        a_in = apply_norm(cfg, h, lp, "ln1")
        attn, (k, v) = causal_attention(cfg, lp, a_in, positions, st=st)
        h = h + attn
        x_in = apply_norm(cfg, h, lp, "lnx")
        xattn, (xk, xv) = causal_attention(
            cfg, lp, x_in, prefix="x", causal=False,
            kv_override=_cross_kv(cfg, lp, enc_out), st=st)
        h = h + xattn
        m_in = apply_norm(cfg, h, lp, "ln2")
        h = h + mlp_apply(cfg, lp, m_in, st=st)
        if collect_cache:
            hkv = cfg.n_kv_heads
            ys.append((tp.to_cache_block(k, hkv, cache_split),
                       tp.to_cache_block(v, hkv, cache_split),
                       tp.to_cache_block(xk, hkv, cross_split),
                       tp.to_cache_block(xv, hkv, cross_split)))
    h = apply_norm(cfg, h, params, "final")
    if not collect_cache:
        return h, None
    cache = {name: torch.stack([y[i] for y in ys])
             for i, name in enumerate(("k", "v", "xk", "xv"))}
    return h, cache


def forward_train(cfg, params, batch):
    """((B, S, V) float32 logits of `batch["tokens"]` against the encoded
    `batch["enc_embeds"]`, aux loss 0.0).  Under a mesh that splits the
    head over "model" the logits are the rank's vocab block."""
    enc_out = encode(cfg, params, batch["enc_embeds"])
    h, _ = decode_train(cfg, params, batch["tokens"], enc_out)
    return (_head(cfg, params, h),
            torch.zeros((), dtype=torch.float32, device=h.device))


def loss_fn(cfg, params, batch, aux_weight: float = 0.0):
    """Cross entropy against `batch["targets"]` (no aux term),
    vocab-parallel where the head is split."""
    logits, _ = forward_train(cfg, params, batch)
    return cross_entropy(logits, batch["targets"], cfg.padded_vocab,
                         _vocab_group(cfg, params))


def prefill(cfg, params, batch, cache_split: tp.CacheSplit = tp.NO_SPLIT):
    """Encode `batch["enc_embeds"]` (B, S_enc, D) and run the decoder over
    `batch["tokens"]` (B, S): (last-token logits (B, V) float32 (the
    rank's vocab block where the head is split), cache {"k", "v": (L, B,
    S, H, hd), "xk", "xv": (L, B, S_enc, H, hd)}).  Under a mesh the
    cache holds the rank's blocks of a cache laid out by `cache_split`
    (`tensor_parallel.cache_split`): the self K/V padded to its length,
    the cross K/V as the encoder gave them, which must then fill the
    cache's cross positions exactly (the reference pads no cross cache,
    and `decode_attention(cross=True)` attends every cached position)."""
    s_enc = batch["enc_embeds"].shape[1]
    if cache_split.length is not None and s_enc != cache_split.length:
        raise ValueError(f"{cfg.name}: the cache holds {cache_split.length} "
                         f"cross positions, the encoder gave {s_enc}")
    enc_out = encode(cfg, params, batch["enc_embeds"])
    h, cache = decode_train(cfg, params, batch["tokens"], enc_out,
                            collect_cache=True, cache_split=cache_split)
    return _head(cfg, params, h[:, -1:, :])[:, 0], cache


def cache_schema(cfg, batch: int, seq: int) -> Schema:
    """The decoder's self K/V of `seq` positions and the cross K/V; the
    encoder length is `seq` too (the registry passes half the cell's)."""
    hd, hkv = cfg.head_dim_, cfg.n_kv_heads
    s_enc = seq                                  # encoder length == cell seq/2
    kv_axes = ("layers", "batch", "seq", "kv", None)
    return {
        "k": ParamSpec((cfg.n_layers, batch, seq, hkv, hd), kv_axes, "zeros"),
        "v": ParamSpec((cfg.n_layers, batch, seq, hkv, hd), kv_axes, "zeros"),
        "xk": ParamSpec((cfg.n_layers, batch, s_enc, hkv, hd), kv_axes, "zeros"),
        "xv": ParamSpec((cfg.n_layers, batch, s_enc, hkv, hd), kv_axes, "zeros"),
    }


def decode_step(cfg, params, cache, token, pos,
                cache_split: tp.CacheSplit = tp.NO_SPLIT):
    """One decode step: (B, 1) token ids at positions `pos` (B,) -> ((B, V)
    float32 logits, cache).  The token's self K/V are written into
    `cache["k"]` / `cache["v"]` in place; the cross K/V are only read.
    `cache_split`: how a sharded serve step laid the cache (the rank's
    block of the self and cross positions, or whole)."""
    dtype = torch_dtype(cfg.compute_dtype)
    h = embed_tokens(params, token, dtype, _vocab_group(cfg, params))
    # per-sequence sinusoidal position for the new token
    d = cfg.d_model
    inv = 1e4 ** (-torch.arange(0, d, 2, dtype=torch.float32,
                                device=token.device) / d)
    ang = pos[:, None].float() * inv[None, :]
    pe = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
    h = h + pe[:, None, :].to(dtype)
    for li in range(cfg.n_layers):
        lp = layer_params(params, li, key="dec_layers")
        a_in = apply_norm(cfg, h, lp, "ln1")
        h = h + decode_attention(cfg, lp, a_in, cache["k"][li],
                                 cache["v"][li], pos, split=cache_split)[0]
        x_in = apply_norm(cfg, h, lp, "lnx")
        h = h + decode_attention(cfg, lp, x_in, cache["xk"][li],
                                 cache["xv"][li], pos, prefix="x",
                                 cross=True, split=cache_split)[0]
        m_in = apply_norm(cfg, h, lp, "ln2")
        h = h + mlp_apply(cfg, lp, m_in)
    h = apply_norm(cfg, h, params, "final")
    return _head(cfg, params, h)[:, 0], cache
