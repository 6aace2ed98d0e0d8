"""Whisper-style encoder-decoder backbone (port of `repro.models.encdec`).

The conv audio frontend is a stub: `enc_embeds` arrive precomputed, as in
the reference.  Sinusoidal positions, LayerNorm, GELU MLP, MHA (kv == q
heads).  Decoder layers carry both self-attention (causal, cached at
decode) and cross-attention over the encoder output (its K/V cached once
at prefill, never written at decode).

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

from .attention import attn_schema, causal_attention, decode_attention
from .common import (ParamSpec, Schema, abstract_from_schema, add_norm,
                     apply_norm, axes_from_schema, cross_entropy,
                     embed_schema, embed_tokens, init_from_schema, lm_logits,
                     sinusoid_pos_emb, torch_dtype)
from .lm import layer_params
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
    compute dtype."""
    dtype = torch_dtype(cfg.compute_dtype)
    b, s, d = enc_embeds.shape
    h = (enc_embeds.to(dtype)
         + sinusoid_pos_emb(s, d, device=enc_embeds.device).to(dtype)[None])
    for li in range(cfg.n_enc_layers):
        lp = layer_params(params, li, key="enc_layers")
        a_in = apply_norm(cfg, h, lp, "ln1")
        h = h + causal_attention(cfg, lp, a_in, causal=False)[0]
        m_in = apply_norm(cfg, h, lp, "ln2")
        h = h + mlp_apply(cfg, lp, m_in)
    return apply_norm(cfg, h, params, "enc_final")


def _cross_kv(cfg, lp, enc_out):
    """Project encoder output to one decoder layer's cross K/V."""
    b, s, _ = enc_out.shape
    hd, hkv = cfg.head_dim_, cfg.n_kv_heads
    k = (enc_out @ lp["xwk"]).reshape(b, s, hkv, hd)
    v = (enc_out @ lp["xwv"]).reshape(b, s, hkv, hd)
    if cfg.qkv_bias:
        k = k + lp["xbk"].reshape(hkv, hd)
        v = v + lp["xbv"].reshape(hkv, hd)
    return k, v


def decode_train(cfg, params, tokens, enc_out, collect_cache: bool = False):
    """The decoder over `tokens` (B, S) against `enc_out`: (h after the
    final norm, cache {"k", "v", "xk", "xv"} stacked over layers when
    `collect_cache`, else None)."""
    dtype = torch_dtype(cfg.compute_dtype)
    b, s = tokens.shape
    h = embed_tokens(params, tokens, dtype)
    h = h + sinusoid_pos_emb(s, cfg.d_model,
                             device=tokens.device).to(dtype)[None]
    positions = torch.arange(s, device=tokens.device)[None, :]
    ys = []
    for li in range(cfg.n_layers):
        lp = layer_params(params, li, key="dec_layers")
        a_in = apply_norm(cfg, h, lp, "ln1")
        attn, (k, v) = causal_attention(cfg, lp, a_in, positions)
        h = h + attn
        x_in = apply_norm(cfg, h, lp, "lnx")
        xk, xv = _cross_kv(cfg, lp, enc_out)
        h = h + causal_attention(cfg, lp, x_in, prefix="x", causal=False,
                                 kv_override=(xk, xv))[0]
        m_in = apply_norm(cfg, h, lp, "ln2")
        h = h + mlp_apply(cfg, lp, m_in)
        if collect_cache:
            ys.append((k, v, xk, xv))
    h = apply_norm(cfg, h, params, "final")
    if not collect_cache:
        return h, None
    cache = {name: torch.stack([y[i] for y in ys])
             for i, name in enumerate(("k", "v", "xk", "xv"))}
    return h, cache


def forward_train(cfg, params, batch):
    """((B, S, V) float32 logits of `batch["tokens"]` against the encoded
    `batch["enc_embeds"]`, aux loss 0.0)."""
    enc_out = encode(cfg, params, batch["enc_embeds"])
    h, _ = decode_train(cfg, params, batch["tokens"], enc_out)
    return (lm_logits(cfg, params, h),
            torch.zeros((), dtype=torch.float32, device=h.device))


def loss_fn(cfg, params, batch, aux_weight: float = 0.0):
    """Cross entropy against `batch["targets"]` (no aux term)."""
    logits, _ = forward_train(cfg, params, batch)
    return cross_entropy(logits, batch["targets"], cfg.padded_vocab)


def prefill(cfg, params, batch):
    """Encode `batch["enc_embeds"]` (B, S_enc, D) and run the decoder over
    `batch["tokens"]` (B, S): (last-token logits (B, V) float32, cache
    {"k", "v": (L, B, S, H, hd), "xk", "xv": (L, B, S_enc, H, hd)})."""
    enc_out = encode(cfg, params, batch["enc_embeds"])
    h, cache = decode_train(cfg, params, batch["tokens"], enc_out,
                            collect_cache=True)
    return lm_logits(cfg, params, h[:, -1:, :])[:, 0], cache


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


def decode_step(cfg, params, cache, token, pos):
    """One decode step: (B, 1) token ids at positions `pos` (B,) -> ((B, V)
    float32 logits, cache).  The token's self K/V are written into
    `cache["k"]` / `cache["v"]` in place; the cross K/V are only read."""
    dtype = torch_dtype(cfg.compute_dtype)
    h = embed_tokens(params, token, dtype)
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
                                 cache["v"][li], pos)[0]
        x_in = apply_norm(cfg, h, lp, "lnx")
        h = h + decode_attention(cfg, lp, x_in, cache["xk"][li],
                                 cache["xv"][li], pos, prefix="x",
                                 cross=True)[0]
        m_in = apply_norm(cfg, h, lp, "ln2")
        h = h + mlp_apply(cfg, lp, m_in)
    h = apply_norm(cfg, h, params, "final")
    return lm_logits(cfg, params, h)[:, 0], cache
