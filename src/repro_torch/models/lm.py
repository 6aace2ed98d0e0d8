"""Decoder-only LM of the attention families: schema, prefill and decode.

Port of the dense / MoE / VLM path of `repro.models.lm`, with the gated
HLO decode (`cfg.strap_decode`).  Parameters are the reference's tree
(layer-stacked tensors under "layers"); a Python loop over layers takes
the place of `jax.lax.scan`.  The SSM and hybrid families, enc-dec and
training (`forward_train`, `loss_fn`) are not ported yet (ROADMAP.md).

Public entry points (functions of (cfg, params, ...)):
  init_params     -> params on the requested device
  prefill         -> (last_logits, cache)
  decode_step     -> (logits, cache), the cache updated in place
  cache_schema    -> Schema of the decode cache (shapes + logical axes)
"""

from __future__ import annotations

import torch

from .attention import (attn_schema, causal_attention, decode_attention,
                        decode_attention_gated)
from .common import (ParamSpec, Schema, add_norm, apply_norm, embed_schema,
                     embed_tokens, init_from_schema, lm_logits, torch_dtype)
from .mlp import mlp_apply, mlp_schema
from .moe import moe_apply, moe_schema


def check_supported(cfg) -> None:
    """Raise for a config outside the ported attention-decoder families."""
    if cfg.family in ("ssm", "hybrid", "audio") or cfg.is_encdec:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet (the port "
            "runs the dense, MoE and VLM decoder families); see ROADMAP.md")


def _tf_layer_schema(cfg, layers: int) -> Schema:
    s: Schema = {}
    add_norm(s, cfg, "ln1", cfg.d_model, layers)
    s.update(attn_schema(cfg, layers))
    add_norm(s, cfg, "ln2", cfg.d_model, layers)
    if cfg.n_experts:
        s.update(moe_schema(cfg, layers))
    else:
        s.update(mlp_schema(cfg, layers))
    return s


def lm_schema(cfg) -> Schema:
    check_supported(cfg)
    s = embed_schema(cfg)
    s["layers"] = _tf_layer_schema(cfg, cfg.n_layers)
    return s


def init_params(cfg, generator: torch.Generator, device="cuda") -> dict:
    """Parameters from `generator` on `device` (default "cuda"), in the
    config's `param_dtype`."""
    return init_from_schema(lm_schema(cfg), generator,
                            torch_dtype(cfg.param_dtype), device)


def layer_params(params, li: int) -> dict:
    """Layer `li`'s slice of the stacked weights (views, no copy)."""
    return {k: v[li] for k, v in params["layers"].items()}


def ffn_apply(cfg, lp, m_in):
    """The block's feed-forward half: the MoE (its aux loss dropped, as
    the reference's prefill and decode drop it) or the dense MLP."""
    if cfg.n_experts:
        return moe_apply(cfg, lp, m_in)[0]
    return mlp_apply(cfg, lp, m_in)


def _tf_block(cfg, lp, h, positions):
    a_in = apply_norm(cfg, h, lp, "ln1")
    attn_out, (k, v) = causal_attention(cfg, lp, a_in, positions)
    h = h + attn_out
    m_in = apply_norm(cfg, h, lp, "ln2")
    return h + ffn_apply(cfg, lp, m_in), (k, v)


def _embed_inputs(cfg, params, batch, dtype):
    """Token (+ vision-stub) embedding -> (B, S, D), positions (1, S): the
    vision embeddings come first and the positions run over both."""
    h = embed_tokens(params, batch["tokens"], dtype)
    if cfg.n_vision_tokens and "vision_embeds" in batch:
        h = torch.cat([batch["vision_embeds"].to(dtype), h], dim=1)
    positions = torch.arange(h.shape[1], device=h.device)[None, :]
    return h, positions


def prefill(cfg, params, batch):
    """Forward over the prompt `batch["tokens"]` (B, S), after
    `batch["vision_embeds"]` (B, Nv, D) for a VLM; returns (last-token
    logits (B, V) float32, cache {"k", "v"}: (L, B, Nv + S, Hkv, hd)).  A
    gated config (`strap_decode`) gets the same cache: as in the
    reference, the caller adds the per-strap key sums `ksum`."""
    check_supported(cfg)
    dtype = torch_dtype(cfg.compute_dtype)
    h, positions = _embed_inputs(cfg, params, batch, dtype)
    ks, vs = [], []
    for li in range(cfg.n_layers):
        h, (k, v) = _tf_block(cfg, layer_params(params, li), h, positions)
        ks.append(k)
        vs.append(v)
    cache = dict(k=torch.stack(ks).to(dtype), v=torch.stack(vs).to(dtype))
    logits = lm_logits(cfg, params, apply_norm(cfg, h[:, -1:, :], params,
                                               "final"))
    return logits[:, 0], cache


def cache_schema(cfg, batch: int, seq: int) -> Schema:
    """Decode-cache schema (shapes + logical axes)."""
    check_supported(cfg)
    hd, hkv = cfg.head_dim_, cfg.n_kv_heads
    if cfg.strap_decode:
        # gated decode: seq stays device-local (the gather must be local);
        # the reference's TP moves to the head_dim axis instead.
        nst = max(seq // cfg.decode_strap_tokens, 1)
        kv_axes = ("layers", "batch", None, "kv", "headdim")
        return {
            "k": ParamSpec((cfg.n_layers, batch, seq, hkv, hd), kv_axes,
                           "zeros"),
            "v": ParamSpec((cfg.n_layers, batch, seq, hkv, hd), kv_axes,
                           "zeros"),
            "ksum": ParamSpec((cfg.n_layers, batch, nst, hkv, hd),
                              ("layers", "batch", None, "kv", "headdim"),
                              "zeros"),
        }
    kv_axes = ("layers", "batch", "seq", "kv", None)
    return {
        "k": ParamSpec((cfg.n_layers, batch, seq, hkv, hd), kv_axes, "zeros"),
        "v": ParamSpec((cfg.n_layers, batch, seq, hkv, hd), kv_axes, "zeros"),
    }


def decode_step(cfg, params, cache, token, pos):
    """One decode step: (B,1) token ids at positions `pos` (B,) -> ((B, V)
    float32 logits, cache).  The token's K/V (and, gated, its key sum)
    are written into `cache` in place; the same dict is returned."""
    check_supported(cfg)
    dtype = torch_dtype(cfg.compute_dtype)
    h = embed_tokens(params, token, dtype)                   # (B,1,D)
    for li in range(cfg.n_layers):
        lp = layer_params(params, li)
        a_in = apply_norm(cfg, h, lp, "ln1")
        if cfg.strap_decode:
            attn_out = decode_attention_gated(
                cfg, lp, a_in, cache["k"][li], cache["v"][li],
                cache["ksum"][li], pos)[0]
        else:
            attn_out = decode_attention(cfg, lp, a_in, cache["k"][li],
                                        cache["v"][li], pos)[0]
        h = h + attn_out
        m_in = apply_norm(cfg, h, lp, "ln2")
        h = h + ffn_apply(cfg, lp, m_in)
    h = apply_norm(cfg, h, params, "final")
    return lm_logits(cfg, params, h)[:, 0], cache
