"""Decoder-only LM: the dense / MoE / VLM / SSM / hybrid families.

Port of `repro.models.lm`'s serving path, with the gated HLO decode
(`cfg.strap_decode`).  Parameters are the reference's tree (layer-stacked
tensors under "layers"); a Python loop over layers takes the place of
`jax.lax.scan`.  The hybrid (Zamba2) family runs groups of
`shared_attn_every` Mamba2 layers, each followed by ONE weight-shared
attention+MLP block ("shared"), then the trailing Mamba2 layers
("trailing").

Training runs the same blocks under autograd: each stacked leaf is
unbound once per forward (`_unstack`: the backward of one unbind is one
stack, where a select per layer would write a zero tensor the size of the
whole stack for every layer), and with `cfg.remat` each layer body (the
hybrid: each group body, not the trailing layers) is recomputed in the
backward instead of keeping its activations, where the reference puts
`jax.checkpoint`.

Public entry points (functions of (cfg, params, ...)):
  init_params     -> params on the requested device
  param_axes / abstract_params -> logical axes / meta-device shapes
  forward_train   -> (logits, aux_loss)
  loss_fn         -> scalar loss
  prefill         -> (last_logits, cache)
  decode_step     -> (logits, cache), the cache updated in place
  cache_schema    -> Schema of the decode cache (shapes + logical axes)
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from .attention import (attn_schema, causal_attention, decode_attention,
                        decode_attention_gated)
from .common import (ParamSpec, Schema, abstract_from_schema, add_norm,
                     apply_norm, axes_from_schema, cross_entropy,
                     embed_schema, embed_tokens, init_from_schema, lm_logits,
                     torch_dtype)
from .mlp import mlp_apply, mlp_schema
from .moe import moe_apply, moe_apply_ep, moe_schema
from .ssm import ssm_apply, ssm_decode_step, ssm_schema

ATTENTION_FAMILIES = ("dense", "moe", "vlm")


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


def _ssm_layer_schema(cfg, layers: int) -> Schema:
    s: Schema = {}
    add_norm(s, cfg, "ln1", cfg.d_model, layers)
    s.update(ssm_schema(cfg, layers))
    return s


def _shared_block_schema(cfg) -> Schema:
    """Zamba2's weight-shared attention+MLP block (no layer stacking)."""
    s: Schema = {}
    add_norm(s, cfg, "ln1", cfg.d_model)
    s.update(attn_schema(cfg))
    add_norm(s, cfg, "ln2", cfg.d_model)
    s.update(mlp_schema(cfg))
    return s


def _hybrid_split(cfg) -> tuple[int, int, int]:
    """(groups, per_group, trailing) for the hybrid family."""
    per = cfg.shared_attn_every
    groups = cfg.n_layers // per
    trailing = cfg.n_layers - groups * per
    return groups, per, trailing


def lm_schema(cfg) -> Schema:
    s = embed_schema(cfg)
    if cfg.family == "ssm":
        s["layers"] = _ssm_layer_schema(cfg, cfg.n_layers)
    elif cfg.family == "hybrid":
        groups, per, trailing = _hybrid_split(cfg)
        grouped = _ssm_layer_schema(cfg, groups * per)
        # the stacked specs as (groups, per, ...)
        s["layers"] = {
            k: ParamSpec((groups, per) + v.shape[1:],
                         ("layer_groups",) + v.axes, v.scale)
            for k, v in grouped.items()}
        if trailing:
            s["trailing"] = _ssm_layer_schema(cfg, trailing)
        s["shared"] = _shared_block_schema(cfg)
    else:
        s["layers"] = _tf_layer_schema(cfg, cfg.n_layers)
    return s


def init_params(cfg, generator: torch.Generator, device="cuda") -> dict:
    """Parameters from `generator` on `device` (default "cuda"), in the
    config's `param_dtype`."""
    return init_from_schema(lm_schema(cfg), generator,
                            torch_dtype(cfg.param_dtype), device)


def param_axes(cfg):
    return axes_from_schema(lm_schema(cfg))


def abstract_params(cfg):
    return abstract_from_schema(lm_schema(cfg), torch_dtype(cfg.param_dtype))


def layer_params(params, *idx, key: str = "layers") -> dict:
    """One layer's slice of the stacked weights under `key` (views, no
    copy): `layer_params(params, li)`, or `(params, g, i)` for layer i of
    the hybrid's group g."""
    return {k: v[idx] for k, v in params[key].items()}


def ffn_apply(cfg, lp, m_in):
    """The block's feed-forward half: the MoE (its aux loss dropped, as
    the reference's prefill and decode drop it) or the dense MLP."""
    if cfg.n_experts:
        return moe_apply(cfg, lp, m_in)[0]
    return mlp_apply(cfg, lp, m_in)


def _tf_block(cfg, lp, h, positions):
    """An attention layer over the prompt: (h, MoE aux loss (0.0 for the
    dense MLP), (k, v))."""
    a_in = apply_norm(cfg, h, lp, "ln1")
    attn_out, (k, v) = causal_attention(cfg, lp, a_in, positions)
    h = h + attn_out
    m_in = apply_norm(cfg, h, lp, "ln2")
    if cfg.n_experts:
        moe_fn = moe_apply_ep if cfg.moe_ep else moe_apply
        mo, aux = moe_fn(cfg, lp, m_in)
    else:
        mo = mlp_apply(cfg, lp, m_in)
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
    return h + mo, aux, (k, v)


def _ssm_block(cfg, lp, h):
    """A Mamba2 layer over the prompt: (h, (ssm state, conv tail))."""
    a_in = apply_norm(cfg, h, lp, "ln1")
    out, hf, convf = ssm_apply(cfg, lp, a_in, return_state=True)
    return h + out, (hf, convf)


def _embed_inputs(cfg, params, batch, dtype):
    """Token (+ vision-stub) embedding -> (B, S, D), positions (1, S): the
    vision embeddings come first and the positions run over both."""
    h = embed_tokens(params, batch["tokens"], dtype)
    if cfg.n_vision_tokens and "vision_embeds" in batch:
        h = torch.cat([batch["vision_embeds"].to(dtype), h], dim=1)
    positions = torch.arange(h.shape[1], device=h.device)[None, :]
    return h, positions


def _ssm_stack(cfg, params, h, *lead, key="layers"):
    """The Mamba2 layers of `params[key]` (under the leading index `lead`,
    a hybrid group) in order; returns (h, stacked ssm states, stacked conv
    tails)."""
    n = params[key]["A_log"][lead].shape[0]
    states = []
    for i in range(n):
        h, st = _ssm_block(cfg, layer_params(params, *lead, i, key=key), h)
        states.append(st)
    return (h, torch.stack([s for s, _ in states]),
            torch.stack([c for _, c in states]))


def _prefill_ssm_like(cfg, params, h, positions) -> tuple:
    """(h, cache) of the ssm and hybrid families."""
    if cfg.family == "ssm":
        h, hs, convs = _ssm_stack(cfg, params, h)
        return h, {"ssm": hs, "conv": convs}
    shared = params["shared"]
    groups = _hybrid_split(cfg)[0]
    hs, convs, ks, vs = [], [], [], []
    for g in range(groups):
        h, hs_g, convs_g = _ssm_stack(cfg, params, h, g)
        hs.append(hs_g)
        convs.append(convs_g)
        h, (k, v) = _shared_block(cfg, shared, h, positions)
        ks.append(k)
        vs.append(v)
    cache = {"ssm": torch.stack(hs), "conv": torch.stack(convs),
             "k": torch.stack(ks), "v": torch.stack(vs)}
    if "trailing" in params:
        h, cache["t_ssm"], cache["t_conv"] = _ssm_stack(cfg, params, h,
                                                        key="trailing")
    return h, cache


def _shared_block(cfg, shared, h, positions):
    """The hybrid's weight-shared attention + MLP block over the prompt."""
    a_in = apply_norm(cfg, h, shared, "ln1")
    attn_out, kv = causal_attention(cfg, shared, a_in, positions)
    h = h + attn_out
    m_in = apply_norm(cfg, h, shared, "ln2")
    return h + mlp_apply(cfg, shared, m_in), kv


def prefill(cfg, params, batch):
    """Forward over the prompt `batch["tokens"]` (B, S), after
    `batch["vision_embeds"]` (B, Nv, D) for a VLM; returns (last-token
    logits (B, V) float32, cache).  The attention families' cache is
    {"k", "v"}: (L, B, Nv + S, Hkv, hd); a gated config (`strap_decode`)
    gets the same cache: as in the reference, the caller adds the
    per-strap key sums `ksum`.  The ssm and hybrid caches are as
    `cache_schema` gives them (the SSM state in float32)."""
    dtype = torch_dtype(cfg.compute_dtype)
    h, positions = _embed_inputs(cfg, params, batch, dtype)
    if cfg.family in ("ssm", "hybrid"):
        h, cache = _prefill_ssm_like(cfg, params, h, positions)
    else:
        ks, vs = [], []
        for li in range(cfg.n_layers):
            h, _, (k, v) = _tf_block(cfg, layer_params(params, li), h,
                                     positions)
            ks.append(k)
            vs.append(v)
        cache = dict(k=torch.stack(ks).to(dtype), v=torch.stack(vs).to(dtype))
    logits = lm_logits(cfg, params, apply_norm(cfg, h[:, -1:, :], params,
                                               "final"))
    return logits[:, 0], cache


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

def _unstack(stacked: dict) -> list[dict]:
    """Per-layer dicts of a stacked weight dict, one `unbind(0)` per leaf."""
    cols = {k: v.unbind(0) for k, v in stacked.items()}
    n = len(next(iter(cols.values())))
    return [{k: c[i] for k, c in cols.items()} for i in range(n)]


def _maybe_remat(cfg, fn):
    """`fn` recomputed in the backward when `cfg.remat` (non-reentrant
    `torch.utils.checkpoint`, the reference's `jax.checkpoint` with
    nothing saveable)."""
    if not cfg.remat:
        return fn
    return lambda *args: checkpoint(fn, *args, use_reentrant=False)


def _ssm_layer(cfg, lp, h):
    return h + ssm_apply(cfg, lp, apply_norm(cfg, h, lp, "ln1"))


def _run_layers(cfg, params, h, positions):
    """The layer stack for training: (h, aux loss summed over layers)."""
    zero = torch.zeros((), dtype=torch.float32, device=h.device)
    if cfg.family == "ssm":
        body = _maybe_remat(cfg, lambda hh, lp: _ssm_layer(cfg, lp, hh))
        for lp in _unstack(params["layers"]):
            h = body(h, lp)
        return h, zero
    if cfg.family == "hybrid":
        shared = params["shared"]

        def group_body(hh, glp):
            for lp in _unstack(glp):
                hh = _ssm_layer(cfg, lp, hh)
            return _shared_block(cfg, shared, hh, positions)[0]

        body = _maybe_remat(cfg, group_body)
        for glp in _unstack(params["layers"]):
            h = body(h, glp)
        if "trailing" in params:
            for lp in _unstack(params["trailing"]):
                h = _ssm_layer(cfg, lp, h)
        return h, zero
    body = _maybe_remat(cfg, lambda hh, lp: _tf_block(cfg, lp, hh,
                                                       positions)[:2])
    auxs = []
    for lp in _unstack(params["layers"]):
        h, aux = body(h, lp)
        auxs.append(aux)
    return h, torch.stack(auxs).sum()


def forward_train(cfg, params, batch):
    """Forward over `batch["tokens"]` (after `batch["vision_embeds"]` for a
    VLM): ((B, S, V) float32 logits, the MoE aux loss summed over layers,
    0.0 for the other families)."""
    dtype = torch_dtype(cfg.compute_dtype)
    h, positions = _embed_inputs(cfg, params, batch, dtype)
    h, aux = _run_layers(cfg, params, h, positions)
    h = apply_norm(cfg, h, params, "final")
    return lm_logits(cfg, params, h), aux


def loss_fn(cfg, params, batch, aux_weight: float = 0.01):
    """Next-token cross entropy against `batch["targets"]` plus
    `aux_weight` times the aux loss.  A VLM's logits are cut to the token
    rows from `nv - 1` on, nv the vision tokens."""
    logits, aux = forward_train(cfg, params, batch)
    if cfg.n_vision_tokens and "vision_embeds" in batch:
        nv = batch["vision_embeds"].shape[1]
        t = batch["targets"].shape[1]
        logits = logits[:, nv - 1: nv - 1 + t]
    loss = cross_entropy(logits, batch["targets"], cfg.padded_vocab)
    return loss + aux_weight * aux


def cache_schema(cfg, batch: int, seq: int) -> Schema:
    """Decode-cache schema (shapes + logical axes)."""
    hd, hkv = cfg.head_dim_, cfg.n_kv_heads
    nh, hp, st = cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state
    conv_dim = cfg.d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state
    kc = cfg.conv_kernel - 1
    kv_axes = ("layers", "batch", "seq", "kv", None)
    if cfg.strap_decode and cfg.family in ATTENTION_FAMILIES:
        # gated decode: seq stays device-local (the gather must be local);
        # the reference's TP moves to the head_dim axis instead.
        nst = max(seq // cfg.decode_strap_tokens, 1)
        g_axes = ("layers", "batch", None, "kv", "headdim")
        return {
            "k": ParamSpec((cfg.n_layers, batch, seq, hkv, hd), g_axes,
                           "zeros"),
            "v": ParamSpec((cfg.n_layers, batch, seq, hkv, hd), g_axes,
                           "zeros"),
            "ksum": ParamSpec((cfg.n_layers, batch, nst, hkv, hd), g_axes,
                              "zeros"),
        }
    if cfg.family == "ssm":
        return {
            "ssm": ParamSpec((cfg.n_layers, batch, nh, hp, st),
                             ("layers", "batch", "heads", None, None), "zeros"),
            "conv": ParamSpec((cfg.n_layers, batch, kc, conv_dim),
                              ("layers", "batch", None, "ssm_out"), "zeros"),
        }
    if cfg.family == "hybrid":
        groups, per, trailing = _hybrid_split(cfg)
        s: Schema = {
            "ssm": ParamSpec((groups, per, batch, nh, hp, st),
                             ("layer_groups", "layers", "batch", "heads",
                              None, None), "zeros"),
            "conv": ParamSpec((groups, per, batch, kc, conv_dim),
                              ("layer_groups", "layers", "batch", None,
                               "ssm_out"), "zeros"),
            "k": ParamSpec((groups, batch, seq, hkv, hd), kv_axes, "zeros"),
            "v": ParamSpec((groups, batch, seq, hkv, hd), kv_axes, "zeros"),
        }
        if trailing:
            s["t_ssm"] = ParamSpec((trailing, batch, nh, hp, st),
                                   ("layers", "batch", "heads", None, None),
                                   "zeros")
            s["t_conv"] = ParamSpec((trailing, batch, kc, conv_dim),
                                    ("layers", "batch", None, "ssm_out"),
                                    "zeros")
        return s
    return {
        "k": ParamSpec((cfg.n_layers, batch, seq, hkv, hd), kv_axes, "zeros"),
        "v": ParamSpec((cfg.n_layers, batch, seq, hkv, hd), kv_axes, "zeros"),
    }


def _ssm_decode_stack(cfg, params, h, ssm, conv, *lead, key="layers"):
    """One token through the Mamba2 layers of `params[key]` (under the
    leading index `lead`); each layer's state written into `ssm[i]` and
    `conv[i]` in place."""
    for i in range(ssm.shape[0]):
        lp = layer_params(params, *lead, i, key=key)
        a_in = apply_norm(cfg, h, lp, "ln1")
        out, h_new, conv_new = ssm_decode_step(cfg, lp, a_in, ssm[i], conv[i])
        ssm[i].copy_(h_new)
        conv[i].copy_(conv_new)
        h = h + out
    return h


def decode_step(cfg, params, cache, token, pos):
    """One decode step: (B,1) token ids at positions `pos` (B,) -> ((B, V)
    float32 logits, cache).  The token's K/V (gated: and its key sum) or
    the SSM and conv states are written into `cache` in place; the same
    dict is returned."""
    dtype = torch_dtype(cfg.compute_dtype)
    h = embed_tokens(params, token, dtype)                   # (B,1,D)
    if cfg.family == "ssm":
        h = _ssm_decode_stack(cfg, params, h, cache["ssm"], cache["conv"])
    elif cfg.family == "hybrid":
        shared = params["shared"]
        for g in range(cache["k"].shape[0]):
            h = _ssm_decode_stack(cfg, params, h, cache["ssm"][g],
                                  cache["conv"][g], g)
            a_in = apply_norm(cfg, h, shared, "ln1")
            h = h + decode_attention(cfg, shared, a_in, cache["k"][g],
                                     cache["v"][g], pos)[0]
            m_in = apply_norm(cfg, h, shared, "ln2")
            h = h + mlp_apply(cfg, shared, m_in)
        if "t_ssm" in cache:
            h = _ssm_decode_stack(cfg, params, h, cache["t_ssm"],
                                  cache["t_conv"], key="trailing")
    else:
        gated = cfg.strap_decode and cfg.family in ATTENTION_FAMILIES
        for li in range(cfg.n_layers):
            lp = layer_params(params, li)
            a_in = apply_norm(cfg, h, lp, "ln1")
            if gated:
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
