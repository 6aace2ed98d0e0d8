"""Shared model components: schema-driven params, norms, RoPE, embeddings.

Port of `repro.models.common`.  Parameter trees are nested dicts of
tensors derived from a *schema* (dict name -> ParamSpec), the reference's
own tree: layer-stacked weights carry a leading "layers" axis and are read
one layer at a time (`{k: v[li]}`) by a Python loop over layers.  The
reference's sharding annotations (`constrain`) have no counterpart here.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..device import resolve_device

# ---------------------------------------------------------------------------
# Schema
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]   # logical axis name per dim
    scale: float | str = "fan_in"  # gaussian std, or "fan_in", or "zeros"/"ones"

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


Schema = dict  # nested dict name -> ParamSpec


def torch_dtype(name: str) -> torch.dtype:
    """A config's dtype name ("bfloat16" or anything else = float32), as the
    reference maps `param_dtype` / `compute_dtype`."""
    return torch.bfloat16 if name == "bfloat16" else torch.float32


def schema_leaves(schema: Schema, prefix: tuple = ()) -> list:
    """[(path, ParamSpec)] in the reference's flattening order (dict keys
    sorted, depth first)."""
    out = []
    for k in sorted(schema):
        v = schema[k]
        if isinstance(v, ParamSpec):
            out.append((prefix + (k,), v))
        else:
            out.extend(schema_leaves(v, prefix + (k,)))
    return out


def init_from_schema(schema: Schema, generator: torch.Generator, dtype,
                     device="cuda") -> dict:
    """Draw a parameter tree from `generator` on `device` with the
    reference's scales: "zeros", "ones", gaussian with std `fan_in ** -0.5`
    ("fan_in": the second-to-last dim, or the last of a vector) or the
    given std.  Drawn in float32, then cast to `dtype`.  The numbers are
    torch's, not `jax.random`'s; `interop.params_from_numpy` carries the
    reference's own weights across."""
    dev = resolve_device(device)
    if generator.device.type != dev.type:
        raise ValueError(f"generator is on {generator.device}, params on "
                         f"{dev}: pass a generator of the params' device")
    out: dict = {}
    for path, spec in schema_leaves(schema):
        if spec.scale == "zeros":
            x = torch.zeros(spec.shape, dtype=dtype, device=dev)
        elif spec.scale == "ones":
            x = torch.ones(spec.shape, dtype=dtype, device=dev)
        else:
            if spec.scale == "fan_in":
                fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
                std = fan_in ** -0.5
            else:
                std = float(spec.scale)
            x = torch.randn(spec.shape, generator=generator,
                            dtype=torch.float32, device=dev)
            x = x.mul_(std).to(dtype)
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = x
    return out


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm(x, w, eps=1e-6):
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * w.float()).to(x.dtype)


def layernorm(x, w, b, eps=1e-5):
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, correction=0)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * w.float() + b.float()).to(x.dtype)


def nonparam_ln(x, eps=1e-5):
    """OLMo's non-parametric LayerNorm (no scale / bias)."""
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, correction=0)
    return ((x32 - mu) * torch.rsqrt(var + eps)).to(x.dtype)


def apply_norm(cfg, x, layer_params, prefix: str):
    if cfg.norm == "rmsnorm":
        return rmsnorm(x, layer_params[prefix + "_w"])
    if cfg.norm == "layernorm":
        return layernorm(x, layer_params[prefix + "_w"],
                         layer_params[prefix + "_b"])
    return nonparam_ln(x)


def norm_schema(cfg, d: int) -> Schema:
    if cfg.norm == "rmsnorm":
        return {"_w": ParamSpec((d,), ("dmodel",), "ones")}
    if cfg.norm == "layernorm":
        return {"_w": ParamSpec((d,), ("dmodel",), "ones"),
                "_b": ParamSpec((d,), ("dmodel",), "zeros")}
    return {}


def add_norm(schema: Schema, cfg, name: str, d: int, layers: int | None = None):
    for suffix, spec in norm_schema(cfg, d).items():
        if layers is not None:
            spec = ParamSpec((layers,) + spec.shape, ("layers",) + spec.axes,
                             spec.scale)
        schema[name + suffix] = spec


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None):
    return theta ** (-torch.arange(0, head_dim, 2, dtype=torch.float32,
                                   device=device) / head_dim)


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                # (hd/2,)
    angles = positions[..., None].float() * freqs          # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]                  # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x32 = x.float()
    x1, x2 = x32[..., : hd // 2], x32[..., hd // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoid_pos_emb(seq: int, d: int, offset=0, device=None):
    """(seq, d) float32 sinusoidal positions `offset .. offset + seq - 1`:
    sines in the first half, cosines in the second (enc-dec)."""
    pos = torch.arange(seq, dtype=torch.float32, device=device) + offset
    inv = 1e4 ** (-torch.arange(0, d, 2, dtype=torch.float32, device=device)
                  / d)
    ang = pos[:, None] * inv[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------

def embed_schema(cfg) -> Schema:
    v, d = cfg.padded_vocab, cfg.d_model
    s: Schema = {"embed": ParamSpec((v, d), ("vocab", "dmodel"), 0.02)}
    add_norm(s, cfg, "final", d)
    if not cfg.tie_embeddings:
        s["lm_head"] = ParamSpec((v, d), ("vocab", "dmodel"), "fan_in")
    return s


def embed_tokens(params, tokens, dtype):
    return params["embed"][tokens].to(dtype)


def lm_logits(cfg, params, h):
    """(B, S, D) -> (B, S, V) logits in float32: the (tied) table is cast
    to float32 on every call, as the reference does."""
    table = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    return torch.einsum("bsd,vd->bsv", h.float(), table.float())


def cross_entropy(logits, targets, vocab_size: int):
    """Mean cross entropy over all tokens, in float32: the logsumexp over
    every column (the padded vocabulary's tail included, as in the
    reference, which takes `vocab_size` and does not cut on it) minus the
    gold logit."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    return torch.mean(logz - gold)
