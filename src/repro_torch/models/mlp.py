"""Dense MLP blocks: SwiGLU (llama-family) and GELU (port of
`repro.models.mlp`)."""

from __future__ import annotations

import torch.nn.functional as F

from .common import ParamSpec, Schema


def mlp_schema(cfg, layers: int | None = None) -> Schema:
    d, f = cfg.d_model, cfg.d_ff
    L = (layers,) if layers is not None else ()
    A = ("layers",) if layers is not None else ()
    if cfg.act == "swiglu":
        return {
            "w_gate": ParamSpec(L + (d, f), A + ("dmodel", "ff"), "fan_in"),
            "w_up": ParamSpec(L + (d, f), A + ("dmodel", "ff"), "fan_in"),
            "w_down": ParamSpec(L + (f, d), A + ("ff", "dmodel"), "fan_in"),
        }
    return {
        "w_in": ParamSpec(L + (d, f), A + ("dmodel", "ff"), "fan_in"),
        "b_in": ParamSpec(L + (f,), A + ("ff",), "zeros"),
        "w_out": ParamSpec(L + (f, d), A + ("ff", "dmodel"), "fan_in"),
        "b_out": ParamSpec(L + (d,), A + ("dmodel",), "zeros"),
    }


def mlp_apply(cfg, p, x):
    if cfg.act == "swiglu":
        g = x @ p["w_gate"]
        u = x @ p["w_up"]
        h = F.silu(g.float()).to(x.dtype) * u
        return h @ p["w_down"]
    h = x @ p["w_in"] + p["b_in"].to(x.dtype)
    # jax.nn.gelu defaults to the tanh approximation
    h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
    return h @ p["w_out"] + p["b_out"].to(x.dtype)
