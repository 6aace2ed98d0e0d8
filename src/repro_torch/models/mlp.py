"""Dense MLP blocks: SwiGLU (llama-family) and GELU (port of
`repro.models.mlp`).  `prefix=` names a second MLP beside the first
(Arctic's dense residual, `res_w_gate`, ...)."""

from __future__ import annotations

import torch.nn.functional as F

from .common import ParamSpec, Schema


def mlp_schema(cfg, layers: int | None = None, prefix: str = "") -> Schema:
    d, f = cfg.d_model, cfg.d_ff
    L = (layers,) if layers is not None else ()
    A = ("layers",) if layers is not None else ()
    if cfg.act == "swiglu":
        return {
            prefix + "w_gate": ParamSpec(L + (d, f), A + ("dmodel", "ff"), "fan_in"),
            prefix + "w_up": ParamSpec(L + (d, f), A + ("dmodel", "ff"), "fan_in"),
            prefix + "w_down": ParamSpec(L + (f, d), A + ("ff", "dmodel"), "fan_in"),
        }
    return {
        prefix + "w_in": ParamSpec(L + (d, f), A + ("dmodel", "ff"), "fan_in"),
        prefix + "b_in": ParamSpec(L + (f,), A + ("ff",), "zeros"),
        prefix + "w_out": ParamSpec(L + (f, d), A + ("ff", "dmodel"), "fan_in"),
        prefix + "b_out": ParamSpec(L + (d,), A + ("dmodel",), "zeros"),
    }


def mlp_apply(cfg, p, x, prefix: str = ""):
    if cfg.act == "swiglu":
        g = x @ p[prefix + "w_gate"]
        u = x @ p[prefix + "w_up"]
        h = F.silu(g.float()).to(x.dtype) * u
        return h @ p[prefix + "w_down"]
    h = x @ p[prefix + "w_in"] + p[prefix + "b_in"].to(x.dtype)
    # jax.nn.gelu defaults to the tanh approximation
    h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
    return h @ p[prefix + "w_out"] + p[prefix + "b_out"].to(x.dtype)
