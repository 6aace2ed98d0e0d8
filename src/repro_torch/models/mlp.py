"""Dense MLP blocks: SwiGLU (llama-family) and GELU (port of
`repro.models.mlp`).  `prefix=` names a second MLP beside the first
(Arctic's dense residual, `res_w_gate`, ...)."""

from __future__ import annotations

import torch.nn.functional as F

from ..distributed import tensor_parallel as tp
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


def mlp_body(cfg, p, x, prefix: str = ""):
    """The MLP without its output bias.  With `p` holding the rank's "ff"
    blocks (`w_gate` / `w_up` / `w_in` / `b_in` column-parallel, `w_down`
    / `w_out` row-parallel) the result is the rank's partial sum."""
    if cfg.act == "swiglu":
        g = x @ p[prefix + "w_gate"]
        u = x @ p[prefix + "w_up"]
        h = F.silu(g.float()).to(x.dtype) * u
        return h @ p[prefix + "w_down"]
    h = x @ p[prefix + "w_in"] + p[prefix + "b_in"].to(x.dtype)
    # jax.nn.gelu defaults to the tanh approximation
    h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
    return h @ p[prefix + "w_out"]


def mlp_apply(cfg, p, x, prefix: str = "", st: tp.Stream = tp.WHOLE):
    """The MLP on the residual stream as `st` holds it.  Under a mesh that
    gives the rank its "ff" blocks (`tp.block_group`) each rank multiplies its
    blocks and the partial sums are summed over "model" (reduce-scattered
    along the sequence under `seq_parallel`); `b_out` is added once,
    after the sum."""
    first = prefix + ("w_gate" if cfg.act == "swiglu" else "w_in")
    group = tp.block_group(p[first], cfg.d_ff, -1)
    if group is None:
        y = mlp_body(cfg, p, tp.enter_whole(x, st), prefix)
        if cfg.act != "swiglu":
            y = y + p[prefix + "b_out"].to(x.dtype)
        return tp.leave_whole(y, st)
    y = tp.leave(mlp_body(cfg, p, tp.enter(x, group, st), prefix), group,
                 st)
    if cfg.act != "swiglu":
        y = y + tp.seq_param(p[prefix + "b_out"], st).to(x.dtype)
    return y
