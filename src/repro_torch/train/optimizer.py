"""Optimizers, built from scratch: AdamW and AdamW8bit.

Port of `repro.train.optimizer`.  AdamW8bit keeps both Adam moments in
int8 with per-row float32 scales (block = last dim), a quarter of
AdamW's moment bytes plus the scales.  The state tree is the reference's:
{"m", "v", "count"}, with m and v trees of float32 tensors (AdamW) or of
{"q": int8, "s": float32[..., 1]} (AdamW8bit), and count an int32
scalar.

`update(grads, state, params) -> (params, state)` writes the new
parameters and moments into the given tensors in place (the counterpart
of the reference's donated buffers) and returns the same trees with a new
count.  The schedule, the bias corrections and every division run on
float32 tensors on the parameters' device, as the reference computes
them, never in Python floats: a scalar divisor of a CUDA tensor would
become a reciprocal multiply.  `opt_state_axes` / `abstract_opt_state`
give the state's logical axes (those of the parameters: co-located
shards) and shapes for the sharding rules.  Under a sharded step each
rank updates its own blocks; AdamW8bit's row max then spans the ranks
that share a row (`row_groups`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, NamedTuple

import torch
import torch.distributed as dist

from ..distributed.collectives import all_reduce
from ..tree import leaves, tree_map


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), x, dtype=torch.float32, device=like.device)


def lr_schedule(oc: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay to min_lr_ratio, in float32."""
    step = step.float()
    warm = step / _f32(max(oc.warmup_steps, 1), step)
    prog = torch.clamp((step - oc.warmup_steps)
                       / _f32(max(oc.total_steps - oc.warmup_steps, 1), step),
                       0, 1)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    decay = oc.min_lr_ratio + (1 - oc.min_lr_ratio) * cos
    return oc.lr * torch.clamp(warm, max=1.0) * decay


def _step_scalars(oc: OptConfig, count: torch.Tensor):
    """(lr, 1 - b1 ** c, 1 - b2 ** c) as float32 tensors for step c."""
    c = count.float()
    return lr_schedule(oc, count), 1 - oc.b1 ** c, 1 - oc.b2 ** c


def _new_param(oc, lr, bc1, bc2, m, v, p):
    step = (m / bc1) / (torch.sqrt(v / bc2) + oc.eps)
    step = step + oc.weight_decay * p.float()
    return (p.float() - lr * step).to(p.dtype)


def _count0(params) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=leaves(params)[0].device)


# ---------------------------------------------------------------------------
# AdamW (fp32 moments)
# ---------------------------------------------------------------------------

def adamw_init(params) -> dict:
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    return dict(m=tree_map(zeros, params), v=tree_map(zeros, params),
                count=_count0(params))


@torch.no_grad()
def adamw_update(oc: OptConfig, grads, state, params):
    count = state["count"] + 1
    lr, bc1, bc2 = _step_scalars(oc, count)

    def upd(g, m, v, p):
        g32 = g.float()
        m.copy_(oc.b1 * m + (1 - oc.b1) * g32)
        v.copy_(oc.b2 * v + (1 - oc.b2) * g32 * g32)
        p.copy_(_new_param(oc, lr, bc1, bc2, m, v, p))

    tree_map(upd, grads, state["m"], state["v"], params)
    return params, dict(m=state["m"], v=state["v"], count=count)


# ---------------------------------------------------------------------------
# AdamW8bit (int8 moments, per-row scales)
# ---------------------------------------------------------------------------

def _q8(x: torch.Tensor, groups=()):
    """Quantize along the last dim: (int8, float32 scale[..., 1]); round
    half to even, as `jnp.round`.  `groups`: the process groups over which
    the last dim is split (a block of a sharded row), whose row max is
    reduced over them so every block takes the whole row's scale."""
    amax = torch.amax(torch.abs(x), dim=-1, keepdim=True)
    for g in groups:
        amax = all_reduce(amax, g, dist.ReduceOp.MAX)
    s = amax / _f32(127.0, x) + 1e-12
    q = torch.clamp(torch.round(x / s), -127, 127).to(torch.int8)
    return q, s.float()


def _dq8(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return q.float() * s


def adamw8_init(params) -> dict:
    def z8(p):
        q, s = _q8(torch.zeros(p.shape, dtype=torch.float32, device=p.device))
        return dict(q=q, s=s)
    return dict(m=tree_map(z8, params), v=tree_map(z8, params),
                count=_count0(params))


@torch.no_grad()
def adamw8_update(oc: OptConfig, grads, state, params, row_groups=None):
    """`row_groups`: a tree of `params`' structure, each leaf the process
    groups its last dim is split over (see `_q8`); None: whole rows."""
    count = state["count"] + 1
    lr, bc1, bc2 = _step_scalars(oc, count)
    if row_groups is None:
        row_groups = tree_map(lambda p: (), params)

    def upd(g, mq, vq, p, groups):
        g32 = g.float()
        m = oc.b1 * _dq8(mq["q"], mq["s"]) + (1 - oc.b1) * g32
        v = oc.b2 * _dq8(vq["q"], vq["s"]) + (1 - oc.b2) * g32 * g32
        v = torch.clamp_min(v, 0.0)
        p.copy_(_new_param(oc, lr, bc1, bc2, m, v, p))
        for moment, x in ((mq, m), (vq, v)):
            q, s = _q8(x, groups)
            moment["q"].copy_(q)
            moment["s"].copy_(s)

    tree_map(upd, grads, state["m"], state["v"], params, row_groups)
    return params, dict(m=state["m"], v=state["v"], count=count)


# ---------------------------------------------------------------------------

class Optimizer(NamedTuple):
    init: Callable
    update: Callable


def make_optimizer(name: str, oc: OptConfig | None = None,
                   row_groups=None) -> Optimizer:
    """`row_groups` (AdamW8bit under a sharded step): see
    `adamw8_update`."""
    oc = oc or OptConfig()
    if name == "adamw":
        return Optimizer(adamw_init,
                         lambda g, s, p: adamw_update(oc, g, s, p))
    if name == "adamw8bit":
        return Optimizer(adamw8_init,
                         lambda g, s, p: adamw8_update(oc, g, s, p,
                                                       row_groups))
    raise ValueError(name)


def opt_state_axes(name: str, param_axes_tree):
    """Optimizer-state logical axes mirror the parameter axes (co-location)."""
    if name == "adamw":
        return dict(m=param_axes_tree, v=param_axes_tree, count=())
    if name == "adamw8bit":
        mapped = tree_map(lambda ax: dict(q=ax, s=ax[:-1] + (None,)),
                          param_axes_tree)
        return dict(m=mapped, v=mapped, count=())
    raise ValueError(name)


def abstract_opt_state(name: str, abstract_params):
    """The state's shapes and dtypes on the `meta` device."""
    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    count = meta((), torch.int32)
    if name == "adamw":
        f32 = lambda p: meta(p.shape, torch.float32)
        return dict(m=tree_map(f32, abstract_params),
                    v=tree_map(f32, abstract_params), count=count)
    if name == "adamw8bit":
        def q8(p):
            return dict(q=meta(p.shape, torch.int8),
                        s=meta(tuple(p.shape[:-1]) + (1,), torch.float32))
        return dict(m=tree_map(q8, abstract_params),
                    v=tree_map(q8, abstract_params), count=count)
    raise ValueError(name)
