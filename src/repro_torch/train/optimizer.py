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
become a reciprocal multiply.  The distributed slice's
`opt_state_axes` / `abstract_opt_state` are not ported (ROADMAP.md).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, NamedTuple

import torch

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

def _q8(x: torch.Tensor):
    """Quantize along the last dim: (int8, float32 scale[..., 1]); round
    half to even, as `jnp.round`."""
    s = (torch.amax(torch.abs(x), dim=-1, keepdim=True) / _f32(127.0, x)
         + 1e-12)
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
def adamw8_update(oc: OptConfig, grads, state, params):
    count = state["count"] + 1
    lr, bc1, bc2 = _step_scalars(oc, count)

    def upd(g, mq, vq, p):
        g32 = g.float()
        m = oc.b1 * _dq8(mq["q"], mq["s"]) + (1 - oc.b1) * g32
        v = oc.b2 * _dq8(vq["q"], vq["s"]) + (1 - oc.b2) * g32 * g32
        v = torch.clamp_min(v, 0.0)
        p.copy_(_new_param(oc, lr, bc1, bc2, m, v, p))
        for moment, x in ((mq, m), (vq, v)):
            q, s = _q8(x)
            moment["q"].copy_(q)
            moment["s"].copy_(s)

    tree_map(upd, grads, state["m"], state["v"], params)
    return params, dict(m=state["m"], v=state["v"], count=count)


# ---------------------------------------------------------------------------

class Optimizer(NamedTuple):
    init: Callable
    update: Callable


def make_optimizer(name: str, oc: OptConfig | None = None) -> Optimizer:
    oc = oc or OptConfig()
    if name == "adamw":
        return Optimizer(adamw_init,
                         lambda g, s, p: adamw_update(oc, g, s, p))
    if name == "adamw8bit":
        return Optimizer(adamw8_init,
                         lambda g, s, p: adamw8_update(oc, g, s, p))
    raise ValueError(name)
