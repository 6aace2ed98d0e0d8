"""Family dispatch: one model API over the ported families (port of
`repro.models.registry`; the attention-decoder families of `lm`: dense,
MoE and VLM)."""

from __future__ import annotations

import torch

from ..device import resolve_device
from . import lm
from .common import torch_dtype


def schema(cfg):
    return lm.lm_schema(cfg)


def init_params(cfg, generator: torch.Generator, device="cuda"):
    """Parameters drawn from `generator` on `device` (default "cuda";
    raises without a GPU unless `device="cpu"`)."""
    return lm.init_params(cfg, generator, device)


def prefill(cfg, params, batch):
    return lm.prefill(cfg, params, batch)


def decode_step(cfg, params, cache, token, pos):
    return lm.decode_step(cfg, params, cache, token, pos)


def cache_schema(cfg, batch: int, seq: int):
    return lm.cache_schema(cfg, batch, seq)


def _cache_dtype(cfg, key):
    # SSM states and strap key-sums are carried in fp32
    if "ssm" in key or key == "ksum":
        return torch.float32
    return torch_dtype(cfg.compute_dtype)


def init_cache(cfg, batch: int, seq: int, device="cuda"):
    """A zeroed decode cache on `device` (default "cuda"; raises without a
    GPU unless `device="cpu"`): K/V in the compute dtype, strap key sums
    in float32."""
    dev = resolve_device(device)
    return {k: torch.zeros(v.shape, dtype=_cache_dtype(cfg, k), device=dev)
            for k, v in cache_schema(cfg, batch, seq).items()}
