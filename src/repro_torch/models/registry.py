"""Family dispatch: one model API over `lm` (the decoder-only families:
dense, MoE, VLM, SSM, hybrid) and `encdec` (Whisper); port of
`repro.models.registry`."""

from __future__ import annotations

import torch

from ..device import resolve_device
from ..distributed.tensor_parallel import NO_SPLIT
from . import encdec, lm
from .common import axes_from_schema, torch_dtype


def _mod(cfg):
    return encdec if cfg.is_encdec else lm


def schema(cfg):
    return encdec.encdec_schema(cfg) if cfg.is_encdec else lm.lm_schema(cfg)


def init_params(cfg, generator: torch.Generator, device="cuda"):
    """Parameters drawn from `generator` on `device` (default "cuda";
    raises without a GPU unless `device="cpu"`)."""
    return _mod(cfg).init_params(cfg, generator, device)


def param_axes(cfg):
    return _mod(cfg).param_axes(cfg)


def abstract_params(cfg):
    """The parameter tree's shapes and dtype on the `meta` device."""
    return _mod(cfg).abstract_params(cfg)


def forward_train(cfg, params, batch):
    return _mod(cfg).forward_train(cfg, params, batch)


def loss_fn(cfg, params, batch):
    return _mod(cfg).loss_fn(cfg, params, batch)


def prefill(cfg, params, batch, cache_split=NO_SPLIT):
    """`cache_split`: how the sharded serve steps lay the cache
    (`tensor_parallel.cache_split`)."""
    return _mod(cfg).prefill(cfg, params, batch, cache_split)


def decode_step(cfg, params, cache, token, pos, cache_split=NO_SPLIT):
    return _mod(cfg).decode_step(cfg, params, cache, token, pos, cache_split)


def cache_schema(cfg, batch: int, seq: int):
    if cfg.is_encdec:
        return encdec.cache_schema(cfg, batch, seq // 2)
    return lm.cache_schema(cfg, batch, seq)


def cache_axes(cfg, batch: int, seq: int):
    return axes_from_schema(cache_schema(cfg, batch, seq))


def _cache_dtype(cfg, key):
    # SSM states and strap key-sums are carried in fp32
    if "ssm" in key or key == "ksum":
        return torch.float32
    return torch_dtype(cfg.compute_dtype)


def abstract_cache(cfg, batch: int, seq: int):
    """The decode cache's shapes and dtypes on the `meta` device."""
    return {k: torch.empty(v.shape, dtype=_cache_dtype(cfg, k), device="meta")
            for k, v in cache_schema(cfg, batch, seq).items()}


def init_cache(cfg, batch: int, seq: int, device="cuda"):
    """A zeroed decode cache on `device` (default "cuda"; raises without a
    GPU unless `device="cpu"`): K/V and conv tails in the compute dtype,
    SSM states and strap key sums in float32."""
    dev = resolve_device(device)
    return {k: torch.zeros(v.shape, dtype=_cache_dtype(cfg, k), device=dev)
            for k, v in cache_schema(cfg, batch, seq).items()}
