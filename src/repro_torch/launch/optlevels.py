"""Optimization-level config variants (port of `repro.launch.optlevels`:
the same rewrites of the same `ArchConfig` fields, level by level).

Levels stack (each includes the ones below it):
  1: attn_chunk 512 -> 1024
  2: remat off outside the train cell (no gradient, nothing to recompute)
  3: selector+strap gated decode (decode cells, full-attention families)
  4: shard_acts (the reference's activation sharding constraints)
  5: moe_ep (expert-parallel MoE dispatch)
  6: seq_parallel in the train cell (full-attention families)
  7: ssm_split_proj (shard-aligned split SSM projections)
  8: seq_parallel for the SSM family's train and prefill cells
"""

from __future__ import annotations

import dataclasses


def apply_opt_level(cfg, cell: str, level: int):
    if level >= 1:
        cfg = dataclasses.replace(cfg, attn_chunk=1024)
    if level >= 2 and cell != "train_4k":
        cfg = dataclasses.replace(cfg, remat=False)
    if level >= 3 and cell in ("decode_32k", "long_500k") \
            and cfg.family in ("dense", "moe", "vlm"):
        cfg = dataclasses.replace(cfg, strap_decode=True,
                                  decode_strap_tokens=2048,
                                  decode_top_straps=4)
    if level >= 4:
        # explicit activation sharding constraints (kills GSPMD reshards)
        cfg = dataclasses.replace(cfg, shard_acts=True)
    if level >= 5 and cfg.n_experts:
        # shard_map expert-parallel MoE dispatch (all-to-all, not gather)
        cfg = dataclasses.replace(cfg, moe_ep=True)
    if level >= 6 and cell == "train_4k" and cfg.family in ("dense", "moe",
                                                            "vlm"):
        # sequence-parallel residual stream (activation memory / 16,
        # AR -> RS+AG on the TP boundary)
        cfg = dataclasses.replace(cfg, seq_parallel=True)
    if level >= 7 and cfg.ssm_state:
        # shard-aligned split of the fused SSM in_proj/conv (H1 iter 2)
        cfg = dataclasses.replace(cfg, ssm_split_proj=True)
    if level >= 8 and cfg.family == "ssm" and cell in ("train_4k",
                                                       "prefill_32k"):
        # seq-parallel residual for attention-free models (H1 iter 3):
        # chunks align with shards; inter-chunk scan passes only the state
        cfg = dataclasses.replace(cfg, seq_parallel=True)
    return cfg
