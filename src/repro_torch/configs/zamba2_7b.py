"""Zamba2-7B: Mamba2 backbone + shared attention block every 6 layers."""

from .base import ArchConfig

ZAMBA2_7B = ArchConfig(
    name="zamba2-7b", family="hybrid", n_layers=81, d_model=3584,
    n_heads=32, n_kv_heads=32, d_ff=14336, vocab_size=32000,
    ssm_state=64, ssm_expand=2, ssm_headdim=64,
    shared_attn_every=6,            # one shared attn+mlp block every 6 Mamba2
    tie_embeddings=True,
    source="arXiv:2411.15242; unverified",
)

CONFIG = ZAMBA2_7B
