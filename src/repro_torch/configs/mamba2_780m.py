"""Mamba2-780M: attention-free SSD (state-space duality)."""

from .base import ArchConfig

MAMBA2_780M = ArchConfig(
    name="mamba2-780m", family="ssm", n_layers=48, d_model=1536,
    n_heads=0, n_kv_heads=0, d_ff=0, vocab_size=50280,
    ssm_state=128, ssm_expand=2, ssm_headdim=64, tie_embeddings=True,
    source="arXiv:2405.21060; unverified",
)

CONFIG = MAMBA2_780M
