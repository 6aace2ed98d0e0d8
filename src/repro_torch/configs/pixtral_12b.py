"""Pixtral-12B: mistral-nemo-style decoder; ViT frontend is a stub."""

from .base import ArchConfig

PIXTRAL_12B = ArchConfig(
    name="pixtral-12b", family="vlm", n_layers=40, d_model=5120,
    n_heads=32, n_kv_heads=8, d_ff=14336, vocab_size=131072,
    head_dim=128, rope_theta=1e6, n_vision_tokens=256,
    source="hf:mistralai/Pixtral-12B-2409; unverified",
)

CONFIG = PIXTRAL_12B
