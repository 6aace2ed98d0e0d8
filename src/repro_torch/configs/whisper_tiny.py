"""Whisper-tiny: encoder-decoder; conv audio frontend is a stub."""

from .base import ArchConfig

WHISPER_TINY = ArchConfig(
    name="whisper-tiny", family="audio", n_layers=4, d_model=384,
    n_heads=6, n_kv_heads=6, d_ff=1536, vocab_size=51865,
    is_encdec=True, n_enc_layers=4, act="gelu", norm="layernorm",
    rope_theta=0.0,  # sinusoidal absolute positions, no RoPE
    source="arXiv:2212.04356; unverified",
)

CONFIG = WHISPER_TINY
