"""DeepSeek-67B: llama-style dense GQA (kv=8)."""

from .base import ArchConfig

DEEPSEEK_67B = ArchConfig(
    name="deepseek-67b", family="dense", n_layers=95, d_model=8192,
    n_heads=64, n_kv_heads=8, d_ff=22016, vocab_size=102400,
    rope_theta=1e4, source="arXiv:2401.02954; hf",
)

CONFIG = DEEPSEEK_67B
