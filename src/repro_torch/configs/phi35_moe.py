"""Phi-3.5-MoE 42B (6.6B active): 16-expert top-2 MoE."""

from .base import ArchConfig

PHI35_MOE = ArchConfig(
    name="phi3.5-moe-42b-a6.6b", family="moe", n_layers=32, d_model=4096,
    n_heads=32, n_kv_heads=8, d_ff=6400, vocab_size=32064,
    n_experts=16, top_k=2,
    source="hf:microsoft/Phi-3.5-MoE-instruct; hf",
)

CONFIG = PHI35_MOE
