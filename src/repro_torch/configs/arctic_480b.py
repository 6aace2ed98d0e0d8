"""Snowflake Arctic 480B: 128-expert top-2 MoE + dense residual MLP."""

from .base import ArchConfig

ARCTIC_480B = ArchConfig(
    name="arctic-480b", family="moe", n_layers=35, d_model=7168,
    n_heads=56, n_kv_heads=8, d_ff=4864, vocab_size=32000,
    n_experts=128, top_k=2, moe_dense_residual=True,
    optimizer="adamw8bit",          # int8 moments: fits HBM at 256 chips
    source="hf:Snowflake/snowflake-arctic-base; hf",
)

CONFIG = ARCTIC_480B
