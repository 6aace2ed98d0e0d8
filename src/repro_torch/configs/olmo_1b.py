"""OLMo-1B: dense MHA with non-parametric LayerNorm."""

from .base import ArchConfig

OLMO_1B = ArchConfig(
    name="olmo-1b", family="dense", n_layers=16, d_model=2048,
    n_heads=16, n_kv_heads=16, d_ff=8192, vocab_size=50304,
    norm="nonparam_ln", tie_embeddings=True,
    source="arXiv:2402.00838; hf",
)

CONFIG = OLMO_1B
