"""The ten assigned architecture configs, by name (port of
`repro.configs.registry`; one module each, the reference's own fields).

`get_arch(name + "-smoke")` gives the config's `reduced()` smoke size.
Every family's model runs in the port (`models.registry`).
"""

from __future__ import annotations

from .arctic_480b import ARCTIC_480B
from .base import ArchConfig
from .deepseek_67b import DEEPSEEK_67B
from .mamba2_780m import MAMBA2_780M
from .olmo_1b import OLMO_1B
from .phi35_moe import PHI35_MOE
from .pixtral_12b import PIXTRAL_12B
from .qwen15_110b import QWEN15_110B
from .qwen2_1_5b import QWEN2_1_5B
from .whisper_tiny import WHISPER_TINY
from .zamba2_7b import ZAMBA2_7B

ARCHS: dict[str, ArchConfig] = {c.name: c for c in (
    ZAMBA2_7B, WHISPER_TINY, QWEN2_1_5B, DEEPSEEK_67B, OLMO_1B,
    QWEN15_110B, MAMBA2_780M, ARCTIC_480B, PHI35_MOE, PIXTRAL_12B,
)}


def get_arch(name: str) -> ArchConfig:
    """The config named `name`; `name + "-smoke"` gives its `reduced()`
    size.  Raises `KeyError` for an unknown name."""
    if name.endswith("-smoke"):
        return ARCHS[name[: -len("-smoke")]].reduced()
    return ARCHS[name]


def list_archs() -> list[str]:
    return sorted(ARCHS)
