"""The architectures the port can run, by name.

Only configs whose family the port implements are registered: the dense
decoder family, with `qwen2-1.5b`.  `get_arch(name + "-smoke")` gives the
config's `reduced()` smoke size, as in the reference registry.  The
reference's other configs (MoE, SSM, hybrid, enc-dec, VLM) are still to
be ported; ROADMAP.md lists them.
"""

from __future__ import annotations

from .base import ArchConfig
from .qwen2_1_5b import QWEN2_1_5B

ARCHS: dict[str, ArchConfig] = {c.name: c for c in (QWEN2_1_5B,)}


def get_arch(name: str) -> ArchConfig:
    base = name[: -len("-smoke")] if name.endswith("-smoke") else name
    if base not in ARCHS:
        raise KeyError(
            f"architecture {name!r} is not ported yet (the port runs "
            f"{sorted(ARCHS)}); ROADMAP.md lists the configs still to port")
    cfg = ARCHS[base]
    return cfg.reduced() if base != name else cfg


def list_archs() -> list[str]:
    return sorted(ARCHS)
