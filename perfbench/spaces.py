"""Design-space declarations: plain JSON lists that both sides build from.

A declaration is the chain of `DesignSpace` calls a user writes, the first
a class method and each next a method of what the last one returned, each
with its keyword arguments (JSON lists are passed as tuples):

    [["paper_grid", {}], ["with_mc", {"samples": 4096}]]
    [["paper_targets", {}],
     ["with_mc", {"samples": 4096, "corr": 1.0, "tail_shift": [4.0, 0.0],
                  "tail_scale": [1.2, 1.0]}]]

Any builder or modifier of the API can be declared (`product`,
`with_replica`, `with_corners`, ...).  `program_space` builds it with the
program's `DesignSpace`, `reference_space` with the reference's copy: the
two APIs are the same.
"""

from __future__ import annotations

import copy


def _arg(value):
    if isinstance(value, list):
        return tuple(_arg(v) for v in value)
    if isinstance(value, dict):
        return {k: _arg(v) for k, v in value.items()}
    return value


def build(cls, decl: list):
    """`decl` as a space of the `DesignSpace` class `cls`."""
    obj = cls
    for name, kwargs in decl:
        obj = getattr(obj, name)(**_arg(kwargs))
    return obj


def with_key(decl: list, key: int) -> list:
    """`decl` with the Monte-Carlo key `key` (unchanged without MC)."""
    out = copy.deepcopy(decl)
    for name, kwargs in out:
        if name == "with_mc":
            kwargs["key"] = int(key)
    return out


def program_space(decl: list):
    from repro_torch.core.space import DesignSpace
    return build(DesignSpace, decl)


def reference_space(decl: list):
    from .reference.space import DesignSpace
    return build(DesignSpace, decl)
