"""Carry the reference's inputs across as plain numpy arrays and dicts.

What the port takes over from the JAX reference are its calibration
registries, its lowered operand batches and, for the LM server, its
parameter trees.  Every function here takes plain Python / numpy values
(e.g. a `dataclasses.asdict` of a reference `TechCal`, `np.asarray` of its
operand arrays, or its parameter tree as nested dicts of numpy arrays),
never objects of the reference package.
"""

from __future__ import annotations

import numpy as np
import torch

from .core import calibration, routing
from .core.batch import ARRAY_FIELDS, INDEX_FIELDS, MASK_FIELDS, DesignBatch
from .core.contracts import check_operands
from .core.transient import FusedOperands
from .device import resolve_device


def _tupled(fields: dict, keys) -> dict:
    out = dict(fields)
    for k in keys:
        if out.get(k) is not None:
            out[k] = tuple(out[k])
    return out


def tech_from_fields(fields: dict, overwrite: bool = False) -> calibration.TechCal:
    """Register a technology given as a field dict (`dataclasses.asdict`
    of a reference `TechCal`) and return the port's `TechCal`."""
    tech = calibration.TechCal(**_tupled(fields, ("allowed_schemes",
                                                  "layer_grid")))
    return calibration.register_tech(tech, overwrite=overwrite)


def scheme_from_fields(fields: dict, overwrite: bool = False) -> routing.SchemeSpec:
    """Register a routing scheme given as a field dict (`dataclasses.asdict`
    of a reference `SchemeSpec`) and return the port's `SchemeSpec`."""
    return routing.register_scheme(routing.SchemeSpec(**fields),
                                   overwrite=overwrite)


def operands_from_numpy(c, g, gc_res, gc_pre, v0, params, sa_tau_ns,
                        t_overhead_ns, replica: bool = False,
                        device="cuda") -> FusedOperands:
    """A `FusedOperands` batch on `device` from numpy operand arrays (the
    fields of a reference `FusedOperands`, in order), contract-checked."""
    dev = resolve_device(device)
    t = lambda x: torch.as_tensor(np.array(x, np.float32, order="C"),
                                  device=dev)
    operands = FusedOperands(t(c), t(g), t(gc_res), t(gc_pre), t(v0),
                             t(params), t(sa_tau_ns), t(t_overhead_ns),
                             replica=bool(replica))
    check_operands(operands, where="interop.operands_from_numpy")
    return operands


def batch_columns_from_numpy(columns: dict, tech_names, scheme_names,
                             corners: dict | None = None, n_samples: int = 1,
                             base_len: int = 0, device="cuda") -> DesignBatch:
    """A `DesignBatch` on `device` from numpy columns keyed by
    `DesignBatch` field names (e.g. the columns of a reference batch), so
    the port's `pareto_mask` / `best_design` can read them."""
    dev = resolve_device(device)

    def col(name):
        dtype = (np.int32 if name in INDEX_FIELDS
                 else bool if name in MASK_FIELDS else np.float32)
        return torch.as_tensor(np.array(columns[name], dtype), device=dev)

    return DesignBatch(
        corners={k: torch.as_tensor(np.array(v, np.float32), device=dev)
                 for k, v in (corners or {}).items()},
        tech_names=tuple(tech_names), scheme_names=tuple(scheme_names),
        n_samples=n_samples, base_len=base_len,
        **{f: col(f) for f in ARRAY_FIELDS})


def _tensor_from_numpy(a, dev) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":               # ml_dtypes bfloat16
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy())
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, order="C"))
    return t.to(device=dev)


def params_from_numpy(tree: dict, device="cuda") -> dict:
    """The port's parameter tree (nested dicts of tensors on `device`) from
    the reference's, given as nested dicts of numpy arrays
    (`jax.tree.map(np.asarray, params)`): bfloat16 arrays as ml_dtypes
    bfloat16, or already cast to float32 by the caller.  Each leaf keeps
    its array's dtype, so a tree in the config's `param_dtype` stays in
    it."""
    dev = resolve_device(device)

    def convert(node):
        if isinstance(node, dict):
            return {k: convert(v) for k, v in node.items()}
        return _tensor_from_numpy(node, dev)

    return convert(tree)
