"""Opt-in runtime contracts for the fused sweep pipeline.

Port of `repro.core.contracts`.  Validates operand shapes/dtypes at the
`lower_design_operands` seam and batch-layout/mask consistency at the
`dse.sweep` seam.  Checks cost nothing unless `REPRO_CHECKS=1` (which
`tests/conftest.py` sets under pytest): every entry point returns before
touching its argument when disabled.  Value checks copy to the host.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..device import to_host


class ContractError(AssertionError):
    """A fused-pipeline invariant violated at a checked seam."""


def checks_enabled() -> bool:
    """Read `REPRO_CHECKS` lazily so tests can flip it per call."""
    return os.environ.get("REPRO_CHECKS", "0") == "1"


def _fail(where: str, msg: str):
    raise ContractError(f"[{where}] {msg}")


def check_operands(operands, where: str = "lower_operands") -> None:
    """Validate a `FusedOperands` batch: kernel operand shapes, float32
    dtypes, finiteness, and the [replica, main] pair layout: a role-2
    (main) row may only sit at an odd index, right after its replica."""
    if not checks_enabled():
        return
    from ..kernels.ref import ROLE_MAIN, ROLE_REPLICA

    c, g, gc_res, gc_pre, v0, params = operands[:6]
    sa_tau, overhead = operands.sa_tau_ns, operands.t_overhead_ns
    if c.ndim != 2:
        _fail(where, f"c must be (B, N), got shape {tuple(c.shape)}")
    b, n = c.shape
    expected = {"g": (g, (b, n - 1)), "gc_res": (gc_res, (b, n)),
                "gc_pre": (gc_pre, (b, n)), "v0": (v0, (b, n)),
                "sa_tau_ns": (sa_tau, (b,)), "t_overhead_ns": (overhead, (b,))}
    for name, (arr, shape) in expected.items():
        if tuple(arr.shape) != shape:
            _fail(where, f"{name} must have shape {shape} (from c = "
                         f"{tuple(c.shape)}), got {tuple(arr.shape)}")
    if params.ndim != 2 or params.shape[0] != b or params.shape[1] not in (5, 6):
        _fail(where, f"params must be (B, 5|6) per-point kernel params, "
                     f"got {tuple(params.shape)}")
    named = [("c", c), ("g", g), ("gc_res", gc_res), ("gc_pre", gc_pre),
             ("v0", v0), ("params", params), ("sa_tau_ns", sa_tau),
             ("t_overhead_ns", overhead)]
    for name, arr in named:
        if arr.dtype != torch.float32:
            _fail(where, f"{name} must be float32, got {arr.dtype}")
    replica = bool(operands.replica)
    if replica and b % 2:
        _fail(where, f"replica mode interleaves [replica, main] pairs; "
                     f"B={b} must be even")
    for name, arr in named:
        if not np.isfinite(to_host(arr)).all():
            _fail(where, f"{name} contains non-finite operand values — "
                         "infeasible points must lower to INACTIVE rows, "
                         "never NaN/inf operands")
    if params.shape[1] == 6:
        role = to_host(params[:, 5])
        if np.any(role[0::2] > ROLE_MAIN - 0.5):
            _fail(where, "a role-2 (main) row sits at an even index; its SA "
                         "enable comes from the replica at row-1, so pairs "
                         "must be [replica, main] at [even, odd] rows")
        if replica and not (np.all(role[0::2] == ROLE_REPLICA)
                            and np.all(role[1::2] == ROLE_MAIN)):
            _fail(where, "replica mode requires role columns interleaved "
                         f"[ROLE_REPLICA={ROLE_REPLICA}, "
                         f"ROLE_MAIN={ROLE_MAIN}] per design point")


def check_batch(batch, where: str = "dse.sweep") -> None:
    """Validate a `DesignBatch`: every array field on the one (B,) batch
    axis, boolean masks with `feasible ⊆ valid`, corner channels shaped
    (B,) with reserved `mc_*` names confined to the registered MC axes,
    and the sample-major MC layout (`len == n_samples * base_len`)."""
    if not checks_enabled():
        return
    from .batch import ARRAY_FIELDS
    from .space import MC_AXES, MC_LOG_W

    b = int(batch.tech_idx.shape[0])
    for name in ARRAY_FIELDS:
        arr = getattr(batch, name)
        if arr.ndim != 1 or int(arr.shape[0]) != b:
            _fail(where, f"batch.{name} must be ({b},) on the single "
                         f"batch axis, got shape {tuple(arr.shape)}")
    for name in ("manufacturable", "feasible", "valid"):
        if getattr(batch, name).dtype != torch.bool:
            _fail(where, f"batch.{name} must be bool, got "
                         f"{getattr(batch, name).dtype}")
    for key, arr in batch.corners.items():
        if key.startswith("mc_") and key not in MC_AXES and key != MC_LOG_W:
            _fail(where, f"corner channel {key!r} uses the reserved mc_* "
                         f"namespace; only {MC_AXES + (MC_LOG_W,)} may be "
                         "written (and only by core/space.py)")
        if tuple(arr.shape) != (b,):
            _fail(where, f"corner channel {key!r} must be ({b},), got "
                         f"{tuple(arr.shape)}")
    n_samples = int(batch.n_samples or 1)
    base_len = int(batch.base_len or 0)
    if n_samples > 1 and (base_len <= 0 or n_samples * base_len != b):
        _fail(where, f"MC batch must be sample-major with len == "
                     f"n_samples * base_len; got len={b}, "
                     f"n_samples={n_samples}, base_len={base_len}")
    valid = to_host(batch.valid)
    feasible = to_host(batch.feasible)
    if not np.all(valid | ~feasible):
        _fail(where, "feasible rows must be a subset of valid rows "
                     "(padding can never be feasible)")
    layers = to_host(batch.layers)
    if valid.any() and not np.isfinite(layers[valid]).all():
        _fail(where, "valid rows must carry finite layer counts")
