"""Public kernel entry points with backend dispatch.

`backend="auto"` launches the CUDA kernel for CUDA tensors and runs the
plain PyTorch version for CPU tensors; `"ref"` forces the plain version on
any device; `"cuda"` forces the kernel and raises on CPU tensors.  There
is no fallback: a CUDA tensor under "auto" launches the kernel or raises.
"""

from __future__ import annotations

from . import ref
from .row_cycle import row_cycle_fused_cuda

BACKENDS = ("auto", "ref", "cuda")


def row_cycle_fused(c, g_branch, gc_res, gc_pre, v0, params, dt,
                    n_act, n_res, n_pre, backend: str = "auto"):
    """Fused ACT/RESTORE/PRE row-cycle engine -> (events (B,4), v_end (B,N)).

    Trace-free: O(B) outputs regardless of the number of time steps.  See
    `ref.row_cycle_fused_ref` for the params layout and event semantics.
    """
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of {BACKENDS}")
    if backend == "auto":
        backend = "cuda" if c.is_cuda else "ref"
    if backend == "cuda":
        return row_cycle_fused_cuda(c, g_branch, gc_res, gc_pre, v0, params,
                                    dt, n_act, n_res, n_pre)
    return ref.row_cycle_fused_ref(c, g_branch, gc_res, gc_pre, v0, params,
                                   dt, n_act, n_res, n_pre)


def tridiag_solve(dl, d, du, b):
    """Batched Thomas solve (plain PyTorch; the reference's is plain jnp)."""
    return ref.tridiag_solve_ref(dl, d, du, b)
