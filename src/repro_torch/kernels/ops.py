"""Public kernel entry points with backend dispatch.

`backend="auto"` launches the CUDA kernel for CUDA tensors and runs the
plain PyTorch version for CPU tensors; `"ref"` forces the plain version on
any device; `"cuda"` forces the kernel and raises on CPU tensors.  There
is no fallback: a CUDA tensor under "auto" launches the kernel or raises.
"""

from __future__ import annotations

from . import ref
from .pareto import pareto_dominated_cuda
from .rc_transient import rc_multistep_cuda
from .row_cycle import row_cycle_fused_cuda
from .strap_gather import strap_attend_cuda

BACKENDS = ("auto", "ref", "cuda")


def resolve_backend(backend: str, x) -> str:
    """The backend a call on tensor `x` runs: "cuda" or "ref"."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of {BACKENDS}")
    if backend == "auto":
        return "cuda" if x.is_cuda else "ref"
    return backend


def rc_multistep(c, g_branch, g_clamp, v_clamp, v0, ramp, dt,
                 backend: str = "auto"):
    """Batched RC-ladder implicit-Euler transient -> (T, B, N) trace.

    See `ref.rc_multistep_ref` for the operands; the access (last) branch
    is scaled by `ramp[t]` at step t.
    """
    if resolve_backend(backend, c) == "cuda":
        return rc_multistep_cuda(c, g_branch, g_clamp, v_clamp, v0, ramp, dt)
    return ref.rc_multistep_ref(c, g_branch, g_clamp, v_clamp, v0, ramp, dt)


def row_cycle_fused(c, g_branch, gc_res, gc_pre, v0, params, dt,
                    n_act, n_res, n_pre, backend: str = "auto"):
    """Fused ACT/RESTORE/PRE row-cycle engine -> (events (B,4), v_end (B,N)).

    Trace-free: O(B) outputs regardless of the number of time steps.  See
    `ref.row_cycle_fused_ref` for the params layout and event semantics.
    """
    if resolve_backend(backend, c) == "cuda":
        return row_cycle_fused_cuda(c, g_branch, gc_res, gc_pre, v0, params,
                                    dt, n_act, n_res, n_pre)
    return ref.row_cycle_fused_ref(c, g_branch, gc_res, gc_pre, v0, params,
                                   dt, n_act, n_res, n_pre)


def strap_attend(q, k_pages, v_pages, strap_ids, pages_per_strap,
                 scale=None, backend: str = "auto", lengths=None):
    """Selector+strap gated decode attention -> (B, Hq, D) in q's dtype.

    `lengths` ((B,) int32, optional) is the valid token count per sequence;
    tokens at flat positions >= lengths[b] are padding inside a partially
    filled strap and are masked out of the softmax.  `None` attends every
    token of every selected strap.  See `ref.strap_attend_ref`.
    """
    if resolve_backend(backend, q) == "cuda":
        return strap_attend_cuda(q, k_pages, v_pages, strap_ids,
                                 pages_per_strap, scale, lengths=lengths)
    return ref.strap_attend_ref(q, k_pages, v_pages, strap_ids,
                                pages_per_strap, scale, lengths=lengths)


def pareto_dominated(hi_d, lo_d, cand_d, hi, lo, cand, block: int = 4096,
                     backend: str = "auto"):
    """Which rows of (hi, lo, cand) some candidate dominator row of
    (hi_d, lo_d, cand_d) dominates -> (B,) bool, on hi's device.

    `dse.pareto_mask` passes the batch as its own dominators; the sharded
    mask passes each slot's slab of them.  CUDA tensors go to the
    dominance kernel (`pareto.pareto_dominated_cuda`), CPU tensors to
    its plain version (`ref.pareto_dominated_ref`), which runs the
    dominators in blocks of `block` rows, each one masked broadcast
    against the whole batch; `block` does not reach the kernel.  Both
    count their dominance tests in `pareto.pairs`: the plain version
    every dominator row against every row, the kernel the pairs it
    schedules.
    """
    if resolve_backend(backend, hi) == "cuda":
        return pareto_dominated_cuda(hi_d, lo_d, cand_d, hi, lo, cand)
    return ref.pareto_dominated_ref(hi_d, lo_d, cand_d, hi, lo, cand, block)


def tridiag_solve(dl, d, du, b):
    """Batched Thomas solve (plain PyTorch; the reference's is plain jnp)."""
    return ref.tridiag_solve_ref(dl, d, du, b)
