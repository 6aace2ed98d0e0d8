"""The fused row-cycle CUDA kernel: build, binding and wrapper.

`row_cycle_fused_cuda` launches the hand-written sm_90a kernel in
`csrc/row_cycle.cu` (which replaces the TPU kernel
`repro.kernels.row_cycle.row_cycle_fused_pallas`) on PyTorch's current
stream.  The kernel is compiled with `nvcc` into `build/` at the repo root
on first use and loaded with ctypes (`kernels.build`); nothing is
compiled or loaded when this module is imported.  The plain version it is
held against is `kernels.ref.row_cycle_fused_ref`.
"""

from __future__ import annotations

import ctypes

import torch

from . import build as _build
from .ref import N_EVENTS, PAR_ROLE, ROLE_MAIN

SOURCE = _build.CSRC / "row_cycle.cu"
KERNEL_NODES = (4, 6, 8)   # ladder sizes the kernel is instantiated for
_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int]
             + [ctypes.c_void_p] * 2
             + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])


def build():
    """Compile `csrc/row_cycle.cu` into `build/` (see `kernels.build`) and
    return the shared library's path."""
    return _build.build(SOURCE)


def _check_inputs(c, g_branch, gc_res, gc_pre, v0, params) -> None:
    named = {"c": c, "g_branch": g_branch, "gc_res": gc_res,
             "gc_pre": gc_pre, "v0": v0, "params": params}
    _build.check_cuda_tensors("row_cycle_fused_cuda", named, c)
    if c.ndim != 2:
        raise ValueError(f"row_cycle_fused_cuda: c must be (B, N), got {tuple(c.shape)}")
    b, n = c.shape
    if n not in KERNEL_NODES:
        raise ValueError(f"row_cycle_fused_cuda: N={n} not supported; the "
                         f"kernel is built for N in {KERNEL_NODES}")
    expected = {"g_branch": (b, n - 1), "gc_res": (b, n), "gc_pre": (b, n),
                "v0": (b, n)}
    for name, shape in expected.items():
        if tuple(named[name].shape) != shape:
            raise ValueError(f"row_cycle_fused_cuda: {name} must be {shape}, "
                             f"got {tuple(named[name].shape)}")
    if params.ndim != 2 or params.shape[0] != b or params.shape[1] not in (5, 6):
        raise ValueError("row_cycle_fused_cuda: params must be (B, 5) or "
                         f"(B, 6), got {tuple(params.shape)}")
    # A main row takes its SA enable from row-1 through a warp shuffle; at
    # an even index that row would sit in the previous pair (the reference
    # wraps around to the last row instead), so such inputs are refused.
    if params.shape[1] > PAR_ROLE and b and bool(
            (params[0::2, PAR_ROLE] > ROLE_MAIN - 0.5).any()):
        raise ValueError("row_cycle_fused_cuda: a role-2 (main) row sits at "
                         "an even index; replica pairs must be [replica, "
                         "main] at [even, odd] rows")


def row_cycle_fused_cuda(c, g_branch, gc_res, gc_pre, v0, params,
                         dt: float, n_act: int, n_res: int, n_pre: int):
    """Launch the fused row-cycle kernel -> (events (B, 4), v_end (B, N)).

    Same contract as `ref.row_cycle_fused_ref`, on contiguous float32 CUDA
    tensors with N in `KERNEL_NODES`.  Adds one to
    `row_cycle_fused_cuda.launches` per kernel launch.
    """
    _check_inputs(c, g_branch, gc_res, gc_pre, v0, params)
    fn = _build.load(SOURCE, "row_cycle_fused_launch",
                     _ARGTYPES).row_cycle_fused_launch
    b, n = c.shape
    events = torch.empty((b, N_EVENTS), dtype=torch.float32, device=c.device)
    v_end = torch.empty((b, n), dtype=torch.float32, device=c.device)
    with torch.cuda.device(c.device):
        stream = torch.cuda.current_stream(c.device).cuda_stream
        err = fn(c.data_ptr(), g_branch.data_ptr(), gc_res.data_ptr(),
                 gc_pre.data_ptr(), v0.data_ptr(), params.data_ptr(),
                 params.shape[1], events.data_ptr(), v_end.data_ptr(),
                 b, n, float(dt), int(n_act), int(n_res), int(n_pre), stream)
    if err:
        raise RuntimeError(f"row_cycle_fused kernel launch failed: CUDA "
                           f"error {err}")
    row_cycle_fused_cuda.launches += 1
    return events, v_end


row_cycle_fused_cuda.launches = 0
