"""The multi-step RC-ladder CUDA kernel: binding and wrapper.

`rc_multistep_cuda` launches the hand-written sm_90a kernel in
`csrc/rc_multistep.cu` (which replaces the TPU kernel
`repro.kernels.rc_transient.rc_multistep_pallas`) on PyTorch's current
stream.  The kernel is compiled with `nvcc` into `build/` at the repo root
on first use and loaded with ctypes (`kernels.build`); nothing is
compiled or loaded when this module is imported.  The plain version it is
held against is `kernels.ref.rc_multistep_ref`.
"""

from __future__ import annotations

import ctypes

import torch

from . import build as _build

SOURCE = _build.CSRC / "rc_multistep.cu"
KERNEL_NODES = (4, 6, 8)   # ladder sizes the kernel is instantiated for
_ARGTYPES = ([ctypes.c_void_p] * 7
             + [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                ctypes.c_void_p])


def build():
    """Compile `csrc/rc_multistep.cu` into `build/` (see `kernels.build`)
    and return the shared library's path."""
    return _build.build(SOURCE)


def _check_inputs(c, g_branch, g_clamp, v_clamp, v0, ramp) -> None:
    named = {"c": c, "g_branch": g_branch, "g_clamp": g_clamp,
             "v_clamp": v_clamp, "v0": v0, "ramp": ramp}
    _build.check_cuda_tensors("rc_multistep_cuda", named, c)
    if c.ndim != 2:
        raise ValueError("rc_multistep_cuda: c must be (B, N), got "
                         f"{tuple(c.shape)}")
    b, n = c.shape
    if n not in KERNEL_NODES:
        raise ValueError(f"rc_multistep_cuda: N={n} not supported; the "
                         f"kernel is built for N in {KERNEL_NODES}")
    expected = {"g_branch": (b, n - 1), "g_clamp": (b, n),
                "v_clamp": (b, n), "v0": (b, n)}
    for name, shape in expected.items():
        if tuple(named[name].shape) != shape:
            raise ValueError(f"rc_multistep_cuda: {name} must be {shape}, "
                             f"got {tuple(named[name].shape)}")
    if ramp.ndim != 1:
        raise ValueError("rc_multistep_cuda: ramp must be (T,), got "
                         f"{tuple(ramp.shape)}")


def rc_multistep_cuda(c, g_branch, g_clamp, v_clamp, v0, ramp,
                      dt: float) -> torch.Tensor:
    """Launch the RC-ladder kernel -> trace (T, B, N).

    Same contract as `ref.rc_multistep_ref`, on contiguous float32 CUDA
    tensors with N in `KERNEL_NODES`.  Adds one to
    `rc_multistep_cuda.launches` per kernel launch (an empty batch or an
    empty ramp launches nothing).
    """
    _check_inputs(c, g_branch, g_clamp, v_clamp, v0, ramp)
    b, n = c.shape
    t = ramp.shape[0]
    trace = torch.empty((t, b, n), dtype=torch.float32, device=c.device)
    if b == 0 or t == 0:
        return trace
    fn = _build.load(SOURCE, "rc_multistep_launch",
                     _ARGTYPES).rc_multistep_launch
    with torch.cuda.device(c.device):
        stream = torch.cuda.current_stream(c.device).cuda_stream
        err = fn(c.data_ptr(), g_branch.data_ptr(), g_clamp.data_ptr(),
                 v_clamp.data_ptr(), v0.data_ptr(), ramp.data_ptr(),
                 trace.data_ptr(), b, n, t, float(dt), stream)
    if err:
        raise RuntimeError(f"rc_multistep kernel launch failed: CUDA "
                           f"error {err}")
    rc_multistep_cuda.launches += 1
    return trace


rc_multistep_cuda.launches = 0
