"""The fused row-cycle CUDA kernel: build, binding and wrapper.

`row_cycle_fused_cuda` launches the hand-written sm_90a kernel in
`csrc/row_cycle.cu` (which replaces the TPU kernel
`repro.kernels.row_cycle.row_cycle_fused_pallas`) on PyTorch's current
stream.  The kernel is compiled with `nvcc` into `build/` at the repo root
on first use and loaded with ctypes; nothing is compiled or loaded when
this module is imported.  The plain version it is held against is
`kernels.ref.row_cycle_fused_ref`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

from .ref import N_EVENTS, PAR_ROLE, ROLE_MAIN

SOURCE = Path(__file__).resolve().parent / "csrc" / "row_cycle.cu"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
# FMA contraction off: the kernel then rounds like the plain version.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-fmad=false",
              "-Xptxas", "-v")
KERNEL_NODES = (4, 6, 8)   # ladder sizes the kernel is instantiated for

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(cuda_home) / "bin" / "nvcc"] if cuda_home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(Path(found))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for path in candidates:
        if path.is_file():
            return str(path)
    raise RuntimeError("nvcc not found (set CUDA_HOME); the row-cycle "
                       "kernel is compiled from csrc/row_cycle.cu at first use")


def build() -> Path:
    """Compile `csrc/row_cycle.cu` into `build/` (once per source and flag
    set) and return the shared library's path.  The compiler's resource
    report (`-Xptxas -v`) is kept beside it as `<lib>.ptxas.txt`."""
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    lib = BUILD_DIR / f"librow_cycle-{digest}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    Path(f"{lib}.ptxas.txt").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)
    return lib


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            fn = lib.row_cycle_fused_launch
            fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int]
                           + [ctypes.c_void_p] * 2
                           + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                              ctypes.c_int, ctypes.c_int, ctypes.c_int,
                              ctypes.c_void_p])
            fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def _check_inputs(c, g_branch, gc_res, gc_pre, v0, params) -> None:
    named = {"c": c, "g_branch": g_branch, "gc_res": gc_res,
             "gc_pre": gc_pre, "v0": v0, "params": params}
    for name, t in named.items():
        if not t.is_cuda:
            raise ValueError(f"row_cycle_fused_cuda: {name} is on {t.device}; "
                             "the kernel takes CUDA tensors only")
        if t.device != c.device:
            raise ValueError(f"row_cycle_fused_cuda: {name} is on {t.device}, "
                             f"c on {c.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"row_cycle_fused_cuda: {name} must be float32, "
                            f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"row_cycle_fused_cuda: {name} must be contiguous")
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
    fn = _load().row_cycle_fused_launch
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
