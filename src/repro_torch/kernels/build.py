"""Build and load the port's CUDA kernels: nvcc into `build/`, ctypes.

Every kernel source under `csrc/` is compiled the same way: `nvcc` for
sm_90a into a shared library with a plain C interface, named by a hash of
the source and the flags, in `build/` at the repo root, on first use; the
library is then loaded with ctypes.  Nothing is compiled or loaded when a
module is imported.
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

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
# FMA contraction off: a kernel then rounds like its plain version.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-fmad=false",
              "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict = {}


def nvcc() -> str:
    """Path of the CUDA compiler: $CUDA_HOME/bin, then PATH, then
    /usr/local/cuda/bin."""
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(cuda_home) / "bin" / "nvcc"] if cuda_home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(Path(found))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for path in candidates:
        if path.is_file():
            return str(path)
    raise RuntimeError("nvcc not found (set CUDA_HOME); the port's kernels "
                       "are compiled from kernels/csrc/ at first use")


def library_path(source: Path) -> Path:
    """Where `source`'s library is built: `build/lib<stem>-<hash>.so`, the
    hash over the source and the flags."""
    digest = hashlib.sha256(source.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{source.stem}-{digest}.so"


def nvcc_command(source: Path, out: Path, compiler: str = "nvcc") -> list:
    """The nvcc command line that builds `source` into `out`."""
    return [compiler, *NVCC_FLAGS, "-o", str(out), str(source)]


def build(source: Path) -> Path:
    """Compile `source` into `build/` (once per source and flag set) and
    return the shared library's path.  The compiler's resource report
    (`-Xptxas -v`) is kept beside it as `<lib>.ptxas.txt`."""
    lib = library_path(source)
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = nvcc_command(source, tmp, nvcc())
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    Path(f"{lib}.ptxas.txt").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)
    return lib


def load(source: Path, symbol: str, argtypes) -> ctypes.CDLL:
    """Build `source` if needed, load it once per process and declare
    `symbol`'s C signature (returns an int CUDA error code)."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            lib = ctypes.CDLL(str(build(source)))
            fn = getattr(lib, symbol)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
            _libs[source] = lib
        return lib


def check_cuda_tensors(kernel: str, named: dict, like) -> None:
    """Every tensor in `named` is a contiguous float32 CUDA tensor on the
    device of `like` (the operand `c`); raises otherwise."""
    for name, t in named.items():
        if not t.is_cuda:
            raise ValueError(f"{kernel}: {name} is on {t.device}; "
                             "the kernel takes CUDA tensors only")
        if t.device != like.device:
            raise ValueError(f"{kernel}: {name} is on {t.device}, "
                             f"c on {like.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{kernel}: {name} must be float32, "
                            f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be contiguous")
