"""Device resolution and the tensor conversions shared by the port.

Every entry point takes `device=` and defaults to "cuda".  Without a
GPU it refuses to run rather than silently carrying on on the CPU; the
caller asks for the CPU explicitly with `device="cpu"`.

`as_f32` / `as_bool` mirror the reference's implicit conversions: JAX
(with 64-bit mode off) turns a float64 numpy gather into float32 the
moment it meets a jnp op, so the port converts at exactly those points
and keeps numpy-with-numpy arithmetic (e.g. a difference of two float64
calibration gathers) on the host in float64, as the reference does.

A scalar is built on the device (`scalar_f32`: a fill, with no copy from
the host).  A plain copy from pageable host memory synchronizes the
stream, draining the card's queue before the host can enqueue the next
kernel; an array that a sync-free path takes goes through pinned memory
without blocking instead (`as_f32(..., non_blocking=True)`).

The helpers are the port's copies from the host to a device: each adds
the bytes it moves to the counter `h2d.bytes` (`runtime.trace`).
"""

from __future__ import annotations

import numpy as np
import torch

from .runtime import trace

H2D_BYTES = "h2d.bytes"


def resolve_device(device="cuda") -> torch.device:
    """`device` as a `torch.device`; raises if it names CUDA and there is
    no GPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device=\"cpu\" to run the "
            "plain PyTorch path on the CPU")
    return dev


def scalar_f32(x, device) -> torch.Tensor:
    """A 0-d float32 tensor holding x rounded to float32, built on `device`
    with no copy from the host.  Dividing or comparing by it is one float32
    operation, as in the reference: a Python-scalar (or CPU 0-d) divisor
    of a CUDA tensor becomes a reciprocal multiply."""
    if isinstance(x, (float, np.floating)):
        with np.errstate(over="ignore"):     # past float32's range: +-inf
            x = float(np.float32(x))
    return torch.full((), x, dtype=torch.float32, device=device)


def _moved(t: torch.Tensor, from_host: bool = True) -> torch.Tensor:
    """`t`, with its bytes counted when it was copied from the host to a
    device."""
    if from_host and t.device.type != "cpu":
        trace.count(H2D_BYTES, t.numel() * t.element_size())
    return t


def _tensor_to(x: torch.Tensor, device, dtype) -> torch.Tensor:
    return _moved(x.to(device=device, dtype=dtype), x.device.type == "cpu")


def as_f32(x, device, non_blocking: bool = False) -> torch.Tensor:
    """Scalar / numpy array / tensor -> float32 tensor on `device`.

    A scalar is filled on the device.  An array is copied; with
    `non_blocking` to a GPU through pinned memory, ordered on the current
    stream without the host waiting, which suits a small array on a path
    that must not wait for the card; without it, by a plain copy, which is
    the faster of the two for the sweep plan's large columns.
    """
    if isinstance(x, torch.Tensor):
        return _tensor_to(x, device, torch.float32)
    arr = np.asarray(x)
    if arr.ndim == 0:
        return scalar_f32(arr.item(), device)
    if non_blocking and torch.device(device).type == "cuda":
        host = torch.as_tensor(arr, dtype=torch.float32).pin_memory()
        return _moved(host.to(device, non_blocking=True))
    return _moved(torch.as_tensor(arr, dtype=torch.float32, device=device))


def as_bool(x, device) -> torch.Tensor:
    """Scalar / numpy array / tensor -> bool tensor on `device` (a scalar
    filled on the device)."""
    if isinstance(x, torch.Tensor):
        return _tensor_to(x, device, torch.bool)
    arr = np.asarray(x, bool)
    if arr.ndim == 0:
        return torch.full((), bool(arr), dtype=torch.bool, device=device)
    return _moved(torch.as_tensor(arr, device=device))


def as_i32(x, device) -> torch.Tensor:
    """Scalar / numpy array / tensor -> int32 tensor on `device` (a scalar
    filled on the device)."""
    if isinstance(x, torch.Tensor):
        return _tensor_to(x, device, torch.int32)
    arr = np.asarray(x, np.int32)
    if arr.ndim == 0:
        return torch.full((), int(arr), dtype=torch.int32, device=device)
    return _moved(torch.as_tensor(arr, device=device))


def to_host(x) -> np.ndarray:
    """A tensor (on any device) or array-like as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def rdiv(num: float, t: torch.Tensor) -> torch.Tensor:
    """`num / t` as ONE correctly rounded division.

    `float / tensor` in PyTorch is `t.reciprocal() * num` (two roundings);
    the reference divides once, so the port divides by the tensor with
    the numerator as a 0-d tensor on the same device.
    """
    return torch.full((), num, dtype=t.dtype, device=t.device) / t


def row_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis, strictly left to right.

    XLA's CPU reduction of a short row is sequential; `torch.sum` splits
    it into vector lanes (and CUDA into a tree), which moves the last ulp.
    A fixed order keeps the port's CPU and GPU paths and the reference
    bit-identical on this sum.
    """
    acc = x[..., 0]
    for i in range(1, x.shape[-1]):
        acc = acc + x[..., i]
    return acc
