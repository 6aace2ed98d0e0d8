"""Device resolution and the tensor conversions shared by the port.

Every entry point takes `device=` and defaults to "cuda".  Without a
GPU it refuses to run rather than silently carrying on on the CPU; the
caller asks for the CPU explicitly with `device="cpu"`.

`as_f32` / `as_bool` mirror the reference's implicit conversions: JAX
(with 64-bit mode off) turns a float64 numpy gather into float32 the
moment it meets a jnp op, so the port converts at exactly those points
and keeps numpy-with-numpy arithmetic (e.g. a difference of two float64
calibration gathers) on the host in float64, as the reference does.
"""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device="cuda") -> torch.device:
    """`device` as a `torch.device`; raises if it names CUDA and there is
    no GPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device=\"cpu\" to run the "
            "plain PyTorch path on the CPU")
    return dev


def as_f32(x, device) -> torch.Tensor:
    """Scalar / numpy array / tensor -> float32 tensor on `device`."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(x), dtype=torch.float32, device=device)


def as_bool(x, device) -> torch.Tensor:
    """Scalar / numpy array / tensor -> bool tensor on `device`."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.bool)
    return torch.as_tensor(np.asarray(x, bool), device=device)


def rdiv(num: float, t: torch.Tensor) -> torch.Tensor:
    """`num / t` as ONE correctly rounded division.

    `float / tensor` in PyTorch is `t.reciprocal() * num` (two roundings);
    the reference divides once, so the port divides by the tensor with
    the numerator as a 0-d tensor on the same device.
    """
    return torch.tensor(num, dtype=t.dtype, device=t.device) / t


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
