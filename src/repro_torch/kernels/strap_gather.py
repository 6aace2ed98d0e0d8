"""The strap-gated decode attention CUDA kernel: binding and wrapper.

`strap_attend_cuda` launches the hand-written sm_90a kernels in
`csrc/strap_attend.cu` (which replace the TPU kernel
`repro.kernels.strap_gather.strap_attend_pallas`) on PyTorch's current
stream: a split kernel, one block per (sequence, kv head, selected-strap
slot, chunk of tokens) as `split_plan` lays them out, and a combine kernel
that merges the blocks' float32 partials.  The kernels are compiled with
`nvcc` into `build/` at the repo root on first use and loaded with ctypes
(`kernels.build`); nothing is compiled or loaded when this module is
imported.  The plain version they are held against is
`kernels.ref.strap_attend_ref`; `kernels.ref.strap_attend_split_ref`
follows the split plan in plain PyTorch.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..runtime.trace import count
from . import build as _build

SOURCE = _build.CSRC / "strap_attend.cu"
LAUNCHES = "strap_attend.launches"   # the counter of its calls (`trace`)
MAX_HEAD_DIM = 256      # D the kernel takes (register accumulators)
MAX_GROUP = 8           # query heads per kv head (the mma's N = 8)
CHUNK_TOKENS = 128      # most tokens of one strap one block takes
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 9
             + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])


class SplitPlan(NamedTuple):
    """How one call is cut into blocks of the split kernel."""
    chunk: int       # tokens of a strap one block takes (at most)
    n_chunks: int    # blocks per selected-strap slot
    n_splits: int    # partials per (sequence, kv head): slots x chunks
    blocks: int      # split-kernel blocks: B x Hkv x n_splits


def split_plan(k_shape, pages_per_strap: int, n_sel: int) -> SplitPlan:
    """The split plan for pages of shape (B, P, page, Hkv, D) and `n_sel`
    selected straps a row: each slot's G*page tokens in chunks of at most
    `CHUNK_TOKENS`, one block per (sequence, kv head, slot, chunk)."""
    b, _, page, hkv, _ = k_shape
    blk = pages_per_strap * page
    chunk = min(CHUNK_TOKENS, blk)
    n_chunks = -(-blk // chunk)
    n_splits = n_sel * n_chunks
    return SplitPlan(chunk, n_chunks, n_splits, b * hkv * n_splits)


def vector_loads(k_pages, v_pages) -> bool:
    """Whether the kernel may copy K and V rows 16 bytes at a time: a row
    (D elements) is a whole number of 16-byte chunks and both base
    pointers are 16-byte aligned.  Otherwise it copies them element by
    element."""
    return ((k_pages.shape[-1] * k_pages.element_size()) % 16 == 0
            and k_pages.data_ptr() % 16 == 0 and v_pages.data_ptr() % 16 == 0)


def build():
    """Compile `csrc/strap_attend.cu` into `build/` (see `kernels.build`)
    and return the shared library's path."""
    return _build.build(SOURCE)


def _check_inputs(q, k_pages, v_pages, strap_ids, pages_per_strap,
                  lengths) -> None:
    name = "strap_attend_cuda"
    named = {"q": q, "k_pages": k_pages, "v_pages": v_pages,
             "strap_ids": strap_ids}
    if lengths is not None:
        named["lengths"] = lengths
    for key, t in named.items():
        if not t.is_cuda:
            raise ValueError(f"{name}: {key} is on {t.device}; the kernel "
                             "takes CUDA tensors only")
        if t.device != q.device:
            raise ValueError(f"{name}: {key} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
    if q.dtype not in _DTYPES:
        raise TypeError(f"{name}: q must be float32 or bfloat16, got {q.dtype}")
    for key in ("k_pages", "v_pages"):
        if named[key].dtype != q.dtype:
            raise TypeError(f"{name}: {key} is {named[key].dtype}, q is "
                            f"{q.dtype}; they must match")
    for key in ("strap_ids", "lengths"):
        if key in named and named[key].dtype != torch.int32:
            raise TypeError(f"{name}: {key} must be int32, got "
                            f"{named[key].dtype}")
    if q.ndim != 3 or k_pages.ndim != 5:
        raise ValueError(f"{name}: q must be (B, Hq, D) and k_pages "
                         f"(B, P, page, Hkv, D), got {tuple(q.shape)} and "
                         f"{tuple(k_pages.shape)}")
    b, p, _, hkv, d = k_pages.shape
    hq = q.shape[1]
    if tuple(q.shape) != (b, hq, d) or v_pages.shape != k_pages.shape:
        raise ValueError(f"{name}: q {tuple(q.shape)}, k_pages "
                         f"{tuple(k_pages.shape)} and v_pages "
                         f"{tuple(v_pages.shape)} do not agree")
    if d > MAX_HEAD_DIM:
        raise ValueError(f"{name}: head dim D={d} above the kernel's "
                         f"{MAX_HEAD_DIM}")
    if hkv == 0 or hq % hkv or hq // hkv > MAX_GROUP:
        raise ValueError(f"{name}: Hq={hq} must be a multiple of Hkv={hkv} "
                         f"with at most {MAX_GROUP} query heads per kv head")
    if pages_per_strap <= 0 or p % pages_per_strap:
        raise ValueError(f"{name}: P={p} pages is not a multiple of "
                         f"pages_per_strap={pages_per_strap}")
    if strap_ids.ndim != 2 or strap_ids.shape[0] != b:
        raise ValueError(f"{name}: strap_ids must be (B, S), got "
                         f"{tuple(strap_ids.shape)}")
    if lengths is not None and tuple(lengths.shape) != (b,):
        raise ValueError(f"{name}: lengths must be (B,), got "
                         f"{tuple(lengths.shape)}")


def strap_attend_cuda(q, k_pages, v_pages, strap_ids, pages_per_strap: int,
                      scale: float | None = None, lengths=None) -> torch.Tensor:
    """Launch the strap-attention kernels -> (B, Hq, D) in q's dtype.

    Same contract as `ref.strap_attend_ref`, on contiguous CUDA tensors:
    q, k_pages, v_pages float32 or bfloat16 (one dtype), strap_ids and
    lengths int32, D <= `MAX_HEAD_DIM`, Hq a multiple of Hkv with at most
    `MAX_GROUP` query heads per kv head.  One call runs two device kernels
    (split, then combine) and adds one to the counter `LAUNCHES`.
    """
    _check_inputs(q, k_pages, v_pages, strap_ids, pages_per_strap, lengths)
    b, p, page, hkv, d = k_pages.shape
    hq = q.shape[1]
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    out = torch.empty_like(q)
    if b == 0:
        return out
    n_sel = strap_ids.shape[1]
    plan = split_plan(k_pages.shape, pages_per_strap, n_sel)
    grp = hq // hkv
    part_ml = torch.empty((b, hkv, plan.n_splits, grp, 2),
                          dtype=torch.float32, device=q.device)
    part_acc = torch.empty((b, hkv, plan.n_splits, grp, d),
                           dtype=torch.float32, device=q.device)
    vec = int(vector_loads(k_pages, v_pages))
    fn = _build.load(SOURCE, "strap_attend_launch",
                     _ARGTYPES).strap_attend_launch
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                 strap_ids.data_ptr(),
                 None if lengths is None else lengths.data_ptr(),
                 out.data_ptr(), part_ml.data_ptr(), part_acc.data_ptr(),
                 b, p, page, hkv, d, hq, n_sel, int(pages_per_strap),
                 plan.chunk, float(scale), _DTYPES[q.dtype], vec, stream)
    if err:
        raise RuntimeError(f"strap_attend kernel launch failed: CUDA error "
                           f"{err}")
    count(LAUNCHES)
    return out
