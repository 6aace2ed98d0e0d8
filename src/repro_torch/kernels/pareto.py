"""The Pareto dominance CUDA kernel: build, binding and wrapper.

`pareto_dominated_cuda` computes `ref.pareto_dominated_ref`'s function
with the hand-written sm_90a kernel in `csrc/pareto.cu` (it replaces no
TPU kernel: the reference's `pareto_mask` is plain jnp), on PyTorch's
current stream.  Around the kernel, in PyTorch:

1. Compact and pack each side: only candidate rows whose objectives are
   all non-NaN (any other row neither dominates nor is dominated), as
   (N, 4) or (N, 8) float32 rows with the minimized columns negated (an
   exact sign flip) and the spare columns 0.  One synchronization a side
   (`nonzero`); one in all where the dominators are the targets.
2. The filter pass: every target against the first `CHUNK` dominators.
3. The survivors (a second synchronization) against the rest, in blocks
   of `CHUNK` dominators.  A row the filter found dominated is
   dominated, so the union is the plain version's mask, bit for bit.
   One launch over all the dominators instead, without the filter pass
   and the second synchronization, is slower on an H100: 1.05 against
   0.70 ms for the 299,008-row grid-mc4096 batch.
4. Scatter the flags back into a (B,) bool on hi's device.

The kernel is compiled with `nvcc` into `build/` at the repo root on
first use and loaded with ctypes (`kernels.build`); nothing is compiled
or loaded when this module is imported.
"""

from __future__ import annotations

import ctypes

import torch

from ..runtime.trace import count
from . import build as _build

SOURCE = _build.CSRC / "pareto.cu"
LAUNCHES = "pareto.launches"   # the counter of its launches (`trace`)
MAX_OBJECTIVES = 8             # K the kernel takes: rows of 1 or 2 float4s
CHUNK = 2048                   # dominators a block tests; the filter's size
_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]


def build():
    """Compile `csrc/pareto.cu` into `build/` (see `kernels.build`) and
    return the shared library's path."""
    return _build.build(SOURCE)


def _check_inputs(hi_d, lo_d, cand_d, hi, lo, cand) -> None:
    for name, t in {"hi_d": hi_d, "lo_d": lo_d, "hi": hi, "lo": lo}.items():
        if not t.is_cuda or t.device != hi.device:
            raise ValueError(f"pareto_dominated_cuda: {name} is on "
                             f"{t.device}; the kernel takes CUDA tensors "
                             f"of one device (hi on {hi.device})")
        if t.dtype != torch.float32:
            raise TypeError(f"pareto_dominated_cuda: {name} must be "
                            f"float32, got {t.dtype}")
    for name, (h, low, c) in {"dominators": (hi_d, lo_d, cand_d),
                              "targets": (hi, lo, cand)}.items():
        if h.ndim != 2 or low.ndim != 2 or h.shape[0] != low.shape[0]:
            raise ValueError(f"pareto_dominated_cuda: {name}' hi and lo must "
                             f"be (B, K) with one B, got {tuple(h.shape)} "
                             f"and {tuple(low.shape)}")
        if c.dtype != torch.bool or tuple(c.shape) != (h.shape[0],):
            raise ValueError(f"pareto_dominated_cuda: {name}' cand must be a "
                             f"({h.shape[0]},) bool, got {c.dtype} "
                             f"{tuple(c.shape)}")
        if c.device != hi.device:
            raise ValueError(f"pareto_dominated_cuda: {name}' cand is on "
                             f"{c.device}, hi on {hi.device}")
    if (hi_d.shape[1], lo_d.shape[1]) != (hi.shape[1], lo.shape[1]):
        raise ValueError("pareto_dominated_cuda: dominators and targets "
                         "must have the same objective columns")
    k = hi.shape[1] + lo.shape[1]
    if k > MAX_OBJECTIVES:
        raise ValueError(f"pareto_dominated_cuda: {k} objectives; the "
                         f"kernel takes at most {MAX_OBJECTIVES}")


def pack(hi, lo, cand):
    """The rows that can dominate or be dominated, packed -> (rows (N,)
    int64 indices into the batch, (N, 4) or (N, 8) float32): the candidate
    rows with no NaN objective, the `hi` columns then the negated `lo`
    ones, zeros after them."""
    obj = torch.cat([hi, -lo], dim=1)
    rows = torch.nonzero(cand & ~obj.isnan().any(dim=1)).squeeze(1)
    k = obj.shape[1]
    width = 4 if k <= 4 else 8
    return rows, torch.nn.functional.pad(obj[rows], (0, width - k))


def dominated_flags(tgt, dom, launch):
    """The two passes over packed rows -> ((N_t,) uint8 flags, 1 where a
    row of `dom` dominates that row of `tgt`; the pairs the passes
    scheduled).  `launch(tgt, dom, flags)` sets `flags` where a row of
    `dom` dominates."""
    n_t, n_d = tgt.shape[0], dom.shape[0]
    flags = torch.zeros((n_t,), dtype=torch.uint8, device=tgt.device)
    if n_t == 0 or n_d == 0:
        return flags, 0
    launch(tgt, dom[:CHUNK], flags)                    # the filter pass
    pairs = n_t * min(CHUNK, n_d)
    if n_d > CHUNK:
        survivors = torch.nonzero(flags == 0).squeeze(1)
        if survivors.numel():
            rest = torch.zeros((survivors.numel(),), dtype=torch.uint8,
                               device=tgt.device)
            launch(tgt[survivors], dom[CHUNK:], rest)
            flags[survivors] = rest
            pairs += survivors.numel() * (n_d - CHUNK)
    return flags, pairs


def dominated_with(launch, hi_d, lo_d, cand_d, hi, lo, cand):
    """`pareto_dominated_cuda`'s steps around the kernel, with `launch`
    (see `dominated_flags`) in its place -> (B,) bool on hi's device.
    Counts `pareto.pairs`: the pairs the two passes scheduled."""
    rows, tgt = pack(hi, lo, cand)
    if hi_d is hi and lo_d is lo and cand_d is cand:
        dom = tgt
    else:
        dom = pack(hi_d, lo_d, cand_d)[1]
    flags, pairs = dominated_flags(tgt, dom, launch)
    count("pareto.pairs", pairs)
    dominated = torch.zeros((hi.shape[0],), dtype=torch.bool,
                            device=hi.device)
    dominated[rows] = flags.bool()
    return dominated


def pareto_dominated_cuda(hi_d, lo_d, cand_d, hi, lo, cand):
    """Which rows of (hi, lo, cand) some candidate dominator row of
    (hi_d, lo_d, cand_d) dominates -> (B,) bool, on hi's device.

    Same contract as `ref.pareto_dominated_ref`, on float32 CUDA tensors
    of one device with at most `MAX_OBJECTIVES` columns in all.  Adds one
    to the counter `LAUNCHES` per kernel launch (one or two a call).
    """
    _check_inputs(hi_d, lo_d, cand_d, hi, lo, cand)
    fn = _build.load(SOURCE, "pareto_dominated_launch",
                     _ARGTYPES).pareto_dominated_launch

    def launch(tgt, dom, flags):
        with torch.cuda.device(tgt.device):
            stream = torch.cuda.current_stream(tgt.device).cuda_stream
            err = fn(tgt.data_ptr(), tgt.shape[0], dom.data_ptr(),
                     dom.shape[0], tgt.shape[1] // 4, CHUNK,
                     flags.data_ptr(), stream)
        if err:
            raise RuntimeError(f"pareto kernel launch failed: CUDA error "
                               f"{err}")
        count(LAUNCHES)

    return dominated_with(launch, hi_d, lo_d, cand_d, hi, lo, cand)
