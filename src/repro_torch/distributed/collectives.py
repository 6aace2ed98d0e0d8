"""Strapped hierarchical collectives (the paper's Selector+Strap, on a
mesh), and the collectives the port's distributed model code runs (port
of `repro.distributed.collectives`).

The pod boundary is the HCB interface: few, expensive links.  In-pod
links are the local strap.  A gradient all-reduce therefore runs as:

  1. reduce-scatter over the in-pod "data" axis   (strap-local aggregation)
  2. all-reduce of the 1/N shard over "pod"       (one bond per strap),
     optionally int8-compressed with a shared scale + error feedback
  3. all-gather back over "data"

Cross-pod bytes drop by |data| (x4 more with int8), exactly like C_BL when
the selector keeps unselected straps off the global line.

The reference runs these inside `shard_map` over named axes; here each
step is a `torch.distributed` call on the group of its mesh axis
(`mesh.get_group(name)`), every rank of the mesh calling it.
`hierarchical_psum_tree` is the gradient synchronizer of the sharded
train step.

Transport: gloo moves host memory, so under a gloo group a CUDA tensor
is copied to pinned host memory, reduced or gathered there, and copied
back.  That is the backend's rule, not a fallback: every computation
stays on the tensor's device (`_via_host`); a gloo group of one rank
skips the round trip.  NCCL takes CUDA tensors directly.  16-bit floats
travel as raw bytes (`_as_bytes`).

The autograd functions below carry the model's collectives (the "model"
axis's conjugate pairs, the MoE's slot exchanges) with the backward each
needs; `counts` counts the all-to-all calls made, and the all-gathers
with the bytes they return.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..tree import tree_map
from .context import mesh_axis_sizes

counts = {"all_to_all": 0, "all_gather": 0, "all_gather_bytes": 0}


def _via_host(t: torch.Tensor, group) -> bool:
    return t.device.type != "cpu" and dist.get_backend(group) == "gloo"


def _alone(t: torch.Tensor, group) -> bool:
    """A gloo group of one rank would stage `t` through the host and back
    for nothing: the collective is skipped."""
    return _via_host(t, group) and dist.get_world_size(group) == 1


def _buffer(shape, like: torch.Tensor) -> torch.Tensor:
    """An empty buffer beside `like` (pinned when `like` is pinned)."""
    return torch.empty(shape, dtype=like.dtype, device=like.device,
                       pin_memory=like.is_pinned())


def _src(t: torch.Tensor, group) -> torch.Tensor:
    """The buffer a collective reads: under gloo a CUDA tensor's copy in
    pinned host memory (fast copies both ways), else `t` itself;
    contiguous, outside autograd."""
    t = t.detach()
    if _via_host(t, group):
        buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        buf.copy_(t)
        return buf
    return t.contiguous()


def all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """A new tensor: `t` reduced with `op` over `group`."""
    if _alone(t, group):
        return t.detach().clone()
    buf = _src(t, group) if _via_host(t, group) \
        else t.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(buf, op=op, group=group)
    return buf.to(t.device)


def _as_bytes(t: torch.Tensor) -> torch.Tensor:
    """A 16-bit float tensor as its flat bytes (a pure data movement:
    gloo has no int16 and not every release moves bf16)."""
    return t.reshape(-1).view(torch.uint8)


def all_gather_cat(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's `t`, concatenated along `dim` in group-rank order
    (under gloo each rank's part goes from the host straight into its
    slice of the result on `t`'s device)."""
    counts["all_gather"] += 1
    counts["all_gather_bytes"] += (t.numel() * t.element_size()
                                   * dist.get_world_size(group))
    if _alone(t, group):
        return t.detach().clone()
    src = _src(t, group)
    move = _as_bytes if src.dtype in (torch.bfloat16, torch.float16) \
        else (lambda x: x)
    moved = move(src)
    parts = [_buffer(moved.shape, moved) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, moved, group=group)
    parts = [p.view(src.dtype).reshape(src.shape) for p in parts]
    if src.device == t.device:
        return torch.cat(parts, dim)
    shape = list(src.shape)
    shape[dim] *= len(parts)
    out = torch.empty(shape, dtype=t.dtype, device=t.device)
    for i, part in enumerate(parts):
        out.narrow(dim, i * src.shape[dim], src.shape[dim]).copy_(part)
    return out


def reduce_scatter(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Sum of every rank's `t` over `group`, this rank's 1/n of `dim`."""
    if dim:
        moved = reduce_scatter(t.movedim(dim, 0).contiguous(), group)
        return moved.movedim(0, dim).contiguous()
    if _alone(t, group):
        return t.detach().clone()
    src = _src(t, group)
    out = _buffer((src.shape[0] // dist.get_world_size(group),) + src.shape[1:], src)
    dist.reduce_scatter_tensor(out, src, group=group)
    return out.to(t.device)


def broadcast_from(t: torch.Tensor, group, src: int) -> torch.Tensor:
    """Group rank `src`'s `t` on every rank of `group` (one broadcast).
    Every rank passes a `t` of the same shape; only `src`'s values are
    read."""
    if _alone(t, group):
        return t.detach().clone()
    src_t = _src(t, group)
    buf = src_t if _via_host(t, group) else src_t.clone()
    if buf.dtype in (torch.bfloat16, torch.float16):
        buf = _as_bytes(buf)
    dist.broadcast(buf, src=dist.get_global_rank(group, src), group=group)
    return buf.view(src_t.dtype).reshape(src_t.shape).to(t.device)


def all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    """Dim 0 cut into n equal chunks, chunk j sent to group rank j; the
    chunks received, in source-rank order, along dim 0."""
    counts["all_to_all"] += 1
    if _alone(t, group):
        return t.detach().clone()
    src = _src(t, group)
    buf = _as_bytes(src) if src.dtype in (torch.bfloat16, torch.float16) \
        else src
    out = _buffer(buf.shape, buf)
    dist.all_to_all_single(out, buf, group=group)
    return out.view(src.dtype).reshape(src.shape).to(t.device)


# ---------------------------------------------------------------------------
# Differentiable collectives for the model's distributed paths
# ---------------------------------------------------------------------------

class _GatherDim(torch.autograd.Function):
    """Forward: all-gather along `dim`.  Backward: every rank's gradient
    summed, this rank's block (each rank's downstream computes a part:
    its loss reads the gathered rows, or it attends its own heads)."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather_cat(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g.contiguous(), ctx.group, ctx.dim), None, None


class _ScatterDim(torch.autograd.Function):
    """Forward: reduce-scatter along `dim` (partial sums to the rank's
    block of their total).  Backward: all-gather along `dim`."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return reduce_scatter(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather_cat(g.contiguous(), ctx.group, ctx.dim), None, None


class _SumReplicated(torch.autograd.Function):
    """Forward: all-reduce SUM.  Backward: identity (what follows runs
    redundantly on every rank of the group, each holding the same
    gradient)."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumBoth(torch.autograd.Function):
    """Forward: all-reduce SUM.  Backward: all-reduce SUM (each rank's
    loss reads the sum)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _OneReplica(torch.autograd.Function):
    """Forward: rank 0's value on every rank of the group.  Backward: the
    gradient over the group's size on every rank.  The reference's
    shard_map output taken from one replica unchecked (`out_specs=P()`,
    `check_rep=False`): its value is one rank's, its gradient reaches
    every rank's as the gradient of their mean."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.n = dist.get_world_size(group)
        first = 1.0 if dist.get_rank(group) == 0 else 0.0
        return all_reduce(x * first, group)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


class _ReduceGrad(torch.autograd.Function):
    """Forward: identity.  Backward: all-reduce SUM (a replicated tensor
    whose ranks each compute a part of the gradient)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _OwnBlock(torch.autograd.Function):
    """Forward: this rank's block of a replicated tensor along `dim`.
    Backward: all-gather of every rank's block gradient (each rank's
    gradient is complete on its own block and zero elsewhere)."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        n, r = dist.get_world_size(group), dist.get_rank(group)
        step = x.shape[dim] // n
        return x.narrow(dim, r * step, step)

    @staticmethod
    def backward(ctx, g):
        return all_gather_cat(g, ctx.group, ctx.dim), None, None


class _GatherReplicated(torch.autograd.Function):
    """Forward: all-gather along `dim`.  Backward: this rank's block (what
    follows runs redundantly on every rank, each holding the full
    gradient)."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather_cat(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        n, r = dist.get_world_size(ctx.group), dist.get_rank(ctx.group)
        step = g.shape[ctx.dim] // n
        return g.narrow(ctx.dim, r * step, step), None, None


class _AllToAll(torch.autograd.Function):
    """Forward and backward: `all_to_all` over equal chunks of dim 0 (its
    own inverse)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_to_all(g.contiguous(), ctx.group), None


def gather_dim(x, group, dim: int):
    return _GatherDim.apply(x, group, dim % x.dim())


def scatter_dim(x, group, dim: int):
    return _ScatterDim.apply(x, group, dim % x.dim())


def sum_replicated(x, group):
    return _SumReplicated.apply(x, group)


def sum_both(x, group):
    return _SumBoth.apply(x, group)


def one_replica(x, group):
    return _OneReplica.apply(x, group)


def reduce_grad(x, group):
    return _ReduceGrad.apply(x, group)


def own_block(x, group, dim: int):
    return _OwnBlock.apply(x, group, dim)


def gather_replicated(x, group, dim: int):
    return _GatherReplicated.apply(x, group, dim)


def all_to_all_grad(x, group):
    return _AllToAll.apply(x.contiguous(), group)


# ---------------------------------------------------------------------------
# Strapped psum
# ---------------------------------------------------------------------------

def _pad_to(x, mult: int):
    n = x.shape[0]
    pad = (-n) % mult
    if pad:
        x = torch.cat([x, torch.zeros((pad,) + tuple(x.shape[1:]),
                                      dtype=x.dtype, device=x.device)])
    return x, n


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    # a 0-d divisor on the tensor's device divides truly (a Python float
    # divisor of a CUDA tensor becomes a reciprocal multiply)
    return torch.full((), x, dtype=torch.float32, device=like.device)


def _psum_int8(x, group):
    """Cross-pod all-reduce of an int8-quantized tensor with a pod-agreed
    scale.  Returns the dequantized sum and the local quantization error
    (for error feedback).  Rounds half to even, as `jnp.round`."""
    absmax = torch.amax(torch.abs(x))
    scale = all_reduce(absmax, group, dist.ReduceOp.MAX) / _f32(127.0, x) \
        + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    err = x - q.float() * scale
    total = all_reduce(q.to(torch.int32), group)
    return total.float() * scale, err


def strapped_psum(x, mesh, data_axis: str = "data",
                  pod_axis: str | None = "pod", compress: bool = False):
    """Hierarchical sum of one tensor over (`pod_axis`, `data_axis`) of
    `mesh`.  Returns (summed x, error_feedback or None)."""
    data = mesh.get_group(data_axis)
    nd = dist.get_world_size(data)
    flat = x.reshape(-1)
    flat, n = _pad_to(flat, nd)
    # 1. strap-local reduce-scatter
    shard = reduce_scatter(flat, data)
    err = None
    if pod_axis is not None:
        pod = mesh.get_group(pod_axis)
        # 2. one bond per strap crosses the pod boundary
        if compress:
            shard, err = _psum_int8(shard, pod)
        else:
            shard = all_reduce(shard, pod)
    # 3. strap-local all-gather
    out = all_gather_cat(shard, data)[:n].reshape(x.shape)
    if err is not None:
        err = all_gather_cat(err, data)[:n].reshape(x.shape)
    return out, err


def hierarchical_psum_tree(grads, mesh, compress: bool = False,
                           mean: bool = True):
    """Synchronize a gradient tree across ("pod","data").

    Gradients enter per rank (each holds its local-batch gradient, in
    full) and leave identical on every rank of the ("pod","data") group
    of its "model" coordinate.  Returns (grads, error_feedback), both
    float32 trees of `grads`' structure (zeros for the error in exact
    mode)."""
    sizes = mesh_axis_sizes(mesh)
    pod_axis = "pod" if "pod" in sizes else None
    # gradients are reduced over the DP axes only (model shards hold
    # different parameter shards and never mix)
    n_total = sizes.get("data", 1) * sizes.get("pod", 1)

    def one(leaf):
        s, e = strapped_psum(leaf.float(), mesh, "data", pod_axis, compress)
        if mean:
            s = s / _f32(n_total, s)
        if e is None:      # exact mode: zeros, as a view of one scalar
            e = torch.zeros((), dtype=s.dtype, device=s.device).expand(s.shape)
        return s, e

    pairs = tree_map(one, grads)
    return tree_map(lambda p: p[0], pairs), tree_map(lambda p: p[1], pairs)


def collective_matrix(mesh) -> dict:
    """Bandwidth bookkeeping for the roofline: bytes crossing each axis for
    a hierarchical vs flat all-reduce of G bytes on this mesh."""
    sizes = mesh_axis_sizes(mesh)
    nd = sizes.get("data", 1)
    npod = sizes.get("pod", 1)
    flat_cross_pod = 2.0 * (npod - 1) / npod         # ring AR fraction
    strapped_cross_pod = flat_cross_pod / nd          # shard is 1/nd
    return dict(axes=sizes,
                flat_cross_pod_bytes_per_byte=flat_cross_pod,
                strapped_cross_pod_bytes_per_byte=strapped_cross_pod,
                strap_factor=nd)
