"""Tensor parallelism over the "model" axis: each rank computes on its own
blocks of the layers' weights, as the reference's GSPMD program does
with the blocks its `param_axes` place on a device.

The reference jits its steps with `in_shardings` from `param_axes`;
GSPMD then multiplies on each device only its "model" block of the
attention projections ("qkv"), the MLP ("ff"), the head ("vocab") and
the experts ("experts"), and attends only its "seq" block of a decode
cache.  Here each rank runs that schedule explicitly.  A region of a
layer whose ranks each compute a part is entered and left through the
conjugate pairs of collectives (Megatron's f / g, all in
`distributed.collectives`):

  * `reduce_grad` (identity forward, sum over "model" backward) in, and
    `sum_replicated` (sum forward, identity backward) out, when the
    residual stream is replicated over "model";
  * `gather_dim` (all-gather along the sequence forward, the rank's
    block of the summed gradient backward) in, and `scatter_dim`
    (reduce-scatter along the sequence forward, all-gather backward)
    out, when the stream holds the rank's sequence block
    (`cfg.seq_parallel`, opt level 6: the Megatron-SP pattern of the
    reference's `src/repro/models/lm.py`);
  * `gather_replicated` / `own_block` between a block and a tensor that
    every rank then uses whole.

`model_split(cfg, mesh)` and `cache_split(cfg, mesh, batch, seq)` are
the rules, and live only here.  `model_split` says, for each parameter
leaf, whether the layer computes on its "model" block (`True`: the step
gathers the leaf over "data" only) or on the whole leaf (`False`:
gathered over every axis, computed redundantly by the "model" ranks).
The layers read what they are given (`block_group`): a module whose
weights are the rank's blocks runs split, one given whole runs whole.
The Mamba2 mixer (the ssm and hybrid families) splits at head
boundaries: the rank's columns of the projections, its channels of the
conv, its heads of the scan, its rows of `out_proj` (`models/ssm.py`;
the fused layout's uniform blocks of `in_proj` and the conv are
all-gathered as weights and re-cut at those boundaries);
its replicated per-head leaves (`A_log`, `D_skip`, `dt_bias`, `in_dt`)
stay whole, each rank using its heads' part through `reduce_grad`.
The encoder-decoder family (Whisper) splits as the attention families
do, its cross-attention (`xw*`) included: the encoder's output is
replicated over "model" and each rank projects it with its columns of
`xwk` / `xwv`.
The MoE computes on the rank's "experts" block of `we_*` in both
dispatches (`models/moe.py`: the mesh-global `moe_apply` on its slot
ranges, `moe_apply_ep` on the slots its all-to-all brings), and Arctic's
dense residual on its "ff" blocks.
Gathered whole: the router (d x E, 256 KB a layer for Phi-3.5-MoE, 3.7
MB for Arctic; splitting its columns would all-gather the (T, E) logits
of the rank's tokens, more bytes than the weights), the Mamba2 mixer
under `seq_parallel` (the stream then holds the rank's sequence block
and the mixer runs whole on it, as the reference's `head_ax = None`),
and any module whose "model" dims do not divide the axis.
`cache_split` says whether the serve steps' decode cache holds the
rank's block of positions (the self and cross K/V), the rank's blocks
of the SSM state, or the gated decode's rank's block of KV heads or of
`head_dim`; they pass its answer to `prefill` and `decode_step`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

from ..tree import leaves_with_paths, unflatten
from . import context as mesh_ctx
from .collectives import (all_gather_cat, all_to_all, broadcast_from,
                          gather_dim, gather_replicated, own_block,
                          reduce_grad, scatter_dim, sum_replicated)

ATTENTION_FAMILIES = ("dense", "moe", "vlm")
SSM_FAMILIES = ("ssm", "hybrid")
ENCDEC_FAMILIES = ("audio",)
# the families whose stream `seq_parallel` puts on the rank's sequence block
SEQ_FAMILIES = ATTENTION_FAMILIES + ("ssm",)


# ---------------------------------------------------------------------------
# The rule
# ---------------------------------------------------------------------------

def _model_size(sizes: dict) -> int:
    return sizes.get("model", 1)


def module_split(cfg, sizes: dict) -> dict[str, bool]:
    """{module: True where its ranks compute on their "model" blocks}
    for a mesh of axis `sizes`: "vocab" (embedding and head), "attn"
    (wq / wk / wv / wo and the biases; Zamba2's shared block and
    Whisper's cross-attention too, the gated decode's projections too),
    "mlp" (the dense MLP), "experts" (`we_*`), "res" (Arctic's dense
    residual MLP) and "ssm" (the Mamba2 mixer, `_ssm_splits`)."""
    m = _model_size(sizes)
    off = dict(vocab=False, attn=False, mlp=False, experts=False, res=False,
               ssm=False)
    if m <= 1 or cfg.family not in (ATTENTION_FAMILIES + SSM_FAMILIES
                                    + ENCDEC_FAMILIES):
        return off
    hd = cfg.head_dim_
    return dict(
        vocab=cfg.padded_vocab % m == 0,
        attn=((cfg.n_heads * hd) % m == 0
              and (cfg.n_kv_heads * hd) % m == 0),
        mlp=not cfg.n_experts and cfg.d_ff % m == 0,
        experts=bool(cfg.n_experts) and cfg.n_experts % m == 0,
        res=cfg.moe_dense_residual and cfg.d_ff % m == 0,
        ssm=cfg.family in SSM_FAMILIES and _ssm_splits(cfg, m))


def _ssm_splits(cfg, m: int) -> bool:
    """The Mamba2 mixer splits over `m` "model" ranks at head boundaries:
    the stream is not the rank's sequence block (`seq_parallel`), the
    heads divide, the rank's heads read whole B/C groups or sit in one,
    and every "ssm_out" dim divides: `d_inner` and the B/C width (the
    split layout's blocks, which the fused layout is re-cut into), and
    for the fused layout `in_proj`'s columns and the conv's channels."""
    nh, ng = cfg.ssm_nheads, cfg.ssm_ngroups
    di, gs = cfg.d_inner, ng * cfg.ssm_state
    if seq_parallel(cfg) or not nh or nh % m:
        return False
    per, rep = nh // m, nh // ng
    if per % rep and rep % per:
        return False
    dims = (di, gs) + (() if cfg.ssm_split_proj
                       else (2 * di + 2 * gs + nh, di + 2 * gs))
    return all(d % m == 0 for d in dims)


def seq_parallel(cfg) -> bool:
    """`cfg.seq_parallel` in a family whose stream it splits."""
    return bool(cfg.seq_parallel and cfg.family in SEQ_FAMILIES)


_LEAF_MODULE = {
    "embed": "vocab", "lm_head": "vocab",
    **{p + k: "attn" for p in ("", "x")
       for k in ("wq", "wk", "wv", "wo", "bq", "bk", "bv")},
    **{k: "mlp" for k in ("w_gate", "w_up", "w_down", "w_in", "b_in",
                          "w_out")},
    **{k: "experts" for k in ("we_gate", "we_up", "we_down")},
    **{"res_" + k: "res" for k in ("w_gate", "w_up", "w_down")},
    **{k: "ssm" for k in ("in_proj", "conv_w", "conv_b", "ssm_norm_w",
                          "out_proj", "in_z", "in_x", "in_B", "in_C",
                          "conv_x_w", "conv_B_w", "conv_C_w", "conv_x_b",
                          "conv_B_b", "conv_C_b")},
}


def _split_specs(cfg, mesh) -> tuple[list, list]:
    """([(path, spec)] of every parameter leaf, [True where the layer
    computes on the leaf's "model" block]), in flattening order."""
    from ..models import registry as M
    from .sharding import tree_specs

    split = module_split(cfg, mesh_ctx.mesh_axis_sizes(mesh))
    specs = leaves_with_paths(tree_specs(M.param_axes(cfg),
                                         M.abstract_params(cfg), mesh))
    on = [split.get(_LEAF_MODULE.get(path[-1]), False) for path, _ in specs]
    for (path, spec), o in zip(specs, on):
        if o and not _on_model(spec):
            raise ValueError(f"{cfg.name}: {'/'.join(path)} is computed on "
                             f"its model block but stored as {spec}")
    return specs, on


def _on_model(spec) -> bool:
    from .sharding import entry_axes
    return any("model" in entry_axes(e) for e in spec)


def model_split(cfg, mesh) -> dict:
    """A tree of `param_axes(cfg)`'s structure: for each leaf True where
    the layer computes on the rank's "model" block of it (the step then
    gathers it over "data" only), False where it is gathered whole.  A
    leaf marked True is split over "model" by its spec (checked, so that
    this rule and the sharding rules cannot drift apart)."""
    from ..models import registry as M

    return unflatten(M.param_axes(cfg), _split_specs(cfg, mesh)[1])


def model_gathered(cfg, mesh) -> list[str]:
    """The leaves stored split over "model" that the step gathers whole
    (the dry-run record's `model_gathered`)."""
    specs, on = _split_specs(cfg, mesh)
    return ["/".join(path) for (path, spec), o in zip(specs, on)
            if not o and _on_model(spec)]


def block_group(t, whole: int, dim: int):
    """The registered mesh's "model" group when `t` is the rank's block of
    a leaf `whole` wide along `dim` (the step gathered it as its "model"
    block, `model_split`), else None (no mesh, or the whole leaf: the
    layer then computes on it whole, as every "model" rank does)."""
    if t.shape[dim] == whole:
        return None
    mesh = mesh_ctx.get_mesh()
    if mesh is None or t.shape[dim] * _model_size(
            mesh_ctx.mesh_axis_sizes(mesh)) != whole:
        raise ValueError(f"a weight {tuple(t.shape)} is neither whole "
                         f"({whole} along dim {dim}) nor a block of it over "
                         "the registered mesh's \"model\" axis")
    return mesh.get_group("model")


# ---------------------------------------------------------------------------
# The residual stream and the regions of a layer
# ---------------------------------------------------------------------------

class Stream(NamedTuple):
    """How a layer holds its residual stream: `group`, the "model" group
    (None: one rank or no mesh); `seq`, the stream is the rank's block
    of dim 1 over `group` (`seq_parallel`)."""
    group: object = None
    seq: bool = False


WHOLE = Stream()


def stream(cfg, prefill: bool = False) -> Stream:
    """The stream of `cfg` under the registered mesh: the train step's,
    or with `prefill` the prefill's.  `seq_parallel` splits the
    attention families' train stream (the reference's opt level 6 sets
    it for their train cell) and the ssm family's train and prefill
    streams (level 8 sets it for both cells); decode never."""
    mesh = mesh_ctx.get_mesh()
    if mesh is None or _model_size(mesh_ctx.mesh_axis_sizes(mesh)) <= 1:
        return WHOLE
    sp = seq_parallel(cfg) and (not prefill or cfg.family == "ssm")
    return Stream(mesh.get_group("model"), sp)


def enter(x, group, st: Stream):
    """The stream -> the whole input of a region whose ranks (`group`,
    the "model" group) each compute a part, their gradients summed on
    the way back."""
    return gather_dim(x, group, 1) if st.seq else reduce_grad(x, group)


def leave(y, group, st: Stream):
    """A region's partial sums over `group` -> the stream."""
    return scatter_dim(y, group, 1) if st.seq else sum_replicated(y, group)


def enter_whole(x, st: Stream):
    """The stream -> the whole input of a computation every rank runs in
    full (each holding the whole gradient)."""
    return gather_replicated(x, st.group, 1) if st.seq else x


def leave_whole(y, st: Stream):
    """A computation every rank ran in full -> the stream."""
    return own_block(y, st.group, 1) if st.seq else y


def seq_param(w, st: Stream):
    """A whole parameter applied to the rank's sequence block: its
    gradient is the block's share, summed over "model" on the way back."""
    return reduce_grad(w, st.group) if st.seq else w


def check_seq(cfg, st: Stream, s: int) -> None:
    """Under `seq_parallel` the sequence of `s` positions must split over
    the "model" ranks; for the SSD scan the whole sequence's chunks must
    also align with the ranks' blocks (its chunk size divides a block),
    so that each rank scans whole chunks of the whole sequence's."""
    if not st.seq:
        return
    m = dist.get_world_size(st.group)
    if s % m:
        raise ValueError(f"{cfg.name}: seq_parallel needs the sequence "
                         f"({s}) to split over the {m} model ranks")
    if cfg.family == "ssm":
        from ..models.ssm import chunk_size
        q = chunk_size(cfg, s)
        if (s // m) % q:
            raise ValueError(f"{cfg.name}: seq_parallel needs the SSD "
                             f"chunks ({q} of the {s} positions) to align "
                             f"with the {m} model ranks' blocks of {s // m}")


def from_last_rank(t, st: Stream):
    """Under `seq_parallel`: the last "model" rank's `t` (what it holds
    at the end of the whole sequence) on every rank (one broadcast).
    Inference only."""
    if not st.seq:
        return t
    return broadcast_from(t, st.group, dist.get_world_size(st.group) - 1)


# ---------------------------------------------------------------------------
# Decode caches split along the sequence
# ---------------------------------------------------------------------------

class CacheSplit(NamedTuple):
    """How the serve steps lay the decode cache: `axes`, the mesh axes
    (major first) whose ranks each hold a block of the K/V positions
    (() : every rank the whole sequence); `length`, the cache's length,
    to which prefill pads each layer's self K/V (None: the prompt's);
    `state`, the SSM state and conv tail are the rank's "model" blocks
    (its heads; its 1/m of the conv channels [x | B | C]), as the split
    mixer computes them (False: whole on every rank); `gated_dim`, the
    logical dim of the gated decode's `k` / `v` / `ksum` that their
    spec puts on "model" ("kv": the rank's KV heads, "headdim": its
    block of `head_dim`; None: whole).  `holds_block` reads it."""
    axes: tuple = ()
    length: int | None = None
    state: bool = False
    gated_dim: str | None = None


NO_SPLIT = CacheSplit()
GATED_KEYS = ("k", "v", "ksum")


def gated(cfg) -> bool:
    """`cfg` decodes through the selector + strap gate (its cache holds
    `ksum`, its sequence stays whole on each rank)."""
    return bool(cfg.strap_decode and cfg.family in ATTENTION_FAMILIES)


def cache_split(cfg, mesh, batch: int, seq: int) -> CacheSplit:
    """The rule for the serve steps' cache of `batch` x `seq` positions
    (the enc-dec family's: `seq // 2` decoder positions and encoder
    frames, as `registry.cache_schema` lays it).  The K/V (the attention
    families but for the gated decode, the hybrid's shared block, the
    enc-dec self and cross K/V) split along the sequence over the axes
    that `cache_specs` puts on its "seq" dim, where more than one
    "model" rank runs and the K/V's other dims, the batch aside, stay
    whole on each rank; else whole.  The gated decode's `k` / `v` /
    `ksum` keep the sequence whole and split the dim their spec puts on
    "model" (`gated_dim`), where the attention splits.  The SSM state
    and conv tail are the rank's blocks where the mixer splits
    (`module_split`'s "ssm"), which their specs then split too (every
    such reading checked against the specs)."""
    from ..models import registry as M
    from .sharding import cache_specs, entry_axes

    sizes = mesh_ctx.mesh_axis_sizes(mesh)
    axes = M.cache_axes(cfg, batch, seq)
    abstract = M.abstract_cache(cfg, batch, seq)
    specs = cache_specs(cfg, axes, abstract, mesh)
    split = module_split(cfg, sizes)
    state = split["ssm"]
    for k in ("ssm", "conv", "t_ssm", "t_conv"):
        if state and k in axes:
            dim = axes[k].index("heads" if k.endswith("ssm") else "ssm_out")
            if "model" not in entry_axes(specs[k][dim]):
                raise ValueError(f"{cfg.name}: the mixer splits over "
                                 f"\"model\" but the cache's {k} is stored "
                                 f"as {specs[k]}")
    length = abstract["k"].shape[2] if "k" in abstract else seq
    if gated(cfg):
        return CacheSplit((), length, state, _gated_dim(cfg, axes, specs,
                                                        split["attn"]))
    if (cfg.family not in ATTENTION_FAMILIES + ("hybrid",) + ENCDEC_FAMILIES
            or _model_size(sizes) <= 1):
        return CacheSplit((), length, state)
    spec, k_axes = specs["k"], axes["k"]
    if any(e for e, a in zip(spec, k_axes) if a not in ("seq", "batch")):
        return CacheSplit((), length, state)
    return CacheSplit(entry_axes(spec[k_axes.index("seq")]), length, state)


def _gated_dim(cfg, axes, specs, attn_split: bool) -> str | None:
    """The logical dim ("kv" or "headdim") that the specs of the gated
    cache's `k`, `v` and `ksum` all put on "model", or None where none
    does; the attention must then split over "model" too, as its blocks
    are what the rank writes into its cache block."""
    from .sharding import entry_axes

    dims = {tuple(a for e, a in zip(specs[k], axes[k])
                  if "model" in entry_axes(e)) for k in GATED_KEYS}
    if dims == {()}:
        return None
    if len(dims) != 1 or len(next(iter(dims))) != 1 or not attn_split:
        raise ValueError(f"{cfg.name}: the gated cache is stored as "
                         f"{[specs[k] for k in GATED_KEYS]} (k, v, ksum), "
                         f"the attention split over \"model\": {attn_split}")
    return next(iter(dims))[0]


def holds_block(key: str, split: CacheSplit) -> bool:
    """The serve steps' cache leaf `key` is the rank's block as the model
    functions return and take it under `split` (prefill's output,
    decode's input and output): the self and cross K/V where their
    sequence splits, the gated `k` / `v` / `ksum` where their KV heads
    or `head_dim` split, the SSM state and conv tail where the mixer
    splits.  Any other leaf goes whole through them and is cut to the
    rank's block after (and gathered before decode)."""
    if split.gated_dim is not None:
        return key in GATED_KEYS
    if key in ("k", "v", "xk", "xv"):
        return bool(split.axes)
    return split.state and key in ("ssm", "conv", "t_ssm", "t_conv")


def cache_blocks(split: CacheSplit) -> tuple[list, int, int]:
    """(groups of `split`'s axes that hold more than one rank of the
    registered mesh, major first; this rank's block index over their
    product; the product)."""
    mesh = mesh_ctx.get_mesh()
    if mesh is None or not split.axes:
        return [], 0, 1
    sizes, coords = mesh_ctx.mesh_axis_sizes(mesh), mesh_ctx.mesh_coords(mesh)
    idx, n = 0, 1
    for a in split.axes:
        idx = idx * sizes[a] + coords[a]
        n *= sizes[a]
    return [mesh.get_group(a) for a in split.axes if sizes[a] > 1], idx, n


def pad_seq(t, length: int | None, dim: int = 1):
    """`t` padded with zeros along `dim` to `length` positions."""
    if length is None or t.shape[dim] == length:
        return t
    shape = list(t.shape)
    shape[dim] = length - shape[dim]
    return torch.cat([t, t.new_zeros(shape)], dim=dim)


def to_cache_block(t, n_heads: int, split: CacheSplit = NO_SPLIT):
    """A layer's prefill K or V (B, S, H, hd) -> the rank's block of the
    cache laid out by `split`: H is all `n_heads` or the rank's block of
    them over "model" (split at head boundaries).  The gated cache keeps
    the rank's KV heads (as the split attention gives them) or its block
    of `head_dim` of every head (the KV heads then do not divide the
    ranks, and the split attention gives them whole).  With no sequence
    split the heads are gathered whole."""
    groups, idx, n = cache_blocks(split)
    t = pad_seq(t, split.length)
    mesh = mesh_ctx.get_mesh()
    if split.gated_dim == "kv":
        return t
    if split.gated_dim == "headdim":
        model = mesh.get_group("model")
        d = t.shape[3] // dist.get_world_size(model)
        return t.narrow(3, dist.get_rank(model) * d, d).contiguous()
    split_heads = t.shape[2] != n_heads
    if split_heads and split.axes == ("model",):
        # one all-to-all: sequence chunks out, head blocks in
        model = mesh.get_group("model")
        m = dist.get_world_size(model)
        b, s, h, d = t.shape
        x = t.reshape(b, m, s // m, h, d).permute(1, 0, 2, 3, 4).contiguous()
        x = all_to_all(x, model)                   # (m: head block, ...)
        return x.permute(1, 2, 0, 3, 4).reshape(b, s // m, m * h, d)
    if split_heads:
        t = all_gather_cat(t, mesh.get_group("model"), 2)
    if n == 1:
        return t
    if t.shape[1] % n:
        raise ValueError(f"a cache of {t.shape[1]} positions does not split "
                         f"into {n} blocks")
    step = t.shape[1] // n
    return t.narrow(1, idx * step, step).contiguous()
