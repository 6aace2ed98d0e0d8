"""Step factories: train_step / serve_prefill / serve_decode.

Port of `repro.train.step`.  Gradients come from autograd; microbatches
accumulate in float32 and are scaled by 1 / microbatch; the gradients
are cast to float32 before the global-norm clip at 1.0 (in the reference
a bf16 gradient times the float32 clip is float32; in PyTorch it would
stay bf16 and take one more rounding), then the optimizer updates the
parameters and its state in place.

`make_sharded_train_step` is the port's form of the reference's
`jax.jit(make_train_step(cfg), in_shardings=(param, opt-state and batch
specs), out_shardings=...)` under a ("pod", "data", "model") mesh: each
rank holds its blocks of the parameters and the optimizer state (the
reference's specs) and its shard of the batch, and computes on its
"model" blocks as GSPMD partitions the reference's program
(`distributed.tensor_parallel`); the gradients are summed over ("pod",
"data") with `hierarchical_psum_tree`, clipped by the global norm (the
same on every rank) and the rank's own blocks updated.
`make_sharded_serve_prefill` / `make_sharded_serve_decode` are the
counterparts of the reference's jitted serve steps on the same mesh.
"""

from __future__ import annotations

import torch

from ..device import rdiv
from ..distributed import context as mesh_ctx
from ..distributed import tensor_parallel as tp
from ..distributed.collectives import (all_gather_cat, all_reduce,
                                       hierarchical_psum_tree)
from ..distributed.sharding import (cache_specs, entry_axes, gather_block,
                                    local_block, tree_specs)
from ..models import registry as M
from ..models.lm import strap_key_sums
from ..tree import leaves, tree_map, unflatten
from .optimizer import (OptConfig, abstract_opt_state, make_optimizer,
                        opt_state_axes)


def make_train_step(cfg, oc: OptConfig | None = None,
                    microbatch: int | None = None):
    """Returns (train_step, optimizer); train_step(params, opt_state,
    batch) -> (params, opt_state, {"loss", "grad_norm"}), the metrics as
    0-d float32 tensors.  The parameters (made to require grad) and the
    optimizer state are updated in place.

    `microbatch`: number of gradient-accumulation slices of the global
    batch (sequential), trading step latency for activation memory.
    """
    opt = make_optimizer(cfg.optimizer, oc)
    grads_of = _grads_fn(cfg, microbatch)

    def train_step(params, opt_state, batch):
        loss, grads = grads_of(params, batch)
        grads, gnorm = _clip(grads)
        params, opt_state = opt.update(unflatten(params, grads), opt_state,
                                       params)
        return params, opt_state, dict(loss=loss, grad_norm=gnorm)

    return train_step, opt


def _grads_fn(cfg, microbatch):
    """grads_of(params, batch) -> (loss, [gradient of each leaf, in
    flattening order]), the parameters made to require grad."""
    def loss_and_grads(params, batch, ps):
        loss = M.loss_fn(cfg, params, batch)
        return loss.detach(), torch.autograd.grad(loss, ps)

    def grads_of(params, batch):
        ps = leaves(params)
        for p in ps:
            p.requires_grad_(True)
        if not microbatch or microbatch <= 1:
            return loss_and_grads(params, batch, ps)
        mb = next(iter(batch.values())).shape[0] // microbatch
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for p in ps]
        lsum = torch.zeros((), dtype=torch.float32, device=ps[0].device)
        for i in range(microbatch):
            part = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
            loss, gs = loss_and_grads(params, part, ps)
            for a, g in zip(acc, gs):
                a.add_(g)
            lsum = lsum + loss
        scale = 1.0 / microbatch
        return lsum * scale, [a * scale for a in acc]

    return grads_of


@torch.no_grad()
def _clip(grads):
    """(float32 gradients clipped in place by the global norm at 1.0,
    the norm).  The gradients are made contiguous first: a sum over a
    transposed tensor (the tied embedding's gradient comes out so) adds
    in another order than over the same values laid out row-major, and
    the sharded step's synchronized gradients are row-major."""
    grads = [g.float().contiguous() for g in grads]
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g)) for g in grads))
    # global-norm clip at 1.0
    clip = torch.clamp(rdiv(1.0, gnorm + 1e-6), max=1.0)
    for g in grads:
        g.mul_(clip)
    return grads, gnorm


def train_specs(cfg, mesh):
    """(parameter specs, optimizer-state specs) of `cfg` on `mesh`: the
    reference's `tree_specs` of `param_axes` / `opt_state_axes` over the
    abstract trees."""
    axes = M.param_axes(cfg)
    abstract = M.abstract_params(cfg)
    p_specs = tree_specs(axes, abstract, mesh)
    o_specs = tree_specs(opt_state_axes(cfg.optimizer, axes),
                         abstract_opt_state(cfg.optimizer, abstract), mesh)
    return p_specs, o_specs


def _compute_specs(cfg, mesh):
    """(storage spec of each parameter leaf, the spec the step gathers it
    under, in flattening order).  A leaf the layer computes on as its
    "model" block (`tensor_parallel.model_split`) is gathered over its
    other axes ("data": the FSDP gather) and stays the rank's block; any
    other leaf is gathered whole."""
    spec_list = leaves(train_specs(cfg, mesh)[0])
    split = leaves(tp.model_split(cfg, mesh))
    gather = [tuple(_drop_model(e) for e in sp) if on else sp
              for sp, on in zip(spec_list, split)]
    return spec_list, gather


def _drop_model(entry):
    axes = tuple(a for a in entry_axes(entry) if a != "model")
    return None if not axes else axes[0] if len(axes) == 1 else axes


def make_sharded_train_step(cfg, mesh, oc: OptConfig | None = None,
                            microbatch: int | None = None):
    """Returns (train_step, optimizer) for this rank of `mesh` (a
    `DeviceMesh` with axes among ("pod", "data", "model")).

    train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "grad_norm"}) takes this rank's blocks: `params` and
    `opt_state` under `train_specs(cfg, mesh)` (`sharding.shard_tree`;
    `optimizer.init` of the parameter blocks gives the state's), `batch`
    under `sharding.batch_specs`, which must split the batch over every
    dp axis.  The blocks are updated in place.

    Each rank computes on its blocks, as the reference's GSPMD program:
    a leaf the layer consumes as its "model" block
    (`tensor_parallel.model_split`) is gathered over "data" only, every
    other leaf whole; the loss and gradients come from the rank's batch
    shard and its blocks (`distributed.tensor_parallel`), each gradient
    is summed over ("pod", "data") leaf by leaf
    (`hierarchical_psum_tree`, so that no float32 copy of every gradient
    lives at once) and cut to the rank's storage block; the global norm
    is the square root of the blocks' sums of squares, each summed over
    the mesh axes that split its leaf (a leaf replicated over an axis
    counted once); the rank's blocks are clipped and updated.  The loss
    is the mean over the dp ranks of their shards' losses (with equal
    shards, the loss of the whole batch: `cross_entropy` is an unmasked
    mean).  On a mesh of one rank the step is `make_train_step`'s, bit
    for bit.
    """
    p_specs, _ = train_specs(cfg, mesh)
    spec_list, gather_specs = _compute_specs(cfg, mesh)
    # AdamW8bit's row max spans the ranks that split a row's last dim
    row_groups = tree_map(
        lambda sp: tuple(mesh.get_group(a) for a in entry_axes(sp[-1])),
        p_specs)
    opt = make_optimizer(cfg.optimizer, oc, row_groups)
    grads_of = _grads_fn(cfg, microbatch)
    dp_groups = mesh_ctx.dp_groups(mesh)
    n_dp = mesh_ctx.dp_size(mesh)
    coords = mesh_ctx.mesh_coords(mesh)
    sizes = mesh_ctx.mesh_axis_sizes(mesh)
    norm_axes = [tuple(sorted(a for e in sp for a in entry_axes(e)
                              if sizes[a] > 1)) for sp in spec_list]

    def train_step(params, opt_state, batch):
        full = _compute_params(params, gather_specs, mesh)
        with mesh_ctx.mesh_scope(mesh):
            loss, grads = grads_of(full, batch)
        del full
        with torch.no_grad():
            grads, local = list(grads), []
            for i, sp in enumerate(gather_specs):
                synced, _ = hierarchical_psum_tree(grads[i].float(), mesh,
                                                   mean=True)
                grads[i] = None
                local.append(local_block(synced, sp, mesh, coords)
                             .contiguous())
            gnorm = _clip_blocks(local, norm_axes, mesh)
            for g in dp_groups:
                loss = all_reduce(loss, g)
            loss = loss / torch.full((), n_dp, dtype=loss.dtype,
                                     device=loss.device)
        params, opt_state = opt.update(unflatten(params, local), opt_state,
                                       params)
        return params, opt_state, dict(loss=loss, grad_norm=gnorm)

    return train_step, opt


def _clip_blocks(blocks, norm_axes, mesh):
    """Clip the rank's gradient blocks in place by the global norm at 1.0
    and return the norm: each block's sum of squares, summed over the
    axes that split its leaf (one all-reduce per axis and set of leaves
    sharing them), then over the sets.  On one rank every set is empty
    and this is `_clip`'s sum, in its order."""
    sums: dict = {}
    for g, axes in zip(blocks, norm_axes):
        sums[axes] = sums.get(axes, 0) + torch.sum(torch.square(g))
    total = 0
    for axes, part in sums.items():
        for a in axes:
            part = all_reduce(part, mesh.get_group(a))
        total = total + part
    gnorm = torch.sqrt(total)
    clip = torch.clamp(rdiv(1.0, gnorm + 1e-6), max=1.0)
    for g in blocks:
        g.mul_(clip)
    return gnorm


def _serve_geometry(cfg, mesh, batch: int, seq: int):
    """(the specs the parameters are gathered under, the cache's rows
    specs (its blocks' specs without the batch, which is already the
    rank's rows), the cache's layout, `tensor_parallel.cache_split`)."""
    gather_specs = _compute_specs(cfg, mesh)[1]
    c_axes = M.cache_axes(cfg, batch, seq)
    c_specs = cache_specs(cfg, c_axes, M.abstract_cache(cfg, batch, seq),
                          mesh)
    rows = tree_map(lambda sp, ax: tuple(None if a == "batch" else e
                                         for e, a in zip(sp, ax)),
                    c_specs, c_axes)
    return gather_specs, rows, tp.cache_split(cfg, mesh, batch, seq)


def _compute_params(params, gather_specs, mesh):
    """The parameters as the rank's layers take them, from its blocks."""
    return unflatten(params, [gather_block(x.detach(), sp, mesh)
                              for x, sp in zip(leaves(params), gather_specs)])


def _whole_logits(cfg, mesh, logits):
    """The rank's rows' logits over the whole vocabulary."""
    if tp.module_split(cfg, mesh_ctx.mesh_axis_sizes(mesh))["vocab"]:
        return all_gather_cat(logits, mesh.get_group("model"), -1)
    return logits


def make_sharded_serve_prefill(cfg, mesh, batch: int, seq: int):
    """The rank's prefill under `mesh`, the counterpart of the reference's
    `jax.jit(make_serve_prefill(cfg), in_shardings=...)`: returns
    serve_prefill(params, inputs) -> (last-token logits of the rank's rows
    over the whole vocabulary (b, V) float32, the rank's blocks of the
    cache).  `params` are the rank's blocks (`train_specs`), `inputs` its
    rows of a global batch of `batch` prompts (`sharding.batch_specs`);
    `seq` is the cache's length, at least the prompt's (and its vision
    tokens'): the prompt's K/V fill its first positions, zeros the rest,
    so that `make_sharded_serve_decode(cfg, mesh, batch, seq)` takes the
    blocks as they are.  Each rank computes on its blocks
    (`tensor_parallel.model_split`); where the cache's sequence splits
    over "model" each layer's K/V (the enc-dec family's self and cross
    K/V) leave as the rank's block (an all-to-all from head blocks to
    sequence blocks), the gated cache's K/V as the rank's KV heads or
    its block of `head_dim`, and the SSM state and conv tail as the
    rank's blocks where the mixer splits (`tensor_parallel.holds_block`);
    elsewhere the cache is cut from the whole.  A gated config's cache
    also gets `ksum`, the strap sums of the rank's block of the padded
    keys (`lm.strap_key_sums`), as the reference's callers add it.  The
    enc-dec family's `seq` is the cell's: `seq // 2` decoder positions
    and encoder frames (`registry.cache_schema`)."""
    gather_specs, rows, split = _serve_geometry(cfg, mesh, batch, seq)

    @torch.no_grad()
    def serve_prefill(params, inputs):
        full = _compute_params(params, gather_specs, mesh)
        with mesh_ctx.mesh_scope(mesh):
            logits, cache = M.prefill(cfg, full, inputs, split)
        del full
        cache = _cache_blocks(cache, rows, mesh, split)
        if tp.gated(cfg):
            cache["ksum"] = strap_key_sums(cache["k"],
                                           cfg.decode_strap_tokens)
        return _whole_logits(cfg, mesh, logits), cache

    return serve_prefill


def _cache_blocks(cache, rows, mesh, split):
    """Each cache leaf as the rank's block under its rows spec: as it came
    out where it already is (`tensor_parallel.holds_block`); anything
    else came out whole, K and V of the prompt's length (padded here to
    `seq`), and is cut."""
    out = {}
    for k, x in cache.items():
        if tp.holds_block(k, split):
            out[k] = x
            continue
        if k in ("k", "v"):
            x = tp.pad_seq(x, split.length, dim=2)
        out[k] = local_block(x, rows[k], mesh).clone()
    return out


def make_sharded_serve_decode(cfg, mesh, batch: int, seq: int):
    """The rank's decode step under `mesh`, the counterpart of the
    reference's jitted `make_serve_decode(cfg)`: returns
    serve_decode(params, cache, token, pos) -> (next token (b, 1) int32,
    logits (b, V) float32 over the whole vocabulary, the rank's cache
    blocks).  `params` are the rank's blocks, `cache` its blocks under
    `cache_specs` (global batch `batch`, length `seq`), `token` / `pos`
    its rows.  Where the cache's sequence splits over "model" (the
    attention families, not gated, the hybrid's shared block, the
    enc-dec family's self and cross caches) each rank attends its block
    of positions and the softmax statistics are combined over the split
    axes; the rank owning `pos` writes the token's K/V, in place (the
    cross cache is only read).  The gated decode's cache keeps the
    sequence whole and splits its KV heads or `head_dim` over "model":
    each rank selects the same straps from the summed scores and attends
    its block (`attention.decode_attention_gated`), writing the token's
    K/V and key sum into its block, in place.  Where the Mamba2 mixer
    splits, each rank advances its heads' state and its block of the
    conv tail, in place.  Elsewhere (a cache or mixer whose dims do not
    divide) the rank's rows of the leaf are gathered whole, decoded, and
    its block cut back out, as the reference's GSPMD gathers them."""
    gather_specs, rows, split = _serve_geometry(cfg, mesh, batch, seq)

    @torch.no_grad()
    def serve_decode(params, cache, token, pos):
        full = _compute_params(params, gather_specs, mesh)
        work = {k: x if tp.holds_block(k, split)
                else gather_block(x, rows[k], mesh)
                for k, x in cache.items()}
        with mesh_ctx.mesh_scope(mesh):
            logits, work = M.decode_step(cfg, full, work, token, pos, split)
        del full
        logits = _whole_logits(cfg, mesh, logits)
        next_token = torch.argmax(logits, dim=-1).to(torch.int32)
        work = {k: x if tp.holds_block(k, split)
                else local_block(x, rows[k], mesh).clone()
                for k, x in work.items()}
        return next_token[:, None], logits, work

    return serve_decode


def make_serve_prefill(cfg):
    def serve_prefill(params, batch):
        return M.prefill(cfg, params, batch)
    return serve_prefill


def make_serve_decode(cfg):
    def serve_decode(params, cache, token, pos):
        logits, new_cache = M.decode_step(cfg, params, cache, token, pos)
        next_token = torch.argmax(logits, dim=-1).to(torch.int32)
        return next_token[:, None], logits, new_cache
    return serve_decode
