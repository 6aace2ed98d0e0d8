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
reference's specs) and its shard of the batch; the step gathers the full
parameters, takes the loss and gradients on its shard, averages the
gradients over ("pod", "data") with `hierarchical_psum_tree`, clips them
by the global norm (the same on every rank) and updates its own blocks
(see `repro_torch.distributed`).
"""

from __future__ import annotations

import torch

from ..device import rdiv
from ..distributed import context as mesh_ctx
from ..distributed.collectives import all_reduce, hierarchical_psum_tree
from ..distributed.sharding import (entry_axes, gather_block, local_block,
                                    tree_specs)
from ..models import registry as M
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


def make_sharded_train_step(cfg, mesh, oc: OptConfig | None = None,
                            microbatch: int | None = None):
    """Returns (train_step, optimizer) for this rank of `mesh` (a
    `DeviceMesh` with axes among ("pod", "data", "model")).

    train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "grad_norm"}) takes this rank's blocks: `params` and
    `opt_state` under `train_specs(cfg, mesh)` (`sharding.shard_tree`;
    `optimizer.init` of the parameter blocks gives the state's), `batch`
    under `sharding.batch_specs`, which must split the batch over every
    dp axis.  The blocks are updated in place.  The loss is the mean over
    the dp ranks of their shards' losses (with equal shards, the loss of
    the whole batch: `cross_entropy` is an unmasked mean); grad_norm is
    the norm of the averaged gradients.  On a mesh of one rank the step
    is `make_train_step`'s, bit for bit.
    """
    p_specs, _ = train_specs(cfg, mesh)
    spec_list = leaves(p_specs)
    # AdamW8bit's row max spans the ranks that split a row's last dim
    row_groups = tree_map(
        lambda sp: tuple(mesh.get_group(a) for a in entry_axes(sp[-1])),
        p_specs)
    opt = make_optimizer(cfg.optimizer, oc, row_groups)
    grads_of = _grads_fn(cfg, microbatch)
    dp_groups = mesh_ctx.dp_groups(mesh)
    n_dp = mesh_ctx.dp_size(mesh)
    coords = mesh_ctx.mesh_coords(mesh)

    def train_step(params, opt_state, batch):
        full = [gather_block(x.detach(), sp, mesh)
                for x, sp in zip(leaves(params), spec_list)]
        full = unflatten(params, full)
        with mesh_ctx.mesh_scope(mesh):
            loss, grads = grads_of(full, batch)
        with torch.no_grad():
            synced, _ = hierarchical_psum_tree(
                unflatten(params, [g.float() for g in grads]), mesh,
                mean=True)
            grads, gnorm = _clip(leaves(synced))
            local = [local_block(g, sp, mesh, coords)
                     for g, sp in zip(grads, spec_list)]
            for g in dp_groups:
                loss = all_reduce(loss, g)
            loss = loss / torch.full((), n_dp, dtype=loss.dtype,
                                     device=loss.device)
        params, opt_state = opt.update(unflatten(params, local), opt_state,
                                       params)
        return params, opt_state, dict(loss=loss, grad_norm=gnorm)

    return train_step, opt


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
