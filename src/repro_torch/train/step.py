"""Step factories: train_step / serve_prefill / serve_decode.

Port of `repro.train.step`.  Gradients come from autograd; microbatches
accumulate in float32 and are scaled by 1 / microbatch; the gradients
are cast to float32 before the global-norm clip at 1.0 (in the reference
a bf16 gradient times the float32 clip is float32; in PyTorch it would
stay bf16 and take one more rounding), then the optimizer updates the
parameters and its state in place.
"""

from __future__ import annotations

import torch

from ..device import rdiv
from ..models import registry as M
from ..tree import leaves, unflatten
from .optimizer import OptConfig, make_optimizer


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

    def train_step(params, opt_state, batch):
        loss, grads = grads_of(params, batch)
        with torch.no_grad():
            grads = [g.float() for g in grads]
            gnorm = torch.sqrt(sum(torch.sum(torch.square(g))
                                   for g in grads))
            # global-norm clip at 1.0
            clip = torch.clamp(rdiv(1.0, gnorm + 1e-6), max=1.0)
            for g in grads:
                g.mul_(clip)
        params, opt_state = opt.update(unflatten(params, grads), opt_state,
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
