"""Mixture-of-Experts layer: top-k routing with sort-based capacity dispatch
(port of `repro.models.moe`).

Token->expert assignments are sorted by expert (stably, so tokens keep
their order within an expert); each takes a slot `(expert,
position_in_expert)` capped by capacity; slot->token indices feed a
gather, the experts run as one batched product over the expert dim, and
the results are added back onto their tokens weighted by the router
gate.  Pairs beyond capacity are dropped.  Arctic additionally runs a
dense residual MLP in parallel with the MoE.

The reference writes the dropped pairs' slot entries onto real slots
(`slot_gate` at slot 0, `slot_token` at slot E*cap - 1), through scatters
with duplicate indices whose last write in sorted order wins on XLA.  A
torch scatter with duplicates leaves the winner undefined, so `moe_apply`
writes the kept pairs only and then sets those two slots to what the
reference's last write leaves there (ROADMAP.md, queue 3).

Under a registered mesh (`distributed.context`, set by the sharded train
step) each rank holds its own batch shard.  `moe_apply` then keeps the
reference's GSPMD semantics: it gathers the tokens of every dp rank
(differentiably: the gather's backward is a reduce-scatter), routes the
global tokens at the global capacity, takes the global aux loss and
returns its own rows.  `moe_apply_ep` is the reference's expert-parallel
dispatch over the "model" axis (local routing, capacity per rank and
expert, one all-to-all each way); it falls back to `moe_apply` where the
reference does.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..distributed import context as mesh_ctx
from ..distributed.collectives import (all_to_all_grad, gather_replicated,
                                       gather_rows, own_block, reduce_grad,
                                       sum_both, sum_replicated)
from .common import ParamSpec, Schema
from .mlp import mlp_apply, mlp_schema


def moe_schema(cfg, layers: int | None = None) -> Schema:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    L = (layers,) if layers is not None else ()
    A = ("layers",) if layers is not None else ()
    s: Schema = {
        "router": ParamSpec(L + (d, e), A + ("dmodel", "experts"), "fan_in"),
        "we_gate": ParamSpec(L + (e, d, f), A + ("experts", "dmodel", "ff"), "fan_in"),
        "we_up": ParamSpec(L + (e, d, f), A + ("experts", "dmodel", "ff"), "fan_in"),
        "we_down": ParamSpec(L + (e, f, d), A + ("experts", "ff", "dmodel"), "fan_in"),
    }
    if cfg.moe_dense_residual:
        s.update(mlp_schema(cfg, layers, prefix="res_"))
    return s


def _capacity(cfg, n_tokens: int) -> int:
    cap = int(n_tokens * cfg.top_k / cfg.n_experts * cfg.capacity_factor)
    return max(cap, cfg.top_k * 4)


def _route(cfg, p, xf):
    """float32 routing: (probs (T, E), gates (T, k) renormalised, experts
    (T, k)).  On the card TF32 must stay off (`torch.backends.cuda.matmul.
    allow_tf32 = False`), or a top-k choice may flip."""
    logits = xf.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = torch.topk(probs, cfg.top_k, dim=-1)
    gate_vals = gate_vals / torch.sum(gate_vals, dim=-1, keepdim=True)
    return probs, gate_vals, expert_idx


def _expert_mlp(h_gate, h_up, w_down, dtype):
    """SwiGLU's second half: one expert's (2-D `w_down`) or every
    expert's (3-D, batched over the expert dim)."""
    return (F.silu(h_gate.float()).to(dtype) * h_up) @ w_down


def _dispatch(cfg, p, xf):
    """Route the tokens xf (T, D) and lay them into expert slots: (aux,
    xe (E, cap, D), slot_token (E*cap,), slot_gate (E*cap,))."""
    t, d = xf.shape
    e, k = cfg.n_experts, cfg.top_k
    cap = _capacity(cfg, t)
    dev = xf.device

    # --- routing (fp32) -------------------------------------------------
    probs, gate_vals, expert_idx = _route(cfg, p, xf)

    # Switch-style aux loss: fraction-of-tokens x mean router prob per expert
    me = torch.mean(probs, dim=0)
    ce = torch.mean(F.one_hot(expert_idx[:, 0], e).float(), dim=0)
    aux = e * torch.sum(me * ce)

    # --- sort-based slotting --------------------------------------------
    flat_expert = expert_idx.reshape(-1)                         # (T*k,)
    flat_gate = gate_vals.reshape(-1)
    flat_token = torch.arange(t, device=dev).repeat_interleave(k)
    order = torch.argsort(flat_expert, stable=True)   # jnp.argsort is stable
    se, st, sg = flat_expert[order], flat_token[order], flat_gate[order]
    # position of each slot within its expert.  Every shape here is fixed
    # by (T, E, cap), never by the routing, and nothing is read back to
    # the host: the dry run traces this under fake tensors.
    counts = torch.zeros(e, dtype=se.dtype, device=dev).index_add_(
        0, se, torch.ones_like(se))
    starts = torch.cumsum(counts, 0) - counts
    pos_in_e = torch.arange(t * k, device=dev) - starts[se]
    keep = pos_in_e < cap

    # slot table: (E*cap,) -> source token (or T = dummy).  Kept slots are
    # distinct; dropped pairs write into one extra slot E*cap, cut off.
    slot = torch.where(keep, se * cap + pos_in_e, e * cap)
    slot_token = torch.full((e * cap + 1,), t, dtype=torch.int64, device=dev)
    slot_token[slot] = st
    slot_token = slot_token[:-1]
    slot_gate = torch.zeros((e * cap + 1,), dtype=torch.float32, device=dev)
    slot_gate[slot] = sg
    slot_gate = slot_gate[:-1]
    # the reference's dropped-pair writes: every dropped pair writes gate
    # 0.0 at slot 0 after expert 0's first pair (sorted order), and the
    # dummy token at slot E*cap - 1, after the last expert's last kept
    # pair only where that expert's own pairs overflow
    any_drop = (~keep).any()
    last_overflows = (~keep & (se == e - 1)).any()
    slot_gate[0] = torch.where(any_drop, 0.0, slot_gate[0])
    slot_token[-1] = torch.where(last_overflows, t, slot_token[-1])

    xpad = torch.cat([xf, torch.zeros((1, d), dtype=xf.dtype, device=dev)])
    xe = xpad[slot_token].reshape(e, cap, d)
    return aux, xe, slot_token, slot_gate


def _combine(ye, slot_token, slot_gate, t: int, dtype):
    """The expert outputs ye (E*cap, D), weighted by their gates, added
    back onto their tokens: (T, D).

    A real token's row takes at most top_k additions onto zero, one per
    kept pair (its k experts are distinct).  For top_k <= 2 (checked by
    the callers) that is 0 + a = a and then a + b = b + a, so the order in
    which index_add_ applies them cannot change a bit; the dummy row T,
    which takes many, is cut off."""
    ye = ye * slot_gate[:, None].to(ye.dtype)
    y = torch.zeros((t + 1, ye.shape[1]), dtype=dtype, device=ye.device)
    y.index_add_(0, slot_token, ye)
    return y[:t]


def _check_top_k(cfg):
    if cfg.top_k > 2:
        # `_combine`'s scatter-add is order-independent only for top_k <= 2
        raise ValueError(
            f"{cfg.name}: top_k={cfg.top_k}; moe_apply's index_add_ is "
            "bitwise deterministic only for top_k <= 2 (on CUDA it adds with "
            "atomics, and three or more terms may sum in any order)")


def _moe_local(cfg, p, x):
    """The MoE over the tokens of x (B, S, D) alone: (y, aux)."""
    _check_top_k(cfg)
    b, s, d = x.shape
    t = b * s
    aux, xe, slot_token, slot_gate = _dispatch(cfg, p, x.reshape(t, d))
    # --- expert GEMMs -> scatter-add -------------------------------------
    ye = _expert_mlp(xe @ p["we_gate"], xe @ p["we_up"], p["we_down"],
                     x.dtype).reshape(-1, d)
    y = _combine(ye, slot_token, slot_gate, t, x.dtype).reshape(b, s, d)
    if cfg.moe_dense_residual:
        y = y + mlp_apply(cfg, p, x, prefix="res_")
    return y, aux


def moe_apply(cfg, p, x):
    """x: (B, S, D) -> (y (B, S, D), aux_loss).

    Under a registered mesh x is this rank's batch shard: the tokens of
    every dp rank are gathered (pod-major), routed together at the global
    capacity, and this rank's rows come back with the global aux loss,
    the reference's GSPMD semantics."""
    mesh = mesh_ctx.get_mesh()
    groups = mesh_ctx.dp_groups(mesh) if mesh is not None else []
    if not groups:
        return _moe_local(cfg, p, x)
    b = x.shape[0]
    y, aux = _moe_local(cfg, p, gather_rows(x, groups))
    i = mesh_ctx.dp_index(mesh)
    return y[i * b:(i + 1) * b], aux


# ---------------------------------------------------------------------------
# Expert-parallel dispatch over the "model" axis
# ---------------------------------------------------------------------------

def _residual_tp(cfg, p, x, model):
    """Arctic's dense residual in full on every "model" rank: each rank
    multiplies its ff block of the SwiGLU weights and the partial products
    are summed over "model"."""
    if cfg.d_ff % dist.get_world_size(model):
        # the reference's shard_map cannot split these weights either
        raise ValueError(f"{cfg.name}: d_ff {cfg.d_ff} does not split over "
                         f"{dist.get_world_size(model)} model ranks")
    xin = reduce_grad(x, model)
    g = xin @ own_block(p["res_w_gate"], model, 1)
    u = xin @ own_block(p["res_w_up"], model, 1)
    part = _expert_mlp(g, u, own_block(p["res_w_down"], model, 0), x.dtype)
    return sum_replicated(part, model)


def moe_apply_ep(cfg, p, x):
    """Expert-parallel MoE over the registered mesh's "model" axis.

    x (B, S, D) is this rank's batch shard, the same on every "model"
    rank.  Each "model" rank routes its 1/ep slice of the sequence alone
    (capacity per rank and expert, the standard EP semantics: local drops
    instead of global), ONE all-to-all moves the dispatched slots to the
    rank holding their expert (experts are split over "model" in
    contiguous blocks), the expert products run there, a reverse
    all-to-all brings them back and the slices are gathered into the full
    (B, S, D) output.  Arctic's dense residual is computed in full (the
    reference adds only this rank's ff block of it: ROADMAP queue 3).

    The aux loss is the reference's: the mean over the dp ranks of the
    local aux of the "model" coordinate-0 slice (its shard_map keeps one
    replica of an unchecked replicated output).

    Falls back to `moe_apply` where the reference does: no mesh, a
    "model" axis of one rank, experts or sequence not divisible by it.
    The reference's batch test cannot fail here: the sharded step splits
    the batch over every dp axis.  Every parameter's gradient comes out
    whole and the same on every "model" rank."""
    mesh = mesh_ctx.get_mesh()
    sizes = mesh_ctx.axis_sizes()
    e = cfg.n_experts
    ep = sizes.get("model", 1)
    if mesh is None or e % max(ep, 1) or ep <= 1:
        return moe_apply(cfg, p, x)         # no mesh / indivisible: fallback
    b, s, d = x.shape
    if s % ep:
        return moe_apply(cfg, p, x)
    _check_top_k(cfg)
    model = mesh.get_group("model")
    el = e // ep
    xl = own_block(x, model, 1)                     # (B, S/ep, D)
    t = b * (s // ep)
    aux, xe, slot_token, slot_gate = _dispatch(
        cfg, {"router": reduce_grad(p["router"], model)}, xl.reshape(t, d))
    cap = xe.shape[1]
    # ---- all-to-all: slots travel to their expert's rank ----------------
    xe = all_to_all_grad(xe.reshape(ep, el, cap, d), model)
    xe = xe.transpose(0, 1).reshape(el, ep * cap, d)
    wg, wu, wd = (own_block(p[k], model, 0)
                  for k in ("we_gate", "we_up", "we_down"))
    ye = _expert_mlp(xe @ wg, xe @ wu, wd, x.dtype)  # (E/ep, ep*cap, D)
    # ---- reverse all-to-all ------------------------------------------------
    ye = all_to_all_grad(ye.reshape(el, ep, cap, d).transpose(0, 1), model)
    y = _combine(ye.reshape(e * cap, d), slot_token, slot_gate, t, x.dtype)
    y = gather_replicated(y.reshape(b, s // ep, d), model, 1)
    if cfg.moe_dense_residual:
        y = y + _residual_tp(cfg, p, x, model)
    groups = mesh_ctx.dp_groups(mesh)
    for g in groups:
        aux = sum_both(aux, g)
    if groups:
        aux = aux / torch.full((), mesh_ctx.dp_size(mesh),
                               dtype=aux.dtype, device=aux.device)
    first = 1.0 if dist.get_rank(model) == 0 else 0.0
    return y, sum_replicated(aux * first, model)


def moe_apply_pairs(cfg, p, x):
    """The plain per-pair version `moe_apply` is checked against: every
    kept (token, expert) pair's expert MLP on its token, weighted by its
    gate, added onto the token; no slot table.  A pair is kept when fewer
    than `capacity` earlier pairs (token-major order) chose its expert;
    where any pair drops, expert 0's first kept pair adds nothing, and
    where the last expert's own pairs overflow, its last kept pair adds
    nothing (the reference's dropped-pair writes, see the module
    docstring).  Returns (y (B, S, D), {"pairs", "dropped", "capacity"}).
    Reads the routing back to the host: a check, not a path."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    t = b * s
    cap = _capacity(cfg, t)
    xf = x.reshape(t, d)
    _, gate_vals, expert_idx = _route(cfg, p, xf)
    counts = torch.bincount(expert_idx.reshape(-1), minlength=e).tolist()
    dropped = sum(max(c - cap, 0) for c in counts)
    y = torch.zeros((t, d), dtype=x.dtype, device=x.device)
    for j in range(e):
        tok, which = torch.nonzero(expert_idx == j, as_tuple=True)
        tok, which = tok[:cap], which[:cap]          # row-major: token order
        gates = gate_vals[tok, which].clone()
        if j == 0 and dropped and len(gates):
            gates[0] = 0.0
        if j == e - 1 and counts[j] > cap:
            gates[-1] = 0.0
        xj = xf[tok]
        out = _expert_mlp(xj @ p["we_gate"][j], xj @ p["we_up"][j],
                          p["we_down"][j], x.dtype)
        y.index_add_(0, tok, out * gates[:, None].to(out.dtype))
    y = y.reshape(b, s, d)
    if cfg.moe_dense_residual:
        y = y + mlp_apply(cfg, p, x, prefix="res_")
    return y, {"pairs": t * k, "dropped": dropped, "capacity": cap}
