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
torch scatter with duplicates leaves the winner undefined, so the one
slot rule (`_global_slots`, on one dp rank or many) writes the kept pairs
only and gives those two slots what the reference's last write leaves
there: gate 0.0 for expert 0's first pair where any pair drops, and no
pair in the last expert's last slot where its own pairs overflow
(ROADMAP.md, queue 3).

Under a registered mesh (`distributed.context`, set by the sharded
steps) each rank holds its own batch shard and computes only its share,
with the reference's GSPMD numbers.  The mesh-global `moe_apply` routes
the rank's own tokens: the per-expert counts of every dp rank's pairs
(one all-gather of E integers) place each pair at its global position
in its expert, so the global capacity, the global drops and the
dropped-pair writes are the reference's; the aux loss comes from the
ranks' sums of the router's probabilities and top-1 choices, summed
over dp.  Each dp rank computes a fixed 1/dp range of the global slots
of the experts it holds (all of them, or its "experts" block of `we_*`
under `tensor_parallel.model_split`, the outputs then summed over
"model"): one all-to-all over dp carries the kept pairs' inputs into
the ranges, a second brings the outputs back (`_moe_mesh`).
`moe_apply_ep` is the reference's expert-parallel dispatch over the
"model" axis (local routing, capacity per rank and expert, one
all-to-all each way) on the rank's expert blocks and, under
`seq_parallel`, on the rank's sequence block as the stream holds it; it
falls back to `moe_apply` where the reference does.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..distributed import context as mesh_ctx
from ..distributed import tensor_parallel as tp
from ..distributed.collectives import (all_gather_cat, all_to_all_grad,
                                       gather_replicated, one_replica,
                                       own_block, reduce_grad, sum_both,
                                       sum_replicated)
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


def _sorted_pairs(expert_idx, e: int):
    """The rank's (token, k) pairs stably sorted by expert: (order, their
    experts, the per-expert counts (E,))."""
    flat = expert_idx.reshape(-1)
    order = torch.argsort(flat, stable=True)   # jnp.argsort is stable
    se = flat[order]
    counts = torch.zeros(e, dtype=se.dtype, device=se.device).index_add_(
        0, se, torch.ones_like(se))
    return order, se, counts


def _slot_table(cfg, p, xf):
    """Route the tokens xf (T, D) and lay them into expert slots: (aux,
    slot_token (E*cap,), slot_gate (E*cap,), cap); slot e * cap + j holds
    expert e's j-th kept pair, slot_token T (a zero row) where none.  The
    slot rule is `_global_slots`' with one dp rank holding every
    expert."""
    t = xf.shape[0]
    e = cfg.n_experts
    cap = _capacity(cfg, t)

    # --- routing (fp32) -------------------------------------------------
    probs, gate_vals, expert_idx = _route(cfg, p, xf)

    # Switch-style aux loss: fraction-of-tokens x mean router prob per expert
    me = torch.mean(probs, dim=0)
    ce = torch.mean(F.one_hot(expert_idx[:, 0], e).float(), dim=0)
    aux = e * torch.sum(me * ce)

    # --- sort-based slotting --------------------------------------------
    order, se, counts = _sorted_pairs(expert_idx, e)
    slot, zero = _global_slots(se, counts, counts[None], 0, cap, cap, 0, e)
    slot_token, slot_gate = _fill_slots(slot, zero, order, gate_vals,
                                        e * cap)
    return aux, slot_token, slot_gate, cap


def _slot_inputs(xf, slot_token, cap: int):
    """The tokens of the slots `slot_token` (n * cap,): (n, cap, D)."""
    d = xf.shape[1]
    xpad = torch.cat([xf, torch.zeros((1, d), dtype=xf.dtype,
                                      device=xf.device)])
    return xpad[slot_token].reshape(-1, cap, d)


def _dispatch(cfg, p, xf):
    """Route the tokens xf (T, D) and lay them into expert slots: (aux,
    xe (E, cap, D), slot_token (E*cap,), slot_gate (E*cap,))."""
    aux, slot_token, slot_gate, cap = _slot_table(cfg, p, xf)
    return aux, _slot_inputs(xf, slot_token, cap), slot_token, slot_gate


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
    """The MoE over the tokens of x (B, S, D) alone, every expert whole:
    (y, aux)."""
    _check_top_k(cfg)
    b, s, d = x.shape
    t = b * s
    aux, xe, slot_token, slot_gate = _dispatch(cfg, p, x.reshape(t, d))
    # --- expert GEMMs -> scatter-add ---------------------------------------
    ye = _expert_mlp(xe @ p["we_gate"], xe @ p["we_up"], p["we_down"],
                     x.dtype).reshape(-1, d)
    y = _combine(ye, slot_token, slot_gate, t, x.dtype).reshape(b, s, d)
    if cfg.moe_dense_residual:
        y = y + mlp_apply(cfg, p, x, prefix="res_")
    return y, aux


def _dp_all_to_all(t, mesh):
    """t (dp, ...), entry j bound for dp rank j (pod-major), -> (dp, ...),
    entry j from dp rank j: one differentiable all-to-all over each dp
    axis of more than one rank ("data", then "pod")."""
    sizes = mesh_ctx.mesh_axis_sizes(mesh)
    npod, ndata = sizes.get("pod", 1), sizes.get("data", 1)
    rest = tuple(t.shape[1:])
    t = t.reshape((npod, ndata) + rest)
    if ndata > 1:
        t = all_to_all_grad(t.transpose(0, 1),
                            mesh.get_group("data")).transpose(0, 1)
    if npod > 1:
        t = all_to_all_grad(t, mesh.get_group("pod"))
    return t.reshape((npod * ndata,) + rest)


def _global_slots(se, counts, every, i: int, cap: int, c: int, e0: int,
                  el: int):
    """Where dp rank `i`'s sorted pairs (experts `se`, per-expert `counts`)
    go, given every dp rank's counts `every` (dp, E): (slot, zero).

    A pair's global position in its expert is the pairs of that expert
    on the dp ranks before `i` plus its position among the rank's own; it
    is kept below `cap`.  `slot` is its place in the (dp, el, c) layout of
    the held experts [e0, e0 + el) by destination (dp rank `pos // c`,
    slot `pos % c` of its range), or dp * el * c where it is dropped or
    its expert is not held.  The reference's dropped-pair writes: where
    any pair drops, expert 0's global slot 0 gets gate 0.0 (`zero`);
    where the last expert overflows, its slot cap - 1 adds nothing (the
    pair is not kept)."""
    e = every.shape[1]
    total = every.sum(0)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(se.shape[0], device=se.device) \
        + (every[:i].sum(0) - starts)[se]
    keep = (pos < cap) & ~((se == e - 1) & (pos == cap - 1)
                           & (total[-1] > cap))
    zero = (se == 0) & (pos == 0) & (total > cap).any()
    held = keep & (se >= e0) & (se < e0 + el)
    dest = torch.div(pos, c, rounding_mode="floor")
    slot = torch.where(held, (dest * el + se - e0) * c + pos - dest * c,
                       every.shape[0] * el * c)
    return slot, zero


def _fill_slots(slot, zero, order, gate_vals, n_slots: int, model=None):
    """The slot table of the rank's pairs at `slot` (`_global_slots`):
    (slot_token (n_slots,), slot_gate (n_slots,)); token T (a zero row)
    and gate 0 where no pair is kept.  Kept slots are distinct; the
    others write into one extra slot n_slots, cut off.  With `model` the
    gates' gradient is summed back over it (`reduce_grad`)."""
    t, k = gate_vals.shape
    dev = gate_vals.device
    st = torch.arange(t, device=dev).repeat_interleave(k)[order]
    sg = gate_vals.reshape(-1)[order]
    sg = torch.where(zero, torch.zeros_like(sg), sg)
    slot_token = torch.full((n_slots + 1,), t, dtype=torch.int64, device=dev)
    slot_token[slot] = st
    slot_gate = torch.zeros((n_slots + 1,), dtype=torch.float32, device=dev)
    slot_gate[slot] = sg if model is None else reduce_grad(sg, model)
    return slot_token[:-1], slot_gate[:-1]


def _moe_mesh(cfg, p, x, mesh):
    """The mesh-global MoE on this rank's tokens x (B, S, D): (y, aux),
    the reference's numbers for the dp ranks' batch routed together.

    Routing: the rank's pairs take their global positions from every dp
    rank's per-expert counts (one all-gather), the capacity is the
    global token count's, and the rank owning a dropped-pair write
    applies it (`_global_slots`).  The aux loss takes the router's
    probabilities and top-1 choices summed over dp (`sum_both`: every
    rank's loss reads the sum, so each rank's tokens get the gradient of
    the global aux).

    Slots: dp rank r computes slots [r c, (r + 1) c) of each expert it
    holds, c = ceil(cap / dp) (slots past cap are never filled).  Each
    rank lays its kept pairs' inputs into a (dp, E_held, c, D) buffer at
    their places in each destination's range (zeros elsewhere); one
    all-to-all over dp delivers it and the receiver sums the dp pieces
    (each slot comes from one rank, so adding the zeros leaves it
    exact).  The experts run on (E_held, c, D); a second all-to-all
    brings every range's outputs back to every dp rank, and each rank
    combines its own pairs' outputs onto its rows.  Where `we_*` are the
    rank's "experts" block (`tp.block_group`) E_held is that block, the
    partial outputs are summed over "model", and the inputs' and gates'
    gradients summed back over it (`reduce_grad`), so that x and the
    router get their whole gradients on every "model" rank.  Every
    shape is fixed by (tokens, E, cap, mesh), never by the routing, and
    nothing is read back to the host."""
    _check_top_k(cfg)
    b, s, d = x.shape
    t = b * s
    e = cfg.n_experts
    groups = mesh_ctx.dp_groups(mesh)
    n_dp = mesh_ctx.dp_size(mesh)
    cap = _capacity(cfg, t * n_dp)
    c = -(-cap // n_dp)
    model = tp.block_group(p["we_gate"], e, -3)
    el = p["we_gate"].shape[-3]
    e0 = dist.get_rank(model) * el if model is not None else 0
    xf = x.reshape(t, d)
    dev = x.device

    # --- routing (fp32) and the global aux loss -----------------------------
    probs, gate_vals, expert_idx = _route(cfg, p, xf)
    sums = torch.stack([torch.sum(probs, dim=0), torch.sum(
        F.one_hot(expert_idx[:, 0], e).float(), dim=0)])
    for g in groups:
        sums = sum_both(sums, g)
    me, ce = sums / torch.full((), t * n_dp, dtype=sums.dtype, device=dev)
    aux = e * torch.sum(me * ce)

    # --- the rank's pairs in the global slot table -------------------------
    order, se, counts = _sorted_pairs(expert_idx, e)
    every = counts[None]                 # every dp rank's, pod-major
    for g in groups:
        every = all_gather_cat(every, g, 0)
    slot, zero = _global_slots(se, counts, every, mesh_ctx.dp_index(mesh),
                               cap, c, e0, el)
    n_slots = n_dp * el * c
    slot_token, slot_gate = _fill_slots(slot, zero, order, gate_vals,
                                        n_slots, model)
    xin = xf if model is None else reduce_grad(xf, model)

    # --- exchange, experts, exchange back, combine --------------------------
    xs = _slot_inputs(xin, slot_token, c).reshape(n_dp, el, c, d)
    xe = _dp_all_to_all(xs, mesh).sum(0)                      # (E_held, c, D)
    ye = _expert_mlp(xe @ p["we_gate"], xe @ p["we_up"], p["we_down"],
                     x.dtype)
    back = _dp_all_to_all(ye.expand(n_dp, el, c, d), mesh)
    y = _combine(back.reshape(n_slots, d), slot_token, slot_gate, t, x.dtype)
    if model is not None:
        y = sum_replicated(y, model)
    y = y.reshape(b, s, d)
    if cfg.moe_dense_residual:
        y = y + mlp_apply(cfg, p, x, prefix="res_")
    return y, aux


def moe_apply(cfg, p, x):
    """x: (B, S, D) -> (y (B, S, D), aux_loss).

    Under a registered mesh x is this rank's batch shard and the result
    is the reference's for the dp ranks' batch routed together at the
    global capacity: this rank's rows and the global aux loss
    (`_moe_mesh`).  With no mesh, or a mesh of one dp rank and every
    expert whole, the tokens are routed alone (`_moe_local`)."""
    mesh = mesh_ctx.get_mesh()
    if mesh is None or (not mesh_ctx.dp_groups(mesh) and tp.block_group(
            p["we_gate"], cfg.n_experts, -3) is None):
        return _moe_local(cfg, p, x)
    return _moe_mesh(cfg, p, x, mesh)


# ---------------------------------------------------------------------------
# Expert-parallel dispatch over the "model" axis
# ---------------------------------------------------------------------------

def _residual_tp(cfg, p, x, model, st: tp.Stream):
    """Arctic's dense residual in full on every "model" rank: each rank
    multiplies its "ff" block of the SwiGLU weights (as given, or cut
    from whole ones) and the partial products are summed over "model"
    (reduce-scattered along the sequence under `seq_parallel`)."""
    if tp.block_group(p["res_w_gate"], cfg.d_ff, -1) is None:
        if cfg.d_ff % dist.get_world_size(model):
            # the reference's shard_map cannot split these weights either
            raise ValueError(f"{cfg.name}: d_ff {cfg.d_ff} does not split "
                             f"over {dist.get_world_size(model)} model ranks")
        p = {"res_w_gate": own_block(p["res_w_gate"], model, 1),
             "res_w_up": own_block(p["res_w_up"], model, 1),
             "res_w_down": own_block(p["res_w_down"], model, 0)}
    return mlp_apply(cfg, p, x, prefix="res_", st=st)


def _expert_block(w, e: int, model):
    """The rank's "model" block of an expert leaf: `w` where it is that
    block already (`tp.block_group`), else cut from the whole leaf."""
    if tp.block_group(w, e, -3) is not None:
        return w
    return own_block(w, model, 0)


def moe_apply_ep(cfg, p, x, st: tp.Stream = tp.WHOLE):
    """Expert-parallel MoE over the registered mesh's "model" axis.

    x is the residual stream as `st` holds it: this rank's batch shard
    (B, S, D), the same on every "model" rank, or under `seq_parallel`
    its sequence block (B, S / ep, D), which is the slice this rank
    routes.  Each "model" rank routes its 1/ep slice of the sequence
    alone (capacity per rank and expert, the standard EP semantics: local
    drops instead of global), ONE all-to-all moves the dispatched slots
    to the rank holding their expert (experts are split over "model" in
    contiguous blocks: `we_*` as given where they are the rank's block,
    cut from whole ones otherwise), the expert products run there, a
    reverse all-to-all brings them back; with the whole sequence the
    slices are gathered into the full (B, S, D) output.  Arctic's dense
    residual is computed in full, on its "ff" blocks (the reference adds
    only this rank's ff block of it: ROADMAP queue 3).

    The aux loss is the reference's: the mean over the dp ranks of the
    local aux of the "model" coordinate-0 slice (its shard_map keeps one
    replica of an unchecked replicated output), whose gradient is the
    reference's too, that of the mean over every dp and "model" rank's
    local aux (`one_replica`; ROADMAP queue 3).

    Falls back to `moe_apply` where the reference does: no mesh, a
    "model" axis of one rank, experts or sequence not divisible by it.
    The reference's batch test cannot fail here: the sharded step splits
    the batch over every dp axis.  The router's gradient comes out whole
    and the same on every "model" rank, each expert block's gradient
    that block's (whole on every rank where the weights were given
    whole)."""
    mesh = mesh_ctx.get_mesh()
    sizes = mesh_ctx.axis_sizes()
    e = cfg.n_experts
    ep = sizes.get("model", 1)
    b, s, d = x.shape
    if (mesh is None or e % max(ep, 1) or ep <= 1
            or (not st.seq and s % ep)):
        # no mesh / indivisible: fallback
        y, aux = moe_apply(cfg, p, tp.enter_whole(x, st))
        return tp.leave_whole(y, st), aux
    _check_top_k(cfg)
    model = mesh.get_group("model")
    el = e // ep
    xl = x if st.seq else own_block(x, model, 1)    # (B, S/ep, D)
    sl = xl.shape[1]
    t = b * sl
    aux, xe, slot_token, slot_gate = _dispatch(
        cfg, {"router": reduce_grad(p["router"], model)}, xl.reshape(t, d))
    cap = xe.shape[1]
    # ---- all-to-all: slots travel to their expert's rank ----------------
    xe = all_to_all_grad(xe.reshape(ep, el, cap, d), model)
    xe = xe.transpose(0, 1).reshape(el, ep * cap, d)
    wg, wu, wd = (_expert_block(p[k], e, model)
                  for k in ("we_gate", "we_up", "we_down"))
    ye = _expert_mlp(xe @ wg, xe @ wu, wd, x.dtype)  # (E/ep, ep*cap, D)
    # ---- reverse all-to-all ------------------------------------------------
    ye = all_to_all_grad(ye.reshape(el, ep, cap, d).transpose(0, 1), model)
    y = _combine(ye.reshape(e * cap, d), slot_token, slot_gate, t, x.dtype)
    y = y.reshape(b, sl, d)
    if not st.seq:
        y = gather_replicated(y, model, 1)
    if cfg.moe_dense_residual:
        y = y + _residual_tp(cfg, p, x, model, st)
    groups = mesh_ctx.dp_groups(mesh)
    for g in groups:
        aux = sum_both(aux, g)
    if groups:
        aux = aux / torch.full((), mesh_ctx.dp_size(mesh),
                               dtype=aux.dtype, device=aux.device)
    return y, one_replica(aux, model)


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
