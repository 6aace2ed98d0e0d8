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

The reference's expert-parallel `moe_apply_ep` (a shard_map over a model
mesh) runs `moe_apply` when there is no mesh; the port has no model mesh
yet, so it runs `moe_apply` for every config (ROADMAP.md lists
`moe_apply_ep` with `distributed/*`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

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


def moe_apply(cfg, p, x):
    """x: (B, S, D) -> (y (B, S, D), aux_loss)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    if k > 2:
        # the scatter-add below is order-independent only for top_k <= 2
        raise ValueError(
            f"{cfg.name}: top_k={k}; moe_apply's index_add_ is bitwise "
            "deterministic only for top_k <= 2 (on CUDA it adds with "
            "atomics, and three or more terms may sum in any order)")
    t = b * s
    cap = _capacity(cfg, t)
    xf = x.reshape(t, d)
    dev = x.device

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
    # position of each slot within its expert
    counts = torch.bincount(se, minlength=e)
    starts = torch.cumsum(counts, 0) - counts
    pos_in_e = torch.arange(t * k, device=dev) - starts[se]
    keep = pos_in_e < cap

    # slot table: (E*cap,) -> source token (or T = dummy).  Kept slots are
    # distinct, so these writes have no duplicate index.
    slot = se * cap + pos_in_e
    slot_token = torch.full((e * cap,), t, dtype=torch.int64, device=dev)
    slot_token[slot[keep]] = st[keep]
    slot_gate = torch.zeros((e * cap,), dtype=torch.float32, device=dev)
    slot_gate[slot[keep]] = sg[keep]
    # the reference's dropped-pair writes: every dropped pair writes gate
    # 0.0 at slot 0 after expert 0's first pair (sorted order), and the
    # dummy token at slot E*cap - 1, after the last expert's last kept
    # pair only where that expert's own pairs overflow
    any_drop = (~keep).any()
    last_overflows = (~keep & (se == e - 1)).any()
    slot_gate[0] = torch.where(any_drop, 0.0, slot_gate[0])
    slot_token[-1] = torch.where(last_overflows, t, slot_token[-1])

    # --- gather -> expert GEMMs -> scatter-add ---------------------------
    xpad = torch.cat([xf, torch.zeros((1, d), dtype=xf.dtype, device=dev)])
    xe = xpad[slot_token].reshape(e, cap, d)
    gate_h = xe @ p["we_gate"]
    up_h = xe @ p["we_up"]
    ye = _expert_mlp(gate_h, up_h, p["we_down"], x.dtype).reshape(e * cap, d)
    ye = ye * slot_gate[:, None].to(ye.dtype)

    # A real token's row takes at most top_k additions onto zero, one per
    # kept pair (its k experts are distinct).  For top_k <= 2 (checked
    # above) that is 0 + a = a and then a + b = b + a, so the order in
    # which index_add_ applies them cannot change a bit; the dummy row T,
    # which takes many, is cut off.
    y = torch.zeros((t + 1, d), dtype=x.dtype, device=dev)
    y.index_add_(0, slot_token, ye)
    y = y[:t].reshape(b, s, d)

    if cfg.moe_dense_residual:
        y = y + mlp_apply(cfg, p, x, prefix="res_")
    return y, aux


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
