"""What the members of the tensor-parallel tests' gloo groups run
(`repro_torch.launch.group.run_group` imports this module in each
member; it imports neither JAX nor pytest).

`pieces` holds each split piece of the model against the same function
on one rank, inside the member: every rank computes the single-rank
function on the whole inputs (cheap at smoke size) and compares its own
output and its own blocks of the gradients; `ssm_pieces` does the same
for the Mamba2 mixer and Zamba2's group.  `serve` runs the sharded
prefill and greedy decode and writes rank 0's tokens and logits for the
test module to hold against the single process and the reference.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

import torch_dist_children as K
from repro_torch.configs.registry import get_arch
from repro_torch.distributed import context as mesh_ctx
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.distributed.sharding import (batch_specs, gather_tree,
                                              local_block, shard_tree)
from repro_torch.launch.mesh import make_train_mesh
from repro_torch.distributed.collectives import all_gather_cat
from repro_torch.models import attention, common, encdec, lm, mlp, moe, ssm
from repro_torch.train.step import (make_sharded_serve_decode,
                                    make_sharded_serve_prefill,
                                    make_train_step, train_specs)
from repro_torch.tree import leaves, leaves_with_paths, tree_map, unflatten

SEED = 3


def config(arch: str, replace: dict | None):
    cfg = get_arch(arch)
    return dataclasses.replace(cfg, **replace) if replace else cfg


def compute_form(cfg, mesh, full: dict) -> dict:
    """The parameters as the layers under `mesh` take them: the rank's
    "model" block of each leaf `model_split` marks, the others whole (a
    mesh with no "data" or "pod" ranks)."""
    p_specs, _ = train_specs(cfg, mesh)
    split = leaves(tp.model_split(cfg, mesh))
    blocks = leaves(shard_tree(full, p_specs, mesh))
    return unflatten(full, [b if on else w for b, w, on in
                            zip(blocks, leaves(full), split)])


def _err(got, want) -> float:
    """max |got - want| over max |want|."""
    want = want.detach().float()
    scale = max(float(want.abs().max()), 1e-30)
    return float((got.detach().float() - want).abs().max()) / scale


def _rng_tensor(rng, shape):
    return torch.as_tensor(rng.standard_normal(shape, dtype=np.float32))


def _objective(fn, inputs: dict, wy):
    """fn(**inputs) -> y; (y, the gradients of sum(y * wy) by input)."""
    for t in inputs.values():
        t.requires_grad_(True)
    y = fn(**inputs)
    grads = torch.autograd.grad(torch.sum(y * wy), list(inputs.values()),
                                allow_unused=True)
    return y.detach(), dict(zip(inputs, grads))


def _compare(mesh, name, run, full_inputs: dict, block_of,
             y_block=lambda y: y) -> dict:
    """`run(inputs, split)` on the whole inputs (no mesh) and on the rank's
    (`block_of(key, whole tensor)`, under the mesh); the rank's output
    (`y_block` of the whole one) and its blocks of the gradients against
    the whole run's."""
    whole = {k: v.clone() for k, v in full_inputs.items()}
    y1, g1 = run(whole, False)
    mine = {k: block_of(k, v).clone() for k, v in full_inputs.items()}
    with mesh_ctx.mesh_scope(mesh):
        y2, g2 = run(mine, True)
    out = {"y": _err(y2, y_block(y1))}
    for k in g1:
        if g1[k] is None:
            continue
        out["grad/" + k] = _err(g2[k], block_of(k, g1[k]))
    return {name: out}


def pieces(shape) -> dict:
    """Every piece at mesh `shape` (1, 1, m): the errors of the rank's
    output and gradient blocks, {piece: {what: err of max}}."""
    torch.set_num_threads(1)
    mesh = make_train_mesh(tuple(shape), device="cpu")
    m = shape[-1]
    rank = dist.get_rank()
    res = {}
    cases = [("olmo-1b-smoke", None)]
    if m == 4:
        cases.append(("olmo-1b-smoke", {"n_heads": 6, "head_dim": 32}))
    for arch, rep in cases:
        cfg = config(arch, rep)
        tag = arch + ("-h6" if rep else "")
        res.update(_attention(cfg, mesh, tag))
        res.update(_mlp(cfg, mesh, tag))
        res.update(_decode(cfg, mesh, tag))
        res.update(_seq_layer(dataclasses.replace(cfg, seq_parallel=True),
                              mesh, tag))
    res.update(_seq_layer(config("qwen2-1.5b-smoke", {"seq_parallel": True}),
                          mesh, "qwen2-1.5b-smoke"))
    res.update(_vocab(config("qwen2-1.5b-smoke", {"vocab_size": 500}),
                      mesh, "qwen2-1.5b-smoke-v500"))
    for arch in ("phi3.5-moe-42b-a6.6b-smoke", "arctic-480b-smoke"):
        res.update(_experts(config(arch, None), mesh, arch))
    out = {"rank": rank, "model_ranks": m, "errors": res}
    if m == 2:
        out["bf16"] = bf16_steps(mesh)
    return out


# ---------------------------------------------------------------------------
# the split train step in bf16
# ---------------------------------------------------------------------------

BF16 = {"param_dtype": "bfloat16", "compute_dtype": "bfloat16"}
BF16_B, BF16_STEPS = 4, 2


def _world1(cfg, start, b: int, steps: int):
    """`steps` single-process steps (K.OC) of `cfg` from `start`: (loss,
    grad norm) per step, the parameters."""
    params = tree_map(torch.clone, start)
    fn, opt = make_train_step(cfg, K.OC)
    state = opt.init(params)
    batch = K.train_batch(cfg, b)
    metrics = []
    for _ in range(steps):
        params, state, m = fn(params, state, batch)
        metrics.append((m["loss"].item(), m["grad_norm"].item()))
    return metrics, params


def _leaf_errs(got, want) -> dict:
    return {"/".join(path): _err(g, w) for (path, w), g in
            zip(leaves_with_paths(want), leaves(got))}


def bf16_steps(mesh, arch: str = "olmo-1b-smoke") -> dict:
    """`arch` in bf16: BF16_STEPS sharded steps at `mesh` (every rank the
    whole batch), world 1 in bf16 from the same weights, and world 1 in
    float32 from those weights cast (the control: how far bf16 itself
    moves the numbers).  Each run's (loss, grad norm) per step, and each
    parameter leaf's max |a - b| / max |b| of the split run against
    world 1 in bf16 and of world 1 in bf16 against float32."""
    cfg = config(arch, BF16)
    f32 = config(arch, {"param_dtype": "float32",
                        "compute_dtype": "float32"})
    params, _, (p_specs, _), metrics = K.sharded_run(cfg, mesh, BF16_STEPS,
                                                     BF16_B)
    got = gather_tree(params, p_specs, mesh)
    start = K.start_params(cfg)
    w1, want = _world1(cfg, start, BF16_B, BF16_STEPS)
    ctl, want32 = _world1(f32, tree_map(lambda t: t.float(), start), BF16_B,
                          BF16_STEPS)
    return {"split": metrics, "world1": w1, "float32": ctl,
            "param_split": _leaf_errs(got, want),
            "param_control": _leaf_errs(want, want32)}


def _layer(cfg, mesh):
    """(whole layer-0 params, the rank's form of them)."""
    full = K.start_params(cfg)
    one = lm.layer_params(full, 0)
    split = compute_form(cfg, mesh, full)
    return one, lm.layer_params(split, 0)


def _param_block(cfg, mesh, whole: dict, mine: dict):
    """block_of for the layer's params: the rank's block where its form
    is a block (shape differs), else the whole tensor."""
    def block_of(key, t):
        if key not in mine or mine[key].shape == whole[key].shape:
            return t
        dim = next(d for d, (a, b) in enumerate(zip(mine[key].shape,
                                                     whole[key].shape))
                   if a != b)
        n = mine[key].shape[dim]
        r = mesh_ctx.mesh_coords(mesh)["model"]
        return t.narrow(dim, r * n, n)
    return block_of


def _attention(cfg, mesh, tag) -> dict:
    rng = np.random.default_rng(SEED)
    whole, mine = _layer(cfg, mesh)
    keys = [k for k in ("wq", "wk", "wv", "wo", "bq", "bk", "bv")
            if k in whole]
    x = _rng_tensor(rng, (2, 64, cfg.d_model))
    wy = _rng_tensor(rng, (2, 64, cfg.d_model))
    block_p = _param_block(cfg, mesh, whole, mine)

    def run(inputs, split):
        def fn(x, **p):
            return attention.causal_attention(cfg, p, x)[0]
        return _objective(fn, inputs, wy)

    full_inputs = {"x": x, **{k: whole[k] for k in keys}}
    return _compare(mesh, f"{tag}/attention", run, full_inputs,
                    lambda k, t: t if k == "x" else block_p(k, t))


def _mlp(cfg, mesh, tag) -> dict:
    rng = np.random.default_rng(SEED + 1)
    whole, mine = _layer(cfg, mesh)
    keys = ("w_gate", "w_up", "w_down")
    x = _rng_tensor(rng, (2, 64, cfg.d_model))
    wy = _rng_tensor(rng, (2, 64, cfg.d_model))
    block_p = _param_block(cfg, mesh, whole, mine)

    def run(inputs, split):
        def fn(x, **p):
            return mlp.mlp_apply(cfg, p, x)
        return _objective(fn, inputs, wy)

    return _compare(mesh, f"{tag}/mlp", run,
                    {"x": x, **{k: whole[k] for k in keys}},
                    lambda k, t: t if k == "x" else block_p(k, t))


def _vocab(cfg, mesh, tag) -> dict:
    """The vocab-parallel lookup, head (tied) and cross entropy: the loss
    of logits(embed(tokens) + x) against targets, the padded tail of the
    vocabulary inside the logsumexp."""
    rng = np.random.default_rng(SEED + 2)
    full = K.start_params(cfg)
    mine = compute_form(cfg, mesh, full)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 33)))
    x = _rng_tensor(rng, (2, 32, cfg.d_model))
    one = torch.ones(())

    def run(inputs, split):
        def fn(embed, x):
            p = {"embed": embed}
            group = tp.block_group(embed, cfg.padded_vocab, 0)
            h = common.embed_tokens(p, toks[:, :-1], torch.float32, group) + x
            if group is not None:
                h = tp.enter(h, group, tp.Stream(group))
            logits = common.lm_logits(cfg, p, h)
            return common.cross_entropy(logits, toks[:, 1:],
                                        cfg.padded_vocab, group)
        return _objective(fn, inputs, one)

    r = mesh_ctx.mesh_coords(mesh)["model"]
    rows = mine["embed"].shape[0]
    return _compare(mesh, f"{tag}/vocab", run,
                    {"embed": full["embed"], "x": x},
                    lambda k, t: t.narrow(0, r * rows, rows)
                    if k == "embed" else t)


def _experts(cfg, mesh, tag) -> dict:
    """The mesh-global `moe_apply` with the experts split: y, the aux loss
    and every gradient (router whole, `we_*` and the residual's blocks)."""
    rng = np.random.default_rng(SEED + 3)
    whole, mine = _layer(cfg, mesh)
    keys = [k for k in whole if k in ("router", "we_gate", "we_up",
                                      "we_down", "res_w_gate", "res_w_up",
                                      "res_w_down")]
    x = _rng_tensor(rng, (2, 32, cfg.d_model))
    wy = _rng_tensor(rng, (2, 32, cfg.d_model))
    block_p = _param_block(cfg, mesh, whole, mine)

    def run(inputs, split):
        def fn(x, **p):
            y, aux = moe.moe_apply(cfg, p, x)
            return torch.cat([y.reshape(-1), aux.reshape(1)])
        return _objective(fn, inputs, torch.cat([wy.reshape(-1),
                                                 torch.ones(1)]))

    return _compare(mesh, f"{tag}/experts", run,
                    {"x": x, **{k: whole[k] for k in keys}},
                    lambda k, t: t if k == "x" else block_p(k, t))


def _decode(cfg, mesh, tag) -> dict:
    """`decode_attention` on a cache whose sequence splits over "model":
    the output and the rank's block of the updated cache against the
    whole decode, for rows at positions in every rank's block."""
    rng = np.random.default_rng(SEED + 4)
    whole, mine = _layer(cfg, mesh)
    s_cache, b = 32, 4
    k = _rng_tensor(rng, (b, s_cache, cfg.n_kv_heads, cfg.head_dim_))
    v = _rng_tensor(rng, (b, s_cache, cfg.n_kv_heads, cfg.head_dim_))
    x = _rng_tensor(rng, (b, 1, cfg.d_model))
    pos = torch.tensor([0, 9, 17, 31], dtype=torch.int32)
    y1, k1, v1 = attention.decode_attention(cfg, whole, x, k.clone(),
                                            v.clone(), pos)
    spec = (None, "model", None, None)
    with mesh_ctx.mesh_scope(mesh):
        kb = local_block(k, spec, mesh).clone()
        vb = local_block(v, spec, mesh).clone()
        y2, k2, v2 = attention.decode_attention(
            cfg, mine, x, kb, vb, pos, split=tp.CacheSplit(("model",)))
    return {f"{tag}/decode": {
        "y": _err(y2, y1), "k": _err(k2, local_block(k1, spec, mesh)),
        "v": _err(v2, local_block(v1, spec, mesh))}}


def _seq_layer(cfg, mesh, tag) -> dict:
    """One `_tf_block` under `seq_parallel`: the stream is the rank's
    sequence block in and out; its output block and the gradients of the
    stream block and of every parameter (norm weights summed over
    "model") against the whole layer."""
    rng = np.random.default_rng(SEED + 5)
    whole, mine = _layer(cfg, mesh)
    keys = sorted(whole)
    s = 64
    h = _rng_tensor(rng, (2, s, cfg.d_model))
    wy = _rng_tensor(rng, (2, s, cfg.d_model))
    positions = torch.arange(s)[None, :]
    block_p = _param_block(cfg, mesh, whole, mine)
    m = mesh_ctx.mesh_axis_sizes(mesh)["model"]
    r = mesh_ctx.mesh_coords(mesh)["model"]

    def seq_block(t):
        return t.narrow(1, r * (s // m), s // m)

    def run(inputs, split):
        st = tp.stream(cfg) if split else tp.WHOLE
        w = seq_block(wy) if split else wy

        def fn(h, **p):
            return lm._tf_block(cfg, p, h, positions, st)[0]
        return _objective(fn, inputs, w)

    return _compare(mesh, f"{tag}/seq_parallel_layer", run,
                    {"h": h, **{k: whole[k] for k in keys}},
                    lambda k, t: seq_block(t) if k == "h" else block_p(k, t),
                    seq_block)


# ---------------------------------------------------------------------------
# the Mamba2 mixer and Zamba2's group over "model"
# ---------------------------------------------------------------------------

MAMBA = "mamba2-780m-smoke"
SPLIT = {"ssm_split_proj": True}                       # opt level 7
LEVEL8 = {"ssm_split_proj": True, "seq_parallel": True}
REPLICATED = ("A_log", "D_skip", "dt_bias", "in_dt")
INDIVISIBLE = {"ssm_expand": 3, "ssm_headdim": 64}     # 6 heads


def ssm_pieces(shape) -> dict:
    """The Mamba2 pieces at mesh `shape` (1, 1, m), both projection
    layouts: the mixer (output and every gradient), the mixer from a
    state and its final state, the decode step on the rank's state
    blocks, a `seq_parallel` layer at seq 128 and its prefill state, and
    Zamba2's first group with the shared block; {piece: {what: err of
    max}}.  Also the replicated leaves after a sharded step (bit-equal
    on every "model" rank), the indivisible mixer at 4 ranks and, at 2,
    mamba2-smoke's split step in bf16."""
    torch.set_num_threads(1)
    mesh = make_train_mesh(tuple(shape), device="cpu")
    m = shape[-1]
    res = {}
    for tag, rep in (("", None), ("-split", SPLIT)):
        cfg = config(MAMBA, rep)
        res.update(_mixer(cfg, mesh, MAMBA + tag))
        res.update(_mixer_state(cfg, mesh, MAMBA + tag))
        res.update(_ssm_decode(cfg, mesh, MAMBA + tag))
        seq = config(MAMBA, {**(rep or {}), "seq_parallel": True})
        res.update(_seq_ssm_layer(seq, mesh, MAMBA + tag))
        res.update(_seq_ssm_state(seq, mesh, MAMBA + tag))
        res.update(_hybrid_group(config("zamba2-7b-smoke", rep), mesh,
                                 "zamba2-7b-smoke" + tag))
    out = {"rank": dist.get_rank(), "model_ranks": m, "errors": res,
           "replicated": {**_replicated(config(MAMBA, None), mesh, MAMBA),
                          **_replicated(config(MAMBA, SPLIT), mesh,
                                        MAMBA + "-split")}}
    if m == 4:
        out["indivisible"] = _indivisible(mesh)
    if m == 2:
        out["bf16"] = bf16_steps(mesh, MAMBA)
    return out


def ssm_card(shape) -> dict:
    """The mixer and its decode steps (`_mixer`, `_ssm_decode`) in both
    layouts on the card, cuda:0 shared by the group's members (a gloo
    group: NCCL refuses two ranks on one GPU), TF32 off."""
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    mesh = make_train_mesh(tuple(shape), device="cuda")
    res = {}
    for tag, rep in (("", None), ("-split", SPLIT)):
        cfg = config(MAMBA, rep)
        res.update(_mixer(cfg, mesh, MAMBA + tag, dev))
        res.update(_ssm_decode(cfg, mesh, MAMBA + tag, dev))
    return {"rank": dist.get_rank(), "errors": res}


def _mixer_inputs(whole: dict) -> list:
    return [k for k in whole if k != "ln1_w"]


def _on(dev, *trees):
    return [{k: v.to(dev) for k, v in t.items()} for t in trees]


def _mixer(cfg, mesh, tag, dev="cpu") -> dict:
    """`ssm_apply` on the rank's blocks: the output and the gradients of
    the input and of every leaf (the replicated ones summed over
    "model")."""
    rng = np.random.default_rng(SEED + 6)
    whole, mine = _on(dev, *_layer(cfg, mesh))
    x = _rng_tensor(rng, (2, 64, cfg.d_model)).to(dev)
    wy = _rng_tensor(rng, (2, 64, cfg.d_model)).to(dev)
    block_p = _param_block(cfg, mesh, whole, mine)

    def run(inputs, split):
        def fn(x, **p):
            return ssm.ssm_apply(cfg, p, x)
        return _objective(fn, inputs, wy)

    return _compare(mesh, f"{tag}/mixer", run,
                    {"x": x, **{k: whole[k] for k in _mixer_inputs(whole)}},
                    lambda k, t: t if k == "x" else block_p(k, t))


def _state_blocks(cfg, mesh):
    """(the rank's heads block of an SSM state (B, nh, hp, st), its
    uniform block of a conv tail (B, K-1, conv_dim)) as functions."""
    m = mesh_ctx.mesh_axis_sizes(mesh)["model"]
    r = mesh_ctx.mesh_coords(mesh)["model"]

    def cut(t, dim):
        n = t.shape[dim] // m
        return t.narrow(dim, r * n, n).contiguous()
    return (lambda h: cut(h, -3)), (lambda c: cut(c, -1))


def _state_inputs(cfg, rng, b: int):
    conv_dim = cfg.d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state
    h0 = _rng_tensor(rng, (b, cfg.ssm_nheads, cfg.ssm_headdim,
                           cfg.ssm_state)) * 0.1
    c0 = _rng_tensor(rng, (b, cfg.conv_kernel - 1, conv_dim))
    return h0, c0


def _mixer_state(cfg, mesh, tag) -> dict:
    """`ssm_apply` from a state (the rank's blocks of it) returning the
    final state: the output, the state (the rank's heads) and the conv
    tail (its uniform block of [x | B | C])."""
    rng = np.random.default_rng(SEED + 7)
    whole, mine = _layer(cfg, mesh)
    x = _rng_tensor(rng, (2, 64, cfg.d_model))
    h0, c0 = _state_inputs(cfg, rng, 2)
    heads, chans = _state_blocks(cfg, mesh)
    with torch.no_grad():
        y1, h1, c1 = ssm.ssm_apply(cfg, whole, x, h0, c0, True)
        with mesh_ctx.mesh_scope(mesh):
            y2, h2, c2 = ssm.ssm_apply(cfg, mine, x, heads(h0), chans(c0),
                                       True)
    return {f"{tag}/mixer_state": {"y": _err(y2, y1),
                                   "h": _err(h2, heads(h1)),
                                   "conv": _err(c2, chans(c1))}}


def _ssm_decode(cfg, mesh, tag, dev="cpu") -> dict:
    """Three `ssm_decode_step`s on the rank's state blocks: each step's
    output, and the final state and conv tail blocks."""
    rng = np.random.default_rng(SEED + 8)
    whole, mine = _on(dev, *_layer(cfg, mesh))
    h1, c1 = (t.to(dev) for t in _state_inputs(cfg, rng, 4))
    heads, chans = _state_blocks(cfg, mesh)
    h2, c2 = heads(h1), chans(c1)
    errs = {}
    with torch.no_grad():
        for i in range(3):
            x = _rng_tensor(rng, (4, 1, cfg.d_model)).to(dev)
            y1, h1, c1 = ssm.ssm_decode_step(cfg, whole, x, h1, c1)
            with mesh_ctx.mesh_scope(mesh):
                y2, h2, c2 = ssm.ssm_decode_step(cfg, mine, x, h2, c2)
            errs[f"y{i}"] = _err(y2, y1)
    errs.update(h=_err(h2, heads(h1)), conv=_err(c2, chans(c1)))
    return {f"{tag}/decode": errs}


SSM_SEQ = 128           # 4 chunks of 32: 2 a rank at 2 ranks, 1 at 4


def _seq_ssm_layer(cfg, mesh, tag) -> dict:
    """One Mamba2 layer under `seq_parallel` (the mixer whole, the stream
    the rank's sequence block: the conv's halo, the state passed between
    the ranks' blocks): its output block and the gradients of the stream
    block and of every leaf (summed over "model") against the whole
    layer."""
    rng = np.random.default_rng(SEED + 9)
    whole, mine = _layer(cfg, mesh)
    s = SSM_SEQ
    h = _rng_tensor(rng, (2, s, cfg.d_model))
    wy = _rng_tensor(rng, (2, s, cfg.d_model))
    m = mesh_ctx.mesh_axis_sizes(mesh)["model"]
    r = mesh_ctx.mesh_coords(mesh)["model"]

    def seq_block(t):
        return t.narrow(1, r * (s // m), s // m)

    def run(inputs, split):
        st = tp.stream(cfg) if split else tp.WHOLE
        w = seq_block(wy) if split else wy

        def fn(h, **p):
            return lm._ssm_layer(cfg, p, h, st)
        return _objective(fn, inputs, w)

    return _compare(mesh, f"{tag}/seq_parallel_layer", run,
                    {"h": h, **whole},
                    lambda k, t: seq_block(t) if k == "h" else t, seq_block)


def _seq_ssm_state(cfg, mesh, tag) -> dict:
    """A `seq_parallel` prefill layer (`lm._ssm_block`): the output block,
    and the last rank's final state and conv tail as every rank receives
    them (whole) against the whole prompt's."""
    rng = np.random.default_rng(SEED + 10)
    whole, _ = _layer(cfg, mesh)
    s = SSM_SEQ
    h = _rng_tensor(rng, (2, s, cfg.d_model))
    m = mesh_ctx.mesh_axis_sizes(mesh)["model"]
    r = mesh_ctx.mesh_coords(mesh)["model"]
    with torch.no_grad():
        y1, (h1, c1) = lm._ssm_block(cfg, whole, h)
        with mesh_ctx.mesh_scope(mesh):
            st = tp.stream(cfg, prefill=True)
            y2, (h2, c2) = lm._ssm_block(
                cfg, whole, h.narrow(1, r * (s // m), s // m), st)
    return {f"{tag}/seq_parallel_state": {
        "y": _err(y2, y1.narrow(1, r * (s // m), s // m)),
        "h": _err(h2, h1), "conv": _err(c2, c1)}}


def _hybrid_group(cfg, mesh, tag) -> dict:
    """Zamba2's first group (its Mamba2 layers, then the shared attention
    + MLP block) on the rank's blocks: the output and the gradients of
    the stream and of every leaf of the group and of the shared block."""
    rng = np.random.default_rng(SEED + 11)
    full = K.start_params(cfg)
    split = compute_form(cfg, mesh, full)
    whole = {**{"l/" + k: v[0] for k, v in full["layers"].items()},
             **{"s/" + k: v for k, v in full["shared"].items()}}
    mine = {**{"l/" + k: v[0] for k, v in split["layers"].items()},
            **{"s/" + k: v for k, v in split["shared"].items()}}
    s = 64
    h = _rng_tensor(rng, (2, s, cfg.d_model))
    wy = _rng_tensor(rng, (2, s, cfg.d_model))
    positions = torch.arange(s)[None, :]
    block_p = _param_block(cfg, mesh, whole, mine)

    def run(inputs, split_):
        st = tp.stream(cfg) if split_ else tp.WHOLE

        def fn(h, **kw):
            layers = {k[2:]: v for k, v in kw.items() if k[0] == "l"}
            shared = {k[2:]: v for k, v in kw.items() if k[0] == "s"}
            for lp in lm._unstack(layers):
                h = lm._ssm_layer(cfg, lp, h, st)
            return lm._shared_block(cfg, shared, h, positions, st)[0]
        return _objective(fn, inputs, wy)

    return _compare(mesh, f"{tag}/group", run, {"h": h, **whole},
                    lambda k, t: t if k == "h" else block_p(k, t))


def _replicated(cfg, mesh, tag) -> dict:
    """One sharded step of `cfg`: {tag/leaf: every "model" rank's block of
    each replicated per-head leaf equal to rank 0's, bit for bit}."""
    params = K.sharded_run(cfg, mesh, 1, 4)[0]
    out = {}
    for name in REPLICATED:
        if name not in params["layers"]:
            continue
        t = params["layers"][name].contiguous()
        every = all_gather_cat(t[None], mesh.get_group("model"), 0)
        bits = every.view(torch.int32)
        out[f"{tag}/{name}"] = bool(all(torch.equal(bits[0], b)
                                        for b in bits[1:]))
    return out


def _indivisible(mesh) -> dict:
    """mamba2-smoke with 6 heads at 4 "model" ranks: the mixer takes the
    whole path (`model_split`), its leaves stored split over "model" are
    named in `model_gathered`, and one sharded step matches world 1
    (loss, grad norm relative; parameters of max(max |want|, lr))."""
    cfg = config(MAMBA, INDIVISIBLE)
    params, _, (p_specs, _), metrics = K.sharded_run(cfg, mesh, 1, 4)
    got = gather_tree(params, p_specs, mesh)
    w1, want = _world1(cfg, K.start_params(cfg), 4, 1)
    errs = {"/".join(path): float((g - w).abs().max())
            / max(float(w.abs().max()), K.OC.lr)
            for (path, w), g in zip(leaves_with_paths(want), leaves(got))}
    sizes = mesh_ctx.mesh_axis_sizes(mesh)
    return {"ssm_split": tp.module_split(cfg, sizes)["ssm"],
            "vocab_split": tp.module_split(cfg, sizes)["vocab"],
            "model_gathered": tp.model_gathered(cfg, mesh),
            "metric_rel": [abs(a - b) / abs(b) for a, b in
                           zip(metrics[0], w1[0])],
            "param_worst": max(errs.values())}


# ---------------------------------------------------------------------------
# the sharded serve steps
# ---------------------------------------------------------------------------

SERVE_B, SERVE_PROMPT, SERVE_STEPS, SERVE_LEN = 4, 16, 4, 32


def serve_lengths(prompt: int | None,
                  steps: int = SERVE_STEPS) -> tuple[int, int]:
    """(prompt length, cache length) of a serve case: SERVE_PROMPT and
    SERVE_LEN, or a longer prompt (a `seq_parallel` prefill's, whose SSD
    chunks align with the ranks' blocks) and room for its steps."""
    if prompt is None:
        return SERVE_PROMPT, SERVE_LEN
    return prompt, prompt + steps


def cache_seq(cfg, length: int) -> int:
    """The serve steps' `seq` for a cache of `length` positions: the
    enc-dec family's cell holds `seq // 2` decoder positions and as many
    encoder frames (`registry.cache_schema`)."""
    return 2 * length if cfg.is_encdec else length


def serve_inputs(cfg, seed: int = SEED, prompt: int = SERVE_PROMPT,
                 frames: int = SERVE_LEN) -> dict:
    """The prompts (and a VLM's vision embeddings, or an enc-dec model's
    `frames` encoder frames) of the serve tests."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size,
                                    (SERVE_B, prompt)).astype(np.int32)}
    if cfg.n_vision_tokens:
        batch["vision_embeds"] = rng.standard_normal(
            (SERVE_B, cfg.n_vision_tokens, cfg.d_model), dtype=np.float32)
    if cfg.is_encdec:
        batch["enc_embeds"] = rng.standard_normal(
            (SERVE_B, frames, cfg.d_model), dtype=np.float32)
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def pad_seq(cache: dict, to: int) -> dict:
    """A prefill cache with its K/V padded with zeros along the sequence
    (dim 2) to `to` positions."""
    out = dict(cache)
    for k in ("k", "v"):
        pad = list(cache[k].shape)
        pad[2] = to - pad[2]
        out[k] = torch.cat([cache[k], cache[k].new_zeros(pad)], dim=2)
    return out


def serve(shape, cases, out_dir: str, steps: int = SERVE_STEPS) -> dict:
    """Each case (label, arch, replace[, prompt length]): the sharded
    prefill of `serve_inputs` into the blocks of a cache of
    `serve_lengths` positions and `steps` greedy decode steps on them
    at mesh `shape`.  Every rank's logits (its rows, the whole
    vocabulary) are gathered over the dp axes; rank 0 writes them and the
    tokens to `out_dir/<shape>-<label>.npz`, with a gated config's strap
    ids (`attention.recording_selections`: rank 0's rows, one (B, K)
    array a layer and step, the prefill's none).  Returns each case's
    `tensor_parallel.cache_split` and which cache leaves the rank holds
    as its blocks."""
    torch.set_num_threads(1)
    mesh = make_train_mesh(tuple(shape), device="cpu")
    rank = dist.get_rank()
    tag = "x".join(map(str, shape))
    groups = mesh_ctx.dp_groups(mesh)
    out = {"rank": rank}
    for label, arch, rep, *prompt in cases:
        cfg = config(arch, rep)
        prompt, length = serve_lengths(prompt[0] if prompt else None, steps)
        p_specs, _ = train_specs(cfg, mesh)
        params = tree_map(torch.clone, shard_tree(K.start_params(cfg),
                                                  p_specs, mesh))
        full = serve_inputs(cfg, prompt=prompt, frames=length)
        specs = batch_specs(full, mesh)
        inputs = {k: local_block(v, specs[k], mesh).contiguous()
                  for k, v in full.items()}
        s = prompt + cfg.n_vision_tokens
        seq = cache_seq(cfg, length)
        logits, cache = make_sharded_serve_prefill(
            cfg, mesh, SERVE_B, seq)(params, inputs)
        dec = make_sharded_serve_decode(cfg, mesh, SERVE_B, seq)
        token = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        all_logits, tokens = [logits], [token]
        with attention.recording_selections() as picks:
            for i in range(steps):
                pos = torch.full((token.shape[0],), s + i, dtype=torch.int32)
                token, logits, cache = dec(params, cache, token, pos)
                all_logits.append(logits)
                tokens.append(token)
        lg = torch.stack(all_logits)
        tk = torch.cat(tokens, dim=1)
        for g in groups:
            lg = _gather_rows(lg, g, 1)
            tk = _gather_rows(tk, g, 0)
        split = tp.cache_split(cfg, mesh, SERVE_B, seq)
        out[label] = {"split": list(split),
                      "blocks": sorted(k for k in cache
                                       if tp.holds_block(k, split))}
        if rank == 0:
            arrays = {"logits": lg.numpy(), "tokens": tk.numpy()}
            if picks:
                arrays["strap_ids"] = np.stack([i.numpy() for i, _ in picks])
            np.savez(Path(out_dir) / f"{tag}-{label}.npz", **arrays)
    return out


def several_serve(shapes, cases, out_dir: str,
                  steps: int = SERVE_STEPS) -> dict:
    """`serve` at each mesh shape in turn, in one group."""
    return {"x".join(map(str, sh)): serve(sh, cases, out_dir, steps)
            for sh in shapes}


def _gather_rows(t, group, dim):
    from repro_torch.distributed.collectives import all_gather_cat
    return all_gather_cat(t, group, dim)


# ---------------------------------------------------------------------------
# the encoder-decoder family over "model"
# ---------------------------------------------------------------------------

WHISPER = "whisper-tiny-smoke"
# six heads: at 4 ranks neither the query nor the KV heads split, and
# every rank attends every head (the path Whisper-tiny takes at 4 and 16)
WHISPER_H6 = {"n_heads": 6, "n_kv_heads": 6}
ENC_B, ENC_S, DEC_S = 2, 32, 64


def _flat(tree) -> dict:
    return {"/".join(path): x for path, x in leaves_with_paths(tree)}


def _nest(flat: dict) -> dict:
    out: dict = {}
    for key, x in flat.items():
        node = out
        *head, last = key.split("/")
        for part in head:
            node = node.setdefault(part, {})
        node[last] = x
    return out


def _tree_compare(cfg, mesh, name, fn, inputs: dict, wy) -> dict:
    """`_compare` of fn(params, **inputs) -> y over the whole parameter
    tree and `inputs` (their gradients too), the rank's form of the
    parameters (`compute_form`) under the mesh."""
    full = K.start_params(cfg)
    whole = _flat(full)
    mine = _flat(compute_form(cfg, mesh, full))
    block_p = _param_block(cfg, mesh, whole, mine)
    names = set(inputs)

    def run(args, split):
        def f(**kw):
            params = _nest({k: v for k, v in kw.items() if k not in names})
            return fn(params, **{k: kw[k] for k in names})
        return _objective(f, args, wy)

    return _compare(mesh, name, run, {**inputs, **whole},
                    lambda k, t: t if k in names else block_p(k, t))


def encdec_pieces(shape) -> dict:
    """Whisper on the rank's blocks at mesh `shape` (1, 1, m): `encode`,
    `decode_train` (from a given encoder output) and the loss, each's
    output and the rank's blocks of every gradient (the encoder output's
    and the frames' included) against the single-rank function, {piece:
    {what: err of max}}; and the FLOPs of one loss and backward,
    `_encdec_flops`, of whisper-tiny-smoke and, at 4 ranks, of its
    six-head variant."""
    torch.set_num_threads(1)
    mesh = make_train_mesh(tuple(shape), device="cpu")
    rng = np.random.default_rng(SEED + 12)
    cfg = config(WHISPER, None)
    frames = _rng_tensor(rng, (ENC_B, ENC_S, cfg.d_model))
    enc_out = _rng_tensor(rng, (ENC_B, ENC_S, cfg.d_model))
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (ENC_B, DEC_S)))
    batch = K.train_batch(cfg, ENC_B)
    res = {}
    res.update(_tree_compare(
        cfg, mesh, f"{WHISPER}/encode",
        lambda p, frames: encdec.encode(cfg, p, frames),
        {"frames": frames}, _rng_tensor(rng, (ENC_B, ENC_S, cfg.d_model))))
    res.update(_tree_compare(
        cfg, mesh, f"{WHISPER}/decode_train",
        lambda p, enc_out: encdec.decode_train(cfg, p, tokens, enc_out)[0],
        {"enc_out": enc_out}, _rng_tensor(rng, (ENC_B, DEC_S, cfg.d_model))))
    res.update(_tree_compare(
        cfg, mesh, f"{WHISPER}/loss",
        lambda p, frames: encdec.loss_fn(cfg, p, {**batch,
                                                  "enc_embeds": frames}),
        {"frames": batch["enc_embeds"]}, torch.ones(())))
    flops = {WHISPER: _encdec_flops(cfg, mesh, batch)}
    if shape[-1] == 4:
        h6 = config(WHISPER, WHISPER_H6)
        flops[WHISPER + "-h6"] = _encdec_flops(h6, mesh, batch)
    return {"rank": dist.get_rank(), "errors": res, "flops": flops}


def attention_flops(cfg, b: int, s_enc: int, s_dec: int) -> int:
    """The attention's own matmul FLOPs in one loss and backward of the
    enc-dec model: the scores q·kᵀ and w·v of every head, forward and
    their two backward products each, in the encoder's self-attention
    (S_enc x S_enc), the decoder's (S_dec x S_dec: every chunk against
    the whole K/V, the mask applied after) and the cross-attention
    (S_dec x S_enc)."""
    per = 3 * 2 * 2 * b * cfg.n_heads * cfg.head_dim_
    return per * (cfg.n_enc_layers * s_enc * s_enc
                  + cfg.n_layers * (s_dec * s_dec + s_dec * s_enc))


def _encdec_flops(cfg, mesh, batch) -> dict:
    """`FlopCounterMode`'s FLOPs of one loss and backward on the whole
    parameters (world 1) and on the rank's blocks under the mesh, and
    the attention's share (`attention_flops`)."""
    from torch.utils.flop_counter import FlopCounterMode

    full = K.start_params(cfg)

    def count(params):
        ps = leaves(params)
        for t in ps:
            t.requires_grad_(True)
        with FlopCounterMode(display=False) as fc:
            loss = encdec.loss_fn(cfg, params, batch)
            torch.autograd.grad(loss, ps)
        return float(fc.get_total_flops())

    world1 = count(tree_map(torch.clone, full))
    mine = tree_map(torch.clone, compute_form(cfg, mesh, full))
    with mesh_ctx.mesh_scope(mesh):
        rank = count(mine)
    b, s_dec = batch["tokens"].shape
    return {"world1": world1, "rank": rank,
            "attention": float(attention_flops(
                cfg, b, batch["enc_embeds"].shape[1], s_dec)),
            "heads_split": cfg.n_heads % mesh_ctx.mesh_axis_sizes(
                mesh)["model"] == 0}


# ---------------------------------------------------------------------------
# the split cross-attention and gated decode on the card
# ---------------------------------------------------------------------------

GATED = {"strap_decode": True, "decode_strap_tokens": 4,
         "decode_top_straps": 2}


def attn_card(shape, device: str = "cuda") -> dict:
    """On `device` (the card: cuda:0 shared by the group's members, a gloo
    group, TF32 off): Whisper's cross-attention on the rank's blocks
    (`_cross`) and the gated decode on the rank's cache blocks
    (`_gated`), each against the same function on one rank."""
    if device == "cuda":
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(device, 0) if device == "cuda" else torch.device(device)
    mesh = make_train_mesh(tuple(shape), device=device)
    res = {}
    res.update(_cross(config(WHISPER, None), mesh, dev))
    res.update(_gated(config("qwen2-1.5b-smoke", GATED), mesh, dev))
    return {"rank": dist.get_rank(), "errors": res}


def _cross(cfg, mesh, dev) -> dict:
    """Decoder layer 0's cross-attention: the prefill form on the rank's
    heads (output and every gradient, the encoder output's summed over
    "model"), and one decode step on the rank's block of the cross
    cache's positions."""
    rng = np.random.default_rng(SEED + 13)
    full = K.start_params(cfg)
    split = compute_form(cfg, mesh, full)
    keys = ("xwq", "xwk", "xwv", "xwo")
    whole, mine = _on(dev, *({k: t["dec_layers"][k][0] for k in keys}
                             for t in (full, split)))
    x = _rng_tensor(rng, (2, 16, cfg.d_model)).to(dev)
    enc = _rng_tensor(rng, (2, 32, cfg.d_model)).to(dev)
    wy = _rng_tensor(rng, (2, 16, cfg.d_model)).to(dev)
    block_p = _param_block(cfg, mesh, whole, mine)
    group = mesh.get_group("model")

    def run(inputs, split_):
        def fn(x, enc, **p):
            if split_:
                enc = tp.enter(enc, group, tp.stream(cfg))
            return attention.causal_attention(
                cfg, p, x, prefix="x", causal=False,
                kv_override=encdec._cross_kv(cfg, p, enc))[0]
        return _objective(fn, inputs, wy)

    out = _compare(mesh, f"{WHISPER}/cross", run,
                   {"x": x, "enc": enc, **whole},
                   lambda k, t: t if k in ("x", "enc") else block_p(k, t))
    hkv, hd = cfg.n_kv_heads, cfg.head_dim_
    xk = _rng_tensor(rng, (4, 32, hkv, hd)).to(dev)
    xv = _rng_tensor(rng, (4, 32, hkv, hd)).to(dev)
    xt = _rng_tensor(rng, (4, 1, cfg.d_model)).to(dev)
    pos = torch.full((4,), 20, dtype=torch.int32, device=dev)
    spec = (None, "model", None, None)
    with torch.no_grad():
        y1 = attention.decode_attention(cfg, whole, xt, xk, xv, pos,
                                        prefix="x", cross=True)[0]
        with mesh_ctx.mesh_scope(mesh):
            y2 = attention.decode_attention(
                cfg, mine, xt, local_block(xk, spec, mesh).contiguous(),
                local_block(xv, spec, mesh).contiguous(), pos, prefix="x",
                cross=True, split=tp.CacheSplit(("model",)))[0]
    out[f"{WHISPER}/cross_decode"] = {"y": _err(y2, y1)}
    return out


def _gated(cfg, mesh, dev) -> dict:
    """Three `decode_attention_gated` steps on the rank's blocks of the
    cache (its KV heads or its block of `head_dim`, as `cache_split`
    reads the spec): each step's output and strap picks, and the rank's
    blocks of the updated K / V / key sums, against the whole cache."""
    rng = np.random.default_rng(SEED + 14)
    full = K.start_params(cfg)
    keys = [k for k in ("wq", "wk", "wv", "wo", "bq", "bk", "bv")
            if k in full["layers"]]
    whole, mine = _on(dev, *({k: t["layers"][k][0] for k in keys}
                             for t in (full, compute_form(cfg, mesh, full))))
    b, s = 4, 32
    split = tp.cache_split(cfg, mesh, b, s)
    dim = {"kv": 2, "headdim": 3}[split.gated_dim]
    m = mesh_ctx.mesh_axis_sizes(mesh)["model"]
    r = mesh_ctx.mesh_coords(mesh)["model"]

    def blk(t):
        n = t.shape[dim] // m
        return t.narrow(dim, r * n, n).contiguous()

    shape = (b, s, cfg.n_kv_heads, cfg.head_dim_)
    k1, v1 = (_rng_tensor(rng, shape).to(dev) for _ in range(2))
    ks1 = lm.strap_key_sums(k1, cfg.decode_strap_tokens)
    k2, v2, ks2 = blk(k1), blk(v1), blk(ks1)
    pos = torch.tensor([16, 19, 22, 27], dtype=torch.int32, device=dev)
    errs = {}
    with torch.no_grad():
        for i in range(3):
            x = _rng_tensor(rng, (b, 1, cfg.d_model)).to(dev)
            with attention.recording_selections() as want:
                y1 = attention.decode_attention_gated(cfg, whole, x, k1, v1,
                                                      ks1, pos + i)[0]
            with mesh_ctx.mesh_scope(mesh), \
                    attention.recording_selections() as got:
                y2 = attention.decode_attention_gated(cfg, mine, x, k2, v2,
                                                      ks2, pos + i, split)[0]
            errs[f"y{i}"] = _err(y2, y1)
            errs[f"picks{i}"] = float(not torch.equal(
                torch.sort(got[0][0], -1).values,
                torch.sort(want[0][0], -1).values))
    errs.update(k=_err(k2, blk(k1)), v=_err(v2, blk(v1)),
                ksum=_err(ks2, blk(ks1)))
    return {f"qwen2-1.5b-smoke/gated_{split.gated_dim}": errs}
