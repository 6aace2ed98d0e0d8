"""What the members of the spawned gloo groups of the distributed-training
tests run (`repro_torch.launch.group.run_group` imports this module in
each member; it imports neither JAX nor pytest).

Every function runs on the CPU in one member of the group, builds its
mesh with `launch.mesh.make_train_mesh`, writes its arrays to `out_dir`
(numpy files, read back by the test module) and returns a small JSON
summary.
"""

from __future__ import annotations

import contextlib
import dataclasses
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.ckpt.manager import CheckpointManager
from repro_torch.configs.registry import get_arch
from repro_torch.distributed import collectives as C
from repro_torch.distributed import context as mesh_ctx
from repro_torch.distributed.sharding import (batch_specs, gather_tree,
                                              local_block, shard_tree)
from repro_torch.launch.mesh import make_train_mesh
from repro_torch.launch.optlevels import apply_opt_level
from repro_torch.models import moe
from repro_torch.models import registry as models
from repro_torch.train import optimizer as topt
from repro_torch.train.step import make_sharded_train_step, train_specs
from repro_torch.tree import leaves_with_paths, tree_map

OC = topt.OptConfig(lr=1e-3, eps=1e-3, warmup_steps=1, total_steps=10)
SEQ = 64
# under the ssm family's seq_parallel (opt level 8) the whole sequence's SSD
# chunks must align with the "model" ranks' blocks: 4 chunks of 32
SSM_SEQ_PARALLEL = 128


def _setup():
    torch.set_num_threads(1)
    return dist.get_rank()


def _save(path: Path, arrays: dict) -> None:
    np.savez(path, **{k: v for k, v in arrays.items()})


def _host(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def batch_seq(cfg) -> int:
    """The tests' sequence: SEQ, or SSM_SEQ_PARALLEL under the ssm
    family's `seq_parallel`."""
    if cfg.seq_parallel and cfg.family == "ssm":
        return SSM_SEQ_PARALLEL
    return SEQ


def train_batch(cfg, b: int, seed: int = 0) -> dict:
    """Tokens, next-token targets and the stub vision / encoder
    embeddings, from numpy's generator at `seed` (the tests' batch)."""
    rng = np.random.default_rng(seed)
    seq = batch_seq(cfg)
    toks = rng.integers(0, cfg.vocab_size, (b, seq + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    if cfg.n_vision_tokens:
        batch["vision_embeds"] = rng.standard_normal(
            (b, cfg.n_vision_tokens, cfg.d_model), dtype=np.float32)
    if cfg.is_encdec:
        batch["enc_embeds"] = rng.standard_normal(
            (b, seq // 2, cfg.d_model), dtype=np.float32)
    return {k: torch.as_tensor(np.ascontiguousarray(v))
            for k, v in batch.items()}


def start_params(cfg) -> dict:
    return models.init_params(cfg, torch.Generator().manual_seed(0), "cpu")


def _tree_arrays(prefix: str, tree) -> dict:
    return {prefix + "/".join(path): _host(x)
            for path, x in leaves_with_paths(tree)}


def sharded_run(cfg, mesh, steps: int, b: int, microbatch=None):
    """`steps` sharded steps of `cfg` from `start_params` on the batch of
    `train_batch(cfg, b)`: (local params, local state, specs, metrics)."""
    p_specs, o_specs = train_specs(cfg, mesh)
    params = tree_map(torch.clone, shard_tree(start_params(cfg), p_specs,
                                              mesh))
    fn, opt = make_sharded_train_step(cfg, mesh, OC, microbatch)
    state = opt.init(params)
    full = train_batch(cfg, b)
    specs = batch_specs(full, mesh)
    batch = {k: local_block(v, specs[k], mesh).contiguous()
             for k, v in full.items()}
    metrics = []
    for _ in range(steps):
        params, state, m = fn(params, state, batch)
        metrics.append((m["loss"].item(), m["grad_norm"].item()))
    return params, state, (p_specs, o_specs), metrics


def case_config(arch: str, optimizer: str | None, opt_level: int = 0):
    """`arch` with `optimizer` (None: the config's) at `opt_level` (the
    train_4k cell's rewrites, `launch.optlevels`)."""
    cfg = apply_opt_level(get_arch(arch), "train_4k", opt_level)
    return dataclasses.replace(cfg, optimizer=optimizer) if optimizer \
        else cfg


def train_group(shapes, cases, out_dir: str) -> dict:
    """Every case (label, arch, optimizer or None for the config's,
    microbatch, batch, steps, opt level) on every mesh shape: rank 0
    writes the gathered parameters and optimizer state after the sharded
    steps, and the losses and grad norms, to
    `out_dir/<shape>-<label>.npz`."""
    rank = _setup()
    out = {}
    for shape in shapes:
        mesh = make_train_mesh(tuple(shape), device="cpu")
        tag = "x".join(map(str, shape))
        for label, arch, optimizer, microbatch, b, steps, level in cases:
            cfg = case_config(arch, optimizer, level)
            params, state, (p_specs, o_specs), metrics = sharded_run(
                cfg, mesh, steps, b, microbatch)
            fp = gather_tree(params, p_specs, mesh)
            fo = gather_tree(state, o_specs, mesh)
            if rank == 0:
                arrays = {**_tree_arrays("params/", fp),
                          **_tree_arrays("opt/", fo),
                          "loss": np.array([m[0] for m in metrics]),
                          "grad_norm": np.array([m[1] for m in metrics])}
                _save(Path(out_dir) / f"{tag}-{label}.npz", arrays)
            out[f"{tag}/{label}"] = metrics
    return {"rank": rank, "metrics": out}


def q8_group(shape) -> dict:
    """AdamW8bit's `_q8` of a row split over mesh axes, with the row max
    reduced over their groups, against the block of `_q8` of the whole
    tensor: {spec: (q equal bit for bit, s equal bit for bit)}."""
    rank = _setup()
    mesh = make_train_mesh(tuple(shape), device="cpu")
    x = torch.as_tensor(np.random.default_rng(7).standard_normal(
        (6, 16), dtype=np.float32))
    x[2, 5] = 40.0                  # a row whose max sits in one block
    q_full, s_full = topt._q8(x)
    out = {}
    for spec in ((None, "data"), (None, "model"), ("data", "model"),
                 (None, ("data", "model"))):
        groups = tuple(mesh.get_group(a) for a in
                       ((spec[1],) if isinstance(spec[1], str) else spec[1]))
        q, s = topt._q8(local_block(x, spec, mesh), groups)
        q_want = local_block(q_full, spec, mesh)
        s_want = local_block(s_full, (spec[0], None), mesh)
        out[repr(spec)] = [bool(torch.equal(q, q_want)),
                           bool(torch.equal(s.view(torch.int32),
                                            s_want.view(torch.int32)))]
    return {"rank": rank, "q8": out}


def ckpt_group(shape_a, shape_b, arch: str, ckpt_dir: str,
               out_dir: str) -> dict:
    """Two sharded steps of `arch` on mesh A, its state saved sharded;
    restored on mesh B (every rank its blocks under B's specs) and on one
    process (mesh=None): each gathered tree against A's, bit for bit.
    Rank 0 writes A's gathered tree to `out_dir/ckpt-a.npz`."""
    rank = _setup()
    cfg = get_arch(arch)
    mesh_a = make_train_mesh(tuple(shape_a), device="cpu")
    params, state, (p_specs, o_specs), _ = sharded_run(cfg, mesh_a, 2, 4)
    tree = {"opt": state, "params": params}
    specs_a = {"opt": o_specs, "params": p_specs}
    mgr = CheckpointManager(ckpt_dir)
    mgr.save(2, tree, mesh=mesh_a, specs=specs_a)
    want = gather_tree(tree, specs_a, mesh_a)
    shapes_a = [list(x.shape) for _, x in leaves_with_paths(tree)]

    def bits(t):
        return t.view(torch.int32) if t.dtype == torch.float32 else t

    def same(a, b):
        return all(torch.equal(bits(x), bits(y)) for (_, x), (_, y) in
                   zip(leaves_with_paths(a), leaves_with_paths(b)))

    mesh_b = make_train_mesh(tuple(shape_b), device="cpu")
    pb, ob = train_specs(cfg, mesh_b)
    specs_b = {"opt": ob, "params": pb}
    got, step = mgr.restore(2, like=want, device="cpu", mesh=mesh_b,
                            specs=specs_b)
    shapes_b = [list(x.shape) for _, x in leaves_with_paths(got)]
    restored_b = same(gather_tree(got, specs_b, mesh_b), want)
    whole, _ = mgr.restore(2, like=want, device="cpu")
    if rank == 0:
        _save(Path(out_dir) / "ckpt-a.npz", _tree_arrays("", want))
    return {"rank": rank, "step": step, "restored_on_b": restored_b,
            "restored_whole": same(whole, want),
            "local_shapes_a": shapes_a, "local_shapes_b": shapes_b}


def several(calls) -> dict:
    """[(function name, kwargs)] of this module, called in turn in the
    same group: {name: result}."""
    return {name: globals()[name](**kwargs) for name, kwargs in calls}


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def grads_of_rank(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"w": torch.as_tensor(rng.normal(size=(16, 8)).astype(np.float32)),
            "b": torch.as_tensor(rng.normal(size=(5,)).astype(np.float32))}


def collectives_group(shape, out_dir: str) -> dict:
    """`hierarchical_psum_tree` in exact and int8 mode on the reference's
    replicated gradients (seed 0 on every rank) and on distinct ones
    (seed 100 + rank); every output and error written to
    `out_dir/rank<r>.npz`; `collective_matrix` returned."""
    rank = _setup()
    mesh = make_train_mesh(tuple(shape), device="cpu")
    arrays = {}
    for label, seed in (("same", 0), ("distinct", 100 + rank)):
        for mode, compress in (("exact", False), ("int8", True)):
            out, err = C.hierarchical_psum_tree(grads_of_rank(seed), mesh,
                                                compress=compress)
            for k in out:
                arrays[f"{label}/{mode}/out/{k}"] = out[k].numpy()
                arrays[f"{label}/{mode}/err/{k}"] = err[k].numpy()
    _save(Path(out_dir) / f"rank{rank}.npz", arrays)
    return {"rank": rank, "coords": mesh_ctx.mesh_coords(mesh),
            "matrix": C.collective_matrix(mesh)}


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

# the rank's "model" block of each MoE leaf, as the sharded steps give it
BLOCK_SPECS = {"we_gate": ("model", None, None), "we_up": ("model", None, None),
               "we_down": ("model", None, None), "res_w_gate": (None, "model"),
               "res_w_up": (None, "model"), "res_w_down": ("model", None)}


def _moe_inputs(weights: str, label: str, mesh, blocks: bool = False):
    """The weights (the rank's "model" blocks of `we_*` / `res_w_*` with
    `blocks`), this rank's batch shard of x and of the output weights."""
    data = np.load(weights)
    pre = label + "/p/"
    p = {k[len(pre):]: torch.as_tensor(data[k]) for k in data.files
         if k.startswith(pre)}
    if blocks:
        p = {k: local_block(v, BLOCK_SPECS[k], mesh).clone()
             if k in BLOCK_SPECS else v for k, v in p.items()}
    x = torch.as_tensor(data[label + "/x"])
    wy = torch.as_tensor(data[label + "/wy"])
    spec = ("data", None, None)
    return p, local_block(x, spec, mesh).clone(), local_block(wy, spec, mesh)


MOE_RUNS = (("ep", "moe_apply_ep", False), ("global", "moe_apply", False),
            ("ep_block", "moe_apply_ep", True),
            ("global_block", "moe_apply", True))


def moe_group(shape, cases, weights: str, out_dir: str) -> dict:
    """For each case (label, arch, capacity_factor): `moe_apply_ep` and
    the mesh-global `moe_apply` on this rank's batch shard of the
    weights and x in `weights`, given every weight whole and given the
    rank's "model" blocks of the expert and residual weights
    (`MOE_RUNS`); their outputs, aux, the gradients of sum(y * wy)
    (+ aux / dp for `moe_apply`) with respect to x and every weight
    (block), written to `out_dir/<label>-rank<r>.npz`, and the
    all-to-alls and all-gathers each made."""
    rank = _setup()
    mesh = make_train_mesh(tuple(shape), device="cpu")
    n_dp = mesh_ctx.dp_size(mesh)
    res = {"rank": rank, "coords": mesh_ctx.mesh_coords(mesh), "cases": {}}
    for label, arch, cf in cases:
        cfg = dataclasses.replace(get_arch(arch), capacity_factor=cf)
        arrays = {}
        info = {}
        for name, fn, blocks in MOE_RUNS:
            aux_w = 1.0 / n_dp if fn == "moe_apply" else 0.0
            p, x, wy = _moe_inputs(weights, label, mesh, blocks)
            for t in (x, *p.values()):
                t.requires_grad_(True)
            before = dict(C.counts)
            with mesh_ctx.mesh_scope(mesh):
                y, aux = getattr(moe, fn)(cfg, p, x)
                obj = torch.sum(y * wy) + aux_w * aux
                names = ["x"] + sorted(p)
                grads = torch.autograd.grad(obj, [x] + [p[k] for k in
                                                        sorted(p)])
            info[name] = {**{k: C.counts[k] - before[k] for k in before},
                          "aux": aux.item()}
            arrays[f"{name}/y"] = y.detach().numpy()
            for k, g in zip(names, grads):
                arrays[f"{name}/grad/{k}"] = g.numpy()
        _save(Path(out_dir) / f"{label}-rank{rank}.npz", arrays)
        res["cases"][label] = info
    return res


def _dropped_pairs(cfg, p, x, mesh) -> int:
    """Pairs beyond the global capacity: the rank's per-expert pair
    counts summed over the dp ranks, against `_capacity` of the global
    token count."""
    xf = x.reshape(-1, x.shape[-1])
    _, _, idx = moe._route(cfg, p, xf)
    counts = torch.bincount(idx.reshape(-1), minlength=cfg.n_experts)
    for g in mesh_ctx.dp_groups(mesh):
        counts = C.all_reduce(counts, g)
    cap = moe._capacity(cfg, xf.shape[0] * mesh_ctx.dp_size(mesh))
    return int((counts - cap).clamp(min=0).sum())


@contextlib.contextmanager
def kept_pairs():
    """The pairs the mesh-global `moe_apply` keeps, counted where it
    places them: [the entries of each `moe._global_slots` call's slot
    below its sentinel] over the calls made inside."""
    rule = moe._global_slots
    kept = []

    def counting(se, counts, every, i, cap, c, e0, el):
        slot, zero = rule(se, counts, every, i, cap, c, e0, el)
        kept.append(int((slot < every.shape[0] * el * c).sum()))
        return slot, zero

    moe._global_slots = counting
    try:
        yield kept
    finally:
        moe._global_slots = rule


def moe_routing_group(shapes, cases, weights: str, out_dir: str) -> dict:
    """The mesh-global `moe_apply` on every mesh shape, for each case
    (label, arch, capacity_factor): this rank's batch shard (dim 0 over
    the dp axes, pod-major) of x, every weight whole; its rows and the
    gradients of sum(y * wy) + aux / dp with respect to x and every
    weight, written to `out_dir/<shape>-<label>-rank<r>.npz`; its aux,
    dp index, the pairs dropped over the whole batch, the pairs the
    rank's slot table kept (`kept_pairs`) and the all-to-alls made,
    returned."""
    rank = _setup()
    out = {"rank": rank, "runs": {}}
    for shape in shapes:
        mesh = make_train_mesh(tuple(shape), device="cpu")
        tag = "x".join(map(str, shape))
        n_dp = mesh_ctx.dp_size(mesh)
        for label, arch, cf in cases:
            cfg = dataclasses.replace(get_arch(arch), capacity_factor=cf)
            data = np.load(weights)
            pre = label + "/p/"
            p = {k[len(pre):]: torch.as_tensor(data[k]) for k in data.files
                 if k.startswith(pre)}
            full = {"x": torch.as_tensor(data[label + "/x"]),
                    "wy": torch.as_tensor(data[label + "/wy"])}
            specs = batch_specs(full, mesh)
            x, wy = (local_block(full[k], specs[k], mesh).clone()
                     for k in ("x", "wy"))
            for t in (x, *p.values()):
                t.requires_grad_(True)
            before = C.counts["all_to_all"]
            with mesh_ctx.mesh_scope(mesh), kept_pairs() as kept:
                y, aux = moe.moe_apply(cfg, p, x)
                obj = torch.sum(y * wy) + aux / n_dp
                grads = torch.autograd.grad(obj, [x] + [p[k] for k in
                                                        sorted(p)])
            arrays = {"y": y.detach().numpy()}
            for k, g in zip(["x"] + sorted(p), grads):
                arrays[f"grad/{k}"] = g.numpy()
            _save(Path(out_dir) / f"{tag}-{label}-rank{rank}.npz", arrays)
            out["runs"][f"{tag}/{label}"] = {
                "aux": aux.item(), "dp_index": mesh_ctx.dp_index(mesh),
                "dropped": _dropped_pairs(cfg, p, x.detach(), mesh),
                "kept": kept, "all_to_all": C.counts["all_to_all"] - before}
    return out


def tp_moe_group(shape, cases, steps: int, b: int, out_dir: str) -> dict:
    """Each case (label, arch, opt level) on the mesh `shape`: `steps`
    sharded steps from `start_params` on `train_batch(cfg, b)`, twice:
    "blocks", the placement `tensor_parallel.model_split` gives (the
    rank's "model" blocks of `we_*` and `res_w_*`), and "whole", with
    `tensor_parallel.module_split` patched to gather those leaves whole
    (the placement before the expert blocks).  Rank 0 writes each run's
    gathered parameters and its losses and grad norms to
    `out_dir/<shape>-<label>-<placement>.npz`; every rank returns its
    `model_gathered` of each run."""
    from repro_torch.distributed import tensor_parallel as tp

    rank = _setup()
    mesh = make_train_mesh(tuple(shape), device="cpu")
    tag = "x".join(map(str, shape))
    rule = tp.module_split

    def whole_experts(cfg, sizes):
        return {**rule(cfg, sizes), "experts": False, "res": False}

    out = {"rank": rank, "model_gathered": {}}
    for label, arch, level in cases:
        cfg = case_config(arch, None, level)
        for placement in ("blocks", "whole"):
            tp.module_split = rule if placement == "blocks" \
                else whole_experts
            try:
                params, _, (p_specs, _), metrics = sharded_run(
                    cfg, mesh, steps, b)
                fp = gather_tree(params, p_specs, mesh)
                gathered = tp.model_gathered(cfg, mesh)
            finally:
                tp.module_split = rule
            if rank == 0:
                _save(Path(out_dir) / f"{tag}-{label}-{placement}.npz",
                      {**_tree_arrays("params/", fp),
                       "loss": np.array([m[0] for m in metrics]),
                       "grad_norm": np.array([m[1] for m in metrics])})
            out["model_gathered"][f"{label}/{placement}"] = gathered
    return out
