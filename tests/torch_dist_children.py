"""What the members of the spawned gloo groups of the distributed-training
tests run (`repro_torch.launch.group.run_group` imports this module in
each member; it imports neither JAX nor pytest).

Every function runs on the CPU in one member of the group, builds its
mesh with `launch.mesh.make_train_mesh`, writes its arrays to `out_dir`
(numpy files, read back by the test module) and returns a small JSON
summary.
"""

from __future__ import annotations

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
from repro_torch.models import moe
from repro_torch.models import registry as models
from repro_torch.train import optimizer as topt
from repro_torch.train.step import make_sharded_train_step, train_specs
from repro_torch.tree import leaves_with_paths, tree_map

OC = topt.OptConfig(lr=1e-3, eps=1e-3, warmup_steps=1, total_steps=10)
SEQ = 64


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


def train_batch(cfg, b: int, seed: int = 0) -> dict:
    """Tokens, next-token targets and the stub vision / encoder
    embeddings, from numpy's generator at `seed` (the tests' batch)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, SEQ + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    if cfg.n_vision_tokens:
        batch["vision_embeds"] = rng.standard_normal(
            (b, cfg.n_vision_tokens, cfg.d_model), dtype=np.float32)
    if cfg.is_encdec:
        batch["enc_embeds"] = rng.standard_normal(
            (b, SEQ // 2, cfg.d_model), dtype=np.float32)
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


def case_config(arch: str, optimizer: str | None):
    cfg = get_arch(arch)
    return dataclasses.replace(cfg, optimizer=optimizer) if optimizer \
        else cfg


def train_group(shapes, cases, out_dir: str) -> dict:
    """Every case (label, arch, optimizer or None for the config's,
    microbatch, batch, steps) on every mesh shape: rank 0 writes the
    gathered parameters and optimizer state after the sharded steps, and
    the losses and grad norms, to `out_dir/<shape>-<label>.npz`."""
    rank = _setup()
    out = {}
    for shape in shapes:
        mesh = make_train_mesh(tuple(shape), device="cpu")
        tag = "x".join(map(str, shape))
        for label, arch, optimizer, microbatch, b, steps in cases:
            cfg = case_config(arch, optimizer)
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

def _moe_inputs(weights: str, label: str, mesh):
    data = np.load(weights)
    pre = label + "/p/"
    p = {k[len(pre):]: torch.as_tensor(data[k]) for k in data.files
         if k.startswith(pre)}
    x = torch.as_tensor(data[label + "/x"])
    wy = torch.as_tensor(data[label + "/wy"])
    spec = ("data", None, None)
    return p, local_block(x, spec, mesh).clone(), local_block(wy, spec, mesh)


def moe_group(shape, cases, weights: str, out_dir: str) -> dict:
    """For each case (label, arch, capacity_factor): `moe_apply_ep` and
    the mesh-global `moe_apply` on this rank's batch shard of the
    weights and x in `weights`, their outputs, aux and the gradients of
    sum(y * wy) (+ aux / dp for `moe_apply`) with respect to x and every
    weight, written to `out_dir/<label>-rank<r>.npz`."""
    rank = _setup()
    mesh = make_train_mesh(tuple(shape), device="cpu")
    n_dp = mesh_ctx.dp_size(mesh)
    res = {"rank": rank, "coords": mesh_ctx.mesh_coords(mesh), "cases": {}}
    for label, arch, cf in cases:
        cfg = dataclasses.replace(get_arch(arch), capacity_factor=cf)
        arrays = {}
        info = {}
        for name, fn, aux_w in (("ep", moe.moe_apply_ep, 0.0),
                                ("global", moe.moe_apply, 1.0 / n_dp)):
            p, x, wy = _moe_inputs(weights, label, mesh)
            for t in (x, *p.values()):
                t.requires_grad_(True)
            before = C.counts["all_to_all"]
            with mesh_ctx.mesh_scope(mesh):
                y, aux = fn(cfg, p, x)
                obj = torch.sum(y * wy) + aux_w * aux
                names = ["x"] + sorted(p)
                grads = torch.autograd.grad(obj, [x] + [p[k] for k in
                                                        sorted(p)])
            info[name] = {"all_to_all": C.counts["all_to_all"] - before,
                          "aux": aux.item()}
            arrays[f"{name}/y"] = y.detach().numpy()
            for k, g in zip(names, grads):
                arrays[f"{name}/grad/{k}"] = g.numpy()
        _save(Path(out_dir) / f"{label}-rank{rank}.npz", arrays)
        res["cases"][label] = info
    return res
