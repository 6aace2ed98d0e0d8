"""Shared by the sharded-train-step parity tests (test_torch_dist_train*.py):
spawn their gloo groups beside the reference's steps, and the bars.

The groups (`torch_dist_children.train_group` and friends) run in
threads of this process while it computes, in the meantime, each case's
two steps with the port's single-process `make_train_step` and with the
reference's `make_train_step` (jitted) on the whole batch, from the same
weights (`torch_dist_children.start_params`, carried to JAX as numpy) and
the same batch.

Bars, phase 24's and tests/test_torch_train_step.py's: loss and
grad_norm 2e-5 relative at each step; each parameter |sharded - want| <=
2e-5 * max(max|want|, lr) (2e-4 on the ssm and hybrid configs, the
reference's SSD bar); each float32 moment 2e-5 (2e-4) of the largest
moment of its tree; AdamW8bit's int8 moments within one step of the
other's, 99% of them equal.  Adam's eps is 1e-3 (see
tests/test_torch_train_step.py).

AdamW8bit (Arctic's optimizer) is held to these bars after ONE step, as
phase 24 holds it, and Arctic trains two steps under AdamW: a code
within rounding of a half step may round either way at step 1 (the
sharded gradients differ from the whole batch's in their last bits),
and at step 2 that moves the row's scale by up to one code in 127 and,
where a v code is 0 or 1, the parameter by up to lr (the reference's
m / eps step, ROADMAP queue 3).  Its sharded row max is held bit for bit
on its own (test_torch_dist_train_ckpt.py).
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

import torch_dist_children as K
from repro.configs import registry as jreg
from repro.launch.optlevels import apply_opt_level as japply_opt_level
from repro.train import step as jstep
from repro_torch.configs.registry import get_arch
from repro_torch.launch.group import run_group
from repro_torch.train.step import make_train_step
from repro_torch.tree import leaves_with_paths

TESTS = Path(__file__).resolve().parent
# the meshes of the 2- and 4-rank groups; at (1, 1, 2), (1, 2, 2) and
# (1, 1, 4) the "model" ranks compute on their blocks
SHAPES = {2: [(1, 2, 1), (1, 1, 2)], 4: [(2, 2, 1), (1, 2, 2), (1, 1, 4)]}


def case(arch: str, optimizer=None, microbatch=None, steps: int = 2,
         opt_level: int = 0):
    """(label, arch, optimizer (None: the config's), microbatch, global
    batch, steps, opt level (the train_4k cell's rewrites)): batch 4, or
    8 with microbatches (two rows a slice on the four-rank dp mesh)."""
    label = "-".join([arch] + ([optimizer] if optimizer else [])
                     + ([f"microbatch{microbatch}"] if microbatch else [])
                     + ([f"level{opt_level}"] if opt_level else []))
    return (label, arch, optimizer, microbatch, 8 if microbatch else 4,
            steps, opt_level)


def _flat(tree) -> dict:
    return {"/".join(p): np.asarray(x.detach().float().numpy()
                                    if isinstance(x, torch.Tensor)
                                    and x.dtype != torch.int8
                                    else x)
            for p, x in leaves_with_paths(tree)}


def single_steps(arch, optimizer, microbatch, b, steps, opt_level):
    """(metrics per step, {path: array}) of the port's single process."""
    cfg = K.case_config(arch, optimizer, opt_level)
    params = K.start_params(cfg)
    fn, opt = make_train_step(cfg, K.OC, microbatch)
    state = opt.init(params)
    batch = K.train_batch(cfg, b)
    metrics = []
    for _ in range(steps):
        params, state, m = fn(params, state, batch)
        metrics.append((m["loss"].item(), m["grad_norm"].item()))
    return metrics, _flat({"opt": state, "params": params})


def reference_steps(arch, optimizer, microbatch, b, steps, opt_level):
    """(metrics per step, {path: array}) of the reference's jitted step
    on the whole batch from the same weights, at the same opt level."""
    cfg = K.case_config(arch, optimizer, opt_level)
    jcfg = dataclasses.replace(
        japply_opt_level(jreg.get_arch(arch), "train_4k", opt_level),
        optimizer=cfg.optimizer)
    params = jax.tree.map(lambda t: jnp.asarray(t.numpy()),
                          K.start_params(cfg))
    fn, opt = jstep.make_train_step(jcfg, K.OC, microbatch)
    state = opt.init(params)
    batch = {k: jnp.asarray(v.numpy()) for k, v in
             K.train_batch(cfg, b).items()}
    step = jax.jit(fn)
    metrics = []
    for _ in range(steps):
        params, state, m = step(params, state, batch)
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    tree = jax.tree.map(np.asarray, {"opt": state, "params": params})
    return metrics, {"/".join(p): x for p, x in leaves_with_paths(tree)}


def launch(cases, out_dir: Path, extra4=()):
    """Run the 2- and 4-rank groups (every case on their meshes; `extra4`
    more (function, kwargs) calls in the 4-rank group) while computing
    the single-process and reference steps: (group results by world,
    {label: single}, {label: reference})."""
    calls = {w: [("train_group", dict(shapes=shapes, cases=cases,
                                      out_dir=str(out_dir)))]
             for w, shapes in SHAPES.items()}
    calls[4] += list(extra4)
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        futures = {w: pool.submit(run_group, "torch_dist_children:several",
                                  w, dict(calls=c), 300, [TESTS])
                   for w, c in calls.items()}
        single = {c[0]: single_steps(*c[1:]) for c in cases}
        ref = {c[0]: reference_steps(*c[1:]) for c in cases}
        groups = {w: f.result() for w, f in futures.items()}
    return groups, single, ref


def sharded(out_dir: Path, shape, label):
    d = np.load(out_dir / f"{'x'.join(map(str, shape))}-{label}.npz")
    metrics = list(zip(d["loss"], d["grad_norm"]))
    return metrics, {k: d[k] for k in d.files
                     if k not in ("loss", "grad_norm")}


def assert_close(case_, got, want):
    """The sharded run `got` of `case_` against `want` (single process or
    reference), both (metrics, {path: array})."""
    cfg = get_arch(case_[1])
    steps = case_[5]
    tol = 2e-4 if cfg.family in ("ssm", "hybrid") else 2e-5
    for (gl, gg), (wl, wg) in zip(got[0], want[0]):
        assert abs(gl - wl) <= 2e-5 * abs(wl), (gl, wl)
        assert abs(gg - wg) <= 2e-5 * abs(wg), (gg, wg)
    assert len(got[0]) == len(want[0]) == steps
    g, w = got[1], want[1]
    assert sorted(g) == sorted(w)
    assert int(g["opt/count"]) == int(w["opt/count"]) == steps
    scale = {m: max(float(np.abs(v).max()) for k, v in w.items()
                    if k.startswith(f"opt/{m}/") and not k.endswith("/q"))
             for m in ("m", "v")}
    for k, want_k in w.items():
        if k == "opt/count":
            continue
        got_k = g[k]
        assert got_k.shape == want_k.shape, k
        if k.endswith("/q"):
            diff = np.abs(got_k.astype(np.int32) - want_k.astype(np.int32))
            assert diff.max() <= 1 and diff.mean() <= 1e-2, k
            continue
        if k.startswith("params/"):
            floor = max(float(np.abs(want_k).max()), K.OC.lr)
        else:
            floor = scale[k.split("/")[1]]
        np.testing.assert_allclose(got_k, want_k.astype(np.float32), rtol=0,
                                   atol=tol * floor, err_msg=k)
