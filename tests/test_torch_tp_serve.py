"""The sharded serve steps (`train.step.make_sharded_serve_prefill` /
`make_sharded_serve_decode`) on gloo groups at meshes (1, 1, 2), (1, 2,
2) and (1, 1, 4): a prefill of 4 x 16 prompts (Pixtral's 8 vision
tokens before them) and 4 greedy decode steps against `M.prefill` /
`M.decode_step` on one process and the reference's on the whole batch,
from the same weights (`tests/torch_tp_children.py:serve`).

Each rank holds its blocks of the parameters and computes on its
"model" blocks; the K/V cache's sequence splits over "model" (the
attention families and Zamba2's shared block: each rank attends its
positions and the softmax statistics are combined), and the SSM state
and conv tail are the rank's heads and channel block (mamba2-smoke in
the fused layout and the split layout of opt level 7, zamba2-smoke).
The prefill writes the blocks of a 32-position cache, which the decode
takes as they are.  mamba2-smoke at opt level 8 (`seq_parallel`)
prefills 4 x 128 prompts, each rank its sequence block (the SSD's 4
chunks of 32 over the "model" ranks; the last rank's state broadcast
and cut as the cache's blocks), then decodes with the mixer whole on the
gathered state.  Bars: the greedy tokens equal, the logits within 2e-5 of max
|logits| (float32 smoke configs).
"""

import concurrent.futures
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_dist_children as K  # noqa: E402
import torch_tp_children as T  # noqa: E402
from repro.configs import registry as jreg  # noqa: E402
from repro.models import registry as JM  # noqa: E402
from repro_torch.launch.group import run_group  # noqa: E402
from repro_torch.models import registry as M  # noqa: E402

TESTS = Path(__file__).resolve().parent
BAR = 2e-5
SHAPES = {2: [(1, 1, 2)], 4: [(1, 2, 2), (1, 1, 4)]}
# (label, arch, config replaced, prompt length (None: SERVE_PROMPT))
CASES = [("olmo", "olmo-1b-smoke", None, None),
         ("qwen2", "qwen2-1.5b-smoke", None, None),
         ("phi", "phi3.5-moe-42b-a6.6b-smoke", None, None),
         ("pixtral", "pixtral-12b-smoke", None, None),
         ("zamba2", "zamba2-7b-smoke", None, None),
         ("mamba2", "mamba2-780m-smoke", None, None),
         ("mamba2-level7", "mamba2-780m-smoke", {"ssm_split_proj": True},
          None),
         ("mamba2-level8", "mamba2-780m-smoke",
          {"ssm_split_proj": True, "seq_parallel": True}, 128)]
MESH_CASES = [(s, c) for shapes in SHAPES.values() for s in shapes
              for c in CASES]


def _single(cfg, prompt):
    """(logits (steps + 1, B, V), tokens (B, steps + 1)) of the port's
    model functions on one process."""
    params = K.start_params(cfg)
    prompt, length = T.serve_lengths(prompt)
    batch = T.serve_inputs(cfg, prompt=prompt)
    s = prompt + cfg.n_vision_tokens
    with torch.no_grad():
        logits, cache = M.prefill(cfg, params, batch)
        if "k" in cache:
            cache = T.pad_seq(cache, length)
        token = torch.argmax(logits, -1).to(torch.int32)[:, None]
        lg, tk = [logits], [token]
        for i in range(T.SERVE_STEPS):
            pos = torch.full((T.SERVE_B,), s + i, dtype=torch.int32)
            logits, cache = M.decode_step(cfg, params, cache, token, pos)
            token = torch.argmax(logits, -1).to(torch.int32)[:, None]
            lg.append(logits)
            tk.append(token)
    return torch.stack(lg).numpy(), torch.cat(tk, 1).numpy()


def _reference(arch, rep, cfg, prompt):
    """The same with the reference's model functions."""
    jcfg = dataclasses.replace(jreg.get_arch(arch), **(rep or {}))
    jparams = jax.tree.map(lambda t: jnp.asarray(t.numpy()),
                           K.start_params(cfg))
    prompt, length = T.serve_lengths(prompt)
    batch = {k: jnp.asarray(v.numpy()) for k, v in
             T.serve_inputs(cfg, prompt=prompt).items()}
    s = prompt + cfg.n_vision_tokens
    logits, cache = JM.prefill(jcfg, jparams, batch)
    pad = length - s
    cache = {k: (jnp.pad(v, [(0, 0), (0, 0), (0, pad)]
                         + [(0, 0)] * (v.ndim - 3)) if k in ("k", "v")
                 else v) for k, v in cache.items()}
    token = jnp.argmax(logits, -1).astype(jnp.int32)[:, None]
    lg, tk = [logits], [token]
    for i in range(T.SERVE_STEPS):
        pos = jnp.full((T.SERVE_B,), s + i, jnp.int32)
        logits, cache = JM.decode_step(jcfg, jparams, cache, token, pos)
        token = jnp.argmax(logits, -1).astype(jnp.int32)[:, None]
        lg.append(logits)
        tk.append(token)
    return np.stack([np.asarray(x) for x in lg]), \
        np.concatenate([np.asarray(x) for x in tk], 1)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_serve")
    cases = [list(c) for c in CASES]
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        futures = [pool.submit(run_group, "torch_tp_children:several_serve",
                               w, dict(shapes=shapes, cases=cases,
                                       out_dir=str(tmp)), 300, [TESTS])
                   for w, shapes in SHAPES.items()]
        single = {label: _single(T.config(arch, rep), prompt)
                  for label, arch, rep, prompt in CASES}
        ref = {label: _reference(arch, rep, T.config(arch, rep), prompt)
               for label, arch, rep, prompt in CASES}
        for f in futures:
            f.result()
    return tmp, single, ref


def _sharded(tmp, shape, label):
    d = np.load(tmp / f"{'x'.join(map(str, shape))}-{label}.npz")
    return d["logits"], d["tokens"]


def _close(got, want):
    (gl, gt), (wl, wt) = got, want
    assert gl.shape == wl.shape and gt.shape == wt.shape
    np.testing.assert_array_equal(gt, wt)
    for step, (g, w) in enumerate(zip(gl, wl)):
        err = np.abs(g - w).max() / np.abs(w).max()
        assert err <= BAR, (step, err)


@pytest.mark.parametrize("shape,case", MESH_CASES,
                         ids=[f"{'x'.join(map(str, s))}-{c[0]}"
                              for s, c in MESH_CASES])
def test_sharded_serve_matches_single_process(run, shape, case):
    tmp, single, _ = run
    _close(_sharded(tmp, shape, case[0]), single[case[0]])


@pytest.mark.parametrize("shape,case", MESH_CASES,
                         ids=[f"{'x'.join(map(str, s))}-{c[0]}"
                              for s, c in MESH_CASES])
def test_sharded_serve_matches_reference(run, shape, case):
    tmp, _, ref = run
    _close(_sharded(tmp, shape, case[0]), ref[case[0]])
