"""The gated strap decode (`cfg.strap_decode`, opt level 3's decode
cells) on the "model" axis, on gloo groups: qwen2-1.5b-smoke and
olmo-1b-smoke (4 query and 2 KV heads, head_dim 32) with 4-token straps
and the top 2 kept, so that the selector drops straps: a cache of 32
positions (8 straps) after a 16-token prompt (4 valid straps, 6 by the
last of 8 decode steps).

The gated cache keeps the sequence whole on each rank and splits the
dim its spec puts on "model" (`tensor_parallel.cache_split`'s
`gated_dim`): at (1, 1, 2) the KV heads (each rank attends its heads,
the selector's scores summed over "model"), at (1, 1, 4) `head_dim`
(the scores and the logits partial dot products, summed).  The sharded
prefill writes `k` / `v` / `ksum` as the rank's blocks and the sharded
decode takes them as they are.  Held against the reference's `prefill`
/ `decode_step` at these settings (the reference's `ksum` built from its
padded keys, as its own test builds it) and the port's model functions
on one process: the same greedy tokens, the logits within 2e-5 of max
|logits|, and the same strap ids at every layer and step as the port's
single process (`attention.recording_selections`; the reference's
selection is not observable from outside its scan, and the port's
single-process gated step is held to it layer by layer in
`tests/test_torch_families.py`).  Where an id differs the failure
reports world 1's score gap between its k-th and (k+1)-th strap there.
"""

import concurrent.futures
import dataclasses
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_dist_children as K  # noqa: E402
import torch_tp_children as T  # noqa: E402
from repro.configs import registry as jreg  # noqa: E402
from repro.models import registry as JM  # noqa: E402
from repro_torch.distributed import tensor_parallel as tp  # noqa: E402
from repro_torch.distributed.sharding import cache_specs  # noqa: E402
from repro_torch.launch.group import run_group  # noqa: E402
from repro_torch.models import attention  # noqa: E402
from repro_torch.models import registry as M  # noqa: E402
from repro_torch.models.lm import strap_key_sums  # noqa: E402

TESTS = Path(__file__).resolve().parent
BAR = 2e-5
STEPS = 8
GATED = {"strap_decode": True, "decode_strap_tokens": 4,
         "decode_top_straps": 2}
CASES = [("qwen2-gated", "qwen2-1.5b-smoke", GATED),
         ("olmo-gated", "olmo-1b-smoke", GATED)]
# mesh: the dim the gated cache's spec puts on "model"
MESHES = {(1, 1, 2): "kv", (1, 1, 4): "headdim"}


def single_run(cfg, params):
    """The port's model functions on one process: (logits (steps + 1, B,
    V), tokens (B, steps + 1), strap ids (steps x layers, B, K), scores
    (steps x layers, B, n_straps))."""
    prompt, length = T.serve_lengths(None, STEPS)
    batch = T.serve_inputs(cfg, prompt=prompt)
    with torch.no_grad(), attention.recording_selections() as picks:
        logits, cache = M.prefill(cfg, params, batch)
        cache = T.pad_seq(cache, length)
        cache["ksum"] = strap_key_sums(cache["k"], cfg.decode_strap_tokens)
        token = torch.argmax(logits, -1).to(torch.int32)[:, None]
        lg, tk = [logits], [token]
        for i in range(STEPS):
            pos = torch.full((T.SERVE_B,), prompt + i, dtype=torch.int32)
            logits, cache = M.decode_step(cfg, params, cache, token, pos)
            token = torch.argmax(logits, -1).to(torch.int32)[:, None]
            lg.append(logits)
            tk.append(token)
    return (torch.stack(lg).numpy(), torch.cat(tk, 1).numpy(),
            np.stack([i.numpy() for i, _ in picks]),
            np.stack([s.numpy() for _, s in picks]))


def reference_run(arch, rep, params):
    """The reference's model functions at the same settings: (logits,
    tokens)."""
    jcfg = dataclasses.replace(jreg.get_arch(arch), **rep)
    jparams = jax.tree.map(lambda t: jnp.asarray(t.numpy()), params)
    prompt, length = T.serve_lengths(None, STEPS)
    cfg = T.config(arch, rep)
    batch = {k: jnp.asarray(v.numpy()) for k, v in
             T.serve_inputs(cfg, prompt=prompt).items()}
    logits, cache = JM.prefill(jcfg, jparams, batch)
    pad = [(0, 0), (0, 0), (0, length - prompt), (0, 0), (0, 0)]
    cache = {k: jnp.pad(v, pad) for k, v in cache.items()}
    strap = jcfg.decode_strap_tokens
    shape = (jcfg.n_layers, T.SERVE_B, length // strap, strap,
             jcfg.n_kv_heads, jcfg.head_dim_)
    cache["ksum"] = cache["k"].reshape(shape).astype(jnp.float32).sum(3)
    token = jnp.argmax(logits, -1).astype(jnp.int32)[:, None]
    lg, tk = [logits], [token]
    for i in range(STEPS):
        pos = jnp.full((T.SERVE_B,), prompt + i, jnp.int32)
        logits, cache = JM.decode_step(jcfg, jparams, cache, token, pos)
        token = jnp.argmax(logits, -1).astype(jnp.int32)[:, None]
        lg.append(logits)
        tk.append(token)
    return np.stack([np.asarray(x) for x in lg]), \
        np.concatenate([np.asarray(x) for x in tk], 1)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_gated")
    cases = [list(c) for c in CASES]
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        futures = {m: pool.submit(run_group, "torch_tp_children:serve",
                                  m[-1], dict(shape=list(m), cases=cases,
                                              out_dir=str(tmp), steps=STEPS),
                                  300, [TESTS]) for m in MESHES}
        single, ref = {}, {}
        for label, arch, rep in CASES:
            cfg = T.config(arch, rep)
            params = K.start_params(cfg)
            single[label] = single_run(cfg, params)
            ref[label] = reference_run(arch, rep, params)
        served = {m: f.result() for m, f in futures.items()}
    return tmp, served, single, ref


def _sharded(tmp, mesh, label):
    return np.load(tmp / f"{'x'.join(map(str, mesh))}-{label}.npz")


def _close(got, want_logits, want_tokens):
    gl, gt = got["logits"], got["tokens"]
    assert gl.shape == want_logits.shape and gt.shape == want_tokens.shape
    np.testing.assert_array_equal(gt, want_tokens)
    for step, (g, w) in enumerate(zip(gl, want_logits)):
        err = np.abs(g - w).max() / np.abs(w).max()
        assert err <= BAR, (step, err)


IDS = [f"{'x'.join(map(str, m))}-{c[0]}" for m in MESHES for c in CASES]
PAIRS = [(m, c) for m in MESHES for c in CASES]


@pytest.mark.parametrize("mesh,case", PAIRS, ids=IDS)
def test_sharded_gated_decode_matches_reference(run, mesh, case):
    tmp, _, _, ref = run
    _close(_sharded(tmp, mesh, case[0]), *ref[case[0]])


@pytest.mark.parametrize("mesh,case", PAIRS, ids=IDS)
def test_sharded_gated_decode_matches_single_process(run, mesh, case):
    tmp, _, single, _ = run
    _close(_sharded(tmp, mesh, case[0]), *single[case[0]][:2])


@pytest.mark.parametrize("mesh,case", PAIRS, ids=IDS)
def test_sharded_selector_picks_world1s_straps(run, mesh, case):
    """The same strap ids at every layer and step (sorted: the top-k's
    order among equal picks is not part of the result); where one
    differs, world 1's gap between its k-th and (k+1)-th score."""
    tmp, _, single, _ = run
    got = np.sort(_sharded(tmp, mesh, case[0])["strap_ids"], -1)
    _, _, ids, scores = single[case[0]]
    want = np.sort(ids, -1)
    assert got.shape == want.shape == (STEPS * 4, T.SERVE_B, 2)
    k = want.shape[-1]
    ranked = -np.sort(-scores, -1)
    differ = [(c, r, float(ranked[c, r, k - 1] - ranked[c, r, k]))
              for c, r in zip(*np.nonzero((got != want).any(-1)))]
    assert not differ, ("(call, row, world 1's score gap)", differ)
    # the selector dropped straps: fewer picked than valid at every step
    assert (ranked[..., k] > -np.inf).all()


@pytest.mark.parametrize("mesh", list(MESHES),
                         ids=lambda m: "x".join(map(str, m)))
def test_sharded_steps_keep_the_gated_blocks(run, mesh):
    """The serve steps keep `k`, `v` and `ksum` as the rank's blocks,
    the sequence whole, split as the rule reads the spec."""
    _, served, _, _ = run
    for res in served[mesh]:
        for label, _, _ in CASES:
            split = res[label]["split"]
            assert split[0] == [] and split[1] == T.SERVE_LEN
            assert split[3] == MESHES[mesh]
            assert res[label]["blocks"] == ["k", "ksum", "v"]


@pytest.mark.parametrize("m,want", [(2, "kv"), (4, "headdim"), (16, "headdim"),
                                    (64, None)])
@pytest.mark.parametrize("arch", ["qwen2-1.5b-smoke", "olmo-1b-smoke"])
def test_cache_split_reads_the_gated_dim_from_the_spec(arch, m, want):
    """`cache_split`'s `gated_dim` is the logical dim that `cache_specs`
    puts on "model" in `k`, `v` and `ksum` alike (2 KV heads and
    head_dim 32: the KV heads at 2 ranks, `head_dim` at 4 and 16, neither
    at 64, where the projections stay split and the cache whole)."""
    cfg = T.config(arch, GATED)
    mesh = SimpleNamespace(axis_names=("data", "model"),
                           devices=SimpleNamespace(shape=(1, m)))
    split = tp.cache_split(cfg, mesh, 8, 64)
    assert split.gated_dim == want and split.axes == ()
    axes = M.cache_axes(cfg, 8, 64)
    specs = cache_specs(cfg, axes, M.abstract_cache(cfg, 8, 64), mesh)
    for key in tp.GATED_KEYS:
        on = [a for e, a in zip(specs[key], axes[key]) if e == "model"]
        assert on == ([want] if want else []), (key, specs[key])
    assert tp.module_split(cfg, {"model": m})["attn"]
