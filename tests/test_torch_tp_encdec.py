"""The encoder-decoder family (Whisper) on the "model" axis, on gloo
groups at meshes (1, 1, 2) (query and KV heads split) and (1, 1, 4)
(the 4 query heads split, the 2 KV heads gathered):

- `encode`, `decode_train` (from a given encoder output) and the loss on
  the rank's blocks: the output and the rank's blocks of every gradient,
  the frames' and the encoder output's included (each rank projects the
  replicated encoder output with its columns of the cross K/V, so its
  gradient is summed over "model"), against the single-rank function at
  2e-5 of max, in float32 (`tests/torch_tp_children.py:encdec_pieces`);
- each rank's `FlopCounterMode` FLOPs of a loss and backward against
  world 1's: 1 / m of them where the heads split, and at 4 ranks for a
  six-head variant, whose heads do not split, a quarter of world 1's
  projection, MLP and head FLOPs plus all of its attention's (the scores
  and w . v, which every rank repeats);
- the sharded prefill of 4 x 16 prompts against 4 x 32 frames and 8
  greedy decode steps (`make_sharded_serve_prefill` / `_decode`, the
  self and cross caches of 32 positions split along the sequence over
  "model") against the reference's `prefill` / `decode_step` and the
  port's on one process, at `tests/test_torch_tp_serve.py`'s bars: the
  same tokens, the logits within 2e-5 of max |logits|.
The sharded train step of whisper-tiny-smoke at these meshes is held
against the reference's jitted step in `test_torch_dist_train_ckpt.py`.
"""

import concurrent.futures
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_dist_children as K  # noqa: E402
import torch_tp_children as T  # noqa: E402
from repro.configs import registry as jreg  # noqa: E402
from repro.models import registry as JM  # noqa: E402
from repro_torch.launch.group import run_group  # noqa: E402
from repro_torch.models import registry as M  # noqa: E402
from repro_torch.tree import leaves_with_paths  # noqa: E402

TESTS = Path(__file__).resolve().parent
BAR = 2e-5
STEPS = 8
MESHES = [(1, 1, 2), (1, 1, 4)]
# piece: (its input, the leaves whose gradients it must give)
PIECES = {"encode": ("frames", ("enc_layers/", "enc_final")),
          "decode_train": ("enc_out", ("dec_layers/", "embed", "final")),
          "loss": ("frames", ("",))}
CASE = ("whisper", T.WHISPER, None)


def serve_single(cfg, steps, params=None):
    """(logits (steps + 1, B, V), tokens (B, steps + 1)) of the port's
    model functions on one process: a cache of `serve_lengths` positions
    (the self K/V padded, the cross K/V as the encoder gave them)."""
    params = K.start_params(cfg) if params is None else params
    prompt, length = T.serve_lengths(None, steps)
    batch = T.serve_inputs(cfg, prompt=prompt, frames=length)
    with torch.no_grad():
        logits, cache = M.prefill(cfg, params, batch)
        cache = T.pad_seq(cache, length)
        token = torch.argmax(logits, -1).to(torch.int32)[:, None]
        lg, tk = [logits], [token]
        for i in range(steps):
            pos = torch.full((T.SERVE_B,), prompt + i, dtype=torch.int32)
            logits, cache = M.decode_step(cfg, params, cache, token, pos)
            token = torch.argmax(logits, -1).to(torch.int32)[:, None]
            lg.append(logits)
            tk.append(token)
    return torch.stack(lg).numpy(), torch.cat(tk, 1).numpy()


def serve_reference(arch, cfg, steps):
    """The same with the reference's model functions."""
    jcfg = jreg.get_arch(arch)
    jparams = jax.tree.map(lambda t: jnp.asarray(t.numpy()),
                           K.start_params(cfg))
    prompt, length = T.serve_lengths(None, steps)
    batch = {k: jnp.asarray(v.numpy()) for k, v in
             T.serve_inputs(cfg, prompt=prompt, frames=length).items()}
    logits, cache = JM.prefill(jcfg, jparams, batch)
    pad = [(0, 0), (0, 0), (0, length - prompt), (0, 0), (0, 0)]
    cache = {k: jnp.pad(v, pad) if k in ("k", "v") else v
             for k, v in cache.items()}
    token = jnp.argmax(logits, -1).astype(jnp.int32)[:, None]
    lg, tk = [logits], [token]
    for i in range(steps):
        pos = jnp.full((T.SERVE_B,), prompt + i, jnp.int32)
        logits, cache = JM.decode_step(jcfg, jparams, cache, token, pos)
        token = jnp.argmax(logits, -1).astype(jnp.int32)[:, None]
        lg.append(logits)
        tk.append(token)
    return np.stack([np.asarray(x) for x in lg]), \
        np.concatenate([np.asarray(x) for x in tk], 1)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_encdec")
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        pieces = {m: pool.submit(run_group, "torch_tp_children:encdec_pieces",
                                 m[-1], dict(shape=list(m)), 300, [TESTS])
                  for m in MESHES}
        serves = [pool.submit(run_group, "torch_tp_children:serve", m[-1],
                              dict(shape=list(m), cases=[list(CASE)],
                                   out_dir=str(tmp), steps=STEPS), 300,
                              [TESTS]) for m in MESHES]
        cfg = T.config(T.WHISPER, None)
        single = serve_single(cfg, STEPS)
        ref = serve_reference(T.WHISPER, cfg, STEPS)
        groups = {m: f.result() for m, f in pieces.items()}
        served = [f.result() for f in serves]
    return tmp, groups, served, single, ref


@pytest.mark.parametrize("piece", sorted(PIECES))
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m)))
def test_split_piece_matches_one_rank(run, mesh, piece):
    _, groups, _, _, _ = run
    given, prefixes = PIECES[piece]
    paths = ["/".join(p) for p, _ in
             leaves_with_paths(K.start_params(T.config(T.WHISPER, None)))]
    want = {"grad/" + given} | {"grad/" + p for p in paths
                                if p.startswith(prefixes)}
    for res in groups[mesh]:
        errs = res["errors"][f"{T.WHISPER}/{piece}"]
        assert errs["y"] <= BAR, (res["rank"], errs)
        assert want <= set(errs), sorted(want - set(errs))
        bad = {k: v for k, v in errs.items() if v > BAR}
        assert not bad, (res["rank"], bad)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m)))
def test_rank_flops_follow_the_block_shapes(run, mesh):
    """1 / m of world 1's FLOPs where the heads split; else 1 / m of its
    projections, MLP and head, plus its whole attention."""
    _, groups, _, _, _ = run
    m = mesh[-1]
    for res in groups[mesh]:
        for name, f in res["flops"].items():
            w, a = f["world1"], f["attention"]
            want = w / m if f["heads_split"] else (w - a) / m + a
            assert f["rank"] == want > 0, (name, res["rank"], f)
        if m == 4:
            assert not res["flops"][T.WHISPER + "-h6"]["heads_split"]


def _served(tmp, mesh):
    d = np.load(tmp / f"{'x'.join(map(str, mesh))}-{CASE[0]}.npz")
    return d["logits"], d["tokens"]


def _close(got, want):
    (gl, gt), (wl, wt) = got, want
    assert gl.shape == wl.shape and gt.shape == wt.shape
    np.testing.assert_array_equal(gt, wt)
    for step, (g, w) in enumerate(zip(gl, wl)):
        err = np.abs(g - w).max() / np.abs(w).max()
        assert err <= BAR, (step, err)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m)))
def test_sharded_serve_matches_reference(run, mesh):
    tmp, _, _, _, ref = run
    _close(_served(tmp, mesh), ref)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m)))
def test_sharded_serve_matches_single_process(run, mesh):
    tmp, _, _, single, _ = run
    _close(_served(tmp, mesh), single)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m)))
def test_self_and_cross_caches_stay_sequence_blocks(run, mesh):
    """The cache splits along the sequence over "model", and the serve
    steps keep every K/V leaf, the cross cache's too, as the rank's
    block (nothing is gathered whole)."""
    _, _, served, _, _ = run
    for res in served[MESHES.index(mesh)]:
        split = res[CASE[0]]["split"]
        assert split[0] == ["model"] and split[1] == T.SERVE_LEN
        assert res[CASE[0]]["blocks"] == ["k", "v", "xk", "xv"]


def test_whisper_full_width_splits_every_leaf():
    """Whisper-tiny at 2, 4 and 16 "model" ranks: every leaf computed on
    its block (`model_gathered` empty), the cross-attention's included."""
    from types import SimpleNamespace as N

    from repro_torch.configs.registry import get_arch
    from repro_torch.distributed import tensor_parallel as tp

    cfg = get_arch("whisper-tiny")
    for m in (2, 4, 16):
        mesh = N(axis_names=("data", "model"), devices=N(shape=(1, m)))
        assert tp.model_gathered(cfg, mesh) == []
        split = tp.model_split(cfg, mesh)
        assert all(split["dec_layers"][k] for k in ("xwq", "xwk", "xwv",
                                                     "xwo"))
