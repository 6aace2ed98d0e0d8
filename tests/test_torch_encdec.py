"""The port's enc-dec backbone (`models/encdec.py`, Whisper) and the
cross-attention of `models/attention.py` against the JAX reference, on
the CPU.

`whisper-tiny-smoke` in float32 (LayerNorm, GELU, sinusoidal positions,
no RoPE); the reference's weights are carried across with
`interop.params_from_numpy` and every input is drawn from a seeded numpy
generator.  Bars: |port - ref| <= 2e-5 * max|ref| (measured ~7e-7); a
decode step against the prefill of one more token, 2e-2 relative (the
reference's own bar, tests/test_models.py); schemas equal; the cross
cache unchanged by decode, bit for bit.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import encdec as jencdec  # noqa: E402
from repro.models import registry as JM  # noqa: E402
from repro.serving.engine import ServeEngine as JEngine  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.models import attention, common, encdec, lm  # noqa: E402
from repro_torch.models import registry as M  # noqa: E402
from repro_torch.serving.engine import ServeEngine  # noqa: E402

TOL = 2e-5
WHISPER = "whisper-tiny-smoke"
B, S_ENC, T_DEC, EXTRA = 2, 40, 16, 8


def close(got, want, tol=TOL):
    """|got - want| <= tol * max|want|."""
    if isinstance(got, torch.Tensor):
        got = got.float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * float(np.abs(want).max()))


@pytest.fixture(scope="module")
def whisper():
    """(cfg, jcfg, params, jparams): the reference's PRNGKey(2) weights."""
    jcfg = jreg.get_arch(WHISPER)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(2))
    params = interop.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                       device="cpu")
    return registry.get_arch(WHISPER), jcfg, params, jparams


@pytest.fixture()
def inputs(rng):
    enc = (rng.normal(size=(B, S_ENC, 128)) * 0.02).astype(np.float32)
    toks = rng.integers(0, 512, (B, T_DEC + 1)).astype(np.int32)
    return enc, toks


def t(x):
    return torch.as_tensor(x)


def layer0(params, jparams, key):
    return (lm.layer_params(params, 0, key=key),
            jax.tree.map(lambda a: a[0], jparams[key]))


# --------------------------------------------------------------------------
# schema and pieces
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["whisper-tiny", WHISPER])
def test_schema_equals_reference(name):
    ours = common.schema_leaves(M.schema(registry.get_arch(name)))
    theirs = jax.tree_util.tree_flatten_with_path(
        JM.schema(jreg.get_arch(name)),
        is_leaf=lambda x: isinstance(x, jcommon.ParamSpec))[0]
    assert [(p, (s.shape, s.axes, s.scale)) for p, s in ours] == [
        (tuple(k.key for k in p), (s.shape, s.axes, s.scale))
        for p, s in theirs]


def test_init_params_follows_the_schema():
    cfg = registry.get_arch(WHISPER)
    params = M.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    assert set(params) == {"embed", "final_w", "final_b", "lm_head",
                           "enc_layers", "dec_layers", "enc_final_w",
                           "enc_final_b"}
    assert params["dec_layers"]["xwq"].shape == (4, 128, 128)
    assert params["enc_layers"]["wk"].shape == (2, 128, 64)


def test_params_from_numpy_walks_the_encdec_tree(whisper):
    """The reference's "enc_layers" / "dec_layers" tree carried across leaf
    for leaf, equal and in the schema's shapes."""
    cfg, _, params, jparams = whisper
    for path, spec in common.schema_leaves(M.schema(cfg)):
        got, want = params, jparams
        for k in path:
            got, want = got[k], want[k]
        assert tuple(got.shape) == spec.shape, path
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("offset", [0, 5])
def test_sinusoid_pos_emb(offset):
    close(common.sinusoid_pos_emb(24, 128, offset),
          jcommon.sinusoid_pos_emb(24, 128, offset), 1e-6)


def test_cross_attention_prefill(rng, whisper):
    cfg, jcfg, params, jparams = whisper
    lp, jlp = layer0(params, jparams, "dec_layers")
    x = rng.normal(size=(B, T_DEC, 128)).astype(np.float32)
    k = rng.normal(size=(B, S_ENC, 2, 32)).astype(np.float32)
    v = rng.normal(size=(B, S_ENC, 2, 32)).astype(np.float32)
    out, (k_o, _) = attention.causal_attention(
        cfg, lp, t(x), prefix="x", causal=False, kv_override=(t(k), t(v)))
    jout, _ = jattn.causal_attention(jcfg, jlp, jnp.asarray(x), prefix="x",
                                     causal=False,
                                     kv_override=(jnp.asarray(k),
                                                  jnp.asarray(v)))
    close(out, jout)
    assert torch.equal(k_o, t(k))           # no RoPE on the override


def test_cross_attention_decode(rng, whisper):
    cfg, jcfg, params, jparams = whisper
    lp, jlp = layer0(params, jparams, "dec_layers")
    x = rng.normal(size=(B, 1, 128)).astype(np.float32)
    k = rng.normal(size=(B, S_ENC, 2, 32)).astype(np.float32)
    v = rng.normal(size=(B, S_ENC, 2, 32)).astype(np.float32)
    pos = np.array([3, 11], np.int32)
    kc, vc = t(k.copy()), t(v.copy())
    out, k_new, v_new = attention.decode_attention(cfg, lp, t(x), kc, vc,
                                                   t(pos), prefix="x",
                                                   cross=True)
    jout, jk, jv = jattn.decode_attention(jcfg, jlp, jnp.asarray(x),
                                          jnp.asarray(k), jnp.asarray(v),
                                          jnp.asarray(pos), prefix="x",
                                          cross=True)
    assert k_new is v_new is jk is jv is None
    close(out, jout)
    assert torch.equal(kc, t(k)) and torch.equal(vc, t(v))   # not written


def test_encode_matches_reference(whisper, inputs):
    cfg, jcfg, params, jparams = whisper
    enc, _ = inputs
    close(encdec.encode(cfg, params, t(enc)),
          jencdec.encode(jcfg, jparams, jnp.asarray(enc)))


def test_cross_kv_matches_reference(rng, whisper):
    cfg, jcfg, params, jparams = whisper
    lp, jlp = layer0(params, jparams, "dec_layers")
    enc_out = rng.normal(size=(B, S_ENC, 128)).astype(np.float32)
    for got, want in zip(encdec._cross_kv(cfg, lp, t(enc_out)),
                         jencdec._cross_kv(jcfg, jlp, jnp.asarray(enc_out))):
        close(got, want)


# --------------------------------------------------------------------------
# prefill and decode
# --------------------------------------------------------------------------

def test_prefill_matches_reference(whisper, inputs):
    cfg, jcfg, params, jparams = whisper
    enc, toks = inputs
    logits, cache = M.prefill(cfg, params, {"enc_embeds": t(enc),
                                            "tokens": t(toks[:, :T_DEC])})
    jlogits, jcache = JM.prefill(jcfg, jparams, {
        "enc_embeds": jnp.asarray(enc), "tokens": jnp.asarray(toks[:, :T_DEC])})
    assert logits.shape == (B, cfg.padded_vocab)
    close(logits, jlogits)
    assert sorted(cache) == sorted(jcache) == ["k", "v", "xk", "xv"]
    assert cache["xk"].shape == (cfg.n_layers, B, S_ENC, 2, 32)
    for k in jcache:
        close(cache[k], jcache[k])


def pad_kv(cache, extra, jx=False):
    if jx:
        return {k: (jnp.pad(v, [(0, 0), (0, 0), (0, extra), (0, 0), (0, 0)])
                    if k in ("k", "v") else v) for k, v in cache.items()}
    return {k: (torch.nn.functional.pad(v, (0, 0, 0, 0, 0, extra))
                if k in ("k", "v") else v) for k, v in cache.items()}


def test_decode_steps_match_reference(rng, whisper, inputs):
    """Three decode steps: logits and the self cache within the bar; the
    cross cache bit for bit unchanged (the same tensors, never written)."""
    cfg, jcfg, params, jparams = whisper
    enc, toks = inputs
    _, cache = M.prefill(cfg, params, {"enc_embeds": t(enc),
                                       "tokens": t(toks[:, :T_DEC])})
    _, jcache = JM.prefill(jcfg, jparams, {
        "enc_embeds": jnp.asarray(enc), "tokens": jnp.asarray(toks[:, :T_DEC])})
    cache, jcache = pad_kv(cache, EXTRA), pad_kv(jcache, EXTRA, True)
    xk, xv = cache["xk"].clone(), cache["xv"].clone()
    pos = np.array([T_DEC, T_DEC - 3], np.int32)     # ragged positions
    for _ in range(3):
        tok = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
        logits, cache = M.decode_step(cfg, params, cache, t(tok), t(pos))
        jlogits, jcache = JM.decode_step(jcfg, jparams, jcache,
                                         jnp.asarray(tok), jnp.asarray(pos))
        close(logits, jlogits)
        for k in jcache:
            close(cache[k], jcache[k])
        pos = pos + 1
    assert torch.equal(cache["xk"], xk) and torch.equal(cache["xv"], xv)


def test_decode_matches_prefill_of_one_more_token(whisper, inputs):
    cfg, _, params, _ = whisper
    enc, toks = inputs
    full, _ = M.prefill(cfg, params, {"enc_embeds": t(enc),
                                      "tokens": t(toks)})
    _, cache = M.prefill(cfg, params, {"enc_embeds": t(enc),
                                       "tokens": t(toks[:, :T_DEC])})
    step, _ = M.decode_step(cfg, params, pad_kv(cache, EXTRA),
                            t(toks[:, T_DEC:]),
                            torch.full((B,), T_DEC, dtype=torch.int32))
    err = ((step - full).abs().max() / full.abs().max()).item()
    assert err < 2e-2, err


@pytest.mark.parametrize("seq", [64, 4096])
def test_cache_schema_and_init_cache(seq):
    """The registry gives enc-dec half the cell's sequence, for the self
    and the cross cache alike, as the reference."""
    cfg, jcfg = registry.get_arch(WHISPER), jreg.get_arch(WHISPER)
    ours = M.cache_schema(cfg, 3, seq)
    theirs = JM.cache_schema(jcfg, 3, seq)
    assert {k: (v.shape, v.axes) for k, v in ours.items()} == {
        k: (v.shape, v.axes) for k, v in theirs.items()}
    cache = M.init_cache(cfg, 3, seq, device="cpu")
    assert {k: tuple(v.shape) for k, v in cache.items()} == {
        k: v.shape for k, v in theirs.items()}
    assert all(v.dtype == torch.float32 and not v.any()
               for v in cache.values())


# --------------------------------------------------------------------------
# the engine refuses enc-dec
# --------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["dense", "strap"])
def test_engine_refuses_encdec(whisper, backend):
    """The reference's engine cannot serve enc-dec (its prefill passes no
    `enc_embeds`: `KeyError`); the port's refuses it when built."""
    cfg, jcfg, params, jparams = whisper
    with pytest.raises(ValueError, match="enc_embeds"):
        ServeEngine(cfg, params, cache_backend=backend, device="cpu")
    if backend == "dense":
        with pytest.raises(KeyError, match="enc_embeds"):
            JEngine(jcfg, jparams).prefill(jnp.zeros((B, 4), jnp.int32))


def test_bf16_prefill_and_decode_match_reference(whisper, inputs):
    """Whisper at its full config's dtypes (bf16): the port's bf16 bar,
    rtol / atol 3e-2 (tests/test_torch_lm.py)."""
    _, _, _, jparams = whisper
    bf = dict(param_dtype="bfloat16", compute_dtype="bfloat16")
    cfg = dataclasses.replace(registry.get_arch(WHISPER), **bf)
    jcfg = dataclasses.replace(jreg.get_arch(WHISPER), **bf)
    jparams = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jparams)
    params = interop.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                       device="cpu")
    enc, toks = inputs
    batch = {"enc_embeds": enc, "tokens": toks[:, :T_DEC]}
    logits, cache = M.prefill(cfg, params, {k: t(v) for k, v in batch.items()})
    jlogits, jcache = JM.prefill(jcfg, jparams,
                                 {k: jnp.asarray(v) for k, v in batch.items()})
    assert cache["k"].dtype == cache["xk"].dtype == torch.bfloat16
    bar = dict(rtol=3e-2, atol=3e-2)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **bar)
    cache, jcache = pad_kv(cache, EXTRA), pad_kv(jcache, EXTRA, True)
    pos = np.full((B,), T_DEC, np.int32)
    logits, _ = M.decode_step(cfg, params, cache, t(toks[:, T_DEC:]), t(pos))
    jlogits, _ = JM.decode_step(jcfg, jparams, jcache,
                                jnp.asarray(toks[:, T_DEC:]), jnp.asarray(pos))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **bar)
