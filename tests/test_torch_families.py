"""The port's MoE, VLM and gated-decode paths (`models/attention.py`'s
`decode_attention_gated`, `models/lm.py`, `serving/engine.py`) against the
JAX reference, on the CPU.

The reference's weights are carried across with
`interop.params_from_numpy`; every input is drawn from a seeded numpy
generator.  Bars: rtol / atol 2e-5 in float32 (tests/test_torch_lm.py's
TOL); gated decode with every strap selected against exact decode, 1e-4
(the reference's own bar, tests/test_perf_features.py); the engine's
greedy tokens and `ServeStats` equal.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.memory.strap_cache import StrapCacheConfig as JStrapCfg  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import registry as JM  # noqa: E402
from repro.serving.engine import ServeEngine as JEngine  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.memory.strap_cache import StrapCacheConfig  # noqa: E402
from repro_torch.models import attention, lm  # noqa: E402
from repro_torch.models import registry as M  # noqa: E402
from repro_torch.serving.engine import ServeEngine, ServeStats  # noqa: E402

TOL = 2e-5
PHI, ARCTIC = "phi3.5-moe-42b-a6.6b-smoke", "arctic-480b-smoke"
PIXTRAL, OLMO, DEEPSEEK = "pixtral-12b-smoke", "olmo-1b-smoke", \
    "deepseek-67b-smoke"
B, PROMPT, NV = 2, 48, 8
STRAP = 16                   # decode_strap_tokens of the gated cases
S_CACHE = 64                 # 4 straps


def close(got, want, tol=TOL):
    if isinstance(got, torch.Tensor):
        got = got.float().numpy()
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def both(name, **change):
    """(port cfg, reference cfg, port params, reference params): the
    reference's PRNGKey(0) weights carried across."""
    jcfg = dataclasses.replace(jreg.get_arch(name), **change)
    cfg = dataclasses.replace(registry.get_arch(name), **change)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    params = interop.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                       device="cpu")
    return cfg, jcfg, params, jparams


_MODELS = {}


def model(key):
    """One set of weights per case, built on first use."""
    if key not in _MODELS:
        name, change = CASES[key]
        _MODELS[key] = both(name, **change)
    return _MODELS[key]


# pixtral_hd48: n_heads * head_dim = 192 != d_model = 128, as in the full
# Pixtral (32 x 128 = 4096 != 5120)
CASES = {"phi": (PHI, {}), "arctic": (ARCTIC, {}), "pixtral": (PIXTRAL, {}),
         "pixtral_hd48": (PIXTRAL, {"head_dim": 48}), "olmo": (OLMO, {}),
         "deepseek": (DEEPSEEK, {})}


def batch_for(cfg, rng, n_tok):
    toks = rng.integers(0, cfg.vocab_size, (B, n_tok)).astype(np.int32)
    batch = {"tokens": toks}
    if cfg.n_vision_tokens:
        batch["vision_embeds"] = (rng.normal(
            size=(B, cfg.n_vision_tokens, cfg.d_model)) * 0.02).astype(
                np.float32)
    return batch


def port_batch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def pad_seq(cache, to):
    return {k: torch.nn.functional.pad(v, (0, 0, 0, 0, 0, to - v.shape[2]))
            for k, v in cache.items()}


def jpad_seq(cache, to):
    return {k: jnp.pad(v, [(0, 0), (0, 0), (0, to - v.shape[2]), (0, 0),
                           (0, 0)]) for k, v in cache.items()}


# --------------------------------------------------------------------------
# prefill and decode step, every attention family
# --------------------------------------------------------------------------

@pytest.mark.parametrize("key", sorted(CASES))
def test_prefill_and_decode_step_match_reference(rng, key):
    cfg, jcfg, params, jparams = model(key)
    if key == "pixtral_hd48":
        assert cfg.n_heads * cfg.head_dim_ != cfg.d_model
    batch = batch_for(cfg, rng, PROMPT)
    logits, cache = M.prefill(cfg, params, port_batch(batch))
    jlogits, jcache = JM.prefill(jcfg, jparams, jax_batch(batch))
    held = PROMPT + (NV if cfg.n_vision_tokens else 0)
    assert cache["k"].shape == (cfg.n_layers, B, held, cfg.n_kv_heads,
                                cfg.head_dim_)
    close(logits, jlogits)
    close(cache["k"], jcache["k"])
    close(cache["v"], jcache["v"])
    cache, jcache = pad_seq(cache, held + 8), jpad_seq(jcache, held + 8)
    token = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
    pos = np.full((B,), held, np.int32)
    logits, cache = M.decode_step(cfg, params, cache, torch.as_tensor(token),
                                  torch.as_tensor(pos))
    jlogits, jcache = JM.decode_step(jcfg, jparams, jcache, jnp.asarray(token),
                                     jnp.asarray(pos))
    close(logits, jlogits)
    close(cache["k"], jcache["k"])
    close(cache["v"], jcache["v"])


@pytest.mark.parametrize("key", ["pixtral", "pixtral_hd48"])
def test_vlm_positions_run_over_vision_and_text(rng, key):
    """The vision embeddings come first and shift the text's positions: a
    decode step at position Nv + S after the prompt equals the prefill of
    the prompt plus that token (within the reference's 2e-2 relative bar,
    tests/test_models.py, and here within 2e-4)."""
    cfg, _, params, _ = model(key)
    batch = batch_for(cfg, rng, PROMPT + 1)
    full, _ = M.prefill(cfg, params, port_batch(batch))
    short = dict(batch, tokens=batch["tokens"][:, :PROMPT])
    _, cache = M.prefill(cfg, params, port_batch(short))
    cache = pad_seq(cache, PROMPT + NV + 8)
    pos = torch.full((B,), PROMPT + NV, dtype=torch.int32)
    step, _ = M.decode_step(cfg, params, cache,
                            torch.as_tensor(batch["tokens"][:, PROMPT:]), pos)
    err = (step - full).abs().max() / full.abs().max()
    assert err < 2e-4, float(err)


# --------------------------------------------------------------------------
# decode_attention_gated
# --------------------------------------------------------------------------

def gated_cfgs(name, top):
    change = dict(strap_decode=True, decode_strap_tokens=STRAP,
                  decode_top_straps=top)
    return (dataclasses.replace(registry.get_arch(name), **change),
            dataclasses.replace(jreg.get_arch(name), **change))


def gated_inputs(rng, cfg, pos):
    """A cache of S_CACHE tokens with random K/V up to each row's `pos`
    and zeros after, its per-strap key sums, and a query token."""
    hkv, hd = cfg.n_kv_heads, cfg.head_dim_
    k = rng.normal(size=(B, S_CACHE, hkv, hd)).astype(np.float32)
    v = rng.normal(size=(B, S_CACHE, hkv, hd)).astype(np.float32)
    live = (np.arange(S_CACHE)[None, :] < np.asarray(pos)[:, None])
    k, v = k * live[..., None, None], v * live[..., None, None]
    ksum = k.reshape(B, S_CACHE // STRAP, STRAP, hkv, hd).sum(2)
    x = rng.normal(size=(B, 1, cfg.d_model)).astype(np.float32)
    return x, k, v, ksum.astype(np.float32), np.asarray(pos, np.int32)


def run_gated(cfg, jcfg, lp, jlp, x, k, v, ksum, pos):
    tk, tv, ts = (torch.as_tensor(a.copy()) for a in (k, v, ksum))
    out = attention.decode_attention_gated(cfg, lp, torch.as_tensor(x), tk,
                                           tv, ts, torch.as_tensor(pos))
    assert out[1] is tk and out[2] is tv and out[3] is ts   # in place
    jout = jattn.decode_attention_gated(jcfg, jlp, jnp.asarray(x),
                                        jnp.asarray(k), jnp.asarray(v),
                                        jnp.asarray(ksum), jnp.asarray(pos))
    return out, jout


@pytest.mark.parametrize("top", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("name", [DEEPSEEK, PIXTRAL])
def test_decode_attention_gated_matches_reference(rng, name, top):
    """Rows at positions 40 (3 valid straps of 4) and 20 (2 valid): top 1
    and 2 select, top 3 selects for row 0 and, for row 1, adds a strap
    whose score is -inf; top 4 and 8 select every strap."""
    key = "deepseek" if name == DEEPSEEK else "pixtral"
    _, _, params, jparams = model(key)
    cfg, jcfg = gated_cfgs(name, top)
    lp = lm.layer_params(params, 0)
    jlp = jax.tree.map(lambda a: a[0], jparams["layers"])
    x, k, v, ksum, pos = gated_inputs(rng, cfg, [40, 20])
    out, jout = run_gated(cfg, jcfg, lp, jlp, x, k, v, ksum, pos)
    for got, want in zip(out, jout):
        close(got, want)


@pytest.mark.parametrize("top", [2, 4, 8])
def test_gated_with_every_valid_strap_equals_exact_decode(rng, top):
    """Where the selector keeps every valid strap, gated decode equals
    exact decode (1e-4, tests/test_perf_features.py): row 1 (position 20,
    2 valid straps) at every top; row 0 (position 40, 3 valid) at top 4
    and 8.  The -inf picks beyond the valid straps (top 8 > 4 straps is
    cut to 4; top 4 for row 1) are masked by the token mask."""
    _, _, params, jparams = model("deepseek")
    cfg, jcfg = gated_cfgs(DEEPSEEK, top)
    lp = lm.layer_params(params, 0)
    x, k, v, ksum, pos = gated_inputs(rng, cfg, [40, 20])
    gated = attention.decode_attention_gated(
        cfg, lp, torch.as_tensor(x), torch.as_tensor(k.copy()),
        torch.as_tensor(v.copy()), torch.as_tensor(ksum.copy()),
        torch.as_tensor(pos))[0]
    exact = attention.decode_attention(
        cfg, lp, torch.as_tensor(x), torch.as_tensor(k.copy()),
        torch.as_tensor(v.copy()), torch.as_tensor(pos))[0]
    jexact = jattn.decode_attention(
        jcfg, jax.tree.map(lambda a: a[0], jparams["layers"]),
        jnp.asarray(x), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos))[0]
    rows = [0, 1] if top >= 3 else [1]
    close(gated[rows], exact[rows], 1e-4)
    close(gated[rows], np.asarray(jexact)[rows], 1e-4)
    if top == 2:
        assert (gated[0] - exact[0]).abs().max() > 1e-3   # row 0 gated


def test_gated_cache_update(rng):
    """The new token lands in the cache at `pos` and its key is added, in
    float32, to the newest strap's sum; nothing else changes."""
    _, _, params, _ = model("deepseek")
    cfg, _ = gated_cfgs(DEEPSEEK, 2)
    x, k, v, ksum, pos = gated_inputs(rng, cfg, [40, 20])
    lp = lm.layer_params(params, 0)
    _, tk, tv, ts = attention.decode_attention_gated(
        cfg, lp, torch.as_tensor(x), torch.as_tensor(k.copy()),
        torch.as_tensor(v.copy()), torch.as_tensor(ksum.copy()),
        torch.as_tensor(pos))
    for r, p in enumerate(pos):
        others = np.ones(S_CACHE, bool)
        others[p] = False
        np.testing.assert_array_equal(tk[r, others].numpy(), k[r, others])
        np.testing.assert_array_equal(tv[r, others].numpy(), v[r, others])
        strap = p // STRAP
        close(ts[r, strap] - torch.as_tensor(ksum[r, strap]), tk[r, p])
        rest = [s for s in range(S_CACHE // STRAP) if s != strap]
        np.testing.assert_array_equal(ts[r, rest].numpy(), ksum[r, rest])


def test_gated_refuses_a_cache_off_the_strap_grid(rng):
    _, _, params, _ = model("deepseek")
    cfg, _ = gated_cfgs(DEEPSEEK, 2)
    x, k, v, ksum, pos = gated_inputs(rng, cfg, [40, 20])
    with pytest.raises(ValueError, match="multiple of decode_strap_tokens"):
        attention.decode_attention_gated(
            cfg, lm.layer_params(params, 0), torch.as_tensor(x),
            torch.as_tensor(k[:, :60].copy()), torch.as_tensor(v[:, :60].copy()),
            torch.as_tensor(ksum), torch.as_tensor(pos))


# --------------------------------------------------------------------------
# the gated decode step of the whole model (dense, MoE, VLM)
# --------------------------------------------------------------------------

def gated_caches(cfg, params, jparams, jcfg, rng):
    """Prefill, pad to S_CACHE and build `ksum` as the reference's own
    test does (tests/test_perf_features.py)."""
    nv = NV if cfg.n_vision_tokens else 0
    batch = batch_for(cfg, rng, PROMPT - nv)
    _, cache = M.prefill(cfg, params, port_batch(batch))
    _, jcache = JM.prefill(jcfg, jparams, jax_batch(batch))
    cache, jcache = pad_seq(cache, S_CACHE), jpad_seq(jcache, S_CACHE)
    nst = S_CACHE // STRAP
    shape = (cfg.n_layers, B, nst, STRAP, cfg.n_kv_heads, cfg.head_dim_)
    jcache["ksum"] = jcache["k"].reshape(shape).astype(jnp.float32).sum(3)
    cache["ksum"] = cache["k"].reshape(shape).float().sum(3)
    return cache, jcache, np.full((B,), PROMPT, np.int32)


@pytest.mark.parametrize("top", [2, 64])
@pytest.mark.parametrize("key", ["deepseek", "phi", "pixtral"])
def test_gated_decode_step_matches_reference(rng, key, top):
    name = CASES[key][0]
    _, _, params, jparams = model(key)
    cfg, jcfg = gated_cfgs(name, top)
    cache, jcache, pos = gated_caches(cfg, params, jparams, jcfg, rng)
    close(cache["ksum"], jcache["ksum"])
    token = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
    logits, cache = M.decode_step(cfg, params, cache, torch.as_tensor(token),
                                  torch.as_tensor(pos))
    jlogits, jcache = JM.decode_step(jcfg, jparams, jcache, jnp.asarray(token),
                                     jnp.asarray(pos))
    for k in ("k", "v", "ksum"):
        close(cache[k], jcache[k])
    close(logits, jlogits)


@pytest.mark.parametrize("key", ["deepseek", "phi", "pixtral"])
def test_gated_decode_step_with_every_strap_equals_exact(rng, key):
    """Top 64 of 4 straps: the gated step equals the exact decode step
    (1e-4, tests/test_perf_features.py)."""
    name = CASES[key][0]
    _, _, params, jparams = model(key)
    cfg, jcfg = gated_cfgs(name, 64)
    cache, _, pos = gated_caches(cfg, params, jparams, jcfg, rng)
    dense = {k: cache[k].clone() for k in ("k", "v")}
    token = torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32))
    gated, _ = M.decode_step(cfg, params, cache, token, torch.as_tensor(pos))
    exact, _ = M.decode_step(registry.get_arch(name), params, dense, token,
                             torch.as_tensor(pos))
    close(gated, exact, 1e-4)
    close(cache["k"], dense["k"], 1e-4)


def test_init_cache_carries_ksum_in_float32():
    cfg = dataclasses.replace(registry.get_arch(PIXTRAL), strap_decode=True,
                              decode_strap_tokens=STRAP,
                              compute_dtype="bfloat16")
    cache = M.init_cache(cfg, B, S_CACHE, device="cpu")
    theirs = JM.init_cache(dataclasses.replace(
        jreg.get_arch(PIXTRAL), strap_decode=True, decode_strap_tokens=STRAP,
        compute_dtype="bfloat16"), B, S_CACHE)
    assert {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
            for k, v in cache.items()} == {
        k: (v.shape, np.dtype(v.dtype).name) for k, v in theirs.items()}
    assert cache["ksum"].dtype == torch.float32
    assert cache["k"].dtype == torch.bfloat16


# --------------------------------------------------------------------------
# the serving engine: MoE on the dense backend, VLM on both
# --------------------------------------------------------------------------

ENGINE_NEW, ENGINE_MAX = 6, 64
ENGINES = {"phi_dense": ("phi", "dense", 0),
           "pixtral_dense": ("pixtral", "dense", 0),
           "pixtral_strap_exact": ("pixtral", "strap", 0),
           "pixtral_strap_gated_top2": ("pixtral", "strap", 2)}


def engines(key, backend, top):
    cfg, jcfg, params, jparams = model(key)
    ours = ServeEngine(cfg, params, max_tokens=ENGINE_MAX,
                       cache_backend=backend,
                       strap_cfg=StrapCacheConfig(8, 2, top), device="cpu")
    theirs = JEngine(jcfg, jparams, max_tokens=ENGINE_MAX,
                     cache_backend=backend, strap_cfg=JStrapCfg(8, 2, top))
    return ours, theirs


@pytest.mark.parametrize("name", sorted(ENGINES))
def test_engine_greedy_decode_matches_reference(name):
    """A true greedy loop (`step()` with no token): tokens equal at every
    step, logits within the bar, `ServeStats` equal; then `generate`
    (the reference's loop) gives the reference's tokens."""
    key, backend, top = ENGINES[name]
    ours, theirs = engines(key, backend, top)
    prompts = np.random.default_rng(1).integers(0, 512, (B, 32)).astype(
        np.int32)
    close(ours.prefill(prompts), theirs.prefill(jnp.asarray(prompts)))
    for _ in range(ENGINE_NEW):
        tok, logits = ours.step()
        jtok, jlogits = theirs.step()
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
        close(logits, jlogits)
    assert ours.stats == ServeStats(**dataclasses.asdict(theirs.stats))
    ours, theirs = engines(key, backend, top)
    got = ours.generate(prompts, ENGINE_NEW)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(theirs.generate(jnp.asarray(prompts),
                                                ENGINE_NEW)))
    assert ours.stats == ServeStats(**dataclasses.asdict(theirs.stats))
    if top:
        assert ours.stats.traffic_reduction < 1.0


@pytest.mark.parametrize("key", ["phi", "arctic"])
def test_strap_backend_refuses_moe(key):
    """As the reference: the strap cache applies to the full-attention
    decoder families (dense, vlm)."""
    cfg, jcfg, params, jparams = model(key)
    with pytest.raises(ValueError, match="full-attention decoder families"):
        ServeEngine(cfg, params, cache_backend="strap", device="cpu")
    with pytest.raises(AssertionError, match="full-attention decoder"):
        JEngine(jcfg, jparams, cache_backend="strap")
