"""The port's MoE, VLM, gated-decode, SSM and hybrid paths
(`models/attention.py`'s `decode_attention_gated`, `models/ssm.py`,
`models/lm.py`, `serving/engine.py`) against the JAX reference, on the
CPU.

The reference's weights are carried across with
`interop.params_from_numpy`; every input is drawn from a seeded numpy
generator.  Bars: rtol / atol 2e-5 in float32 (tests/test_torch_lm.py's
TOL); gated decode with every strap selected against exact decode, 1e-4
(the reference's own bar, tests/test_perf_features.py); the engine's
greedy tokens and `ServeStats` equal.  The ssm and hybrid families:
|port - ref| <= 2e-5 * max|ref| for logits and every cache entry; a
decode step against the prefill of one more token, 2e-2 relative (the
reference's own bar, tests/test_models.py).
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
from repro_torch.models import attention, common, lm  # noqa: E402
from repro_torch.models import registry as M  # noqa: E402
from repro_torch.serving.engine import ServeEngine, ServeStats  # noqa: E402

TOL = 2e-5
PHI, ARCTIC = "phi3.5-moe-42b-a6.6b-smoke", "arctic-480b-smoke"
PIXTRAL, OLMO, DEEPSEEK = "pixtral-12b-smoke", "olmo-1b-smoke", \
    "deepseek-67b-smoke"
MAMBA, ZAMBA = "mamba2-780m-smoke", "zamba2-7b-smoke"
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
        name, change = {**CASES, **SSM_CASES}[key]
        _MODELS[key] = both(name, **change)
    return _MODELS[key]


# pixtral_hd48: n_heads * head_dim = 192 != d_model = 128, as in the full
# Pixtral (32 x 128 = 4096 != 5120)
CASES = {"phi": (PHI, {}), "arctic": (ARCTIC, {}), "pixtral": (PIXTRAL, {}),
         "pixtral_hd48": (PIXTRAL, {"head_dim": 48}), "olmo": (OLMO, {}),
         "deepseek": (DEEPSEEK, {})}
# the ssm and hybrid families: zamba2_trailing is 2 groups of 2 Mamba2
# layers, each followed by the shared block, then one trailing layer
SSM_CASES = {"mamba2": (MAMBA, {}), "mamba2_ng2": (MAMBA, {"ssm_ngroups": 2}),
             "zamba2": (ZAMBA, {}),
             "zamba2_trailing": (ZAMBA, {"n_layers": 5})}


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


# --------------------------------------------------------------------------
# the ssm and hybrid families
# --------------------------------------------------------------------------

def close_scaled(got, want, tol=TOL):
    """|got - want| <= tol * max|want|."""
    if isinstance(got, torch.Tensor):
        got = got.float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * float(np.abs(want).max()))


def pad_kv(cache, to):
    """Grow the K/V's seq axis to `to`; the states keep their shapes."""
    return {k: (torch.nn.functional.pad(v, (0, 0, 0, 0, 0, to - v.shape[2]))
                if k in ("k", "v") else v) for k, v in cache.items()}


def jpad_kv(cache, to):
    return {k: (jnp.pad(v, [(0, 0), (0, 0), (0, to - v.shape[2]), (0, 0),
                            (0, 0)]) if k in ("k", "v") else v)
            for k, v in cache.items()}


@pytest.mark.parametrize("key", sorted(SSM_CASES))
def test_ssm_like_prefill_and_three_steps_match_reference(rng, key):
    """A prompt of 45 tokens (chunks of 15): the logits and every cache
    entry, then three decode steps."""
    cfg, jcfg, params, jparams = model(key)
    batch = batch_for(cfg, rng, 45)
    logits, cache = M.prefill(cfg, params, port_batch(batch))
    jlogits, jcache = JM.prefill(jcfg, jparams, jax_batch(batch))
    close_scaled(logits, jlogits)
    want_keys = {"ssm", "conv"} | ({"k", "v"} if cfg.family == "hybrid"
                                   else set())
    if key == "zamba2_trailing":
        want_keys |= {"t_ssm", "t_conv"}
        assert cache["t_ssm"].shape == (1, B, 8, 32, 16)
    assert set(cache) == set(jcache) == want_keys
    schema = M.cache_schema(cfg, B, 45)
    for k in jcache:
        assert tuple(cache[k].shape) == schema[k].shape, k
        close_scaled(cache[k], jcache[k])
    assert cache["ssm"].dtype == torch.float32
    cache, jcache = pad_kv(cache, 56), jpad_kv(jcache, 56)
    pos = np.full((B,), 45, np.int32)
    for _ in range(3):
        token = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
        logits, cache = M.decode_step(cfg, params, cache,
                                      torch.as_tensor(token),
                                      torch.as_tensor(pos))
        jlogits, jcache = JM.decode_step(jcfg, jparams, jcache,
                                         jnp.asarray(token), jnp.asarray(pos))
        close_scaled(logits, jlogits)
        for k in jcache:
            close_scaled(cache[k], jcache[k])
        pos = pos + 1


@pytest.mark.parametrize("key", ["mamba2", "zamba2_trailing"])
def test_params_from_numpy_walks_the_nested_tree(key):
    """`interop.params_from_numpy` carries the reference's ssm and hybrid
    trees ("layers" as (groups, per, ...), "shared", "trailing") leaf for
    leaf, equal and in the schema's shapes."""
    cfg, _, params, jparams = model(key)
    leaves = common.schema_leaves(M.schema(cfg))
    if key == "zamba2_trailing":
        assert {p[0] for p, _ in leaves} >= {"layers", "shared", "trailing"}
        assert params["layers"]["in_proj"].shape[:2] == (2, 2)
    for path, spec in leaves:
        got, want = params, jparams
        for k in path:
            got, want = got[k], want[k]
        assert tuple(got.shape) == spec.shape, path
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("key", ["mamba2", "zamba2", "zamba2_trailing"])
def test_ssm_like_decode_matches_prefill_of_one_more_token(rng, key):
    """The reference's decode-vs-forward claim (tests/test_models.py), with
    the prefill of T + 1 tokens in place of `forward_train`."""
    cfg, _, params, _ = model(key)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, 65)),
                           dtype=torch.int32)
    full, _ = M.prefill(cfg, params, {"tokens": toks})
    _, cache = M.prefill(cfg, params, {"tokens": toks[:, :64]})
    step, _ = M.decode_step(cfg, params, pad_kv(cache, 72), toks[:, 64:],
                            torch.full((B,), 64, dtype=torch.int32))
    err = ((step - full).abs().max() / full.abs().max()).item()
    assert err < 2e-2, err


@pytest.mark.parametrize("key", ["mamba2", "zamba2"])
def test_strap_decode_flag_keeps_the_ssm_cache(rng, key):
    """The family is tested before `strap_decode`, as in the reference: an
    ssm or hybrid config with the flag takes its own cache and decode."""
    cfg, _, params, _ = model(key)
    gcfg = dataclasses.replace(cfg, strap_decode=True,
                               decode_strap_tokens=STRAP)
    assert set(M.cache_schema(gcfg, B, S_CACHE)) == set(
        M.cache_schema(cfg, B, S_CACHE))
    assert "ksum" not in M.init_cache(gcfg, B, S_CACHE, device="cpu")
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, 33)),
                           dtype=torch.int32)
    _, cache = M.prefill(cfg, params, {"tokens": toks[:, :32]})
    pos = torch.full((B,), 32, dtype=torch.int32)
    copy = {k: v.clone() for k, v in pad_kv(cache, S_CACHE).items()}
    want, _ = M.decode_step(cfg, params, copy, toks[:, 32:], pos)
    got, _ = M.decode_step(gcfg, params, pad_kv(cache, S_CACHE),
                           toks[:, 32:], pos)
    assert torch.equal(got, want)


def test_init_cache_carries_the_ssm_state_in_float32():
    cfg = dataclasses.replace(registry.get_arch(ZAMBA), n_layers=5,
                              compute_dtype="bfloat16")
    cache = M.init_cache(cfg, B, S_CACHE, device="cpu")
    theirs = JM.init_cache(dataclasses.replace(
        jreg.get_arch(ZAMBA), n_layers=5, compute_dtype="bfloat16"), B,
        S_CACHE)
    assert {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
            for k, v in cache.items()} == {
        k: (v.shape, np.dtype(v.dtype).name) for k, v in theirs.items()}
    assert cache["ssm"].dtype == cache["t_ssm"].dtype == torch.float32
    assert cache["conv"].dtype == cache["k"].dtype == torch.bfloat16


def reference_greedy(jcfg, jparams, prompts, n, max_tokens):
    """The reference's engine loop through its model functions (what its
    `ServeEngine` runs), for a family its engine cannot prefill."""
    logits, cache = JM.prefill(jcfg, jparams, {"tokens": jnp.asarray(prompts)})
    if "k" in cache:
        cache = jpad_kv(cache, max_tokens)
    pos = jnp.full((prompts.shape[0],), prompts.shape[1], jnp.int32)
    out = []
    for _ in range(n):
        tok = jnp.argmax(logits, axis=-1)[:, None].astype(jnp.int32)
        logits, cache = JM.decode_step(jcfg, jparams, cache, tok, pos)
        pos = pos + 1
        out.append((tok, logits))
    return out, cache


@pytest.mark.parametrize("key", ["mamba2", "zamba2", "zamba2_trailing"])
def test_ssm_like_engine_greedy_decode_matches_reference(key):
    """The dense backend's true greedy loop: tokens equal at every step,
    logits and the final cache within the bar.  Against the reference's
    engine for the hybrid; for the ssm family, whose cache has no "k",
    the reference's engine raises `KeyError` in prefill (ROADMAP.md, queue
    3), so against its model functions' loop."""
    cfg, jcfg, params, jparams = model(key)
    prompts = np.random.default_rng(1).integers(0, 512, (B, 32)).astype(
        np.int32)
    ours = ServeEngine(cfg, params, max_tokens=ENGINE_MAX, device="cpu")
    close_scaled(ours.prefill(prompts), JM.prefill(
        jcfg, jparams, {"tokens": jnp.asarray(prompts)})[0])
    if cfg.family == "ssm":
        with pytest.raises(KeyError, match="'k'"):
            JEngine(jcfg, jparams, max_tokens=ENGINE_MAX).prefill(
                jnp.asarray(prompts))
        want, jcache = reference_greedy(jcfg, jparams, prompts, ENGINE_NEW,
                                        ENGINE_MAX)
    else:
        theirs = JEngine(jcfg, jparams, max_tokens=ENGINE_MAX)
        theirs.prefill(jnp.asarray(prompts))
        want = [theirs.step() for _ in range(ENGINE_NEW)]
        jcache = theirs._cache
    for jtok, jlogits in want:
        tok, logits = ours.step()
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
        close_scaled(logits, jlogits)
    assert set(ours._cache) == set(jcache)
    for k in jcache:
        close_scaled(ours._cache[k], jcache[k])
    assert ours.stats.tokens_decoded == B * ENGINE_NEW


@pytest.mark.parametrize("key", ["mamba2", "zamba2_trailing"])
def test_engine_pads_only_the_kv_seq_axis(key):
    """The dense backend grows the K/V's seq axis to `max_tokens` and
    leaves the SSM and conv states' shapes as prefill gave them."""
    cfg, _, params, _ = model(key)
    prompts = np.zeros((B, 16), np.int32)
    eng = ServeEngine(cfg, params, max_tokens=40, device="cpu")
    eng.prefill(prompts)
    want = {k: v.shape for k, v in M.cache_schema(cfg, B, 40).items()}
    assert {k: tuple(v.shape) for k, v in eng._cache.items()} == want


@pytest.mark.parametrize("key", ["mamba2", "zamba2"])
def test_strap_backend_refuses_ssm_like(key):
    """As the reference: the strap cache applies to the full-attention
    decoder families (dense, vlm)."""
    cfg, jcfg, params, jparams = model(key)
    with pytest.raises(ValueError, match="full-attention decoder families"):
        ServeEngine(cfg, params, cache_backend="strap", device="cpu")
    with pytest.raises(AssertionError, match="full-attention decoder"):
        JEngine(jcfg, jparams, cache_backend="strap")
