"""The port's LM server (configs, models, serving engine) against the JAX
reference, on the CPU.

The reference's weights are carried across with
`interop.params_from_numpy` (the port's seeded init draws other numbers
than `jax.random`).  Everything runs `qwen2-1.5b-smoke` in float32, where
the port's rounding points are the reference's; the full-width config in
bf16 runs on the card (`chip_smoke.py`).

Bars:
- configs and schemas: equal, field by field and leaf by leaf.
- modules, prefill and decode step: rtol / atol 2e-5, the reference's own
  strap-vs-dense bar (tests/test_strap_cache.py): float32 with matmuls and
  reductions summed in another order (ATen's blocking vs XLA's) over at
  most four layers; measured differences are ~1e-6.
- engine: greedy tokens equal, `ServeStats` equal, logits 2e-5 as above.
- engine in bfloat16 (the smoke config at the full config's dtypes),
  teacher-forced with the reference's tokens: logits rtol / atol 3e-2, the
  reference's bf16 kernel bar (tests/test_kernels.py).  Activations are
  rounded to bf16 (2^-8) after every matmul; a one-ulp flip where the two
  sides accumulate in another order carries through four layers (measured
  1e-2 on logits of magnitude ~0.9).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.configs import registry as jreg  # noqa: E402
from repro.memory.strap_cache import StrapCacheConfig as JStrapCfg  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import mlp as jmlp  # noqa: E402
from repro.models import registry as JM  # noqa: E402
from repro.serving.engine import ServeEngine as JEngine  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import base, registry  # noqa: E402
from repro_torch.configs.qwen2_1_5b import QWEN2_1_5B  # noqa: E402
from repro_torch.memory.strap_cache import StrapCacheConfig  # noqa: E402
from repro_torch.models import attention, common, lm, mlp  # noqa: E402
from repro_torch.models import registry as M  # noqa: E402
from repro_torch.serving.engine import ServeEngine, ServeStats  # noqa: E402

TOL = 2e-5
SMOKE = "qwen2-1.5b-smoke"
B, PROMPT, NEW, MAX = 2, 32, 6, 48


@pytest.fixture(scope="module")
def smoke():
    """(port cfg, reference cfg, port params, reference params): the
    reference's PRNGKey(0) weights carried across."""
    jcfg = jreg.get_arch(SMOKE)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    params = interop.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                       device="cpu")
    return registry.get_arch(SMOKE), jcfg, params, jparams


@pytest.fixture(scope="module")
def prompts():
    return np.random.default_rng(0).integers(0, 512, (B, PROMPT)).astype(
        np.int32)


def close(got, want, tol=TOL):
    if isinstance(got, torch.Tensor):
        got = got.float().numpy()
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def layer0(params, jparams):
    return (lm.layer_params(params, 0),
            jax.tree.map(lambda x: x[0], jparams["layers"]))


# --------------------------------------------------------------------------
# configs and schemas
# --------------------------------------------------------------------------

@pytest.mark.parametrize("smoke_size", [False, True], ids=["full", "smoke"])
def test_config_equals_reference(smoke_size):
    ours, theirs = QWEN2_1_5B, jreg.get_arch("qwen2-1.5b")
    if smoke_size:
        ours, theirs = ours.reduced(), theirs.reduced()
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    for prop in ("head_dim_", "padded_vocab", "d_inner", "ssm_nheads",
                 "attention_free", "sub_quadratic"):
        assert getattr(ours, prop) == getattr(theirs, prop), prop
    assert ours.param_count() == theirs.param_count()
    assert ours.active_param_count() == theirs.active_param_count()
    assert ours.runnable_cells() == theirs.runnable_cells()


def test_shape_cells_equal_reference():
    assert base.SHAPE_CELLS == jbase.SHAPE_CELLS
    assert base.SMOKE_SHAPE == jbase.SMOKE_SHAPE
    assert base.round_up(151936, 256) == jbase.round_up(151936, 256) == 152064


def test_registry():
    """All ten of the reference's configs are registered; only an unknown
    name raises (tests/test_torch_configs.py holds each against the
    reference)."""
    assert registry.list_archs() == jreg.list_archs()
    assert registry.get_arch("qwen2-1.5b") is QWEN2_1_5B
    assert registry.get_arch(SMOKE) == QWEN2_1_5B.reduced()
    assert QWEN2_1_5B.padded_vocab == 152064
    assert registry.get_arch("mamba2-780m").family == "ssm"
    for name in ("phi35-moe", "nope", "nope-smoke"):
        with pytest.raises(KeyError):
            registry.get_arch(name)


def flat_schema(schema, leaves):
    return {path: (spec.shape, spec.axes, spec.scale)
            for path, spec in leaves(schema)}


@pytest.mark.parametrize("name", ["qwen2-1.5b", SMOKE])
def test_schema_equals_reference(name):
    ours = M.schema(registry.get_arch(name))
    theirs = JM.schema(jreg.get_arch(name))
    jleaves = jax.tree_util.tree_flatten_with_path(
        theirs, is_leaf=lambda x: isinstance(x, jcommon.ParamSpec))[0]
    want = {tuple(k.key for k in path): (s.shape, s.axes, s.scale)
            for path, s in jleaves}
    got = flat_schema(ours, common.schema_leaves)
    assert got == want
    assert list(got) == [tuple(k.key for k in p) for p, _ in jleaves]


@pytest.mark.parametrize("seq", [48, 2096])
def test_cache_schema_equals_reference(seq):
    for name in ("qwen2-1.5b", SMOKE):
        ours = M.cache_schema(registry.get_arch(name), 8, seq)
        theirs = JM.cache_schema(jreg.get_arch(name), 8, seq)
        assert {k: (v.shape, v.axes) for k, v in ours.items()} == {
            k: (v.shape, v.axes) for k, v in theirs.items()}


def test_init_cache_matches_reference():
    cfg = registry.get_arch(SMOKE)
    ours = M.init_cache(cfg, 2, 48, device="cpu")
    theirs = JM.init_cache(jreg.get_arch(SMOKE), 2, 48)
    for k in theirs:
        assert tuple(ours[k].shape) == theirs[k].shape
        assert ours[k].dtype == torch.float32 and not ours[k].any()


def test_init_params_follows_schema_scales():
    cfg = registry.get_arch(SMOKE)
    params = M.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    again = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    for path, spec in common.schema_leaves(M.schema(cfg)):
        x = params
        y = again
        for k in path:
            x, y = x[k], y[k]
        assert tuple(x.shape) == spec.shape and x.dtype == torch.float32
        assert torch.equal(x, y), path          # seeded: reproducible
        if spec.scale == "zeros":
            assert not x.any(), path
        elif spec.scale == "ones":
            assert bool((x == 1).all()), path
        else:
            fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
            std = fan_in ** -0.5 if spec.scale == "fan_in" else spec.scale
            assert abs(x.std().item() / std - 1) < 0.05, path


def test_init_params_in_bf16_and_generator_device():
    cfg = dataclasses.replace(registry.get_arch(SMOKE),
                              param_dtype="bfloat16")
    params = M.init_params(cfg, torch.Generator().manual_seed(1),
                           device="cpu")
    assert params["embed"].dtype == torch.bfloat16
    assert params["layers"]["wq"].dtype == torch.bfloat16
    with pytest.raises(ValueError, match="generator"):
        common.init_from_schema(M.schema(cfg), torch.Generator(),
                                torch.float32, device="meta")


# --------------------------------------------------------------------------
# modules
# --------------------------------------------------------------------------

def test_params_from_numpy(smoke):
    cfg, _, params, jparams = smoke
    assert params["layers"]["wq"].shape == (4, 128, 128)
    assert params["layers"]["bk"].shape == (4, 64)
    assert torch.equal(params["embed"], torch.as_tensor(
        np.array(jparams["embed"])))
    bf = jax.tree.map(lambda x: np.asarray(x.astype(jnp.bfloat16)), jparams)
    ported = interop.params_from_numpy(bf, device="cpu")
    assert ported["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(ported["embed"].float().numpy(),
                                  np.asarray(bf["embed"], np.float32))


def test_rmsnorm(rng, smoke):
    x = rng.normal(size=(2, 5, 128)).astype(np.float32)
    w = rng.normal(size=(128,)).astype(np.float32)
    close(common.rmsnorm(torch.as_tensor(x), torch.as_tensor(w)),
          jcommon.rmsnorm(jnp.asarray(x), jnp.asarray(w)))


@pytest.mark.parametrize("pos", ["prefill", "decode"])
def test_apply_rope(rng, pos):
    x = rng.normal(size=(2, 7, 4, 32)).astype(np.float32)
    p = (np.arange(7)[None] if pos == "prefill"
         else np.array([[1000], [2047]]))
    x = x[:, :p.shape[1]]
    close(common.apply_rope(torch.as_tensor(x), torch.as_tensor(p), 1e6),
          jcommon.apply_rope(jnp.asarray(x), jnp.asarray(p), 1e6))


def test_project_qkv(rng, smoke):
    cfg, jcfg, params, jparams = smoke
    lp, jlp = layer0(params, jparams)
    x = rng.normal(size=(2, 5, 128)).astype(np.float32)
    for got, want in zip(attention._project_qkv(cfg, lp, torch.as_tensor(x)),
                         jattn._project_qkv(jcfg, jlp, jnp.asarray(x))):
        assert tuple(got.shape) == want.shape
        close(got, want)


@pytest.mark.parametrize("s", [64, 40], ids=["chunked", "one_block"])
def test_causal_attention(rng, smoke, s):
    """64 tokens: two query blocks of attn_chunk = 32; 40 tokens: not a
    multiple of the chunk, attended in one block."""
    cfg, jcfg, params, jparams = smoke
    lp, jlp = layer0(params, jparams)
    x = rng.normal(size=(2, s, 128)).astype(np.float32)
    out, (k, v) = attention.causal_attention(cfg, lp, torch.as_tensor(x))
    jout, (jk, jv) = jattn.causal_attention(jcfg, jlp, jnp.asarray(x))
    close(out, jout)
    close(k, jk)
    close(v, jv)


def test_decode_attention(rng, smoke):
    cfg, jcfg, params, jparams = smoke
    lp, jlp = layer0(params, jparams)
    x = rng.normal(size=(2, 1, 128)).astype(np.float32)
    kc = rng.normal(size=(2, 48, 2, 32)).astype(np.float32)
    vc = rng.normal(size=(2, 48, 2, 32)).astype(np.float32)
    pos = np.array([5, 30], np.int32)
    k_t, v_t = torch.as_tensor(kc.copy()), torch.as_tensor(vc.copy())
    out, k_new, v_new = attention.decode_attention(
        cfg, lp, torch.as_tensor(x), k_t, v_t, torch.as_tensor(pos))
    jout, jk, jv = jattn.decode_attention(jcfg, jlp, jnp.asarray(x),
                                          jnp.asarray(kc), jnp.asarray(vc),
                                          jnp.asarray(pos))
    assert k_new is k_t and v_new is v_t          # written in place
    close(out, jout)
    close(k_new, jk)
    close(v_new, jv)


def test_mlp_apply(rng, smoke):
    cfg, jcfg, params, jparams = smoke
    lp, jlp = layer0(params, jparams)
    x = rng.normal(size=(2, 3, 128)).astype(np.float32)
    close(mlp.mlp_apply(cfg, lp, torch.as_tensor(x)),
          jmlp.mlp_apply(jcfg, jlp, jnp.asarray(x)))


def test_gelu_mlp(rng):
    """The GELU variant (the reference's tanh approximation)."""
    cfg = dataclasses.replace(registry.get_arch(SMOKE), act="gelu")
    p = {k: rng.normal(size=s.shape).astype(np.float32)
         for k, s in mlp.mlp_schema(cfg).items()}
    x = rng.normal(size=(2, 3, 128)).astype(np.float32)
    close(mlp.mlp_apply(cfg, {k: torch.as_tensor(v) for k, v in p.items()},
                        torch.as_tensor(x)),
          jmlp.mlp_apply(cfg, {k: jnp.asarray(v) for k, v in p.items()},
                         jnp.asarray(x)), 1e-4)


@pytest.mark.parametrize("norm", ["layernorm", "nonparam_ln"])
def test_other_norms(rng, norm):
    cfg = dataclasses.replace(registry.get_arch(SMOKE), norm=norm)
    x = rng.normal(size=(2, 5, 128)).astype(np.float32)
    lp = {"ln_w": rng.normal(size=(128,)).astype(np.float32),
          "ln_b": rng.normal(size=(128,)).astype(np.float32)}
    close(common.apply_norm(cfg, torch.as_tensor(x),
                            {k: torch.as_tensor(v) for k, v in lp.items()},
                            "ln"),
          jcommon.apply_norm(cfg, jnp.asarray(x),
                             {k: jnp.asarray(v) for k, v in lp.items()}, "ln"))


def test_prefill_and_decode_step(smoke, prompts):
    cfg, jcfg, params, jparams = smoke
    logits, cache = M.prefill(cfg, params, {"tokens": torch.as_tensor(prompts)})
    jlogits, jcache = JM.prefill(jcfg, jparams, {"tokens": jnp.asarray(prompts)})
    assert logits.dtype == torch.float32 and logits.shape == (B, 512)
    close(logits, jlogits)
    close(cache["k"], jcache["k"])
    close(cache["v"], jcache["v"])

    pad = MAX - PROMPT
    cache = {k: torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
             for k, v in cache.items()}
    jcache = {k: jnp.pad(v, [(0, 0), (0, 0), (0, pad), (0, 0), (0, 0)])
              for k, v in jcache.items()}
    token = np.array([[7], [300]], np.int32)
    pos = np.full((B,), PROMPT, np.int32)
    logits, cache = M.decode_step(cfg, params, cache, torch.as_tensor(token),
                                  torch.as_tensor(pos))
    jlogits, jcache = JM.decode_step(jcfg, jparams, jcache, jnp.asarray(token),
                                     jnp.asarray(pos))
    close(logits, jlogits)
    close(cache["k"], jcache["k"])
    close(cache["v"], jcache["v"])


# --------------------------------------------------------------------------
# the serving engine, end to end
# --------------------------------------------------------------------------

BACKENDS = {"dense": ("dense", 0), "strap_exact": ("strap", 0),
            "strap_gated_top2": ("strap", 2)}


def engines(smoke, backend, top):
    cfg, jcfg, params, jparams = smoke
    ours = ServeEngine(cfg, params, max_tokens=MAX, cache_backend=backend,
                       strap_cfg=StrapCacheConfig(page_size=8,
                                                  pages_per_strap=2,
                                                  top_straps=top),
                       device="cpu")
    theirs = JEngine(jcfg, jparams, max_tokens=MAX, cache_backend=backend,
                     strap_cfg=JStrapCfg(page_size=8, pages_per_strap=2,
                                         top_straps=top))
    return ours, theirs


@pytest.mark.parametrize("name", sorted(BACKENDS))
def test_generate_matches_reference(smoke, prompts, name):
    """`generate` through the reference's loop: it feeds each returned
    token back into `step`, so every step decodes the first greedy token
    again (ROADMAP.md, queue 3); the port does the same."""
    ours, theirs = engines(smoke, *BACKENDS[name])
    got = ours.generate(prompts, NEW)
    want = np.asarray(theirs.generate(jnp.asarray(prompts), NEW))
    assert got.dtype == torch.int32 and got.shape == (B, NEW)
    np.testing.assert_array_equal(got.numpy(), want)
    assert ours.stats == ServeStats(**dataclasses.asdict(theirs.stats))
    assert ours.stats.traffic_reduction == theirs.stats.traffic_reduction
    close(ours._last_logits, theirs._last_logits)


@pytest.mark.parametrize("name", sorted(BACKENDS))
def test_greedy_decode_matches_reference(smoke, prompts, name):
    """A true greedy loop (`step()` with no token: decode the argmax of the
    last logits): tokens equal at every step, logits within the bar."""
    ours, theirs = engines(smoke, *BACKENDS[name])
    close(ours.prefill(prompts), theirs.prefill(jnp.asarray(prompts)))
    for _ in range(NEW):
        tok, logits = ours.step()
        jtok, jlogits = theirs.step()
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
        close(logits, jlogits)
    assert ours.stats == ServeStats(**dataclasses.asdict(theirs.stats))
    if name == "strap_gated_top2":
        assert ours.stats.traffic_reduction < 0.75


def test_strap_exact_teacher_forced_equals_dense(smoke, prompts):
    """Strap-exact decode fed the dense engine's greedy tokens gives the
    dense engine's logits."""
    dense, _ = engines(smoke, "dense", 0)
    strap, _ = engines(smoke, "strap", 0)
    close(strap.prefill(prompts), dense.prefill(prompts))
    for _ in range(NEW):
        tok, logits = dense.step()
        _, s_logits = strap.step(tok)
        close(s_logits, logits)


@pytest.mark.parametrize("backend", ["dense", "strap"])
def test_bf16_engine_matches_reference(smoke, prompts, backend):
    _, _, _, jparams = smoke
    bf = dict(param_dtype="bfloat16", compute_dtype="bfloat16")
    cfg = dataclasses.replace(registry.get_arch(SMOKE), **bf)
    jcfg = dataclasses.replace(jreg.get_arch(SMOKE), **bf)
    jparams = jax.tree.map(lambda x: x.astype(jnp.bfloat16), jparams)
    params = interop.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                       device="cpu")
    assert params["embed"].dtype == torch.bfloat16
    ours = ServeEngine(cfg, params, max_tokens=MAX, cache_backend=backend,
                       strap_cfg=StrapCacheConfig(8, 2), device="cpu")
    theirs = JEngine(jcfg, jparams, max_tokens=MAX, cache_backend=backend,
                     strap_cfg=JStrapCfg(8, 2))
    close(ours.prefill(prompts), theirs.prefill(jnp.asarray(prompts)), 3e-2)
    for _ in range(NEW):
        jtok, jlogits = theirs.step()
        _, logits = ours.step(np.asarray(jtok))
        close(logits, jlogits, 3e-2)


def test_sampled_step_is_seeded(smoke, prompts):
    runs = []
    for _ in range(2):
        eng, _ = engines(smoke, "strap", 0)
        eng.prefill(prompts)
        gen = torch.Generator().manual_seed(3)
        runs.append(torch.cat([eng.step(greedy=False, generator=gen)[0]
                               for _ in range(4)], 1))
    assert torch.equal(*runs)
    assert runs[0].dtype == torch.int32 and runs[0].shape == (B, 4)


def test_engine_refuses_what_it_cannot_serve(smoke, prompts):
    cfg, _, params, _ = smoke
    with pytest.raises(ValueError, match="cache_backend"):
        ServeEngine(cfg, params, cache_backend="paged", device="cpu")
    # MoE serves on the dense backend only, as in the reference; the vlm
    # family on both (tests/test_torch_families.py)
    moe_cfg = dataclasses.replace(cfg, n_experts=4, family="moe")
    ServeEngine(moe_cfg, params, device="cpu")
    with pytest.raises(ValueError, match="full-attention decoder families"):
        ServeEngine(moe_cfg, params, cache_backend="strap", device="cpu")
    ServeEngine(dataclasses.replace(cfg, family="vlm", n_vision_tokens=8),
                params, cache_backend="strap", device="cpu")
    # the ssm and hybrid families serve on the dense backend only, enc-dec
    # not at all (tests/test_torch_families.py, tests/test_torch_encdec.py)
    ssm_cfg = dataclasses.replace(cfg, family="ssm", ssm_state=16)
    ServeEngine(ssm_cfg, params, device="cpu")
    with pytest.raises(ValueError, match="full-attention decoder families"):
        ServeEngine(ssm_cfg, params, cache_backend="strap", device="cpu")
    with pytest.raises(ValueError, match="enc_embeds"):
        ServeEngine(dataclasses.replace(cfg, is_encdec=True, n_enc_layers=2),
                    params, device="cpu")
    with pytest.raises(ValueError, match="params lie on"):
        ServeEngine(cfg, params, device="meta")
    eng = ServeEngine(cfg, params, max_tokens=PROMPT + 2, device="cpu")
    with pytest.raises(ValueError, match="exceeds max_tokens"):
        eng.prefill(np.zeros((1, PROMPT + 3), np.int32))
    eng.prefill(prompts)
    eng.step()
    eng.step()
    with pytest.raises(ValueError, match="full"):
        eng.step()
