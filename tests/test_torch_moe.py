"""The port's MoE layer (`models/moe.py`) against the JAX reference, on the
CPU.

The reference's weights are carried across with
`interop.params_from_numpy`.  Bars: rtol / atol 2e-5 in float32
(tests/test_torch_lm.py's TOL: the same products summed in another
order); the schema equal leaf by leaf.

The forced-drop cases run `capacity_factor=1.0` with one expert's router
logit raised by 4 (input feature 0 set to 1, the router's row 0 zero but
4 at that expert), so 64 of the 256 (token, expert) pairs drop.  They pin
the reference's dropped-pair writes (ROADMAP.md, queue 3) with the
reference's own outputs: expert 0's first pair adds nothing whenever a
pair drops, and the last expert's last kept pair adds nothing when that
expert overflows.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import registry as JM  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.models import common, moe  # noqa: E402

TOL = 2e-5
PHI, ARCTIC = "phi3.5-moe-42b-a6.6b-smoke", "arctic-480b-smoke"


@pytest.fixture(scope="module", params=[PHI, ARCTIC])
def layer(request):
    """(port cfg, reference cfg, port layer-0 params, reference's)."""
    name = request.param
    jcfg = jreg.get_arch(name)
    jlp = jax.tree.map(lambda x: x[0],
                       JM.init_params(jcfg, jax.random.PRNGKey(0))["layers"])
    lp = interop.params_from_numpy(jax.tree.map(np.asarray, jlp),
                                   device="cpu")
    return registry.get_arch(name), jcfg, lp, jlp


def close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("name", [PHI, ARCTIC, PHI.removesuffix("-smoke"),
                                  ARCTIC.removesuffix("-smoke")])
def test_moe_schema_equals_reference(name):
    cfg, jcfg = registry.get_arch(name), jreg.get_arch(name)
    for layers in (None, 3):
        ours = moe.moe_schema(cfg, layers)
        theirs = jmoe.moe_schema(jcfg, layers)
        assert list(ours) == list(theirs)
        assert {k: (v.shape, v.axes, v.scale) for k, v in ours.items()} == {
            k: (v.shape, v.axes, v.scale) for k, v in theirs.items()}
    assert ("res_w_gate" in ours) == cfg.moe_dense_residual


@pytest.mark.parametrize("tokens", [1, 2, 7, 128, 4096, 32768])
def test_capacity_equals_reference(tokens):
    for name in (PHI, ARCTIC, "phi3.5-moe-42b-a6.6b", "arctic-480b"):
        assert moe._capacity(registry.get_arch(name), tokens) == \
            jmoe._capacity(jreg.get_arch(name), tokens)


@pytest.mark.parametrize("shape", [(2, 64), (2, 1), (3, 5)],
                         ids=["prefill", "decode", "ragged"])
def test_moe_apply_matches_reference(rng, layer, shape):
    cfg, jcfg, lp, jlp = layer
    x = rng.normal(size=shape + (cfg.d_model,)).astype(np.float32)
    y, aux = moe.moe_apply(cfg, lp, torch.as_tensor(x))
    jy, jaux = jmoe.moe_apply(jcfg, jlp, jnp.asarray(x))
    assert y.shape == x.shape and y.dtype == torch.float32
    close(y, jy)
    close(aux, jaux)
    yp, info = moe.moe_apply_pairs(cfg, lp, torch.as_tensor(x))
    close(yp, jy)
    assert info["dropped"] == 0          # smoke capacity_factor 4.0


def biased(cfg, jcfg, lp, jlp, x, expert):
    """capacity_factor 1.0 and `expert`'s router logit raised by 4."""
    change = dict(capacity_factor=1.0)
    cfg, jcfg = (dataclasses.replace(c, **change) for c in (cfg, jcfg))
    x = x.copy()
    x[..., 0] = 1.0
    router = np.array(jlp["router"])
    router[0] = 0.0
    router[0, expert] = 4.0
    return (cfg, jcfg, dict(lp, router=torch.as_tensor(router)),
            dict(jlp, router=jnp.asarray(router)), x)


def pair_table(jcfg, jlp, x):
    """From the reference's own routing: each (token, slot) pair's expert,
    its position within its expert (token-major order) and its gated
    expert output, in float64."""
    e, k = jcfg.n_experts, jcfg.top_k
    xf = x.reshape(-1, x.shape[-1])
    probs = jax.nn.softmax(jnp.asarray(xf) @ jlp["router"], axis=-1)
    gates, experts = jax.lax.top_k(probs, k)
    gates = np.asarray(gates / gates.sum(-1, keepdims=True), np.float64)
    experts = np.asarray(experts)
    pos = np.zeros_like(experts)
    seen = np.zeros(e, int)
    for t in range(len(xf)):
        for s in range(k):
            pos[t, s] = seen[experts[t, s]]
            seen[experts[t, s]] += 1
    w = {n: np.asarray(jlp[n], np.float64) for n in ("we_gate", "we_up",
                                                     "we_down")}
    out = np.zeros(experts.shape + (x.shape[-1],))
    for t in range(len(xf)):
        for s in range(k):
            j = experts[t, s]
            g = xf[t] @ w["we_gate"][j]
            h = g / (1 + np.exp(-g)) * (xf[t] @ w["we_up"][j])
            out[t, s] = gates[t, s] * (h @ w["we_down"][j])
    return experts, pos, seen, out


@pytest.mark.parametrize("expert", [0, 3], ids=["expert0_biased",
                                                "last_expert_biased"])
def test_forced_drops_pin_the_reference_quirk(rng, expert):
    """64 of 256 pairs drop.  The reference's output is the kept pairs'
    sum except that expert 0's first pair adds nothing (its gate slot 0
    was overwritten with 0) and, when the last expert overflows, its last
    kept pair adds nothing (its token slot E*cap-1 was overwritten with
    the dummy).  The port and the per-pair plain version give it."""
    jcfg0 = jreg.get_arch(PHI)
    jlp = jax.tree.map(lambda a: a[0], JM.init_params(
        jcfg0, jax.random.PRNGKey(0))["layers"])
    lp = interop.params_from_numpy(jax.tree.map(np.asarray, jlp),
                                   device="cpu")
    x = rng.normal(size=(2, 64, 128)).astype(np.float32)
    cfg, jcfg, lp, jlp, x = biased(registry.get_arch(PHI), jcfg0, lp, jlp,
                                   x, expert)
    cap = jmoe._capacity(jcfg, 128)
    assert cap == 64
    jy, jaux = jmoe.moe_apply(jcfg, jlp, jnp.asarray(x))
    experts, pos, counts, contrib = pair_table(jcfg, jlp, x)
    assert counts[expert] == 128 and (counts > cap).sum() == 1
    kept = pos < cap
    assert (~kept).sum() == 64
    first0 = (experts == 0) & (pos == 0)
    last = (experts == 3) & (pos == cap - 1)
    quirk = first0 | (last if counts[3] > cap else np.zeros_like(last))
    assert quirk.sum() == (2 if expert == 3 else 1)
    want = (contrib * (kept & ~quirk)[..., None]).sum(1).reshape(x.shape)
    jy = np.asarray(jy)
    close(jy, want)
    # the skipped pairs were not negligible: with them the rows differ
    for t, s in zip(*np.nonzero(quirk)):
        b, i = divmod(t, 64)
        assert np.abs(contrib[t, s]).max() > 1e-2
        assert np.abs(jy[b, i] - (want[b, i] + contrib[t, s])).max() > 1e-2
    y, aux = moe.moe_apply(cfg, lp, torch.as_tensor(x))
    close(y, jy)
    close(aux, jaux)
    yp, info = moe.moe_apply_pairs(cfg, lp, torch.as_tensor(x))
    close(yp, jy)
    assert info == {"pairs": 256, "dropped": 64, "capacity": 64}


@pytest.mark.parametrize("expert", [0, 3])
def test_forced_drops_arctic_with_dense_residual(rng, expert):
    """Arctic-smoke (4 experts and the dense residual) with drops: the
    port, the per-pair version and the reference agree."""
    jcfg = jreg.get_arch(ARCTIC)
    jlp = jax.tree.map(lambda a: a[0], JM.init_params(
        jcfg, jax.random.PRNGKey(1))["layers"])
    lp = interop.params_from_numpy(jax.tree.map(np.asarray, jlp),
                                   device="cpu")
    x = rng.normal(size=(2, 64, 128)).astype(np.float32)
    cfg, jcfg, lp, jlp, x = biased(registry.get_arch(ARCTIC), jcfg, lp, jlp,
                                   x, expert)
    jy, jaux = jmoe.moe_apply(jcfg, jlp, jnp.asarray(x))
    y, aux = moe.moe_apply(cfg, lp, torch.as_tensor(x))
    close(y, jy)
    close(aux, jaux)
    yp, info = moe.moe_apply_pairs(cfg, lp, torch.as_tensor(x))
    close(yp, jy)
    assert info["dropped"] == 64


def test_moe_apply_bf16_matches_reference(rng, layer):
    """bf16 weights and activations (the full configs' dtypes): within the
    port's bf16 bar, 3e-2 (tests/test_torch_lm.py)."""
    cfg, jcfg, lp, jlp = layer
    jlp = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jlp)
    lp = interop.params_from_numpy(jax.tree.map(np.asarray, jlp),
                                   device="cpu")
    x = rng.normal(size=(2, 16, cfg.d_model)).astype(np.float32)
    y, _ = moe.moe_apply(cfg, lp, torch.as_tensor(x).bfloat16())
    jy, _ = jmoe.moe_apply(jcfg, jlp, jnp.asarray(x).astype(jnp.bfloat16))
    assert y.dtype == torch.bfloat16
    close(y.float(), np.asarray(jy.astype(jnp.float32)), 3e-2)


def test_moe_init_follows_schema(layer):
    cfg = layer[0]
    params = common.init_from_schema(moe.moe_schema(cfg, 2),
                                     torch.Generator().manual_seed(0),
                                     torch.float32, device="cpu")
    assert params["we_gate"].shape == (2, 4, 128, 256)
    assert params["router"].shape == (2, 128, 4)


def test_moe_apply_refuses_top_k_above_two(rng, layer):
    """Three or more terms onto one token could sum in any order under
    CUDA's atomic index_add_, so `moe_apply` refuses top_k > 2 rather
    than drift from run to run."""
    cfg, _, lp, _ = layer
    x = torch.as_tensor(rng.normal(size=(1, 8, cfg.d_model))
                        .astype(np.float32))
    with pytest.raises(ValueError, match="top_k=3"):
        moe.moe_apply(dataclasses.replace(cfg, top_k=3), lp, x)
