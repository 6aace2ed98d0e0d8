"""One step of the port's `train.step.make_train_step` against the JAX
reference's, on the CPU: loss, grad_norm and every parameter after the
step (the optimizer state too), on dense, MoE, SSM and enc-dec smoke
configs, with microbatch=2, with the global-norm clip engaged, and in
bf16.

The reference's PRNGKey(0) weights are carried across with
`interop.params_from_numpy`; the batch is drawn from a seeded numpy
generator.  Adam's `eps` is 1e-3 here: with the default 1e-8 the first
step is sign(g) wherever |g| > 1e-8, so an element whose gradient is
rounding noise (a key bias's is zero in exact arithmetic: the softmax
cannot see it) moves by +-lr on a coin flip, and the clip's and the
microbatches' scales cancel out of the step.  With eps near the
gradients' size the step follows the clipped gradient.

Bars, float32: loss and grad_norm 2e-5 relative; each parameter leaf
|port - ref| <= 2e-5 * max(max|ref|, lr) (a parameter at zero moves by
about lr; 2e-4 on the SSM config, the reference's SSD bar); each moment
leaf 2e-5 of the largest moment of its tree (a moment of a noise
gradient is noise); AdamW8bit's int8 moments within one step of the
reference's (a float32 moment within rounding of a half step may round
either way), 99% of them equal.  bf16: 3e-2 relative, the port's bf16
bar (tests/test_torch_lm.py).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.models import registry as JM  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402
from repro_torch.train.optimizer import OptConfig  # noqa: E402
from repro_torch.tree import leaves_with_paths, unflatten  # noqa: E402

OC = OptConfig(lr=1e-3, eps=1e-3, warmup_steps=1, total_steps=10)
B, S = 4, 64
QWEN = "qwen2-1.5b-smoke"

CASES = {
    "dense": (QWEN, {}, None),
    "moe": ("phi3.5-moe-42b-a6.6b-smoke", {}, None),
    "ssm": ("mamba2-780m-smoke", {}, None),
    "encdec": ("whisper-tiny-smoke", {}, None),
    "microbatch2": (QWEN, {}, 2),
    "adamw8bit": (QWEN, {"optimizer": "adamw8bit"}, None),
}


def close(got, want, tol, floor=1e-30):
    """|got - want| <= tol * max(max|want|, floor)."""
    if isinstance(got, torch.Tensor):
        got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(float(np.abs(want).max()),
                                              floor))


def max_abs(tree) -> float:
    return max(float(np.abs(np.asarray(x, np.float32)).max())
               for _, x in leaves_with_paths(tree))


def setup(name, change):
    jcfg = dataclasses.replace(jreg.get_arch(name), **change)
    cfg = dataclasses.replace(registry.get_arch(name), **change)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    params = interop.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                       device="cpu")
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    if cfg.is_encdec:
        batch["enc_embeds"] = rng.normal(
            size=(B, 32, cfg.d_model)).astype(np.float32)
    return cfg, jcfg, params, jparams, batch


def both_steps(cfg, jcfg, params, jparams, batch, microbatch=None):
    """(reference (params, opt, metrics), port (params, opt, metrics)),
    each after one step from the same weights."""
    jfn, jopt = jstep.make_train_step(jcfg, OC, microbatch)
    jout = jax.jit(jfn)(jparams, jopt.init(jparams),
                        {k: jnp.asarray(v) for k, v in batch.items()})
    fn, opt = tstep.make_train_step(cfg, OC, microbatch)
    out = fn(params, opt.init(params),
             {k: torch.as_tensor(v) for k, v in batch.items()})
    return jax.tree.map(np.asarray, jout), out


@pytest.mark.parametrize("label", sorted(CASES))
def test_one_step_matches_reference(label):
    name, change, microbatch = CASES[label]
    cfg, jcfg, params, jparams, batch = setup(name, change)
    before = [p.clone() for _, p in leaves_with_paths(params)]
    (jp, jo, jm), (p, o, m) = both_steps(cfg, jcfg, params, jparams, batch,
                                         microbatch)
    tol = 2e-4 if cfg.family in ("ssm", "hybrid") else 2e-5
    close(m["loss"], jm["loss"], 2e-5)
    close(m["grad_norm"], jm["grad_norm"], 2e-5)
    # the clip engaged (grad_norm > 1) on every case at these weights
    assert float(jm["grad_norm"]) > 1
    jflat = leaves_with_paths({"opt": jo, "params": jp})
    flat = leaves_with_paths({"opt": o, "params": p})
    assert [k for k, _ in jflat] == [k for k, _ in flat]
    for (path, want), (_, got) in zip(jflat, flat):
        assert str(got.dtype).removeprefix("torch.") == str(want.dtype), path
        if path[0] == "params":
            close(got, want, tol, floor=OC.lr)
        elif path[-1] == "q":
            diff = np.abs(got.numpy().astype(np.int32) - want)
            assert diff.max() <= 1 and diff.mean() <= 1e-2, path
        elif path[1] in ("m", "v"):
            scale = max_abs({k: v for k, v in leaves_with_paths(jo[path[1]])
                             if k[-1] != "q"})
            close(got, want, tol, floor=scale)
    assert int(o["count"]) == int(jo["count"]) == 1
    # every parameter moved, and the returned tree is the updated one
    for (path, got), old in zip(leaves_with_paths(p), before):
        assert not torch.equal(got.detach(), old), path


def test_bf16_step_clips_in_float32(monkeypatch):
    """bf16 weights: the optimizer gets float32 gradients, each the bf16
    gradient cast to float32 times the clip (the reference's dtype: a
    bf16 array times its float32 clip is float32), holding bits a bf16
    product would drop.  Loss, grad_norm and the clipped gradients
    against the reference's at the bf16 bar (the gradients against the
    largest of the tree: a bias's small bf16 gradient carries the
    backward's rounding at the whole gradient's scale); the parameters
    after the
    step against the reference's AdamW given the port's clipped
    gradients, within one bf16 ulp of the leaf's largest value."""
    from repro.train import optimizer as jopt

    change = {"param_dtype": "bfloat16", "compute_dtype": "bfloat16"}
    cfg, jcfg, params, jparams, batch = setup(QWEN, change)
    seen = []
    real = tstep.make_optimizer

    def recording(name, oc):
        opt = real(name, oc)

        def update(grads, state, ps):
            seen.append([g.clone() for _, g in leaves_with_paths(grads)])
            return opt.update(grads, state, ps)
        return opt._replace(update=update)

    monkeypatch.setattr(tstep, "make_optimizer", recording)
    fn, opt = tstep.make_train_step(cfg, OC)
    p, _, m = fn(params, opt.init(params),
                 {k: torch.as_tensor(v) for k, v in batch.items()})
    clipped = seen[0]
    assert all(g.dtype == torch.float32 for g in clipped)
    mantissa = torch.cat([g.flatten() for g in clipped]).view(torch.int32)
    assert bool((mantissa & 0xFFFF).ne(0).any())

    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    @jax.jit
    def reference(ps):
        loss, g = jax.value_and_grad(lambda q: JM.loss_fn(jcfg, q, jb))(ps)
        gnorm = jnp.sqrt(sum(jnp.sum(jnp.square(x.astype(jnp.float32)))
                             for x in jax.tree.leaves(g)))
        clip = jnp.minimum(1.0, 1.0 / (gnorm + 1e-6))
        return loss, gnorm, jax.tree.map(lambda x: x * clip, g)

    jloss, jgnorm, jclipped = reference(jparams)
    assert float(jgnorm) > 1
    close(m["loss"], jloss, 3e-2)
    close(m["grad_norm"], jgnorm, 3e-2)
    scale = max_abs(jclipped)
    for (path, want), got in zip(leaves_with_paths(jclipped), clipped):
        assert want.dtype == jnp.float32, path
        close(got, np.asarray(want), 3e-2, floor=scale)
    grads = jax.tree.map(lambda g: jnp.asarray(g.numpy()),
                         unflatten(params, clipped))
    want, _ = jopt.adamw_update(OC, grads, jopt.adamw_init(jparams), jparams)
    for (path, w), (_, got) in zip(leaves_with_paths(want),
                                   leaves_with_paths(p)):
        assert got.dtype == torch.bfloat16, path
        close(got, np.asarray(w, np.float32), 2 ** -8, floor=OC.lr)
