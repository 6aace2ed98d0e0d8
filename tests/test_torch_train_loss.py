"""The port's training forward (`models.{lm,encdec,registry}.forward_train`
and `loss_fn`, `models.common.cross_entropy`) against the JAX reference,
on the CPU, for all ten smoke configs.

The reference's PRNGKey(0) weights are carried across with
`interop.params_from_numpy`; the batch is drawn from a seeded numpy
generator (a Pixtral batch with its vision embeddings, a Whisper batch
with its encoder frames).  The reference's loss and gradients come from
`jax.jit(jax.value_and_grad(M.loss_fn))`, the port's from autograd.
Bar: |port - ref| <= 2e-5 * max|ref| per leaf (logits, aux, loss, every
gradient), 2e-4 on the ssm and hybrid configs (the reference's SSD bar,
tests/test_models.py).  `remat` on and off give the same bits.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import registry as JM  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.models import registry as M  # noqa: E402
from repro_torch.tree import leaves, leaves_with_paths  # noqa: E402

NAMES = [n + "-smoke" for n in registry.list_archs()]
B, S, S_ENC = 2, 64, 32


def tol_of(cfg):
    return 2e-4 if cfg.family in ("ssm", "hybrid") else 2e-5


def close(got, want, tol):
    if isinstance(got, torch.Tensor):
        got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(float(np.abs(want).max()),
                                              1e-30))


def make_batch(cfg, seed=0, vision=True):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    if cfg.n_vision_tokens and vision:
        batch["vision_embeds"] = rng.normal(
            size=(B, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32)
    if cfg.is_encdec:
        batch["enc_embeds"] = rng.normal(
            size=(B, S_ENC, cfg.d_model)).astype(np.float32)
    return batch


_CASES = {}


def case(name, vision=True):
    """(cfg, params, batch, reference results): the reference's forward,
    loss and gradients, computed once per case."""
    key = (name, vision)
    if key not in _CASES:
        jcfg, cfg = jreg.get_arch(name), registry.get_arch(name)
        jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
        params = interop.params_from_numpy(
            jax.tree.map(np.asarray, jparams), device="cpu")
        batch = make_batch(cfg, vision=vision)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}

        @jax.jit
        def ref(p):
            logits, aux = JM.forward_train(jcfg, p, jb)
            loss, grads = jax.value_and_grad(
                lambda q: JM.loss_fn(jcfg, q, jb))(p)
            return logits, aux, loss, grads

        out = jax.tree.map(np.asarray, ref(jparams))
        _CASES[key] = (cfg, params, batch, out)
    return _CASES[key]


def port_loss_and_grads(cfg, params, batch):
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    ps = leaves(params)
    for p in ps:
        p.requires_grad_(True)
    loss = M.loss_fn(cfg, params, tb)
    return loss.detach(), torch.autograd.grad(loss, ps)


@pytest.mark.parametrize("name", NAMES)
def test_forward_train_matches_reference(name):
    cfg, params, batch, (jlogits, jaux, _, _) = case(name)
    with torch.no_grad():
        logits, aux = M.forward_train(
            cfg, params, {k: torch.as_tensor(v) for k, v in batch.items()})
    assert logits.dtype == aux.dtype == torch.float32
    assert aux.shape == ()
    close(logits, jlogits, tol_of(cfg))
    if cfg.n_experts:
        assert float(jaux) > 0
        close(aux, jaux, 2e-5)
    else:
        assert float(aux) == float(jaux) == 0.0


@pytest.mark.parametrize("name", NAMES)
def test_loss_and_every_gradient_match_reference(name):
    cfg, params, batch, (_, _, jloss, jgrads) = case(name)
    loss, grads = port_loss_and_grads(cfg, params, batch)
    close(loss, jloss, 2e-5)
    flat = leaves_with_paths(jgrads)
    assert len(flat) == len(grads)
    for (path, jg), g in zip(flat, grads):
        assert g.dtype == torch.float32, path
        close(g, jg, tol_of(cfg))


def test_pixtral_loss_without_vision_matches_reference():
    """A VLM batch with no `vision_embeds`: no rows are cut."""
    cfg, params, batch, (jlogits, _, jloss, jgrads) = case(
        "pixtral-12b-smoke", vision=False)
    assert jlogits.shape[1] == S
    loss, grads = port_loss_and_grads(cfg, params, batch)
    close(loss, jloss, 2e-5)
    for (path, jg), g in zip(leaves_with_paths(jgrads), grads):
        close(g, jg, 2e-5)


@pytest.mark.parametrize("name", NAMES)
def test_remat_changes_no_bit(name):
    """`cfg.remat` (recompute each layer body in the backward) gives the
    same loss and gradients, bit for bit, as keeping the activations."""
    cfg, params, batch, _ = case(name)
    assert cfg.remat
    on = port_loss_and_grads(cfg, params, batch)
    off = port_loss_and_grads(dataclasses.replace(cfg, remat=False), params,
                              batch)
    assert torch.equal(on[0], off[0])
    assert all(torch.equal(a, b) for a, b in zip(on[1], off[1]))


@pytest.mark.parametrize("name", ["phi3.5-moe-42b-a6.6b-smoke",
                                  "arctic-480b-smoke"])
def test_moe_aux_is_summed_over_layers(name):
    """The MoE aux loss is the reference's sum over layers (each layer's
    Switch loss, about 1 at a uniform router, so the sum is near
    n_layers), and the loss adds 0.01 of it to the cross entropy."""
    cfg, params, batch, (jlogits, jaux, jloss, _) = case(name)
    assert 0.5 * cfg.n_layers < float(jaux) < 2 * cfg.n_layers
    with torch.no_grad():
        tb = {k: torch.as_tensor(v) for k, v in batch.items()}
        logits, aux = M.forward_train(cfg, params, tb)
        loss = M.loss_fn(cfg, params, tb)
    close(aux, jaux, 2e-5)
    ce = jcommon.cross_entropy(jnp.asarray(jlogits),
                               jnp.asarray(batch["targets"]),
                               cfg.padded_vocab)
    close(loss, float(ce) + 0.01 * float(jaux), 2e-5)


def test_cross_entropy_matches_reference(rng):
    """Float32 logsumexp over every column (the padded tail included)
    minus the gold logit, mean over tokens; bf16 logits too."""
    from repro_torch.models.common import cross_entropy

    logits = rng.normal(size=(3, 5, 64)).astype(np.float32) * 4
    targets = rng.integers(0, 50, (3, 5)).astype(np.int32)
    want = jcommon.cross_entropy(jnp.asarray(logits), jnp.asarray(targets),
                                 50)
    got = cross_entropy(torch.as_tensor(logits), torch.as_tensor(targets), 50)
    assert got.dtype == torch.float32
    close(got, want, 1e-6)
    jb = jnp.asarray(logits, jnp.bfloat16)
    tb = torch.as_tensor(logits).to(torch.bfloat16)
    close(cross_entropy(tb, torch.as_tensor(targets), 50),
          jcommon.cross_entropy(jb, jnp.asarray(targets), 50), 1e-6)
