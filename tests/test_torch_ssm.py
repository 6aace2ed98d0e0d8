"""The port's Mamba2 mixer (`models/ssm.py`) against the JAX reference, on
the CPU.

Every input is drawn from a seeded numpy generator; the reference's
weights are carried across with `interop.params_from_numpy`.  Bars:
- port vs reference in float32: |port - ref| <= 2e-5 * max|ref| (the same
  products summed in another order; measured ~2e-6);
- the chunked scan vs a float64 per-token recurrence: rtol / atol 2e-4,
  the reference's own bar (tests/test_models.py, `TestSSD`);
- the split projection layout vs the fused one: rtol / atol 1e-4, the
  reference's own bar (tests/test_perf_features.py);
- bf16 (the full configs' dtypes): rtol / atol 3e-2, the port's bf16 bar
  (tests/test_torch_lm.py).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.models import registry as JM  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.models import lm, ssm  # noqa: E402
from repro_torch.models import registry as M  # noqa: E402

TOL = 2e-5
MAMBA = "mamba2-780m-smoke"


def close(got, want, tol=TOL):
    """|got - want| <= tol * max|want|."""
    if isinstance(got, torch.Tensor):
        got = got.float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * float(np.abs(want).max()))


def cfgs(**change):
    return (dataclasses.replace(registry.get_arch(MAMBA), **change),
            dataclasses.replace(jreg.get_arch(MAMBA), **change))


def ssd_inputs(rng, b, l, nh, hp, ng, st):
    """The reference test's draw (tests/test_models.py, `TestSSD`), with
    `ng` B/C groups."""
    x = rng.normal(size=(b, l, nh, hp)).astype(np.float32)
    bm = rng.normal(size=(b, l, ng, st)).astype(np.float32) * 0.5
    cm = rng.normal(size=(b, l, ng, st)).astype(np.float32) * 0.5
    dt = np.abs(rng.normal(size=(b, l, nh))).astype(np.float32) * 0.1
    a_neg = -np.abs(rng.normal(size=(nh,))).astype(np.float32)
    return x, bm, cm, dt, a_neg


def recurrence(x, bmat, cmat, dt, a_neg, h0=None):
    """Token-by-token SSD in float64 (the reference test's recurrence, with
    head h reading B/C group h // (nh // ng))."""
    b, l, nh, hp = x.shape
    rep = nh // bmat.shape[2]
    x, bmat, cmat, dt = (np.asarray(a, np.float64) for a in (x, bmat, cmat, dt))
    bh = np.repeat(bmat, rep, axis=2)
    ch = np.repeat(cmat, rep, axis=2)
    h = (np.zeros((b, nh, hp, bmat.shape[-1])) if h0 is None
         else np.asarray(h0, np.float64))
    ys = []
    for t in range(l):
        da = np.exp(dt[:, t] * a_neg[None, :])
        dtx = x[:, t] * dt[:, t][..., None]
        h = h * da[..., None, None] + np.einsum("bhp,bhn->bhpn", dtx, bh[:, t])
        ys.append(np.einsum("bhpn,bhn->bhp", h, ch[:, t]))
    return np.stack(ys, 1), h


# --------------------------------------------------------------------------
# the chunked scan
# --------------------------------------------------------------------------

@pytest.mark.parametrize("l,chunk,want", [(2047, 256, 89), (2048, 256, 256),
                                          (45, 32, 15), (37, 32, 1)])
def test_chunk_is_the_largest_divisor_below_ssm_chunk(l, chunk, want):
    cfg, _ = cfgs(ssm_chunk=chunk)
    assert ssm.chunk_size(cfg, l) == want


SSD_CASES = {"even": (64, False), "ragged": (45, False), "h0": (64, True)}


@pytest.mark.parametrize("case", sorted(SSD_CASES))
@pytest.mark.parametrize("ng", [1, 2])
def test_ssd_chunked_matches_reference(rng, ng, case):
    """Two chunks of 32; a length of 45 (chunks of 15); a given h0."""
    l, with_h0 = SSD_CASES[case]
    cfg, jcfg = cfgs()
    x, bm, cm, dt, a_neg = ssd_inputs(rng, 2, l, 4, 8, ng, cfg.ssm_state)
    h0 = (rng.normal(size=(2, 4, 8, cfg.ssm_state)).astype(np.float32)
          if with_h0 else None)
    y, h = ssm.ssd_chunked(cfg, *map(torch.as_tensor, (x, bm, cm, dt, a_neg)),
                           None if h0 is None else torch.as_tensor(h0))
    jy, jh = jssm.ssd_chunked(jcfg, *map(jnp.asarray, (x, bm, cm, dt, a_neg)),
                              None if h0 is None else jnp.asarray(h0))
    assert y.dtype == h.dtype == torch.float32
    close(y, jy)
    close(h, jh)


@pytest.mark.parametrize("ng", [1, 2])
def test_ssd_chunked_equals_recurrence(rng, ng):
    cfg, _ = cfgs()
    x, bm, cm, dt, a_neg = ssd_inputs(rng, 2, 64, 4, 8, ng, cfg.ssm_state)
    h0 = rng.normal(size=(2, 4, 8, cfg.ssm_state)).astype(np.float32)
    y, h = ssm.ssd_chunked(cfg, *map(torch.as_tensor, (x, bm, cm, dt, a_neg)),
                           torch.as_tensor(h0))
    y_ref, h_ref = recurrence(x, bm, cm, dt, a_neg, h0)
    np.testing.assert_allclose(y.numpy(), y_ref, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(h.numpy(), h_ref, rtol=2e-4, atol=2e-4)


def test_ssd_state_carries_across_calls(rng):
    """ssd(x) == ssd(x2 | the state from x1): the reference's claim."""
    cfg, _ = cfgs()
    x, bm, cm, dt, a_neg = (torch.as_tensor(a) for a in ssd_inputs(
        rng, 1, 64, 4, 8, 1, cfg.ssm_state))
    y_full, h_full = ssm.ssd_chunked(cfg, x, bm, cm, dt, a_neg)
    y1, h1 = ssm.ssd_chunked(cfg, x[:, :32], bm[:, :32], cm[:, :32],
                             dt[:, :32], a_neg)
    y2, h2 = ssm.ssd_chunked(cfg, x[:, 32:], bm[:, 32:], cm[:, 32:],
                             dt[:, 32:], a_neg, h1)
    np.testing.assert_allclose(y_full[:, 32:].numpy(), y2.numpy(), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(h_full.numpy(), h2.numpy(), rtol=2e-4,
                               atol=2e-4)


# --------------------------------------------------------------------------
# the scan's backward
# --------------------------------------------------------------------------

SSD_GRAD_ARGS = ("x", "bmat", "cmat", "dt", "a_neg", "h0")


@pytest.mark.parametrize("with_h0", [False, True], ids=["zero_h0", "h0"])
@pytest.mark.parametrize("ng", [1, 2])
def test_ssd_chunked_gradients_match_reference(rng, ng, with_h0):
    """d/d(x, B, C, dt, A[, h0]) of sum(y * wy) + sum(h * wh) against
    `jax.grad` of the reference's `ssd_chunked`: 2e-4 of max|ref| per
    input (the reference's SSD bar)."""
    cfg, jcfg = cfgs()
    inputs = list(ssd_inputs(rng, 2, 64, 4, 8, ng, cfg.ssm_state))
    inputs.append(rng.normal(size=(2, 4, 8, cfg.ssm_state)).astype(
        np.float32) if with_h0 else None)
    wy = rng.normal(size=(2, 64, 4, 8)).astype(np.float32)
    wh = rng.normal(size=(2, 4, 8, cfg.ssm_state)).astype(np.float32)
    n = len(inputs) if with_h0 else len(inputs) - 1

    def jloss(*args):
        y, h = jssm.ssd_chunked(jcfg, *args[:5], args[5] if with_h0 else None)
        return jnp.sum(y * wy) + jnp.sum(h * wh)

    jgrads = jax.grad(jloss, argnums=tuple(range(n)))(
        *(jnp.asarray(a) for a in inputs[:n]))
    ts = [torch.tensor(a, requires_grad=True) for a in inputs[:n]]
    y, h = ssm.ssd_chunked(cfg, *ts[:5], ts[5] if with_h0 else None)
    loss = (y * torch.as_tensor(wy)).sum() + (h * torch.as_tensor(wh)).sum()
    grads = torch.autograd.grad(loss, ts)
    for name, g, jg in zip(SSD_GRAD_ARGS, grads, jgrads):
        assert g.shape == jg.shape, name
        close(g, jg, tol=2e-4)


def test_ssd_chunked_gradients_match_float64(rng):
    """The float32 scan's gradients against the same function run in
    float64 (2e-4 of max|float64| per input)."""
    cfg, _ = cfgs()
    inputs = ssd_inputs(rng, 2, 64, 4, 8, 2, cfg.ssm_state)
    wy = torch.as_tensor(rng.normal(size=(2, 64, 4, 8)))

    def grads(dtype):
        ts = [torch.tensor(a, dtype=dtype, requires_grad=True)
              for a in inputs]
        y, _ = ssm.ssd_chunked(cfg, *ts)
        assert y.dtype == dtype
        return torch.autograd.grad((y * wy.to(dtype)).sum(), ts)

    for g32, g64 in zip(grads(torch.float32), grads(torch.float64)):
        close(g32, g64.numpy(), tol=2e-4)


def test_ssd_backward_stays_finite_where_the_decay_overflows(rng):
    """Chunks of 64 whose decay sums reach ~300: exp(cs[q] - cs[s])
    overflows float32 in the masked upper triangle.  The port's gradients
    stay finite and match its float64 run (2e-4 of max|float64|), and its
    output keeps the no_grad path's bits; the reference's gradient with
    respect to dt is not finite there (0 * inf in the backward of its
    masked exp; ROADMAP queue 3), which this pins."""
    cfg, jcfg = cfgs(ssm_chunk=64)
    x, bm, cm, _, _ = ssd_inputs(rng, 2, 128, 4, 8, 1, cfg.ssm_state)
    dt = (np.abs(rng.normal(size=(2, 128, 4))) * 2 + 0.5).astype(np.float32)
    a_neg = -(np.abs(rng.normal(size=(4,))) + 1).astype(np.float32)
    inputs = (x, bm, cm, dt, a_neg)
    assert float((dt[:, :64] * -a_neg).sum(1).max()) > 89   # exp overflows

    def grads(dtype):
        ts = [torch.tensor(a, dtype=dtype, requires_grad=True)
              for a in inputs]
        y, _ = ssm.ssd_chunked(cfg, *ts)
        return y, torch.autograd.grad(y.sum(), ts)

    y32, g32 = grads(torch.float32)
    with torch.no_grad():
        served, _ = ssm.ssd_chunked(cfg, *map(torch.as_tensor, inputs))
    assert torch.equal(y32.detach(), served)
    for g, g64 in zip(g32, grads(torch.float64)[1]):
        assert torch.isfinite(g).all()
        close(g, g64.numpy(), tol=2e-4)
    jdt = jax.grad(lambda d: jnp.sum(jssm.ssd_chunked(
        jcfg, *map(jnp.asarray, (x, bm, cm)), d, jnp.asarray(a_neg))[0]))(
            jnp.asarray(dt))
    assert not np.isfinite(np.asarray(jdt)).all()


@pytest.mark.parametrize("name", [MAMBA, "zamba2-7b-smoke"])
def test_prefill_backpropagates_and_no_grad_keeps_its_bits(name):
    """`M.prefill` with every parameter requiring grad backpropagates
    (the decay is built out of place under autograd), gives the same
    logits bit for bit as the in-place path under no_grad, and every
    parameter of the SSM layers gets a finite gradient."""
    cfg = registry.get_arch(name)
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 64)))
    with torch.no_grad():
        served, _ = M.prefill(cfg, params, {"tokens": tokens})
    leaves = [v for group in ("layers", "trailing") if group in params
              for v in params[group].values()]
    for v in leaves:
        v.requires_grad_(True)
    logits, _ = M.prefill(cfg, params, {"tokens": tokens})
    assert torch.equal(logits.detach(), served)
    grads = torch.autograd.grad(logits.square().sum(), leaves)
    assert all(torch.isfinite(g).all() for g in grads)
    assert all(g.abs().sum() > 0 for g in grads)


# --------------------------------------------------------------------------
# the mixer
# --------------------------------------------------------------------------

def split_layer(cfg, lp):
    """Fused layer weights re-partitioned into the split layout (the
    reference test's `_split_params`): the same linear map."""
    di, gs = cfg.d_inner, cfg.ssm_ngroups * cfg.ssm_state
    w, cw, cb = lp["in_proj"], lp["conv_w"], lp["conv_b"]
    out = {k: v for k, v in lp.items()
           if k not in ("in_proj", "conv_w", "conv_b")}
    out.update(in_z=w[..., :di], in_x=w[..., di:2 * di],
               in_B=w[..., 2 * di:2 * di + gs],
               in_C=w[..., 2 * di + gs:2 * di + 2 * gs],
               in_dt=w[..., 2 * di + 2 * gs:],
               conv_x_w=cw[..., :di], conv_x_b=cb[..., :di],
               conv_B_w=cw[..., di:di + gs], conv_B_b=cb[..., di:di + gs],
               conv_C_w=cw[..., di + gs:], conv_C_b=cb[..., di + gs:])
    return out


@pytest.fixture(scope="module")
def mixer():
    """(cfg, jcfg, port layer-0 weights, reference layer-0 weights) in the
    fused layout, then in the split one, from the reference's init."""
    out = {}
    for layout, split in (("fused", False), ("split", True)):
        cfg, jcfg = cfgs(ssm_split_proj=split)
        jp = JM.init_params(jcfg, jax.random.PRNGKey(3))
        jlp = jax.tree.map(lambda a: a[0], jp["layers"])
        # the norm weight and dt bias drawn off their init, so they count
        draw = np.random.default_rng(7)
        jlp = dict(jlp, ssm_norm_w=jnp.asarray(
            1 + 0.1 * draw.normal(size=jlp["ssm_norm_w"].shape), jnp.float32),
            dt_bias=jnp.asarray(draw.normal(size=jlp["dt_bias"].shape),
                                jnp.float32))
        lp = interop.params_from_numpy(jax.tree.map(np.asarray, jlp),
                                       device="cpu")
        out[layout] = (cfg, jcfg, lp, jlp)
    return out


def state_inputs(rng, cfg, b):
    nh, hp, st = cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state
    conv_dim = cfg.d_inner + 2 * cfg.ssm_ngroups * st
    h0 = rng.normal(size=(b, nh, hp, st)).astype(np.float32) * 0.1
    conv0 = rng.normal(size=(b, cfg.conv_kernel - 1, conv_dim)).astype(
        np.float32)
    return h0, conv0


@pytest.mark.parametrize("state", ["none", "state_in", "state_out"])
@pytest.mark.parametrize("layout", ["fused", "split"])
def test_ssm_apply_matches_reference(rng, mixer, layout, state):
    cfg, jcfg, lp, jlp = mixer[layout]
    x = rng.normal(size=(2, 45, cfg.d_model)).astype(np.float32)
    h0 = conv0 = None
    if state == "state_in":
        h0, conv0 = state_inputs(rng, cfg, 2)
    want_state = state != "none"
    got = ssm.ssm_apply(cfg, lp, torch.as_tensor(x),
                        None if h0 is None else torch.as_tensor(h0),
                        None if conv0 is None else torch.as_tensor(conv0),
                        return_state=want_state)
    want = jssm.ssm_apply(jcfg, jlp, jnp.asarray(x),
                          None if h0 is None else jnp.asarray(h0),
                          None if conv0 is None else jnp.asarray(conv0),
                          return_state=want_state)
    if not want_state:
        got, want = (got,), (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        close(g, w)


@pytest.mark.parametrize("layout", ["fused", "split"])
def test_ssm_decode_step_matches_reference(rng, mixer, layout):
    cfg, jcfg, lp, jlp = mixer[layout]
    h0, conv0 = state_inputs(rng, cfg, 2)
    x = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
    got = ssm.ssm_decode_step(cfg, lp, torch.as_tensor(x), torch.as_tensor(h0),
                              torch.as_tensor(conv0))
    want = jssm.ssm_decode_step(jcfg, jlp, jnp.asarray(x), jnp.asarray(h0),
                                jnp.asarray(conv0))
    assert got[1].dtype == torch.float32
    for g, w in zip(got, want):
        close(g, w)


def test_decode_continues_the_prefill(rng, mixer):
    """A mixer over L + 1 tokens ends where the mixer over L tokens and one
    decode step from its state end."""
    cfg, _, lp, _ = mixer["fused"]
    x = torch.as_tensor(rng.normal(size=(2, 33, cfg.d_model)).astype(
        np.float32))
    full = ssm.ssm_apply(cfg, lp, x)
    _, h, conv = ssm.ssm_apply(cfg, lp, x[:, :32], return_state=True)
    out, _, _ = ssm.ssm_decode_step(cfg, lp, x[:, 32:], h, conv)
    np.testing.assert_allclose(out.numpy(), full[:, 32:].numpy(), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("layout", ["fused", "split"])
def test_bf16_mixer_matches_reference(rng, mixer, layout):
    """The full configs' dtypes: bf16 weights and stream, the state and
    the scan in float32, the conv tail in bf16."""
    cfg, jcfg, lp, jlp = mixer[layout]
    lp = {k: v.to(torch.bfloat16) for k, v in lp.items()}
    jlp = {k: v.astype(jnp.bfloat16) for k, v in jlp.items()}
    x = rng.normal(size=(2, 40, cfg.d_model)).astype(np.float32)
    xb = torch.as_tensor(x).to(torch.bfloat16)
    out, h, conv = ssm.ssm_apply(cfg, lp, xb, return_state=True)
    jout, jh, jconv = jssm.ssm_apply(jcfg, jlp, jnp.asarray(x, jnp.bfloat16),
                                     return_state=True)
    assert (out.dtype, h.dtype, conv.dtype) == (torch.bfloat16, torch.float32,
                                                torch.bfloat16)
    for g, w in ((out, jout), (h, jh), (conv, jconv)):
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w, np.float32),
                                   rtol=3e-2, atol=3e-2)
    step = ssm.ssm_decode_step(cfg, lp, xb[:, :1], h, conv)
    jstep = jssm.ssm_decode_step(jcfg, jlp, jnp.asarray(x[:, :1], jnp.bfloat16),
                                 jh, jconv)
    assert (step[1].dtype, step[2].dtype) == (torch.float32, torch.bfloat16)
    for g, w in zip(step, jstep):
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w, np.float32),
                                   rtol=3e-2, atol=3e-2)


def test_split_layout_model_equals_fused(rng):
    """mamba2-smoke with `ssm_split_proj` and the same weights
    re-partitioned: prefill logits and a decode step equal the fused
    layout's within the reference's 1e-4."""
    cfg = registry.get_arch(MAMBA)
    cfg_s = dataclasses.replace(cfg, ssm_split_proj=True)
    params = M.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    params_s = dict(params, layers=split_layer(cfg, params["layers"]))
    assert set(params_s["layers"]) == set(lm.lm_schema(cfg_s)["layers"])
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 33)),
                           dtype=torch.int32)
    l0, c0 = M.prefill(cfg, params, {"tokens": toks[:, :32]})
    l1, c1 = M.prefill(cfg_s, params_s, {"tokens": toks[:, :32]})
    np.testing.assert_allclose(l0.numpy(), l1.numpy(), rtol=1e-4, atol=1e-4)
    pos = torch.full((2,), 32, dtype=torch.int32)
    d0, _ = M.decode_step(cfg, params, c0, toks[:, 32:], pos)
    d1, _ = M.decode_step(cfg_s, params_s, c1, toks[:, 32:], pos)
    np.testing.assert_allclose(d0.numpy(), d1.numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("split", [False, True], ids=["fused", "split"])
def test_schema_equals_reference(split):
    for name in (MAMBA, "zamba2-7b-smoke", "mamba2-780m", "zamba2-7b"):
        cfg = dataclasses.replace(registry.get_arch(name),
                                  ssm_split_proj=split)
        jcfg = dataclasses.replace(jreg.get_arch(name), ssm_split_proj=split)
        ours = ssm.ssm_schema(cfg, 3)
        theirs = jssm.ssm_schema(jcfg, 3)
        assert {k: (v.shape, v.axes, v.scale) for k, v in ours.items()} == {
            k: (v.shape, v.axes, v.scale) for k, v in theirs.items()}
