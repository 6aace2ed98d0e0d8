"""The port's optimizers (`train/optimizer.py`) against a numpy AdamW
(the cases of tests/test_optimizer.py) and against the JAX reference's
`adamw_update` / `adamw8_update`, `lr_schedule`, `_q8` and `_dq8`, on the
CPU.

Bars: rtol 2e-5 / atol 2e-6 (tests/test_optimizer.py's), for parameters
and moments; the 8-bit moments' cosine to AdamW's > 0.999; `_q8` / `_dq8`
exactly equal to the reference's (the same int8 values and the same
float32 scales, round half to even).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.train import optimizer as jopt  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train.optimizer import (OptConfig, lr_schedule,  # noqa: E402
                                         make_optimizer)
from repro_torch.tree import leaves_with_paths  # noqa: E402

RTOL, ATOL = 2e-5, 2e-6


def numpy_adamw(oc, params, grads, steps):
    m = {k: np.zeros_like(v) for k, v in params.items()}
    v_ = {k: np.zeros_like(v) for k, v in params.items()}
    p = {k: v.copy() for k, v in params.items()}
    for t in range(1, steps + 1):
        warm = min(t / oc.warmup_steps, 1.0)
        prog = min(max((t - oc.warmup_steps)
                       / max(oc.total_steps - oc.warmup_steps, 1), 0), 1)
        lr = oc.lr * warm * (oc.min_lr_ratio + (1 - oc.min_lr_ratio)
                             * 0.5 * (1 + np.cos(np.pi * prog)))
        for k in p:
            g = grads[k]
            m[k] = oc.b1 * m[k] + (1 - oc.b1) * g
            v_[k] = oc.b2 * v_[k] + (1 - oc.b2) * g * g
            mhat = m[k] / (1 - oc.b1 ** t)
            vhat = v_[k] / (1 - oc.b2 ** t)
            p[k] -= lr * (mhat / (np.sqrt(vhat) + oc.eps)
                          + oc.weight_decay * p[k])
    return p


def tensors(tree):
    return {k: torch.tensor(v) for k, v in tree.items()}


def test_adamw_matches_numpy_reference(rng):
    oc = OptConfig(lr=1e-2, warmup_steps=2, total_steps=10)
    params = {"a": rng.normal(size=(4, 8)).astype(np.float32),
              "b": rng.normal(size=(8,)).astype(np.float32)}
    grads = {k: rng.normal(size=v.shape).astype(np.float32)
             for k, v in params.items()}
    opt = make_optimizer("adamw", oc)
    tp, tg = tensors(params), tensors(grads)
    state = opt.init(tp)
    for _ in range(5):
        tp, state = opt.update(tg, state, tp)
    want = numpy_adamw(oc, params, grads, 5)
    for k in params:
        np.testing.assert_allclose(tp[k].numpy(), want[k], rtol=RTOL,
                                   atol=ATOL)


def test_schedule_shape():
    oc = OptConfig(lr=1.0, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    lrs = [float(lr_schedule(oc, torch.tensor(s))) for s in
           [1, 5, 10, 50, 100]]
    assert lrs[0] < lrs[1] < lrs[2]          # warmup
    assert lrs[2] > lrs[3] > lrs[4]          # decay
    assert abs(lrs[4] - 0.1) < 1e-3          # floor


@pytest.mark.parametrize("oc", [
    OptConfig(lr=3e-4, warmup_steps=2, total_steps=12),
    OptConfig(lr=1.0, warmup_steps=10, total_steps=100, min_lr_ratio=0.1),
    OptConfig(lr=6e-4, warmup_steps=0, total_steps=1)],
    ids=["olmo_phase", "test_optimizer", "no_warmup"])
def test_lr_schedule_matches_reference(oc):
    """Every step from 0 to past the end, in float32."""
    steps = np.arange(0, oc.total_steps + 5, dtype=np.int32)
    want = np.asarray(jopt.lr_schedule(oc, jnp.asarray(steps)))
    got = lr_schedule(oc, torch.as_tensor(steps))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


def test_adamw8bit_tracks_fp32_adamw(rng):
    oc = OptConfig(lr=1e-2, warmup_steps=1, total_steps=50, weight_decay=0.0)
    params = {"w": rng.normal(size=(16, 64)).astype(np.float32)}
    opt32, opt8 = make_optimizer("adamw", oc), make_optimizer("adamw8bit", oc)
    p32, p8 = tensors(params), tensors(params)
    s32, s8 = opt32.init(p32), opt8.init(p8)
    for _ in range(10):
        g = {"w": torch.as_tensor(
            rng.normal(size=params["w"].shape).astype(np.float32))}
        p32, s32 = opt32.update(g, s32, p32)
        p8, s8 = opt8.update(g, s8, p8)
    a, b = p32["w"].numpy(), p8["w"].numpy()
    cos = (a * b).sum() / (np.linalg.norm(a) * np.linalg.norm(b))
    assert cos > 0.999
    assert np.abs(a - b).max() < 0.05


def test_adamw8bit_state_is_int8(rng):
    opt8 = make_optimizer("adamw8bit", OptConfig())
    p = {"w": torch.as_tensor(rng.normal(size=(8, 32)).astype(np.float32))}
    s = opt8.init(p)
    for moment in ("m", "v"):
        assert s[moment]["w"]["q"].dtype == torch.int8
        assert s[moment]["w"]["s"].dtype == torch.float32
        assert s[moment]["w"]["s"].shape == (8, 1)
    assert s["count"].dtype == torch.int32 and s["count"].shape == ()
    # 4x memory saving vs fp32 moments (excluding scales)
    bytes8 = s["m"]["w"]["q"].numel() + s["m"]["w"]["s"].numel() * 4
    assert bytes8 < 0.3 * (p["w"].numel() * 4)


def _tree(rng):
    return {"embed": rng.normal(size=(16, 32)).astype(np.float32),
            "layers": {"w": rng.normal(size=(2, 32, 24)).astype(np.float32),
                       "b": np.zeros((2, 24), np.float32)},
            "norm_w": np.ones((32,), np.float32)}


@pytest.mark.parametrize("name", ["adamw", "adamw8bit"])
def test_update_matches_reference_over_five_steps(rng, name):
    """Five updates on shared gradients (one set per step): parameters,
    moments and count against the reference's, with the same state
    tree."""
    oc = OptConfig(lr=1e-2, warmup_steps=2, total_steps=10)
    params = _tree(rng)
    grads = [jax.tree.map(lambda a: rng.normal(size=a.shape).astype(
        np.float32) * 0.1, params) for _ in range(5)]
    jo, to = jopt.make_optimizer(name, oc), make_optimizer(name, oc)
    jp = jax.tree.map(jnp.asarray, params)
    tp = jax.tree.map(torch.tensor, params)
    js, ts = jo.init(jp), to.init(tp)
    for g in grads:
        jp, js = jo.update(jax.tree.map(jnp.asarray, g), js, jp)
        tp, ts = to.update(jax.tree.map(torch.as_tensor, g), ts, tp)
    jflat = leaves_with_paths(jax.tree.map(np.asarray, {"p": jp, "s": js}))
    tflat = leaves_with_paths({"p": tp, "s": ts})
    assert [p for p, _ in jflat] == [p for p, _ in tflat]
    for (path, want), (_, got) in zip(jflat, tflat):
        assert str(got.dtype).removeprefix("torch.") == str(want.dtype), path
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL,
                                   err_msg=str(path))


def q8_inputs(rng):
    x = rng.normal(size=(6, 33)).astype(np.float32) * 3
    x[1] = 0.0                                  # an all-zero row
    x[2, :] = np.linspace(-1, 1, 33, dtype=np.float32)
    # row max 127: the scale is 1.0 (1e-12 is below its half ulp), so
    # k + 0.5 are exact halves, which round half to even decides
    x[3, :] = np.float32(127.0)
    x[3, :6] = np.arange(6, dtype=np.float32) + np.float32(0.5)
    x[4] = rng.normal(size=33).astype(np.float32) * 1e-20   # tiny scale
    return x


def test_q8_and_dq8_equal_reference_exactly(rng):
    for x in (q8_inputs(rng), rng.normal(size=(3, 4, 64)).astype(np.float32),
              np.abs(rng.normal(size=(5, 128))).astype(np.float32) * 1e-3):
        jq, js = jopt._q8(jnp.asarray(x))
        q, s = topt._q8(torch.as_tensor(x))
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(s.numpy().view(np.int32),
                                      np.asarray(js).view(np.int32))
        np.testing.assert_array_equal(
            topt._dq8(q, s).numpy().view(np.int32),
            np.asarray(jopt._dq8(jq, js)).view(np.int32))


def test_adamw8bit_steps_by_m_over_eps_where_v_quantizes_to_zero():
    """The reference's AdamW8bit quantizes each row of v to int8 against
    the row's max: an element whose v falls below half a step becomes 0
    while its m, quantized against m's own row max, stays nonzero.  A
    later step then divides that m by eps alone.  Both packages take the
    same step of ~2e3 here (lr 1e-3): the 8-bit optimizer's instability,
    pinned (ROADMAP queue 3; on the H100 it spikes OLMo-1B's loss)."""
    oc = OptConfig(lr=1e-3, warmup_steps=1, total_steps=10, weight_decay=0.0)
    g1 = np.asarray([[1.0, 0.05, 0.0, 0.0]], np.float32)
    g2 = np.asarray([[1.0, 0.0, 0.0, 0.0]], np.float32)
    p0 = np.zeros((1, 4), np.float32)
    jo, to = jopt.make_optimizer("adamw8bit", oc), make_optimizer(
        "adamw8bit", oc)
    jp, tp = {"w": jnp.asarray(p0)}, {"w": torch.tensor(p0)}
    js, ts = jo.init(jp), to.init(tp)
    for g in (g1, g2):
        jp, js = jo.update({"w": jnp.asarray(g)}, js, jp)
        tp, ts = to.update({"w": torch.as_tensor(g)}, ts, tp)
    assert ts["m"]["w"]["q"][0, 1] != 0 and ts["v"]["w"]["q"][0, 1] == 0
    np.testing.assert_allclose(tp["w"].numpy(), np.asarray(jp["w"]),
                               rtol=RTOL, atol=ATOL)
    assert abs(float(tp["w"][0, 1])) > 1e3
