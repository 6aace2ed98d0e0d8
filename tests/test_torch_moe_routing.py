"""The mesh-global `moe_apply` routes each rank's own tokens, against the
JAX reference's `moe_apply` on the whole batch.

One spawned gloo group of four CPU processes (`torch_dist_children.
moe_routing_group`) builds two meshes in turn: (2, 2, 1) ("pod" 2 x
"data" 2, the batch laid out pod-major) and (1, 4, 1).  Each rank holds
one row of x (4, 16, D) and routes its 16 tokens; the per-expert counts
of every dp rank give each pair its global position, so the global
capacity, the global drops and the reference's dropped-pair writes hold
(`src/repro/models/moe.py:65-82`).  This process runs the reference on
the whole batch.  Layer 0 of the reference's `PRNGKey(0)` weights of
phi-smoke (4 experts, top 2), float32.

- "cf1": x from numpy's generator at capacity_factor 1.0 (cap 32 of 128
  pairs, 8 slots a dp rank);
- "skew": capacity_factor 0.9375, so cap 30, which 4 does not divide (8
  slots a rank, the last two never filled); the 64 tokens drawn from a
  seeded pool by the reference's own routing: row 0's pairs avoid
  experts 0 and 3, row 1 holds 8 tokens that choose expert 0 and 8
  that choose expert 3, rows 2 and 3 choose expert 3 only.  Expert 3
  then overflows (40 pairs) and both dropped-pair writes land on ranks
  other than 0: expert 0's global slot 0 on dp rank 1 (gate 0.0), expert
  3's slot cap - 1 on dp rank 3 (adds nothing).

Each: every rank's rows and aux, the gradients of sum(y * wy) + aux
(each rank's loss adds aux / dp) with respect to its rows of x and,
summed over the ranks, every weight, within 2e-5 of max|ref|; the pairs
dropped equal to the reference's (and > 0); the pairs the ranks' slot
tables kept (`torch_dist_children.kept_pairs`, summed over the ranks)
equal to those the reference computes: each expert's first cap, less
the last expert's slot cap - 1 where it overflows; two all-to-alls
forward and two backward on each of the mesh's dp axes.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import registry as JM  # noqa: E402
from repro_torch.launch.group import run_group  # noqa: E402

TESTS = Path(__file__).resolve().parent
SHAPES = ((2, 2, 1), (1, 4, 1))
B, S = 4, 16
PHI = "phi3.5-moe-42b-a6.6b-smoke"
CASES = (("cf1", PHI, 1.0), ("skew", PHI, 0.9375))
BAR = 2e-5
MOE_KEYS = ("router", "we_gate", "we_up", "we_down")


def config(cf):
    return dataclasses.replace(jreg.get_arch(PHI), capacity_factor=cf)


def _routing(lp, x):
    """The reference's top-k experts of the tokens x (N, D)."""
    logits = x.astype(np.float32) @ lp["router"]
    return np.asarray(jax.lax.top_k(jax.nn.softmax(jnp.asarray(logits)),
                                    2)[1])


def skew_tokens(cfg, lp):
    """x (4, 16, D): tokens of a seeded pool picked by their experts
    (see the module docstring)."""
    pool = (np.random.default_rng(5).normal(size=(4000, cfg.d_model))
            * 0.1).astype(np.float32)
    top = _routing(lp, pool)
    has = [np.any(top == j, axis=1) for j in range(cfg.n_experts)]
    avoid = np.flatnonzero(~has[0] & ~has[3])
    zero = np.flatnonzero(has[0] & ~has[3])
    three = np.flatnonzero(has[3] & ~has[0])
    rows = [avoid[:16], np.concatenate([zero[:8], three[:8]]),
            three[8:24], three[24:40]]
    return np.stack([pool[r] for r in rows])


def case_inputs(label, cf):
    cfg = config(cf)
    params = JM.init_params(cfg, jax.random.PRNGKey(0))
    lp = {k: np.asarray(v[0], np.float32)
          for k, v in params["layers"].items() if k in MOE_KEYS}
    if label == "skew":
        x = skew_tokens(cfg, lp)
    else:
        x = (np.random.default_rng(0).normal(size=(B, S, cfg.d_model))
             * 0.1).astype(np.float32)
    wy = np.random.default_rng(1).normal(size=(B, S, cfg.d_model)).astype(
        np.float32)
    return cfg, lp, x, wy


def reference(cfg, lp, x, wy):
    """(y, aux, grads of sum(y * wy) + aux, pairs dropped)."""
    def obj(x_, lp_):
        y, aux = jmoe.moe_apply(cfg, lp_, x_)
        return jnp.sum(y * wy) + aux, (y, aux)

    (_, (y, aux)), grads = jax.jit(jax.value_and_grad(
        obj, argnums=(0, 1), has_aux=True))(jnp.asarray(x), lp)
    t = x.shape[0] * x.shape[1]
    cap = jmoe._capacity(cfg, t)
    counts = np.bincount(_routing(lp, x.reshape(t, -1)).reshape(-1),
                         minlength=cfg.n_experts)
    return (np.asarray(y), float(aux),
            jax.tree.map(np.asarray, {"x": grads[0], **grads[1]}),
            int(np.maximum(counts - cap, 0).sum()), counts, cap)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe_routing")
    inputs, arrays, refs = {}, {}, {}
    for label, _, cf in CASES:
        cfg, lp, x, wy = case_inputs(label, cf)
        inputs[label] = (cfg, lp, x, wy)
        arrays.update({f"{label}/p/{k}": v for k, v in lp.items()})
        arrays[f"{label}/x"] = x
        arrays[f"{label}/wy"] = wy
        refs[label] = reference(cfg, lp, x, wy)
    np.savez(tmp / "weights.npz", **arrays)
    results = run_group(
        "torch_dist_children:moe_routing_group", 4,
        dict(shapes=SHAPES, cases=CASES, weights=str(tmp / "weights.npz"),
             out_dir=str(tmp)), timeout_s=240, pythonpath=[TESTS])
    return tmp, inputs, refs, results


def close(got, want, tol):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * float(np.abs(want).max()))


def test_skew_case_puts_both_dropped_pair_writes_off_rank_0(run):
    """The reference's routing of the "skew" batch: expert 0's first pair
    on row 1, expert 3's pair at global position cap - 1 on row 3, and
    expert 3 over capacity."""
    _, inputs, refs, _ = run
    cfg, lp, x, _ = inputs["skew"]
    cap = refs["skew"][5]
    assert cap == 30 and cap % 4
    top = _routing(lp, x.reshape(B * S, -1)).reshape(B, S * 2)
    per_row = [np.bincount(r, minlength=cfg.n_experts) for r in top]
    assert per_row[0][0] == 0 and per_row[0][3] == 0 and per_row[1][0] > 0
    three = np.cumsum([r[3] for r in per_row])
    assert three[-1] > cap and three[2] < cap <= three[3]


@pytest.mark.parametrize("label", [c[0] for c in CASES])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_rank_local_routing_matches_reference_on_whole_batch(run, shape,
                                                             label):
    tmp, inputs, refs, results = run
    lp = inputs[label][1]
    y_ref, aux_ref, g_ref, dropped, counts, cap = refs[label]
    tag = "x".join(map(str, shape))
    n_axes = sum(1 for n in shape[:2] if n > 1)
    total, kept = {}, 0
    for res in results:
        info = res["runs"][f"{tag}/{label}"]
        i = info["dp_index"]
        got = np.load(tmp / f"{tag}-{label}-rank{res['rank']}.npz")
        close(got["y"], y_ref[i:i + 1], BAR)
        close(got["grad/x"], g_ref["x"][i:i + 1], BAR)
        assert abs(info["aux"] - aux_ref) <= BAR * abs(aux_ref)
        assert info["dropped"] == dropped > 0
        assert info["all_to_all"] == 4 * n_axes
        assert len(info["kept"]) == 1
        kept += info["kept"][0]
        for k in lp:
            total[k] = total.get(k, 0) + got[f"grad/{k}"]
    assert sorted(r["runs"][f"{tag}/{label}"]["dp_index"]
                  for r in results) == [0, 1, 2, 3]
    assert kept == (np.minimum(counts, cap).sum()
                    - int(counts[-1] > cap))
    for k in lp:
        close(total[k], g_ref[k], BAR)
