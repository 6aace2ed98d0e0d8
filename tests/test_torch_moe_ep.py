"""The port's MoE under a mesh against the JAX reference: one spawned
gloo group of four CPU processes at mesh (1, 2, 2) ("data" 2 x "model"
2) runs `moe_apply_ep` and the mesh-global `moe_apply` on each rank's
batch shard (`torch_dist_children.moe_group`); this process runs the
reference's `moe_apply` on the same numbers.

Layer 0 of the reference's `PRNGKey(0)` weights in float32, x (4, 32, D)
x 0.1 and the output weights wy from numpy's generators.  Rank (d, m)
holds batch rows [2d, 2d + 2); `moe_apply_ep` routes its sequence slice
[16m, 16m + 16) alone.

- `moe_apply_ep` against the reference's `moe_apply` on each (batch,
  sequence) shard, 2e-5 of max|ref|: phi-smoke at capacity_factor 4.0
  and at 1.0 (pairs dropped per rank and expert), arctic-smoke with its
  dense residual in full;
- EP == baseline: against the reference's `moe_apply` over the whole
  batch within 2e-4 (the reference's own bar,
  tests/test_perf_features.py), on phi and on Arctic;
- the aux loss pinned to the reference's: the mean over the dp ranks of
  the "model" coordinate-0 shard's local aux;
- the mesh-global `moe_apply` against the reference's on the whole batch
  (rows, aux): each rank routes its own tokens at the global capacity
  (phi_cf1 drops pairs across the ranks) and exchanges the slots;
- gradients of sum(y * wy) (plus the aux for `moe_apply`) with respect
  to x and every weight against `jax.grad`, 2e-5 of max|ref|;
- both paths again given the rank's "model" blocks of `we_*` and
  `res_w_*` (as the sharded steps give them): rows, aux and every
  gradient, each rank's block gradient against that block of the
  reference's;
- the EP path ran its all-to-alls (it did not fall back), the global
  path its two slot exchanges over "data" and no all-gather of the
  tokens (one of the per-expert counts).

The slow test at the end pins the reference's own deviation on Arctic
(its EP adds 1/ep of the dense residual) on 8 forced host devices.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import registry as JM  # noqa: E402
from repro_torch.configs.registry import get_arch as tget_arch  # noqa: E402
from repro_torch.launch.group import run_group  # noqa: E402
from repro_torch.models.moe import moe_apply_pairs  # noqa: E402

TESTS = Path(__file__).resolve().parent
SRC = str(TESTS.parent / "src")
SHAPE = (1, 2, 2)
B, S = 4, 32
PHI = "phi3.5-moe-42b-a6.6b-smoke"
ARCTIC = "arctic-480b-smoke"
CASES = (("phi", PHI, 4.0), ("phi_cf1", PHI, 1.0), ("arctic", ARCTIC, 4.0))
BAR = 2e-5
EP_BASELINE_BAR = 2e-4
MOE_KEYS = ("router", "we_gate", "we_up", "we_down", "res_w_gate",
            "res_w_up", "res_w_down")


def config(arch, cf):
    return dataclasses.replace(jreg.get_arch(arch), capacity_factor=cf)


def case_inputs(arch, cf):
    cfg = config(arch, cf)
    params = JM.init_params(cfg, jax.random.PRNGKey(0))
    lp = {k: np.asarray(v[0], np.float32)
          for k, v in params["layers"].items() if k in MOE_KEYS}
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(B, S, cfg.d_model)) * 0.1).astype(np.float32)
    wy = np.random.default_rng(1).normal(
        size=(B, S, cfg.d_model)).astype(np.float32)
    return cfg, lp, x, wy


def reference(cfg, lp, x, wy, aux_w):
    """(y, aux, grad of sum(y * wy) + aux_w * aux w.r.t. (x, lp))."""
    def obj(x_, lp_):
        y, aux = jmoe.moe_apply(cfg, lp_, x_)
        return jnp.sum(y * wy) + aux_w * aux, (y, aux)

    (_, (y, aux)), grads = jax.jit(jax.value_and_grad(
        obj, argnums=(0, 1), has_aux=True))(jnp.asarray(x), lp)
    return (np.asarray(y), float(aux),
            jax.tree.map(np.asarray, {"x": grads[0], **grads[1]}))


def shards(x):
    """{(d, m): x's batch block d, sequence block m}."""
    nb, ns = B // SHAPE[1], S // SHAPE[2]
    return {(d, m): x[d * nb:(d + 1) * nb, m * ns:(m + 1) * ns]
            for d in range(SHAPE[1]) for m in range(SHAPE[2])}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe_ep")
    inputs, arrays = {}, {}
    for label, arch, cf in CASES:
        cfg, lp, x, wy = case_inputs(arch, cf)
        inputs[label] = (cfg, lp, x, wy)
        arrays.update({f"{label}/p/{k}": v for k, v in lp.items()})
        arrays[f"{label}/x"] = x
        arrays[f"{label}/wy"] = wy
    np.savez(tmp / "weights.npz", **arrays)
    refs = {}
    for label, (cfg, lp, x, wy) in inputs.items():
        xs, ws = shards(x), shards(wy)
        refs[label] = {"shards": {k: reference(cfg, lp, xs[k], ws[k], 0.0)
                                  for k in xs},
                       "global": reference(cfg, lp, x, wy, 1.0)}
    results = run_group(
        "torch_dist_children:moe_group", int(np.prod(SHAPE)),
        dict(shape=SHAPE, cases=CASES, weights=str(tmp / "weights.npz"),
             out_dir=str(tmp)), timeout_s=240, pythonpath=[TESTS])
    ranks = {}
    for res in results:
        c = res["coords"]
        ranks[(c["data"], c["model"])] = res
    return tmp, inputs, refs, ranks


def port(tmp, label, rank):
    return np.load(tmp / f"{label}-rank{rank}.npz")


def close(got, want, tol):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * float(np.abs(want).max()))


@pytest.mark.parametrize("label", [c[0] for c in CASES])
def test_ep_matches_reference_moe_on_each_local_shard(run, label):
    tmp, inputs, refs, ranks = run
    cfg, lp, x, wy = inputs[label]
    xs = shards(x)
    ref = refs[label]["shards"]
    for (d, m), res in ranks.items():
        got = port(tmp, label, res["rank"])["ep/y"]
        want = np.concatenate([ref[(d, j)][0] for j in range(SHAPE[2])], 1)
        close(got, want, BAR)
    # capacity per rank and expert: at 1.0 the shards drop pairs
    tcfg = dataclasses.replace(tget_arch(cfg.name), capacity_factor=
                               cfg.capacity_factor)
    tp = {k: torch.as_tensor(np.array(v)) for k, v in lp.items()}
    dropped = sum(moe_apply_pairs(tcfg, tp, torch.as_tensor(xs[k]))[1][
        "dropped"] for k in xs)
    assert (dropped > 0) == (label == "phi_cf1")


@pytest.mark.parametrize("label", ["phi", "arctic"])
def test_ep_equals_baseline_with_the_residual_in_full(run, label):
    tmp, inputs, refs, ranks = run
    cfg = inputs[label][0]
    y_ref = refs[label]["global"][0]
    nb = B // SHAPE[1]
    got = np.concatenate([port(tmp, label, ranks[(d, 0)]["rank"])["ep/y"]
                          for d in range(SHAPE[1])])
    assert np.abs(got - y_ref).max() < EP_BASELINE_BAR
    assert got.shape == (nb * SHAPE[1], S, cfg.d_model)


@pytest.mark.parametrize("label", [c[0] for c in CASES])
def test_ep_aux_is_the_dp_mean_of_model_coordinate_zero(run, label):
    _, _, refs, ranks = run
    want = np.mean([refs[label]["shards"][(d, 0)][1]
                    for d in range(SHAPE[1])])
    for res in ranks.values():
        got = res["cases"][label]["ep"]["aux"]
        assert abs(got - want) <= BAR * abs(want)


@pytest.mark.parametrize("label", [c[0] for c in CASES])
def test_mesh_global_moe_matches_reference_on_whole_batch(run, label):
    tmp, _, refs, ranks = run
    y_ref, aux_ref, _ = refs[label]["global"]
    nb = B // SHAPE[1]
    for (d, m), res in ranks.items():
        close(port(tmp, label, res["rank"])["global/y"],
              y_ref[d * nb:(d + 1) * nb], BAR)
        assert abs(res["cases"][label]["global"]["aux"] - aux_ref) \
            <= BAR * abs(aux_ref)


@pytest.mark.parametrize("label", [c[0] for c in CASES])
def test_ep_gradients_match_jax_grad_per_shard(run, label):
    tmp, inputs, refs, ranks = run
    lp = inputs[label][1]
    ref = {k: r[2] for k, r in refs[label]["shards"].items()}
    total = {}
    for d in range(SHAPE[1]):
        models_ = [port(tmp, label, ranks[(d, m)]["rank"])
                   for m in range(SHAPE[2])]
        want_x = np.concatenate([ref[(d, j)]["x"] for j in range(SHAPE[2])],
                                1)
        for got in models_:
            close(got["ep/grad/x"], want_x, BAR)
        for k in lp:
            g = models_[0][f"ep/grad/{k}"]
            for other in models_[1:]:           # the same on every "model"
                np.testing.assert_array_equal(other[f"ep/grad/{k}"], g)
            total[k] = total.get(k, 0) + g
    for k in lp:
        close(total[k], sum(r[k] for r in ref.values()), BAR)


@pytest.mark.parametrize("label", [c[0] for c in CASES])
def test_mesh_global_gradients_match_jax_grad(run, label):
    tmp, inputs, refs, ranks = run
    lp = inputs[label][1]
    ref = refs[label]["global"][2]
    nb = B // SHAPE[1]
    total = {}
    for d in range(SHAPE[1]):
        got = port(tmp, label, ranks[(d, 0)]["rank"])
        close(got["global/grad/x"], ref["x"][d * nb:(d + 1) * nb], BAR)
        for k in lp:
            total[k] = total.get(k, 0) + got[f"global/grad/{k}"]
    for k in lp:
        close(total[k], ref[k], BAR)


def test_ep_ran_its_all_to_alls_and_global_none(run):
    """Forward one all-to-all each way, backward one each way, on both
    paths (the global path's over "data", its one dp axis).  The global
    path gathers only the per-expert counts (E int64 a dp rank), never
    the tokens."""
    _, inputs, _, ranks = run
    for res in ranks.values():
        for label, info in res["cases"].items():
            e = inputs[label][0].n_experts
            for name in ("ep", "ep_block"):
                assert info[name]["all_to_all"] == 4
            for name in ("global", "global_block"):
                assert info[name]["all_to_all"] == 4
                assert info[name]["all_gather"] == 1
                assert info[name]["all_gather_bytes"] == SHAPE[1] * e * 8


BLOCK_DIM = {"we_gate": 0, "we_up": 0, "we_down": 0, "res_w_gate": 1,
             "res_w_up": 1, "res_w_down": 0}


def block(a, k, m):
    """Block m over the "model" axis of the weight (gradient) `a` of leaf
    `k`, as `torch_dist_children.BLOCK_SPECS` cuts it."""
    dim = BLOCK_DIM[k]
    n = a.shape[dim] // SHAPE[2]
    return np.take(a, np.arange(m * n, (m + 1) * n), axis=dim)


@pytest.mark.parametrize("path", ["ep", "global"])
@pytest.mark.parametrize("label", [c[0] for c in CASES])
def test_expert_blocks_match_reference(run, label, path):
    """Both paths given the rank's "model" blocks of the expert and
    residual weights: the same rows and aux as given whole (held against
    the reference as above), x's and the router's gradients whole, and
    each rank's block gradient that block of the reference's: for the EP
    path the sum over its dp row's shards, for the global path summed
    over the dp ranks against the whole batch's."""
    tmp, inputs, refs, ranks = run
    lp = inputs[label][1]
    name = path + "_block"
    nb = B // SHAPE[1]
    if path == "ep":
        ref = refs[label]["shards"]
        for (d, m), res in ranks.items():
            got = port(tmp, label, res["rank"])
            want = {k: sum(ref[(d, j)][2][k] for j in range(SHAPE[2]))
                    for k in lp}
            close(got[f"{name}/y"], np.concatenate(
                [ref[(d, j)][0] for j in range(SHAPE[2])], 1), BAR)
            close(got[f"{name}/grad/x"], np.concatenate(
                [ref[(d, j)][2]["x"] for j in range(SHAPE[2])], 1), BAR)
            assert res["cases"][label][name]["aux"] == pytest.approx(
                res["cases"][label]["ep"]["aux"], rel=BAR)
            for k in lp:
                w = block(want[k], k, m) if k in BLOCK_DIM else want[k]
                close(got[f"{name}/grad/{k}"], w, BAR)
        return
    y_ref, aux_ref, g_ref = refs[label]["global"]
    total = {}
    for (d, m), res in ranks.items():
        got = port(tmp, label, res["rank"])
        close(got[f"{name}/y"], y_ref[d * nb:(d + 1) * nb], BAR)
        close(got[f"{name}/grad/x"], g_ref["x"][d * nb:(d + 1) * nb], BAR)
        assert abs(res["cases"][label][name]["aux"] - aux_ref) \
            <= BAR * abs(aux_ref)
        for k in lp:
            total[(k, m)] = total.get((k, m), 0) + got[f"{name}/grad/{k}"]
    for (k, m), g in total.items():
        close(g, block(g_ref[k], k, m) if k in BLOCK_DIM else g_ref[k], BAR)


ARCTIC_SCRIPT = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import json
    import numpy as np, jax, jax.numpy as jnp
    from repro.launch.mesh import make_test_mesh
    from repro.distributed import context as mesh_ctx
    from repro.configs.registry import get_arch
    from repro.models import registry as M
    from repro.models.moe import moe_apply, moe_apply_ep

    mesh = make_test_mesh((2, 2, 2), ("pod", "data", "model"))
    mesh_ctx.set_mesh(mesh)
    cfg = get_arch("arctic-480b-smoke")
    params = M.init_params(cfg, jax.random.PRNGKey(0))
    lp = jax.tree.map(lambda x: x[0].astype(jnp.float32), params["layers"])
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(size=(4, 32, cfg.d_model)) * 0.1, jnp.float32)
    with mesh:
        y0, _ = jax.jit(lambda lp, x: moe_apply(cfg, lp, x))(lp, x)
        y1, _ = jax.jit(lambda lp, x: moe_apply_ep(cfg, lp, x))(lp, x)
    print(json.dumps(dict(
        err=float(np.max(np.abs(np.array(y0) - np.array(y1)))),
        ymax=float(np.max(np.abs(np.array(y0)))))))
""")


@pytest.mark.slow
def test_reference_ep_adds_a_fraction_of_arctic_dense_residual():
    """The reference's own EP breaks its invariant (EP == baseline) on
    Arctic: its shard_map multiplies each rank's tokens by that rank's ff
    block of the dense residual and sums nothing over "model"
    (src/repro/models/moe.py:194-209).  Pinned: 1.605e-2 against
    max|y| 3.479e-2 (ROADMAP queue 3); the port computes the residual in
    full (test_ep_equals_baseline_with_the_residual_in_full)."""
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", ARCTIC_SCRIPT],
                       capture_output=True, text=True, env=env, timeout=560)
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["err"] == pytest.approx(1.605e-2, rel=2e-3)
    assert out["ymax"] == pytest.approx(3.479e-2, rel=2e-3)
