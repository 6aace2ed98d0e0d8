"""The sharded train step of the MoE family at opt level 6 (`moe_ep` and
`seq_parallel`) on the rank's expert blocks: phi-smoke (4 experts) and
arctic-smoke (4 experts and the dense residual), two steps of 4 x 64
tokens, at meshes (1, 1, 2) and (1, 2, 2) (`torch_dist_children.
tp_moe_group`, one spawned gloo group a mesh, side by side).

Each rank takes `we_*` and `res_w_*` as its "model" blocks, gathered
over "data" only (`tensor_parallel.model_split`), and `moe_apply_ep`
routes the rank's sequence block as the stream holds it.

- phi-smoke against the reference's jitted `make_train_step` at the
  same opt level on a JAX mesh of the same shape (`REF_SCRIPT`, a
  subprocess on four forced host devices, from the same weights and
  batch): its shard_map routes each (batch, sequence) block alone and
  returns one replica's aux, which the port follows.
- Both configs against the same step with `tensor_parallel.module_split`
  patched in the members to gather those leaves whole (each rank then
  cuts its block from the whole weights, the placement before the
  expert blocks).  Arctic is held to this alone: the reference's EP
  adds only the rank's "ff" block of the dense residual where the port
  computes it in full (ROADMAP queue 3), so its level-6 step is not the
  reference's.

Bars: losses and grad norms within 2e-5 relative, every parameter
within 2e-5 of max(max|want|, lr).  `model_gathered` is the router
alone on the blocks' run, the router and the expert (and residual)
leaves on the other.
"""

import concurrent.futures
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

from repro_torch.launch.group import run_group  # noqa: E402

TESTS = Path(__file__).resolve().parent
SHAPES = ((1, 1, 2), (1, 2, 2))
CASES = (("phi", "phi3.5-moe-42b-a6.6b-smoke", 6),
         ("arctic", "arctic-480b-smoke", 6))
STEPS, BATCH = 2, 4
BAR = 2e-5
LR = 1e-3                                   # torch_dist_children.OC

# the reference's step at the case's opt level on a JAX mesh of each
# shape: argv[1] is JSON [shapes, arch, level, steps, batch, out_dir]
REF_SCRIPT = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import numpy as np, jax, jax.numpy as jnp
    import torch_dist_children as K
    from repro.configs import registry as jreg
    from repro.distributed import context as mesh_ctx
    from repro.launch.mesh import make_test_mesh
    from repro.launch.optlevels import apply_opt_level
    from repro.train import step as jstep
    from repro_torch.tree import leaves_with_paths

    shapes, arch, level, steps, b, out_dir = json.loads(sys.argv[1])
    cfg = K.case_config(arch, None, level)
    jcfg = apply_opt_level(jreg.get_arch(arch), "train_4k", level)
    start = jax.tree.map(lambda t: jnp.asarray(t.numpy()),
                         K.start_params(cfg))
    batch = {k: jnp.asarray(v.numpy())
             for k, v in K.train_batch(cfg, b).items()}
    for shape in shapes:
        mesh = make_test_mesh(tuple(shape))
        mesh_ctx.set_mesh(mesh)
        fn, opt = jstep.make_train_step(jcfg, K.OC)
        params, state, metrics = start, opt.init(start), []
        with mesh:
            step = jax.jit(fn)
            for _ in range(steps):
                params, state, m = step(params, state, batch)
                metrics.append((float(m["loss"]), float(m["grad_norm"])))
        arrays = {"params/" + "/".join(p): np.asarray(x, np.float32)
                  for p, x in leaves_with_paths(params)}
        arrays["loss"] = np.array([m[0] for m in metrics])
        arrays["grad_norm"] = np.array([m[1] for m in metrics])
        tag = "x".join(map(str, shape))
        np.savez(os.path.join(out_dir, f"{tag}-ref.npz"), **arrays)
""")


def reference(tmp):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join(
        [str(TESTS.parent / "src"), str(TESTS)]))
    arg = json.dumps([SHAPES, CASES[0][1], CASES[0][2], STEPS, BATCH,
                      str(tmp)])
    r = subprocess.run([sys.executable, "-c", REF_SCRIPT, arg],
                       capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_moe")
    with concurrent.futures.ThreadPoolExecutor(len(SHAPES) + 1) as pool:
        futures = {shape: pool.submit(
            run_group, "torch_dist_children:tp_moe_group",
            int(np.prod(shape)), dict(shape=shape, cases=CASES, steps=STEPS,
                                      b=BATCH, out_dir=str(tmp)),
            300, [TESTS]) for shape in SHAPES}
        ref = pool.submit(reference, tmp)
        ref.result()
        return tmp, {s: f.result() for s, f in futures.items()}


def load(tmp, shape, label, placement):
    tag = "x".join(map(str, shape))
    return np.load(tmp / f"{tag}-{label}-{placement}.npz")


def assert_step_close(got, want):
    """Losses and grad norms 2e-5 relative, parameters 2e-5 of
    max(max|want|, lr), the same leaves."""
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(got[k], want[k], rtol=BAR, atol=0)
    keys = [k for k in want.files if k.startswith("params/")]
    assert sorted(keys) == sorted(k for k in got.files
                                  if k.startswith("params/"))
    for k in keys:
        w = want[k]
        np.testing.assert_allclose(got[k], w, rtol=0, atol=BAR * max(
            float(np.abs(w).max()), LR), err_msg=k)
    assert np.isfinite(got["loss"]).all()


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_level_6_step_on_expert_blocks_matches_reference(run, shape):
    tmp, _ = run
    tag = "x".join(map(str, shape))
    assert_step_close(load(tmp, shape, CASES[0][0], "blocks"),
                      np.load(tmp / f"{tag}-ref.npz"))


@pytest.mark.parametrize("label", [c[0] for c in CASES])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_level_6_step_on_expert_blocks_matches_whole_experts(run, shape,
                                                             label):
    tmp, _ = run
    assert_step_close(load(tmp, shape, label, "blocks"),
                      load(tmp, shape, label, "whole"))


@pytest.mark.parametrize("label", [c[0] for c in CASES])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_level_6_gathers_only_the_router_whole(run, shape, label):
    _, results = run
    res = {"blocks": ["layers/router"],
           "whole": sorted(["layers/router", "layers/we_down",
                            "layers/we_gate", "layers/we_up"]
                           + (["layers/res_w_down", "layers/res_w_gate",
                               "layers/res_w_up"] if label == "arctic"
                              else []))}
    for r in results[shape]:
        for placement, want in res.items():
            assert sorted(r["model_gathered"][f"{label}/{placement}"]) \
                == want
