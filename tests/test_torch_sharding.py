"""The port's sharding rules, per-rank blocks, activation annotations and
optimization levels against the JAX reference.

- every case of tests/test_sharding.py through the port, on the same
  duck-typed FakeMesh;
- the spec trees of the parameters, the AdamW and AdamW8bit states, the
  decode caches (at (2, 128), at batch 1 on a 524,288-token sequence,
  whose sequence goes to ("data", "model"), and gated) and the inputs of
  every runnable cell equal to the reference's `PartitionSpec`s as
  tuples, for all ten configs, full and smoke, on meshes (16, 16), (2,
  16, 16) and (2, 2, 2);
- `local_block`'s slices equal to `NamedSharding(mesh,
  spec).devices_indices_map(shape)` at every coordinate of an 8-device
  (2, 2, 2) mesh (a subprocess with 8 forced host devices; nothing is
  compiled);
- `constrain` is the identity with and without a mesh, the spec it
  stands for equal to the one the reference pins (TestConstrainNoOp);
- `apply_opt_level` equal to the reference's, field by field, for every
  config x cell x level 0-8.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.configs import registry as jreg  # noqa: E402
from repro.distributed import context as jctx  # noqa: E402
from repro.distributed import sharding as jshard  # noqa: E402
from repro.launch import optlevels as jopt  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import registry as JM  # noqa: E402
from repro.train import optimizer as joptim  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.configs.registry import get_arch, list_archs  # noqa: E402
from repro_torch.distributed import context as ctx  # noqa: E402
from repro_torch.distributed.sharding import (batch_specs,  # noqa: E402
                                              block_slices, cache_specs,
                                              dp_axes, local_block,
                                              spec_for_axes, tree_specs)
from repro_torch.launch.optlevels import apply_opt_level  # noqa: E402
from repro_torch.models import common  # noqa: E402
from repro_torch.models import registry as models  # noqa: E402
from repro_torch.train import optimizer as optim  # noqa: E402
from repro_torch.tree import leaves, leaves_with_paths  # noqa: E402

SRC = str(Path(__file__).resolve().parents[1] / "src")


class FakeMesh:
    """Duck-typed mesh: only .axis_names and .devices.shape are used."""
    def __init__(self, sizes: dict):
        self.axis_names = tuple(sizes)
        self.devices = np.zeros(tuple(sizes.values()))


MESH1 = FakeMesh({"data": 16, "model": 16})
MESH2 = FakeMesh({"pod": 2, "data": 16, "model": 16})
MESH3 = FakeMesh({"pod": 2, "data": 2, "model": 2})
MESHES = {"16x16": MESH1, "2x16x16": MESH2, "2x2x2": MESH3}
NAMES = [n + s for n in list_archs() for s in ("", "-smoke")]


class TestSpecForAxes:
    def test_tp_and_fsdp(self):
        s = spec_for_axes(("dmodel", "ff"), (8192, 22016), MESH1)
        assert s == ("data", "model")

    def test_indivisible_drops_to_replicated(self):
        s = spec_for_axes(("heads",), (12,), MESH1)
        assert s == (None,)
        s = spec_for_axes(("qkv",), (1536,), MESH1)
        assert s == ("model",)

    def test_batch_multi_axis(self):
        s = spec_for_axes(("batch", None), (256, 4096), MESH2)
        assert s == (("pod", "data"), None)
        s = spec_for_axes(("batch", None), (32, 4096), MESH2)
        assert s == (("pod", "data"), None)
        s = spec_for_axes(("batch", None), (1, 4096), MESH2)
        assert s == (None, None)

    def test_no_double_use_of_axis(self):
        s = spec_for_axes(("vocab", "ff"), (51200, 8192), MESH1)
        assert s == ("model", None)

    def test_dp_axes_fallback(self):
        assert dp_axes(MESH2, 256) == ("pod", "data")
        assert dp_axes(MESH2, 16) == ("pod",) or dp_axes(MESH2, 16) == ()
        assert dp_axes(MESH1, 16) == ("data",)


class TestParamSpecsEndToEnd:
    @pytest.mark.parametrize("arch", ["deepseek-67b", "arctic-480b",
                                      "mamba2-780m", "zamba2-7b",
                                      "whisper-tiny"])
    def test_all_params_get_specs(self, arch):
        cfg = get_arch(arch)
        abs_p = models.abstract_params(cfg)
        specs = tree_specs(models.param_axes(cfg), abs_p, MESH1)
        n_sharded = total_bytes = sharded_bytes = 0
        for spec, ab in zip(leaves(specs), leaves(abs_p)):
            assert isinstance(spec, tuple) and len(spec) == ab.dim()
            assert ab.device.type == "meta"
            nb = ab.numel() * ab.element_size()
            total_bytes += nb
            if any(e is not None for e in spec):
                n_sharded += 1
                sharded_bytes += nb
        assert n_sharded > 0
        # at least 99% of parameter bytes must be sharded (ZeRO discipline)
        assert sharded_bytes / total_bytes > 0.99, arch


# ---------------------------------------------------------------------------
# spec trees against the reference's
# ---------------------------------------------------------------------------

def _entry(e):
    """A PartitionSpec entry as the port writes it (a one-axis tuple as
    its name)."""
    if isinstance(e, tuple):
        return e[0] if len(e) == 1 else e
    return e


def ref_specs(tree) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))[0]
    return {"/".join(str(k.key) for k in path): tuple(_entry(e) for e in p)
            for path, p in flat}


def port_specs(tree) -> dict:
    return {"/".join(path): s for path, s in leaves_with_paths(tree)}


def shapes(tree, port: bool) -> dict:
    if port:
        return {"/".join(p): tuple(x.shape) for p, x in
                leaves_with_paths(tree)}
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(k.key) for k in p): tuple(x.shape)
            for p, x in flat}


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("name", NAMES)
def test_param_and_opt_state_specs_equal_reference(name, mesh):
    m = MESHES[mesh]
    cfg, jcfg = get_arch(name), jreg.get_arch(name)
    abs_p, jabs = models.abstract_params(cfg), JM.abstract_params(jcfg)
    assert shapes(abs_p, True) == shapes(jabs, False)
    axes, jaxes = models.param_axes(cfg), JM.param_axes(jcfg)
    assert port_specs(tree_specs(axes, abs_p, m)) == ref_specs(
        jshard.tree_specs(jaxes, jabs, m))
    for opt in ("adamw", "adamw8bit"):
        o_abs = optim.abstract_opt_state(opt, abs_p)
        jo_abs = joptim.abstract_opt_state(opt, jabs)
        assert shapes(o_abs, True) == shapes(jo_abs, False)
        got = tree_specs(optim.opt_state_axes(opt, axes), o_abs, m)
        want = jshard.tree_specs(joptim.opt_state_axes(opt, jaxes), jo_abs,
                                 m)
        assert port_specs(got) == ref_specs(want), opt


CACHE_SHAPES = [(2, 128), (1, 524_288)]


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("name", NAMES)
def test_cache_specs_equal_reference(name, mesh):
    m = MESHES[mesh]
    variants = [(get_arch(name), jreg.get_arch(name))]
    if variants[0][0].family in ("dense", "moe", "vlm"):
        gated = dict(strap_decode=True, decode_strap_tokens=64)
        variants.append(tuple(dataclasses.replace(c, **gated)
                              for c in variants[0]))
    upgraded = 0
    for cfg, jcfg in variants:
        for b, s in CACHE_SHAPES:
            ab, jab = models.abstract_cache(cfg, b, s), \
                JM.abstract_cache(jcfg, b, s)
            assert {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
                    for k, v in ab.items()} == {
                k: (tuple(v.shape), np.dtype(v.dtype).name)
                for k, v in jab.items()}
            got = port_specs(cache_specs(cfg, models.cache_axes(cfg, b, s),
                                         ab, m))
            want = ref_specs(jshard.cache_specs(
                jcfg, JM.cache_axes(jcfg, b, s), jab, m))
            assert got == want, (b, s)
            upgraded += sum(("data", "model") in v for v in got.values())
    if variants[0][0].family in ("dense", "moe", "vlm"):
        assert upgraded > 0         # batch 1: the sequence on data x model


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("name", NAMES)
def test_batch_specs_equal_reference(name, mesh):
    m = MESHES[mesh]
    cfg = get_arch(name)
    for cell in cfg.runnable_cells():
        ours = base.input_specs(cfg, cell)
        theirs = jbase.input_specs(jreg.get_arch(name), cell)
        assert port_specs(batch_specs(ours, m)) == ref_specs(
            jshard.batch_specs(theirs, m)), cell


# ---------------------------------------------------------------------------
# local blocks against NamedSharding on 8 forced host devices
# ---------------------------------------------------------------------------

def block_cases():
    """(shape, spec) pairs: qwen2-smoke's parameters and AdamW8bit state,
    a batch-1 cache with its sequence on ("data", "model"), a batch on
    ("pod", "data"), and hand-made specs."""
    cfg = get_arch("qwen2-1.5b-smoke")
    abs_p = models.abstract_params(cfg)
    axes = models.param_axes(cfg)
    trees = [(abs_p, tree_specs(axes, abs_p, MESH3))]
    o_abs = optim.abstract_opt_state("adamw8bit", abs_p)
    trees.append((o_abs, tree_specs(optim.opt_state_axes("adamw8bit", axes),
                                    o_abs, MESH3)))
    c_abs = models.abstract_cache(cfg, 1, 256)
    trees.append((c_abs, cache_specs(cfg, models.cache_axes(cfg, 1, 256),
                                     c_abs, MESH3)))
    inputs = {"tokens": torch.empty((8, 16), device="meta")}
    trees.append((inputs, batch_specs(inputs, MESH3)))
    cases = [(tuple(x.shape), s) for tree, specs in trees
             for x, s in zip(leaves(tree), leaves(specs))]
    cases += [((4, 6, 8), (("pod", "model"), None, "data")),
              ((8, 3), (("model", "data", "pod"), None)),
              ((2, 4), ("model",))]
    return sorted(set(cases), key=repr)


INDEX_SCRIPT = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import json, sys
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.launch.mesh import make_test_mesh

mesh = make_test_mesh((2, 2, 2), ("pod", "data", "model"))
out = []
for shape, spec in json.loads(sys.stdin.read()):
    spec = [tuple(e) if isinstance(e, list) else e for e in spec]
    idx = NamedSharding(mesh, P(*spec)).devices_indices_map(tuple(shape))
    per = {}
    for dev, sl in idx.items():
        coord = [int(c) for c in np.argwhere(mesh.devices == dev)[0]]
        per[json.dumps(coord)] = [[s.start or 0,
                                   s.stop if s.stop is not None else n]
                                  for s, n in zip(sl, shape)]
    out.append(per)
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def index_maps():
    cases = block_cases()
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", INDEX_SCRIPT],
                       input=json.dumps(cases), capture_output=True,
                       text=True, env=env, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    return cases, json.loads(r.stdout.strip().splitlines()[-1])


def test_local_blocks_equal_named_sharding_indices(index_maps):
    cases, maps = index_maps
    assert len(cases) > 20
    for (shape, spec), per in zip(cases, maps):
        assert len(per) == 8
        for coord, want in per.items():
            c = dict(zip(("pod", "data", "model"), json.loads(coord)))
            got = block_slices(shape, spec, MESH3, c)
            assert [[s.start, s.stop] for s in got] == want, (shape, spec, c)


def test_local_block_is_the_sliced_view(index_maps):
    cases, _ = index_maps
    x = torch.arange(4 * 6 * 8).reshape(4, 6, 8)
    spec = (("pod", "model"), None, "data")
    for p in range(2):
        for d in range(2):
            for m in range(2):
                c = {"pod": p, "data": d, "model": m}
                blk = local_block(x, spec, MESH3, c)
                i = p * 2 + m
                assert torch.equal(blk, x[i:i + 1, :, d * 4:(d + 1) * 4])
                assert blk.data_ptr() >= x.data_ptr()      # a view


# ---------------------------------------------------------------------------
# constrain
# ---------------------------------------------------------------------------

CONSTRAIN_CASES = [((4, 8, 16), ("dp", None, "model")),
                   ((4, 64, 4, 32), ("dp", None, "model", None)),
                   ((2, 64, 256), ("dp", "model", None)),
                   ((6, 8, 3), ("dp", "model", "model")),
                   ((1, 128, 2, 32), ("dp", None, None, "model"))]


class TestConstrainNoOp:
    def test_no_mesh_no_op(self):
        cfg = dataclasses.replace(get_arch("mamba2-780m-smoke"),
                                  shard_acts=True)
        x = torch.ones((4, 8, 16))
        assert common.constrain(cfg, x, ("dp", None, "model")) is x
        assert common.constrain_spec(cfg, (4, 8, 16),
                                     ("dp", None, "model")) is None

    @pytest.mark.parametrize("mesh", sorted(MESHES))
    def test_spec_equals_the_one_the_reference_pins(self, mesh, monkeypatch):
        m = MESHES[mesh]
        pinned = []
        monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                            lambda x, p: pinned.append(p) or x)
        cfg = dataclasses.replace(get_arch("qwen2-1.5b-smoke"),
                                  shard_acts=True)
        jcfg = dataclasses.replace(jreg.get_arch("qwen2-1.5b-smoke"),
                                   shard_acts=True)
        jctx.set_mesh(m)
        try:
            with ctx.mesh_scope(m):
                for shape, logical in CONSTRAIN_CASES:
                    x = torch.ones(shape)
                    assert common.constrain(cfg, x, logical) is x
                    jcommon.constrain(jcfg, jnp.ones(shape), logical)
                    assert common.constrain_spec(cfg, shape, logical) == \
                        tuple(_entry(e) for e in pinned[-1])
                    # off without shard_acts unless forced
                    off = dataclasses.replace(cfg, shard_acts=False)
                    assert common.constrain_spec(off, shape, logical) is None
                    assert common.constrain_spec(off, shape, logical,
                                                 force=True) == \
                        common.constrain_spec(cfg, shape, logical)
        finally:
            jctx.set_mesh(None)
        assert len(pinned) == len(CONSTRAIN_CASES)

    def test_shard_acts_model_still_correct(self):
        """shard_acts=True must not change numerics on a single device."""
        cfg = get_arch("mamba2-780m-smoke")
        cfg_s = dataclasses.replace(cfg, shard_acts=True)
        params = models.init_params(cfg, torch.Generator().manual_seed(0),
                                    "cpu")
        toks = torch.as_tensor(np.random.default_rng(0).integers(
            0, cfg.vocab_size, (2, 64)))
        with torch.no_grad():
            y0, _ = models.forward_train(cfg, params, {"tokens": toks})
            y1, _ = models.forward_train(cfg_s, params, {"tokens": toks})
        assert torch.equal(y0, y1)


# ---------------------------------------------------------------------------
# optimization levels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cell", sorted(jbase.SHAPE_CELLS))
@pytest.mark.parametrize("name", NAMES)
def test_apply_opt_level_equals_reference(name, cell):
    for level in range(9):
        ours = apply_opt_level(get_arch(name), cell, level)
        theirs = jopt.apply_opt_level(jreg.get_arch(name), cell, level)
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs), level
