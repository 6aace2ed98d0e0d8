"""The port's roofline (`repro_torch.roofline`) against the JAX
reference's `repro.roofline`, on the CPU.

- `analytic.hbm_bytes_per_device` and `analytic.model_flops` equal the
  reference's exactly (`==` on floats) for every config x runnable cell
  x n_dev in {256, 512} x opt level 0-8, each level applied by its own
  package's `apply_opt_level`;
- `analyze.analyze_one`, given the reference's v5e constants (read from
  `repro.roofline.analyze`), returns the reference's `Roofline` fields
  exactly, on result records in the loop-corrected (`hlo_exact`) and the
  legacy form, with and without `model_flops`, and for an arch neither
  package knows (the bytes the record carries); `interesting_cells`
  picks the same cells.  The default target is the H100's spec sheet and
  reads the node split of the port's counts;
- `counts.StepCounts` around the port's `make_train_step` on each of the
  ten smoke configs (fake tensors, the smoke batch 2 x 128) against
  `hlo_exact.analyze(...)["dot_flops_per_device"]` of the reference's
  jitted step on one CPU device: equal, except that for the SSM layers
  of mamba2 and zamba2 the reference counts four reductions of the SSD
  backward as dots (XLA lowers them so) which the port's autograd runs
  as broadcast products reduced by `sum`, not matmul-class: the
  difference equals them exactly;
- the collective bytes of one sharded train step on a fake (2, 2, 2)
  mesh equal those that `gather_block`, `hierarchical_psum_tree` and the
  loss's all-reduce move, reckoned from the block shapes, by operator,
  by mesh axis, and split by pod and by node.
"""

import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.configs.base import input_specs as jinput_specs  # noqa: E402
from repro.launch import optlevels as joptlevels  # noqa: E402
from repro.models import registry as JM  # noqa: E402
from repro.roofline import analytic as janalytic  # noqa: E402
from repro.roofline import analyze as janalyze  # noqa: E402
from repro.roofline import hlo_exact  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro.train.optimizer import abstract_opt_state  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.configs.base import input_specs  # noqa: E402
from repro_torch.distributed.sharding import entry_axes  # noqa: E402
from repro_torch.launch import dryrun, optlevels  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.models import registry as M  # noqa: E402
from repro_torch.roofline import analytic, analyze, counts  # noqa: E402
from repro_torch.train.step import make_train_step, train_specs  # noqa: E402
from repro_torch.tree import leaves, tree_map  # noqa: E402

ARCHS = registry.list_archs()
LEVELS = range(9)              # the reference's levels: 0 and 1-8
SMOKE_B, SMOKE_S = 2, 128      # the reference's SMOKE_SHAPE
V5E = analyze.Target(
    name="TPU v5e", peak_flops=janalyze.PEAK_FLOPS, hbm_bw=janalyze.HBM_BW,
    near_bw=janalyze.ICI_LINKS_EFFECTIVE * janalyze.ICI_LINK_BW,
    far_bw=janalyze.DCN_BW, domain="pod", memory_bytes=math.inf)


@pytest.mark.parametrize("arch", ARCHS)
def test_analytic_equals_reference(arch):
    cfg, jcfg = registry.get_arch(arch), jreg.get_arch(arch)
    for cell in jcfg.runnable_cells():
        for level in LEVELS:
            c = optlevels.apply_opt_level(cfg, cell, level)
            jc = joptlevels.apply_opt_level(jcfg, cell, level)
            assert analytic.model_flops(c, cell) == \
                janalytic.model_flops(jc, cell), (cell, level)
            for n_dev in (256, 512):
                assert analytic.hbm_bytes_per_device(c, cell, n_dev) == \
                    janalytic.hbm_bytes_per_device(jc, cell, n_dev), \
                    (cell, level, n_dev)


def _records():
    """Result records of both forms for a spread of cells, meshes, opt
    levels and magnitudes."""
    out = []
    rng = np.random.default_rng(0)
    for i, arch in enumerate(ARCHS):
        cfg = registry.get_arch(arch)
        for j, cell in enumerate(cfg.runnable_cells()):
            mesh, chips = (("single", 256), ("multi", 512))[(i + j) % 2]
            spec = {"train_4k": (256, 4096, "train"),
                    "prefill_32k": (32, 32768, "prefill"),
                    "decode_32k": (128, 32768, "decode"),
                    "long_500k": (1, 524288, "decode")}[cell]
            base = dict(arch=arch, cell=cell, mesh=mesh, devices=chips,
                        kind=spec[2], global_batch=spec[0], seq_len=spec[1],
                        opt_level=int((i + 2 * j) % 9), ok=True,
                        active_params=cfg.active_param_count())
            f, cross, inp = (float(x) for x in
                             rng.uniform(1, 10, 3) * [1e14, 1e9, 1e10])
            exact = dict(base, hlo_exact=dict(
                dot_flops_per_device=f, in_pod_bytes=inp,
                cross_pod_bytes=cross if mesh == "multi" else 0.0,
                collective_bytes_total=inp + cross))
            legacy = dict(base, flops_per_device=f / 7, collectives=dict(
                in_pod_bytes=inp / 3, cross_pod_bytes=cross / 3,
                total_bytes=(inp + cross) / 3))
            out += [exact, legacy]
            if j == 0:
                out.append(dict(exact, model_flops=f * chips / 2))
    out.append(dict(out[0], arch="no-such-arch",
                    analytic_hbm_bytes_per_device=1.25e10))
    out.append(dict(out[1], arch="no-such-arch"))
    return out


RECORDS = _records()


def test_analyze_equals_reference_with_its_constants():
    fields = [f.name for f in dataclasses.fields(janalyze.Roofline)]
    for d in RECORDS:
        want = janalyze.analyze_one(dict(d)).row()
        got = analyze.analyze_one(dict(d), V5E).row()
        assert {k: got[k] for k in fields} == want, (d["arch"], d["cell"])
    assert analyze.model_flops_for(RECORDS[0]) == \
        janalyze.model_flops_for(RECORDS[0])


def test_interesting_cells_equal_reference():
    rows = [analyze.analyze_one(dict(d), V5E) for d in RECORDS[:-2]]
    jrows = [janalyze.analyze_one(dict(d)) for d in RECORDS[:-2]]
    got = analyze.interesting_cells(rows)
    want = janalyze.interesting_cells(jrows)
    assert {k: (r.arch, r.cell) for k, r in got.items()} == \
        {k: (r.arch, r.cell) for k, r in want.items()}


def test_h100_target_reads_the_node_split():
    """The default target: the H100 SXM5's spec sheet, the counts' node
    split on NVLink and InfiniBand, the peak against 80 GB."""
    d = dict(RECORDS[0], arch="olmo-1b", cell="train_4k", kind="train",
             global_batch=256, seq_len=4096, devices=256, opt_level=0,
             memory={"peak_memory_in_bytes": 81e9},
             counts=dict(dot_flops_per_device=7e14, in_node_bytes=9e8,
                         cross_node_bytes=6e9, in_pod_bytes=6.9e9,
                         cross_pod_bytes=0.0, collective_bytes_total=6.9e9))
    r = analyze.analyze_one(d)
    h = analyze.H100_SXM
    assert (h.peak_flops, h.hbm_bw, h.near_bw, h.far_bw, h.memory_bytes) \
        == (989e12, 3.35e12, 450e9, 50e9, 80e9)
    assert r.t_compute == 7e14 * 256 / (256 * 989e12)
    assert r.t_collective == 9e8 / 450e9 + 6e9 / 50e9
    assert r.t_memory == analytic.hbm_bytes_per_device(
        registry.get_arch("olmo-1b"), "train_4k", 256) / 3.35e12
    assert r.peak_memory_bytes == 81e9 and not r.fits_memory
    assert "olmo-1b" in analyze.table([r])


def _ssd_backward_reductions(cfg) -> float:
    """The four reductions of the SSD backward (`src/repro/models/ssm.py`
    :149, :156, :175) that XLA emits as dots and the port's autograd as a
    broadcast product summed, per SSM layer at the smoke batch: the
    gradient of the C.B scores summed over the heads (Q.Q.nh), of the
    per-head decays summed over the head dim (nh.hp) and over the state
    (nh.st), and of C summed over the heads (st.nh)."""
    assert cfg.ssm_ngroups == 1
    q = ssm.chunk_size(cfg, SMOKE_S)
    nc, nh = SMOKE_S // q, cfg.ssm_nheads
    hp, st = cfg.ssm_headdim, cfg.ssm_state
    per_layer = 2 * SMOKE_B * nc * q * nh * (q + hp + 2 * st)
    return float(cfg.n_layers * per_layer)


def _reference_dot_flops(name: str) -> float:
    jcfg = jreg.get_arch(name)
    step, _ = jstep.make_train_step(jcfg)
    abs_p = JM.abstract_params(jcfg)
    abs_o = abstract_opt_state(jcfg.optimizer, abs_p)
    text = jax.jit(step).lower(abs_p, abs_o,
                               jinput_specs(jcfg, "smoke")).compile().as_text()
    return hlo_exact.analyze(text)["dot_flops_per_device"]


def _port_counts(name: str) -> dict:
    cfg = registry.get_arch(name)
    with FakeTensorMode(), counts.StepCounts() as c:
        params = tree_map(lambda a: torch.empty(a.shape, dtype=a.dtype),
                          M.abstract_params(cfg))
        batch = tree_map(lambda a: torch.zeros(a.shape, dtype=a.dtype),
                         input_specs(cfg, "smoke"))
        step, opt = make_train_step(cfg)
        state = opt.init(params)
        c.mark_arguments()
        step(params, state, batch)
    return c.result()


@pytest.mark.parametrize("arch", ARCHS)
def test_counted_flops_equal_hlo_exact(arch):
    name = arch + "-smoke"
    cfg = registry.get_arch(name)
    got = _port_counts(name)
    want = _reference_dot_flops(name)
    named = (_ssd_backward_reductions(cfg)
             if cfg.family in ("ssm", "hybrid") else 0.0)
    assert want - got["dot_flops_per_device"] == named
    assert sum(got["flops_by_op"].values()) == got["dot_flops_per_device"]
    assert got["collective_ops"] == 0
    assert 0 < got["memory"]["argument_size_in_bytes"] \
        < got["memory"]["peak_memory_in_bytes"]


class _Mesh:
    """A duck-typed mesh for the port's spec rules (no process group)."""
    def __init__(self, shape, axes):
        self.axis_names = axes
        self.devices = np.empty(shape)


def _reckoned_bytes(cfg, shape) -> dict:
    """What rank 0 of a (pod, data, model) mesh of `shape` moves in one
    sharded train step of `cfg`, from the block shapes: every parameter
    gathered axis by axis (the minor axis of a dim first), every float32
    gradient reduce-scattered over "data", all-reduced over "pod" and
    all-gathered over "data" (padded to a multiple of |data|), and the
    loss all-reduced over each dp axis of more than one rank."""
    axes = ("pod", "data", "model")
    sizes = dict(zip(axes, shape))
    p_specs, _ = train_specs(cfg, _Mesh(shape, axes))
    by_op = {"allgather_": 0, "_reduce_scatter_base_": 0, "allreduce_": 0}
    by_axis = dict.fromkeys(axes, 0)

    def add(op, axis, nbytes):
        by_op[op] += nbytes
        by_axis[axis] += nbytes

    for ab, spec in zip(leaves(M.abstract_params(cfg)), leaves(p_specs)):
        block = list(ab.shape)
        for d, entry in enumerate(spec):
            for a in entry_axes(entry):
                block[d] //= sizes[a]
        item = ab.element_size()
        for d, entry in enumerate(spec):
            for a in reversed(entry_axes(entry)):
                block[d] *= sizes[a]
                add("allgather_", a, math.prod(block) * item)
        nd = sizes["data"]
        padded = -(-ab.numel() // nd) * nd
        add("_reduce_scatter_base_", "data", padded // nd * 4)
        add("allreduce_", "pod", padded // nd * 4)
        add("allgather_", "data", padded * 4)
    for a in ("data", "pod"):
        add("allreduce_", a, 4)
    return dict(by_op=by_op, by_axis=by_axis)


def test_collective_bytes_equal_the_reckoned_moves(monkeypatch):
    """qwen2-1.5b-smoke, 8 x 64 tokens, on a fake (2, 2, 2) mesh.  Pods of
    4 ranks and nodes of 2 make rank 0's "pod" group ([0, 4]) cross a pod
    and a node, its "data" group ([0, 2]) a node only, its "model" group
    ([0, 1]) neither."""
    monkeypatch.setattr(counts, "POD_SIZE", 4)
    monkeypatch.setattr(counts, "NODE_SIZE", 2)
    cfg = registry.get_arch("qwen2-1.5b-smoke")
    got = dryrun.dry_run(cfg, "train", (2, 2, 2), 8, 64)
    want = _reckoned_bytes(cfg, (2, 2, 2))
    assert got["collective_bytes_by_type"] == \
        {k: float(v) for k, v in want["by_op"].items()}
    assert got["by_axis"] == {k: float(v) for k, v in
                              want["by_axis"].items()}
    total = sum(want["by_op"].values())
    assert got["collective_bytes_total"] == total
    assert got["cross_pod_bytes"] == want["by_axis"]["pod"]
    assert got["in_pod_bytes"] == total - want["by_axis"]["pod"]
    assert got["cross_node_bytes"] == \
        want["by_axis"]["pod"] + want["by_axis"]["data"]
    assert got["in_node_bytes"] == want["by_axis"]["model"]
