"""The port's sharded sweep fabric (`repro_torch.launch.{mesh,shard}`) on
the CPU: the cases of tests/test_sharded_sweep.py on the port, and the
port's sharded sweep against the reference's.

Port against port, bit for bit (float32 as int32 views, so NaN payloads
and signed zeros count): the sharded sweep equals the sequential sweep on
meshes of 1, 3 and 8 slots (a device may fill many slots, as the
reference's forced host devices do), for the nominal, Monte-Carlo and
replica Monte-Carlo spaces, at b_chunk 64 and the default; the sharded
Pareto mask equals the sequential one.

Port against the reference (`repro.launch.shard` on its one-device CPU
mesh), within the bars of tests/test_torch_sweep.py: event times within
one DT_NS, the same NaN pattern, tRC within 3 dt + 0.05 ns, and the
feasible mask identical.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import dse as jdse  # noqa: E402
from repro.core.space import DesignSpace as JDesignSpace  # noqa: E402
from repro.launch import shard as jshard  # noqa: E402
from repro.launch.mesh import make_sweep_mesh as jmake_sweep_mesh  # noqa: E402
from repro_torch.core import dse, transient  # noqa: E402
from repro_torch.core.batch import DesignBatch, DesignPoint  # noqa: E402
from repro_torch.core.space import DesignSpace  # noqa: E402
from repro_torch.launch import shard  # noqa: E402
from repro_torch.launch.mesh import (SweepMesh, make_local_mesh,  # noqa: E402
                                     make_production_mesh, make_sweep_mesh,
                                     make_test_mesh)

DT = transient.DT_NS
REGEN_SLACK_NS = 0.05
SPACES = {
    "nominal": lambda m: m.paper_grid(),
    "mc": lambda m: m.paper_grid().with_mc(samples=16, key=0),
    "replica_mc": lambda m: m.paper_targets().with_replica()
    .with_mc(samples=16, key=0),
}
CHUNKS = (64, transient.DEFAULT_B_CHUNK)
SLOTS = (1, 3, 8)


def cpu_mesh(n):
    return make_test_mesh((n,), ("batch",), device="cpu")


@pytest.fixture(scope="module")
def sequential():
    """The sequential sweep of (space, b_chunk), computed once."""
    cache = {}

    def get(name, b_chunk=transient.DEFAULT_B_CHUNK):
        if (name, b_chunk) not in cache:
            cache[name, b_chunk] = dse.sweep(SPACES[name](DesignSpace),
                                             b_chunk=b_chunk, device="cpu")
        return cache[name, b_chunk]
    return get


@pytest.mark.parametrize("slots", SLOTS)
@pytest.mark.parametrize("b_chunk", CHUNKS)
@pytest.mark.parametrize("name", sorted(SPACES))
def test_sharded_sweep_is_bit_identical(sequential, name, b_chunk, slots):
    got = dse.sweep(SPACES[name](DesignSpace), sharding=cpu_mesh(slots),
                    b_chunk=b_chunk, device="cpu")
    assert shard.batch_mismatches(got, sequential(name, b_chunk)) == []
    assert (got.n_samples, got.base_len) == (
        sequential(name, b_chunk).n_samples,
        sequential(name, b_chunk).base_len)


def test_mesh_forms_hit_the_same_path(sequential):
    space = SPACES["nominal"](DesignSpace)
    seq = sequential("nominal")
    mesh = cpu_mesh(3)
    for sharding in (mesh, shard.sweep_sharding(mesh),
                     shard.batch_sharding(mesh),
                     make_sweep_mesh(device="cpu"), make_local_mesh("cpu")):
        got = dse.sweep(space, sharding=sharding, device="cpu")
        assert shard.batch_mismatches(got, seq) == [], sharding
    got = shard.sharded_sweep(space, mesh=mesh, device="cpu")
    assert shard.batch_mismatches(got, seq) == []
    got = shard.sharded_sweep(space, device="cpu")    # every CPU slot: one
    assert shard.batch_mismatches(got, seq) == []


def test_multi_axis_mesh_shards_over_the_full_product(sequential):
    mesh = make_test_mesh((2, 2, 2), ("pod", "data", "model"), device="cpu")
    assert mesh.size == 8 and len(mesh.slots) == 8
    got = dse.sweep(SPACES["replica_mc"](DesignSpace), sharding=mesh,
                    device="cpu")
    assert shard.batch_mismatches(got, sequential("replica_mc")) == []


def test_partial_axis_spec_rejected():
    mesh = make_test_mesh((2, 2, 2), ("pod", "data", "model"), device="cpu")
    space = DesignSpace.points([("si", "sel_strap", 137)])
    with pytest.raises(ValueError, match="full slot product"):
        dse.sweep(space, sharding=shard.SweepSharding(mesh, ("pod",)),
                  device="cpu")
    # an axis of one slot places nothing: on a 1-slot mesh every spec is
    # the canonical one, as on the reference's one-device mesh
    local = make_local_mesh("cpu")
    assert shard.SweepSharding(local, ("data",)).is_canonical()
    assert shard.SweepSharding(
        make_test_mesh((1, 4), ("data", "model"), device="cpu"),
        ("model",)).is_canonical()


def test_sharding_rejects_garbage():
    with pytest.raises(TypeError, match="SweepMesh or SweepSharding"):
        dse.sweep(DesignSpace.paper_targets(), sharding="please",
                  device="cpu")
    with pytest.raises(TypeError, match="SweepMesh or SweepSharding"):
        dse.pareto_mask(dse.sweep(DesignSpace.paper_targets(),
                                  with_transient=False, device="cpu"),
                        sharding=object())


def test_sharding_with_transient_off_rejected():
    with pytest.raises(ValueError, match="nothing to shard"):
        dse.sweep(DesignSpace.paper_targets(), with_transient=False,
                  sharding=cpu_mesh(2), device="cpu")


def test_dispatch_target_is_the_reference_arithmetic():
    align = transient.B_ALIGN
    for b in (1, 2, 63, 64, 65, 73, 146, 1000, 4097, 10_000, 299_008):
        for n_dev in (1, 2, 3, 4, 7, 8):
            for b_chunk in (64, 128, 192, 2048):
                got = shard._dispatch_target(b, n_dev, b_chunk)
                assert got == jshard._dispatch_target(b, n_dev, b_chunk)
                slab = got // n_dev
                assert got % n_dev == 0 and slab % align == 0 and got >= b
                assert slab <= b_chunk or slab % b_chunk == 0
    assert shard._dispatch_target(73, 8, 2048) == 8 * align
    assert shard._dispatch_target(1, 8, 2048) == 8 * align
    assert shard._dispatch_target(73, 1, 2048) == 2 * align


@pytest.mark.parametrize("bad", [16, 96, 0, -64])
def test_unaligned_b_chunk_rejected(bad):
    space = DesignSpace.product(techs=("si",), schemes=("sel_strap",),
                                layers=np.linspace(32, 200, 4))
    operands = dse.plan_sweep(space, device="cpu").operands
    with pytest.raises(ValueError, match="B_ALIGN"):
        shard.row_cycle_fused_sharded(operands, cpu_mesh(2), b_chunk=bad)
    with pytest.raises(ValueError, match="B_ALIGN"):
        dse.sweep(space, sharding=cpu_mesh(2), b_chunk=bad, device="cpu")


@pytest.mark.parametrize("slots", SLOTS)
def test_row_cycle_sharded_equals_the_sequential_engine(slots):
    operands = dse.plan_sweep(SPACES["replica_mc"](DesignSpace),
                              device="cpu").operands
    evt, v_end = shard.row_cycle_fused_sharded(operands, cpu_mesh(slots),
                                               b_chunk=64)
    evt_s, v_end_s = transient._row_cycle_fused_chunked(operands[:6], "auto",
                                                        64)
    assert torch.equal(evt.view(torch.int32), evt_s.view(torch.int32))
    assert torch.equal(v_end.view(torch.int32), v_end_s.view(torch.int32))
    res = shard.simulate_row_cycle_sharded(operands, cpu_mesh(slots))
    want = transient.simulate_row_cycle_lowered(operands)
    for f in ("t_sense_ns", "t_restore_ns", "trc_ns", "dv_sense_v",
              "t_fire_ns"):
        assert torch.equal(getattr(res, f).view(torch.int32),
                           getattr(want, f).view(torch.int32)), f


def test_put_global_gives_each_slot_its_rows():
    x = torch.arange(24, dtype=torch.float32).reshape(12, 2)
    slabs = shard.put_global(x, cpu_mesh(3))
    assert [s[:, 0].tolist() for s in slabs] == [
        [0.0, 2.0, 4.0, 6.0], [8.0, 10.0, 12.0, 14.0],
        [16.0, 18.0, 20.0, 22.0]]
    with pytest.raises(ValueError, match="equal"):
        shard.put_global(x, cpu_mesh(5))


def test_mesh_constructors():
    mesh = make_sweep_mesh(device="cpu")
    assert mesh.slots == (torch.device("cpu"),) and mesh.shape == (1,)
    assert (mesh.axis_names, mesh.world, mesh.rank) == (("batch",), 1, 0)
    with pytest.raises(RuntimeError, match="devices"):
        make_sweep_mesh(2, device="cpu")
    local = make_local_mesh("cpu")
    assert (local.shape, local.axis_names) == ((1, 1), ("data", "model"))
    test = make_test_mesh(device="cpu")
    assert (test.size, test.axis_names) == (8, ("pod", "data", "model"))
    assert list(test.local_slots) == list(range(8))
    with pytest.raises(ValueError, match="slots"):
        SweepMesh((torch.device("cpu"),) * 3, (4,))
    with pytest.raises(RuntimeError, match="need 256 devices"):
        make_production_mesh()
    with pytest.raises(RuntimeError, match="need 512 devices"):
        make_production_mesh(multi_pod=True)


def test_world_size_one_gloo_group(tmp_path, sequential):
    """A process group of one rank (gloo, file rendezvous): the sweep's
    columns come back through `all_gather`, the Pareto mask through
    `all_reduce`, both bit-identical; `elastic_sweep` refuses a mesh
    that spans a group."""
    import torch.distributed as dist
    from repro_torch.launch import elastic
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rv'}",
                            world_size=1, rank=0)
    try:
        mesh = make_sweep_mesh(device="cpu", group=dist.group.WORLD)
        assert (mesh.world, mesh.rank, mesh.size) == (1, 0, 1)
        for name in ("nominal", "replica_mc"):
            got = dse.sweep(SPACES[name](DesignSpace), sharding=mesh,
                            device="cpu")
            assert shard.batch_mismatches(got, sequential(name)) == []
        wide = SweepMesh((torch.device("cpu"),) * 3, (3,), ("batch",),
                         dist.group.WORLD)
        batch = sequential("nominal")
        assert torch.equal(dse.pareto_mask(batch, sharding=wide, block=7),
                           dse.pareto_mask(batch))
        with pytest.raises(ValueError, match="one process"):
            elastic.elastic_sweep(SPACES["nominal"](DesignSpace), mesh,
                                  device="cpu")
    finally:
        dist.destroy_process_group()


# --------------------------------------------------------------------------
# Sharded Pareto
# --------------------------------------------------------------------------

@pytest.mark.parametrize("slots", SLOTS)
@pytest.mark.parametrize("block", [4096, 2])
def test_sharded_pareto_bit_identical(sequential, slots, block):
    batch = sequential("mc")
    assert torch.equal(dse.pareto_mask(batch, sharding=cpu_mesh(slots),
                                       block=block),
                       dse.pareto_mask(batch, block=block))


def test_sharded_pareto_nan_columns_stay_inert(sequential):
    batch = sequential("nominal")
    marg = batch.margin_mv.clone()
    marg[::3] = float("nan")
    nan_batch = dataclasses.replace(batch, margin_mv=marg)
    for slots in SLOTS:
        assert torch.equal(
            dse.pareto_mask(nan_batch, sharding=cpu_mesh(slots),
                            require_feasible=False, block=17),
            dse.pareto_mask(nan_batch, require_feasible=False, block=17))


def test_front_passthrough(sequential):
    batch = sequential("nominal")
    got = dse.pareto_front(batch, require_feasible=False,
                           sharding=cpu_mesh(3))
    want = dse.pareto_front(batch, require_feasible=False)
    assert shard.batch_mismatches(got, want) == []


def two_point_batch():
    def mk(dens, marg, trc, erd):
        return DesignPoint(
            tech="si", scheme="sel_strap", layers=100,
            density_gb_mm2=dens, height_um=10.0, cbl_ff=30.0,
            margin_mv=marg, margin_disturbed_mv=marg, trc_ns=trc,
            e_write_fj=1.0, e_read_fj=erd, hcb_pitch_um=1.0,
            blsa_area_um2=1.0, feasible=True)
    # point 0 strictly beats point 1 on every nominal objective
    return DesignBatch.from_points([mk(8.0, 120.0, 9.0, 1.0),
                                    mk(4.0, 80.0, 12.0, 2.0)], device="cpu")


def test_sharded_pareto_nan_semantics():
    batch = two_point_batch()
    mesh = cpu_mesh(3)
    plain = dse.pareto_mask(batch, sharding=mesh,
                            extra_maximize=(torch.tensor([1.0, 0.5]),))
    assert plain.tolist() == [True, False]
    shielded = dse.pareto_mask(
        batch, sharding=mesh,
        extra_maximize=(torch.tensor([1.0, float("nan")]),))
    assert shielded.tolist() == [True, True]
    mask = dse.pareto_mask(
        batch, sharding=mesh,
        extra_maximize=(torch.tensor([float("nan"), 0.5]),))
    assert mask.tolist() == [True, True]


# --------------------------------------------------------------------------
# Port against the reference's sharded sweep
# --------------------------------------------------------------------------

def host(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("name", sorted(SPACES))
def test_sharded_sweep_matches_the_reference(name):
    ref = jdse.sweep(SPACES[name](JDesignSpace), sharding=jmake_sweep_mesh())
    port = dse.sweep(SPACES[name](DesignSpace), sharding=cpu_mesh(3),
                     device="cpu")
    assert len(port) == len(ref)
    for f in ("tech_idx", "scheme_idx", "layers", "valid", "manufacturable",
              "feasible"):
        np.testing.assert_array_equal(host(getattr(port, f)),
                                      host(getattr(ref, f)), err_msg=f)
    for f, bar in (("t_fire_ns", DT), ("t_sense_ns", DT + REGEN_SLACK_NS),
                   ("trc_ns", 3 * DT + REGEN_SLACK_NS)):
        a, b = host(getattr(port, f)), host(getattr(ref, f))
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=f)
        slack = 4 * np.spacing(np.float32(np.nanmax(np.abs(b))))
        assert np.nanmax(np.abs(a - b)) <= bar + slack, f


@pytest.mark.parametrize("name", sorted(SPACES))
def test_sharded_pareto_matches_the_reference(name):
    """The port's sharded dominance test on the reference batch's own
    columns gives the reference's sharded mask."""
    from repro_torch import interop
    from repro_torch.core.batch import ARRAY_FIELDS
    ref = jdse.sweep(SPACES[name](JDesignSpace))
    cols = {f: np.asarray(getattr(ref, f)) for f in ARRAY_FIELDS}
    batch = interop.batch_columns_from_numpy(
        cols, ref.tech_names, ref.scheme_names, device="cpu")
    for feasible in (True, False):
        np.testing.assert_array_equal(
            dse.pareto_mask(batch, require_feasible=feasible,
                            sharding=cpu_mesh(3)).numpy(),
            np.asarray(jdse.pareto_mask(ref, require_feasible=feasible,
                                        sharding=jmake_sweep_mesh())))
