"""The port's elastic sweep (`repro_torch.launch.elastic`) on the CPU: the
reference's `TestElasticSweepFast` (tests/test_sharded_sweep.py) and its
two 8-host cases (tests/test_elastic.py), with the numbers they assert.

The reference needs eight forced host devices in a subprocess for the
8-host cases; the port's mesh puts eight slots on the CPU in-process, so
they run here in the fast tier.  Every batch is held against the
sequential `dse.sweep` bit for bit (float32 as int32 views).
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import dse  # noqa: E402
from repro_torch.core.space import DesignSpace  # noqa: E402
from repro_torch.launch import elastic, shard  # noqa: E402
from repro_torch.launch.mesh import (make_sweep_mesh,  # noqa: E402
                                     make_test_mesh)
from repro_torch.runtime.fault import FailureInjector  # noqa: E402

POINTS = (("si", "sel_strap", 137), ("aos", "sel_strap", 87),
          ("d1b", "direct", 1))


def base_space():
    return DesignSpace.points(POINTS)


def cpu_mesh():
    return make_sweep_mesh(device="cpu")


class TestElasticSweepFast:
    def test_fault_free_bit_identical(self):
        space = base_space().with_mc(samples=4, key=0)
        batch, rep = elastic.elastic_sweep(space, cpu_mesh(), slab_points=5,
                                           device="cpu")
        assert shard.batch_mismatches(
            batch, dse.sweep(space, device="cpu")) == []
        assert (rep.restarts, rep.recomputed_points) == (0, 0)
        assert rep.resume_overhead_frac == 0.0
        assert rep.n_slabs == 3 and rep.total_points == 12
        assert rep.device_history == [1, 1, 1]

    def test_crash_and_nan_recovery_bit_identical(self):
        space = base_space().with_mc(samples=4, key=0)
        batch, rep = elastic.elastic_sweep(
            space, cpu_mesh(), slab_points=5, device="cpu",
            injector=FailureInjector(schedule={1: "crash", 2: "nan"}))
        assert shard.batch_mismatches(
            batch, dse.sweep(space, device="cpu")) == []
        assert rep.restarts == 2
        # slab 1 holds 5 points, slab 2 only 2 (12 = 5 + 5 + 2)
        assert rep.recomputed_points == 7
        assert rep.resume_overhead_frac == pytest.approx(7 / 12)

    def test_dropping_the_last_host_is_fatal(self):
        # ClusterLostError is NOT a RuntimeError on purpose: the runner
        # would otherwise restore-and-retry a sweep with no slots left
        assert not issubclass(elastic.ClusterLostError, RuntimeError)
        with pytest.raises(elastic.ClusterLostError, match="all hosts lost"):
            elastic.elastic_sweep(
                base_space(), cpu_mesh(), device="cpu",
                injector=FailureInjector(schedule={0: "drop:host0"}))

    def test_unknown_host_rejected(self):
        with pytest.raises(ValueError, match="host9"):
            elastic.elastic_sweep(
                base_space(), cpu_mesh(), device="cpu",
                injector=FailureInjector(schedule={0: "drop:host9"}))


@pytest.fixture(scope="module")
def mc_oracle():
    space = DesignSpace.paper_grid().with_mc(samples=4, key=0)
    return space, dse.sweep(space, device="cpu")


def eight_slots():
    return make_test_mesh((8,), ("batch",), device="cpu")


def test_host_drop_reslab_bit_identical(mc_oracle):
    """One host stops heartbeating after slab 1's dispatch: detection ->
    replan over the survivors -> resume from the checkpoint."""
    space, oracle = mc_oracle
    batch, rep = elastic.elastic_sweep(
        space, eight_slots(), device="cpu",
        injector=FailureInjector(schedule={1: "drop:host3"}))
    assert shard.batch_mismatches(batch, oracle) == []
    assert rep.restarts == 1
    assert rep.dropped_hosts == ["host3"]
    # slab 0 ran on 8 slots; the re-dispatched slab 1 onward on 7
    assert rep.device_history[0] == 8 and rep.device_history[-1] == 7
    assert rep.device_history == [8, 8, 7, 7, 7]
    assert rep.resume_overhead_frac == pytest.approx(0.25)


def test_fault_pileup_shrinks_twice_still_bit_identical(mc_oracle):
    space, oracle = mc_oracle
    batch, rep = elastic.elastic_sweep(
        space, eight_slots(), device="cpu",
        injector=FailureInjector(schedule={0: "crash", 1: "drop:host0",
                                           2: "nan", 3: "drop:host5"}))
    assert shard.batch_mismatches(batch, oracle) == []
    assert rep.restarts == 4
    assert rep.dropped_hosts == ["host0", "host5"]
    assert rep.device_history[0] == 8 and rep.device_history[-1] == 6
    assert rep.device_history == [8, 8, 8, 7, 7, 7, 7, 6]
