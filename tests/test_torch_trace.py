"""The port's spans and counters (`repro_torch.runtime.trace`) on the CPU:
the span tree of a sweep and its ids, self time, that nothing records
while no recording is open, the Pareto work counters, the host-to-device
byte counts of the copy helpers (on the `meta` device, a device other
than the host's), counting from two threads, the plans the co-design
service makes on its dispatcher thread, and the synchronization count (a stand-in warning here,
a real synchronization on a card).
"""

import os
import sys
import threading
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import device as tdevice  # noqa: E402
from repro_torch.core import dse  # noqa: E402
from repro_torch.core.space import DesignSpace, SpaceView  # noqa: E402
from repro_torch.launch.mesh import make_test_mesh  # noqa: E402
from repro_torch.runtime import trace  # noqa: E402
from repro_torch.serving.dse_service import DSEService  # noqa: E402

CPU = "cpu"
MC_SPACE = DesignSpace.product(techs=["aos"], layers=(87, 137)).with_mc(
    samples=3, key=11)
SYNC_MESSAGE = trace.SYNC_WARNING

# parent of each span of one sweep (`dse.sweep` is the root)
SWEEP_TREE = {
    "dse.plan": "dse.sweep",
    "space.lower": "dse.plan",
    "space.lower.mc": "space.lower",
    "parasitics": "dse.plan",
    "transient.operands": "dse.plan",
    "transient.engine": "dse.sweep",
    "dse.score": "dse.sweep",
    "dse.score.view": "dse.score",
    "dse.score.columns": "dse.score",
    "dse.score.assemble": "dse.score",
}


def closed(rec, name=None):
    return [s for s in rec.last if name is None or s["name"] == name]


def test_a_sweep_gives_the_span_tree_under_one_root():
    with trace.record(range_prefix="test.") as rec:
        dse.sweep(MC_SPACE, device=CPU)
    spans = closed(rec)
    by_id = {s["id"]: s for s in spans}
    (root,) = closed(rec, "dse.sweep")
    assert root["parent"] is None and root["root"] == root["id"]
    assert {s["name"] for s in spans} == set(SWEEP_TREE) | {"dse.sweep"}
    for s in spans:
        assert s["root"] == root["id"], s["name"]
        assert s["thread"] == threading.get_ident()
        if s["name"] != "dse.sweep":
            assert by_id[s["parent"]]["name"] == SWEEP_TREE[s["name"]]
        assert s["start_ns"] <= s["end_ns"]
    assert all(v["calls"] == 1 for v in rec.spans.values())


def test_self_time_is_total_less_the_children():
    with trace.record() as rec:
        dse.sweep(MC_SPACE, device=CPU)
    spans = closed(rec)
    for s in spans:
        kids = [k for k in spans if k["parent"] == s["id"]]
        total = s["end_ns"] - s["start_ns"]
        own = total - sum(k["end_ns"] - k["start_ns"] for k in kids)
        assert rec.spans[s["name"]] == {"calls": 1, "total_ms": total / 1e6,
                                        "self_ms": own / 1e6}
    # the plan's parts and its own time make up the plan
    plan = rec.spans["dse.plan"]
    parts = sum(rec.spans[k]["total_ms"] for k in
                ("space.lower", "parasitics", "transient.operands"))
    assert plan["self_ms"] + parts == pytest.approx(plan["total_ms"],
                                                    abs=1e-9)


def _profiled_names(fn):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return {e.name for e in prof.events()}


def test_no_recording_records_nothing_and_opens_no_range():
    sweep = lambda: dse.sweep(MC_SPACE, with_transient=False, device=CPU)
    names = _profiled_names(sweep)
    assert not names & (set(SWEEP_TREE) | {"dse.sweep"})
    assert not [n for n in names if n.startswith("test.")]
    assert trace._stack() == [] and trace._rec is None

    def recorded():
        with trace.record(range_prefix="test.") as rec:
            sweep()
        return rec

    got = []
    names = _profiled_names(lambda: got.append(recorded()))
    assert {"test.dse.sweep", "test.dse.plan", "test.space.lower"} <= names
    assert "transient.engine" not in got[0].spans       # no transient


def test_one_recording_at_a_time():
    with trace.record(), pytest.raises(RuntimeError, match="already open"):
        trace.record().__enter__()
    assert trace._rec is None


def _batch(rows: int):
    base = dse.sweep(DesignSpace.paper_grid().with_mc(samples=5, key=3),
                     with_transient=False, device=CPU)
    return base.select(np.arange(rows))


@pytest.mark.parametrize("sharded", [False, True])
def test_pareto_counts_its_pairs(sharded):
    batch = _batch(300)
    mesh = make_test_mesh(device=CPU) if sharded else None
    # the mesh's 8 slots test 38 dominators each, 4 of them padding
    pairs = (304 if sharded else 300) * 300
    before = trace.totals()
    with trace.record() as rec:
        dse.pareto_mask(batch, block=128, sharding=mesh)
    after = trace.totals()
    assert rec.counters["pareto.pairs"] == pairs
    assert rec.by_span["dse.pareto"]["pareto.pairs"] == pairs
    assert rec.counters["pareto.masks"] == 1
    gained = {k: after.get(k, 0) - before.get(k, 0) for k in after}
    assert gained["pareto.pairs"] == pairs
    assert gained["pareto.masks"] == 1
    # unrecorded: the counters still count
    dse.pareto_mask(batch, block=128, sharding=mesh)
    assert trace.totals()["pareto.pairs"] == after["pareto.pairs"] + pairs


def test_every_plan_is_counted_with_or_without_a_recording():
    """`dse.plans` counts each `plan_sweep`, whether `sweep` or a caller
    of its two halves (the co-design service) makes it."""
    before = trace.totals().get("dse.plans", 0)
    dse.sweep(MC_SPACE, with_transient=False, device=CPU)
    with trace.record() as rec:
        plan = dse.plan_sweep(MC_SPACE, with_transient=False, device=CPU)
        dse.finalize_sweep(plan)
    assert trace.totals()["dse.plans"] - before == 2
    assert rec.counters["dse.plans"] == 1
    assert rec.by_span[trace.OUTSIDE]["dse.plans"] == 1


def test_copy_helpers_count_host_to_device_bytes():
    meta = torch.device("meta")
    before = trace.totals().get(tdevice.H2D_BYTES, 0)
    with trace.record() as rec, trace.span("test.copy"):
        assert tdevice.as_f32(np.zeros(10), meta).dtype == torch.float32
        tdevice.as_bool(np.ones(7, bool), meta)
        tdevice.as_i32(np.arange(5), meta)
        tdevice.as_f32(torch.zeros(3, dtype=torch.float64), meta)
        tdevice.as_f32(3.0, meta)                    # a fill: no copy
        tdevice.as_f32(np.zeros(4), CPU)             # stays on the host
        tdevice.as_bool(torch.ones(2, dtype=torch.bool), CPU)
    want = 10 * 4 + 7 + 5 * 4 + 3 * 4
    assert trace.totals()[tdevice.H2D_BYTES] - before == want
    assert rec.counters[tdevice.H2D_BYTES] == want
    assert rec.by_span["test.copy"][tdevice.H2D_BYTES] == want


def test_the_device_view_counts_every_column_it_copies():
    sp = MC_SPACE.lower(device="meta")
    with trace.record() as rec:
        view = SpaceView.from_lowered(sp)
        view.tech("sa_offset_mv")                    # a table of one tech
    b = len(sp)
    # tech, scheme (int32), layers (float32), valid (bool), two MC corners
    want = b * (4 + 4 + 4 + 1) + b * 4 * len(sp.corners) + 4
    assert rec.counters[tdevice.H2D_BYTES] == want
    assert view.tech_idx.dtype == torch.int32 and view.valid.dtype == \
        torch.bool


def test_counters_survive_two_threads():
    n, gate = 20000, threading.Barrier(2)
    before = trace.totals().get("test.threads", 0)

    def client(name):
        with trace.span(name):
            gate.wait()
            for _ in range(n):
                trace.count("test.threads")

    with trace.record() as rec:
        t = threading.Thread(target=client, args=("test.client",))
        t.start()
        client("test.main")
        t.join(60.0)
    assert not t.is_alive()
    assert trace.totals()["test.threads"] - before == 2 * n
    assert rec.counters["test.threads"] == 2 * n
    assert rec.by_span["test.client"]["test.threads"] == n
    assert rec.by_span["test.main"]["test.threads"] == n
    roots = {s["name"]: s["root"] for s in rec.last}
    assert roots["test.client"] != roots["test.main"]


def test_counters_and_spans_lose_nothing_under_contention():
    """More threads than cores, switching as often as the interpreter
    allows: no count and no closed span is lost."""
    workers, n = (os.cpu_count() or 1) + 1, 500
    gate = threading.Barrier(workers)
    before = trace.totals().get("test.stress", 0)

    def work():
        gate.wait()
        for _ in range(n):
            with trace.span("test.stress"):
                trace.count("test.stress")

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with trace.record() as rec:
            threads = [threading.Thread(target=work) for _ in range(workers)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(120.0)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert trace.totals()["test.stress"] - before == workers * n
    assert rec.counters["test.stress"] == workers * n
    assert rec.by_span["test.stress"]["test.stress"] == workers * n
    assert rec.spans["test.stress"]["calls"] == workers * n
    assert len(rec.last) == min(workers * n, trace.KEEP)


def test_the_service_plans_on_its_dispatcher_thread():
    """A client thread's query, served on the dispatcher thread: the plan
    and the scoring are roots of their own on the dispatcher's stack."""
    svc = DSEService(window_ms=0.0, device=CPU).start()
    try:
        with trace.record() as rec:
            out = []
            t = threading.Thread(target=lambda: out.append(
                svc.sweep(MC_SPACE, with_transient=False, timeout=60.0)))
            t.start()
            t.join(60.0)
    finally:
        svc.stop()
    assert out and len(out[0]) == len(MC_SPACE)
    (plan,) = closed(rec, "dse.plan")
    (score,) = closed(rec, "dse.score")
    assert plan["thread"] not in (threading.get_ident(), t.ident)
    assert score["thread"] == plan["thread"]
    assert plan["parent"] is None and plan["root"] == plan["id"]
    assert score["parent"] is None and score["root"] == score["id"]
    assert {s["root"] for s in rec.last} == {plan["id"], score["id"]}


def test_the_service_counts_a_plan_for_each_query_it_plans():
    """Coalesced repeats and memo hits are not planned again."""
    svc = DSEService(window_ms=0.0, device=CPU)
    with trace.record() as rec:
        svc.submit(MC_SPACE, with_transient=False)
        svc.submit(MC_SPACE, with_transient=False)   # coalesced
        svc.submit(DesignSpace.paper_targets(), with_transient=False)
        assert svc.flush() == 3
        assert rec.counters["dse.plans"] == 2
        svc.submit(MC_SPACE, with_transient=False)   # a memo hit
        assert svc.flush() == 1
    assert rec.counters["dse.plans"] == 2
    assert rec.spans["dse.plan"]["calls"] == 2
    assert rec.spans["dse.score"]["calls"] == 2


def test_synchronizations_count_under_the_innermost_span():
    shown = []
    previous = warnings.showwarning
    filters = list(warnings.filters)
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = lambda *a, **k: shown.append(str(a[0]))
        with trace.record() as rec:
            with trace.span("test.outer"):
                with trace.span("test.inner"):
                    for _ in range(3):           # one site, each counted
                        warnings.warn(SYNC_MESSAGE)
                warnings.warn(SYNC_MESSAGE)
                warnings.warn("another warning")
        assert shown == ["another warning"]
    assert warnings.showwarning is previous
    assert list(warnings.filters) == filters
    assert rec.counters[trace.SYNCS] == 4
    assert rec.by_span["test.inner"][trace.SYNCS] == 3
    assert rec.by_span["test.outer"][trace.SYNCS] == 1
    assert sum(rec.sync_sites.values()) == 4


@pytest.mark.gpu
def test_real_synchronizations_are_counted_on_the_card():
    """A read of the card and each pageable copy to it make the host wait;
    a copy's site is its caller in the port, not the helper."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (a synchronization needs a device)")
    x = torch.ones(8, device="cuda")
    sp = MC_SPACE.lower(device="cuda")
    torch.cuda.synchronize()
    mode = torch.cuda.get_sync_debug_mode()
    with trace.record() as rec:
        with trace.span("test.read"):
            x.sum().item()
            x * 2                                # no synchronization
        with trace.span("test.copy"):
            SpaceView.from_lowered(sp)
    assert torch.cuda.get_sync_debug_mode() == mode
    copies = 4 + len(sp.corners)    # tech, scheme, layers, valid, corners
    assert rec.by_span["test.read"][trace.SYNCS] == 1
    assert rec.by_span["test.copy"][trace.SYNCS] == copies
    assert rec.counters[trace.SYNCS] == 1 + copies
    assert sum(n for site, n in rec.sync_sites.items()
               if site.startswith("space.py:")) == copies
