"""The port's co-design service (`repro_torch.serving.dse_service`) on the
CPU: every case of tests/test_dse_service.py against the port, plus the
served batches against the reference's `dse.sweep` and the lock order.

Bars: served vs the port's direct `dse.sweep` — NaN-aware bit identity
over every column, corner channel and the static aux data (the
reference's own served-vs-direct check).  Served vs the reference's
`dse.sweep` — the slice bars of tests/test_torch_sweep.py: identity
columns and `feasible` exact, static metrics rtol 1e-5, the ACT fire
within one dt, t_sense within one dt + 0.05 ns, tRC within 3 dt + 0.05 ns,
the same NaN pattern.  Every thread join and `Future.result` takes a
timeout.
"""

import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import dse as jdse  # noqa: E402
from repro.core import space as jspace  # noqa: E402
from repro_torch.core import dse, transient  # noqa: E402
from repro_torch.core import space as tspace  # noqa: E402
from repro_torch.core.batch import (ARRAY_FIELDS, DesignBatch,  # noqa: E402
                                    DesignPoint)
from repro_torch.core.space import DesignSpace  # noqa: E402
from repro_torch.serving import dse_service  # noqa: E402
from repro_torch.serving.dse_service import (DSEService, Query,  # noqa: E402
                                             request_key)

CPU = "cpu"
JOIN_S = 120.0
S_A = DesignSpace.product(techs=["aos"], layers=(87, 137))
S_B = DesignSpace.product(techs=["si"], layers=(87,))
S_MC = DesignSpace.product(techs=["aos"], layers=(87,)).with_mc(
    samples=8, key=5)


def direct(space, **kw):
    return dse.sweep(space, device=CPU, **kw)


def host(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_batches_identical(a: DesignBatch, b: DesignBatch):
    """NaN-aware bit-identity across every tensor field, corner channel
    and the static aux data."""
    assert a.tech_names == b.tech_names
    assert a.scheme_names == b.scheme_names
    assert a.n_samples == b.n_samples
    # base_len 0 is the "= len" sentinel, so compare the effective value
    assert (a.base_len or len(a)) == (b.base_len or len(b))
    assert set(a.corners) == set(b.corners)

    def eq(x, y):
        x, y = host(x), host(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        if x.dtype.kind == "f":
            return ((x == y) | (np.isnan(x) & np.isnan(y))).all()
        return (x == y).all()

    for f in ARRAY_FIELDS:
        assert eq(getattr(a, f), getattr(b, f)), f
    for k in a.corners:
        assert eq(a.corners[k], b.corners[k]), f"corners[{k}]"


@pytest.fixture
def svc():
    return DSEService(window_ms=0.0, device=CPU)


@pytest.fixture
def count_dispatches(monkeypatch):
    """Count the service's packed fused dispatches (the serving seam —
    direct `dse.sweep` calls go through `simulate_row_cycle_lowered` and
    are not counted)."""
    calls = []
    orig = transient.row_cycle_events

    def counting(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(transient, "row_cycle_events", counting)
    return calls


def run_threads(threads):
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=JOIN_S)
    assert not any(t.is_alive() for t in threads), "a client thread hung"


class TestMicroBatchWindow:
    def test_two_clients_share_one_dispatch(self, svc, count_dispatches):
        fa, fb = svc.submit(S_A), svc.submit(S_B)
        assert svc.flush() == 2
        assert len(count_dispatches) == 1
        assert_batches_identical(fa.result(timeout=0).batch, direct(S_A))
        assert_batches_identical(fb.result(timeout=0).batch, direct(S_B))

    def test_mixed_sweep_yield_one_dispatch(self, svc, count_dispatches):
        fa = svc.submit(S_A)
        fy = svc.submit(S_MC, kind="yield", spec={"margin_mv": 5.0})
        svc.flush()
        assert len(count_dispatches) == 1
        ry = fy.result(timeout=0)
        assert_batches_identical(ry.batch, direct(S_MC))
        assert "yield_frac" in ry.summary.corners
        assert len(ry.summary) == len(S_MC) // 8
        assert_batches_identical(fa.result(timeout=0).batch, direct(S_A))

    def test_replica_mode_gets_own_dispatch(self, svc, count_dispatches):
        s_rep = S_A.with_replica()
        fa, fr = svc.submit(S_A), svc.submit(s_rep)
        svc.flush()
        # replica operands interleave [replica, main] rows, so the two
        # modes cannot share a slab: one dispatch per group
        assert len(count_dispatches) == 2
        assert_batches_identical(fa.result(timeout=0).batch, direct(S_A))
        assert_batches_identical(fr.result(timeout=0).batch, direct(s_rep))

    def test_identical_queries_coalesce(self, svc, count_dispatches):
        f1, f2 = svc.submit(S_A), svc.submit(S_A)
        svc.flush()
        assert len(count_dispatches) == 1
        st = svc.stats()
        assert st["memo"]["coalesced"] == 1
        assert st["memo"]["misses"] == 1
        assert_batches_identical(f1.result(timeout=0).batch,
                                 f2.result(timeout=0).batch)

    def test_background_dispatcher_serves_threads(self):
        out = {}
        barrier = threading.Barrier(2)

        def client(name, space, service):
            barrier.wait(timeout=JOIN_S)
            out[name] = service.sweep(space, timeout=60.0)

        with DSEService(window_ms=25.0, device=CPU) as service:
            run_threads([threading.Thread(target=client,
                                          args=(n, s, service))
                         for n, s in (("a", S_A), ("b", S_B))])
            st = service.stats()
        assert st["windows"] >= 1 and st["requests"] == 2
        assert_batches_identical(out["a"], direct(S_A))
        assert_batches_identical(out["b"], direct(S_B))

    def test_bad_request_fails_only_its_own_future(self, svc):
        bad = DesignSpace.product(techs=["aos"], layers=(87,)) \
            .with_corners(not_an_axis=(1.0,))
        fb, fa = svc.submit(bad), svc.submit(S_A)
        svc.flush()
        with pytest.raises(ValueError, match="unsupported corner axes"):
            fb.result(timeout=0)
        assert_batches_identical(fa.result(timeout=0).batch, direct(S_A))
        assert svc.stats()["errors"] == 1


class TestMemo:
    def test_repeat_answers_from_memo(self, svc, count_dispatches):
        first = svc.sweep(S_A)
        f = svc.submit(S_A)
        svc.flush()
        r = f.result(timeout=0)
        assert r.memo_hit
        assert len(count_dispatches) == 1          # no re-dispatch
        # the memoized response stays bit-identical to a fresh sweep
        assert_batches_identical(r.batch, direct(S_A))
        assert_batches_identical(r.batch, first)

    def test_corner_values_never_collide(self, svc, count_dispatches):
        base = DesignSpace.product(techs=["aos"], layers=(87,))
        c1 = base.with_corners(rh_toggles=(1e5,))
        c2 = base.with_corners(rh_toggles=(3e5,))
        assert request_key(c1) != request_key(c2)
        svc.sweep(c1)
        f = svc.submit(c2)
        svc.flush()
        r = f.result(timeout=0)
        assert not r.memo_hit
        assert len(count_dispatches) == 2
        assert host(r.batch.corners["rh_toggles"])[0] == 3e5

    def test_mc_key_and_flags_partition_the_memo(self):
        base = DesignSpace.product(techs=["aos"], layers=(87,))
        keys = {request_key(base),
                request_key(base, with_transient=False),
                request_key(base.with_replica()),
                request_key(base.with_mc(samples=8, key=0)),
                request_key(base.with_mc(samples=8, key=1)),
                request_key(base.with_mc(samples=16, key=0))}
        assert len(keys) == 6

    def test_lru_eviction(self, count_dispatches):
        service = DSEService(window_ms=0.0, memo_entries=2, device=CPU)
        service.sweep(S_A)
        service.sweep(S_B)
        service.sweep(S_A)                         # touch A: B becomes LRU
        s_c = DesignSpace.product(techs=["d1b"])
        service.sweep(s_c)                         # evicts B
        st = service.stats()
        assert st["memo"]["evictions"] == 1
        assert st["memo"]["entries"] == 2
        n = len(count_dispatches)
        assert service.submit(S_B) and service.flush() == 1
        assert len(count_dispatches) == n + 1      # B was evicted: re-dispatch
        # re-inserting B pushed A out (LRU after the C insert); C survived
        n = len(count_dispatches)
        f = service.submit(s_c)
        service.flush()
        assert f.result(timeout=0).memo_hit
        assert len(count_dispatches) == n
        assert service.stats()["memo"]["evictions"] == 2

    def test_memo_disabled(self, count_dispatches):
        service = DSEService(window_ms=0.0, memo_entries=0, device=CPU)
        service.sweep(S_A)
        service.sweep(S_A)
        assert len(count_dispatches) == 2
        assert service.stats()["memo"]["entries"] == 0


class TestStreaming:
    def test_chunks_concat_to_monolithic_sweep(self, svc):
        space = DesignSpace.product(techs=["aos", "si"], layers=(87, 137))
        chunks = list(svc.sweep_stream(space, chunk_rows=4))
        assert len(chunks) > 1
        for c in chunks:
            assert_batches_identical(c.response.batch, direct(c.space))
        merged = DesignBatch.concat([c.response.batch for c in chunks])
        assert_batches_identical(merged, direct(space))

    def test_restream_hits_memo(self, svc, count_dispatches):
        space = DesignSpace.product(techs=["aos"], layers=(87, 137))
        list(svc.sweep_stream(space, chunk_rows=2))
        n = len(count_dispatches)
        again = list(svc.sweep_stream(space, chunk_rows=2))
        assert len(count_dispatches) == n
        assert all(c.response.memo_hit for c in again)
        assert svc.stats()["chunks_streamed"] == 2 * len(again)

    def test_mc_space_rejected(self, svc):
        with pytest.raises(ValueError, match="sweep_stream cannot chunk"):
            next(iter(svc.sweep_stream(S_MC)))


class TestQueryValidation:
    def test_bad_kind(self):
        with pytest.raises(ValueError, match="unknown query kind"):
            Query.make(S_A, kind="mystery")

    def test_yield_needs_mc(self):
        with pytest.raises(ValueError, match="needs a Monte-Carlo space"):
            Query.make(S_A, kind="yield")

    def test_bad_spec_key(self):
        with pytest.raises(ValueError, match="unknown spec key"):
            Query.make(S_MC, kind="yield", spec={"margin_Mv": 5.0})

    def test_spec_only_for_yield(self):
        with pytest.raises(ValueError, match="only applies to yield"):
            Query.make(S_A, kind="sweep", spec={"margin_mv": 5.0})

    def test_space_type_checked(self):
        with pytest.raises(TypeError, match="needs a DesignSpace"):
            Query.make("aos")


class TestBatchHelpers:
    def test_slice_concat_roundtrip(self):
        batch = direct(S_A)
        parts = [batch.slice_rows(0, 3), batch.slice_rows(3, len(batch))]
        assert len(parts[0]) == 3
        merged = DesignBatch.concat(parts)
        assert_batches_identical(merged, batch)

    def test_slice_bounds_checked(self):
        batch = direct(S_A)
        with pytest.raises(ValueError):
            batch.slice_rows(0, len(batch) + 1)
        with pytest.raises(ValueError):
            batch.slice_rows(-1, 2)

    def test_concat_remaps_name_tables(self):
        a, b = direct(S_A), direct(S_B)
        merged = DesignBatch.concat([a, b])
        assert len(merged) == len(a) + len(b)
        decode = lambda bt: [bt.tech_names[i]  # noqa: E731
                             for i in host(bt.tech_idx)]
        assert decode(merged) == decode(a) + decode(b)
        schemes = lambda bt: [bt.scheme_names[i]  # noqa: E731
                              for i in host(bt.scheme_idx)]
        assert schemes(merged) == schemes(a) + schemes(b)

    def test_concat_rejects_mc_and_mismatched_corners(self):
        mc = direct(S_MC)
        with pytest.raises(ValueError, match="n_samples == 1"):
            DesignBatch.concat([mc, mc])
        plain = direct(S_A)
        cornered = direct(DesignSpace.product(techs=["aos"], layers=(87,))
                          .with_corners(rh_toggles=(1e5,)))
        with pytest.raises(ValueError, match="corner channels"):
            DesignBatch.concat([plain, cornered])


class TestAsBatchAdapter:
    def test_passthrough_and_points(self):
        batch = direct(S_A)
        assert dse.as_batch(batch) is batch
        with pytest.warns(DeprecationWarning):
            pts = batch.to_points()
        rebuilt = dse.as_batch(pts, device=CPU)
        assert isinstance(rebuilt, DesignBatch)
        assert len(rebuilt) == len(batch)

    def test_pareto_front_list_in_list_out(self):
        batch = direct(S_A)
        with pytest.warns(DeprecationWarning):
            pts = batch.to_points()
        front_pts = dse.pareto_front(pts, device=CPU)
        front_batch = dse.pareto_front(batch)
        assert all(isinstance(p, DesignPoint) for p in front_pts)
        assert isinstance(front_batch, DesignBatch)
        assert len(front_pts) == len(front_batch)


class TestThreadStress:
    """N concurrent clients x M repeated queries against the live
    dispatcher: every response must stay bit-identical to a direct
    `dse.sweep`, and the `stats()` counters must reconcile —
    `requests == memo_hits + dispatched-served` (misses + coalesced),
    with nothing queued and no errors."""

    N_CLIENTS = 6
    N_ITERS = 4
    SPACES = (S_A, S_B,
              DesignSpace.product(techs=["d1b"], layers=(87,)))

    def _hammer(self, service):
        results = [[] for _ in range(self.N_CLIENTS)]
        errors = []
        barrier = threading.Barrier(self.N_CLIENTS)

        def client(i):
            try:
                barrier.wait(timeout=JOIN_S)
                for j in range(self.N_ITERS):
                    k = (i + j) % len(self.SPACES)
                    results[i].append(
                        (k, service.sweep(self.SPACES[k], timeout=120.0)))
            except Exception as e:               # pragma: no cover
                errors.append(e)

        # switch threads often, so a lost counter update would show
        interval = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)
        try:
            run_threads([threading.Thread(target=client, args=(i,))
                         for i in range(self.N_CLIENTS)])
        finally:
            sys.setswitchinterval(interval)
        assert errors == []
        return results

    def _check_identity(self, results):
        golden = [direct(s) for s in self.SPACES]
        for per_thread in results:
            assert len(per_thread) == self.N_ITERS
            for k, batch in per_thread:
                assert_batches_identical(batch, golden[k])

    def test_stress_memo_on(self):
        with DSEService(window_ms=2.0, memo_entries=64,
                        device=CPU) as service:
            results = self._hammer(service)
            st = service.stats()
        self._check_identity(results)
        total = self.N_CLIENTS * self.N_ITERS
        memo = st["memo"]
        assert st["requests"] == total
        # every request is served exactly once: memo hit, dispatched as
        # a window miss, or coalesced onto a window twin
        assert memo["hits"] + memo["misses"] + memo["coalesced"] == total
        # each distinct space misses at least its first lookup
        assert memo["misses"] >= len(self.SPACES)
        assert st["queued"] == 0 and st["errors"] == 0
        assert st["windows"] >= 1 and st["dispatches"] >= 1
        assert st["rows"]["dispatched"] >= st["dispatches"]

    def test_stress_memo_off(self):
        with DSEService(window_ms=2.0, memo_entries=0,
                        device=CPU) as service:
            results = self._hammer(service)
            st = service.stats()
        self._check_identity(results)
        total = self.N_CLIENTS * self.N_ITERS
        memo = st["memo"]
        assert st["requests"] == total
        assert memo["hits"] == 0 and memo["entries"] == 0
        # with no memo every request is a window miss or a coalesced twin
        assert memo["misses"] + memo["coalesced"] == total
        assert st["queued"] == 0 and st["errors"] == 0
        # all queries are nominal, so each window packs its misses into
        # one slab: never more dispatches than misses, never zero
        assert 1 <= st["dispatches"] <= memo["misses"]


class TestDeprecations:
    def test_legacy_views_warn(self):
        with pytest.warns(DeprecationWarning,
                          match="full_sweep is deprecated"):
            dse.full_sweep(layer_grid=(87,), with_transient=False,
                           device=CPU)
        with pytest.warns(DeprecationWarning,
                          match="sweep_combos is deprecated"):
            dse.sweep_combos(layer_grid=(87,))
        with pytest.warns(DeprecationWarning,
                          match="to_points is deprecated"):
            direct(S_B).to_points()


# ---------------------------------------------------------------------------
# beyond the reference's cases
# ---------------------------------------------------------------------------

DT = transient.DT_NS
REGEN_SLACK_NS = 0.05
EVENT_BARS = {"t_fire_ns": DT, "t_sense_ns": DT + REGEN_SLACK_NS,
              "trc_ns": 3 * DT + REGEN_SLACK_NS}
STATIC = ("density_gb_mm2", "height_um", "cbl_ff", "margin_mv",
          "margin_disturbed_mv", "e_write_fj", "e_read_fj", "hcb_pitch_um",
          "blsa_area_um2")
IDENTITY = ("tech_idx", "scheme_idx", "layers", "valid", "manufacturable",
            "feasible")
GRID = (64, 87, 137)
REFERENCE_SPACES = {
    "grid": lambda m: m.DesignSpace.paper_grid(layer_grid=GRID),
    "replica": lambda m: m.DesignSpace.paper_grid(layer_grid=GRID)
    .with_replica(),
    "mc": lambda m: m.DesignSpace.paper_grid(layer_grid=GRID)
    .with_mc(samples=4, key=0),
    "corners": lambda m: m.DesignSpace.paper_targets().with_corners(
        rh_toggles=(5e3, 2e4)),
}


def test_served_batches_match_reference_sweeps(svc):
    """One window serves every space (a fixed-timing slab and a replica
    slab); each served batch holds the reference's `dse.sweep` of the
    same space at the slice's bars."""
    futures = {n: svc.submit(build(tspace))
               for n, build in REFERENCE_SPACES.items()}
    svc.flush()
    assert svc.stats()["dispatches"] == 2
    for name, build in REFERENCE_SPACES.items():
        port = futures[name].result(timeout=0).batch
        ref = jdse.sweep(build(jspace))
        assert len(port) == len(ref), name
        assert (port.tech_names, port.scheme_names) == (ref.tech_names,
                                                        ref.scheme_names)
        for f in IDENTITY:
            np.testing.assert_array_equal(host(getattr(port, f)),
                                          host(getattr(ref, f)), f)
        for f in STATIC:
            np.testing.assert_allclose(host(getattr(port, f)),
                                       host(getattr(ref, f)), rtol=1e-5,
                                       err_msg=f)
        for f, bar in EVENT_BARS.items():
            a, b = host(getattr(port, f)), host(getattr(ref, f))
            np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
            diff = np.where(np.isnan(b), 0.0, np.abs(a - b))
            slack = 4 * np.spacing(np.float32(np.nanmax(np.abs(b))))
            assert diff.max() <= bar + slack, (name, f, diff.max())
        assert sorted(port.corners) == sorted(ref.corners)
        for k in ref.corners:
            np.testing.assert_array_equal(host(port.corners[k]),
                                          host(ref.corners[k]))


def test_yield_summary_equals_direct_mc_summary(svc):
    spec = {"margin_mv": 80.0, "trc_ns": 11.0}
    resp = svc.query_yield(S_MC, timeout=60.0, **spec)
    want = direct(S_MC).mc_summary(**spec)
    assert_batches_identical(resp.summary, want)


def test_request_key_holds_only_host_values():
    """Equal spaces built apart give equal, equally hashed keys: the key
    holds tuples and numbers, never a tensor (which hashes by identity)."""
    def build():
        return DesignSpace.paper_grid().with_corners(
            rh_toggles=(1e5, 2e5)).with_mc(samples=8, key=3, corr=0.5)

    a, b = request_key(build()), request_key(build())
    assert a == b and hash(a) == hash(b)

    def leaves(x):
        if isinstance(x, (tuple, list)):
            for y in x:
                yield from leaves(y)
        elif hasattr(x, "__dataclass_fields__"):
            for name in x.__dataclass_fields__:
                yield from leaves(getattr(x, name))
        else:
            yield x

    assert all(isinstance(v, (str, int, float, bool, type(None)))
               for v in leaves(a)), [type(v) for v in leaves(a)]


class _OwnedLock:
    """A lock that knows its owner thread and reports each acquire to
    `on_acquire` (usable inside a Condition, like an RLock)."""

    def __init__(self, on_acquire=lambda: None):
        self._lock = threading.Lock()
        self.owner = None
        self.depth = 0
        self.on_acquire = on_acquire

    def acquire(self, blocking=True, timeout=-1):
        self.on_acquire()
        me = threading.get_ident()
        if self.owner == me:
            self.depth += 1
            return True
        if not self._lock.acquire(blocking, timeout):
            return False
        self.owner, self.depth = me, 1
        return True

    def release(self):
        self.depth -= 1
        if not self.depth:
            self.owner = None
            self._lock.release()

    def __enter__(self):
        return self.acquire()

    def __exit__(self, *exc):
        self.release()

    def held(self) -> bool:
        return self.owner == threading.get_ident()

    # the Condition protocol of an RLock
    def _is_owned(self):
        return self.held()

    def _release_save(self):
        depth, self.depth, self.owner = self.depth, 0, None
        self._lock.release()
        return depth

    def _acquire_restore(self, depth):
        self._lock.acquire()
        self.owner, self.depth = threading.get_ident(), depth


def test_lock_order_is_dispatch_lock_then_cv(monkeypatch):
    """`_cv` is never held when `_dispatch_lock` is taken, and no engine
    dispatch runs under `_cv`; the nesting `_dispatch_lock -> _cv` does
    occur (stats updates inside a serve)."""
    violations, nested = [], []
    cv_lock, dispatch_lock = _OwnedLock(), _OwnedLock()
    cv_lock.on_acquire = lambda: dispatch_lock.held() and nested.append(1)

    def dispatch_acquired():
        if cv_lock.held():
            violations.append("_dispatch_lock taken under _cv")

    dispatch_lock.on_acquire = dispatch_acquired
    service = DSEService(window_ms=1.0, memo_entries=2, device=CPU)
    service._cv = threading.Condition(cv_lock)
    service._dispatch_lock = dispatch_lock

    orig_events = transient.row_cycle_events

    def events(*a, **k):
        if cv_lock.held():
            violations.append("engine dispatch under _cv")
        return orig_events(*a, **k)

    monkeypatch.setattr(transient, "row_cycle_events", events)
    service.sweep(S_A)
    service.query_yield(S_MC, timeout=60.0, margin_mv=5.0)
    list(service.sweep_stream(S_B, chunk_rows=1))
    service.sweep(DesignSpace.product(techs=["d1b"]))   # evicts
    service.stats()
    service.memo_clear()
    with service:
        run_threads([threading.Thread(
            target=lambda s=s: service.sweep(s, timeout=60.0))
            for s in (S_A, S_B, S_A)])
        service.stats()
    assert violations == []
    assert nested, "the serve path never updated stats under the lock"
    assert cv_lock.owner is None and dispatch_lock.owner is None


def test_service_refuses_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        DSEService()
    assert dse_service.DSEService(device=CPU).device == torch.device(CPU)


@pytest.mark.parametrize("offset", [1, 3, 7, 17])
def test_served_rows_do_not_depend_on_their_slab_offset(offset):
    """A request packed behind `offset` rows of another (fixed timing and
    replica) equals its direct sweep bit for bit: on the CPU the plain
    version runs in 2048-row chunks and vector loops with scalar tails, so
    a row's position in the slab must not change its result."""
    svc = DSEService(window_ms=0.0, device=CPU)
    front = DesignSpace.points([("aos", "sel_strap", layers)
                                for layers in range(10, 10 + offset)])
    assert len(front) == offset
    grid = DesignSpace.paper_grid()
    futures = [svc.submit(s) for s in (front, grid, front.with_replica(),
                                       grid.with_replica())]
    svc.flush()
    assert svc.stats()["dispatches"] == 2
    assert_batches_identical(futures[1].result(timeout=0).batch,
                             direct(grid))
    assert_batches_identical(futures[3].result(timeout=0).batch,
                             direct(grid.with_replica()))
