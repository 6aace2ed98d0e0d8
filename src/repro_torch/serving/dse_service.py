"""Co-design-as-a-service: a warm DSE engine with cross-client
micro-batching and memoization.

Port of `repro.serving.dse_service`.  The offline flow (`dse.sweep` per
caller) re-pays lowering and dispatch per script run; this module keeps
ONE long-lived engine warm on its device and amortizes it across every
caller:

  micro-batching : concurrent clients' sweep/yield queries queue for a
        short window (`window_ms`); the window's cache misses are packed
        into one operand slab (`_pack_operands`) and run as ONE fused
        engine call per replica-mode group (`transient.row_cycle_events`:
        one launch of `csrc/row_cycle.cu` on the card), then
        de-multiplexed into per-client `DesignBatch` results.  Each
        client's rows go through exactly the `plan_sweep` -> events ->
        `result_from_events` -> `finalize_sweep` pipeline `dse.sweep`
        itself runs, so the demuxed result is bit-identical to a direct
        call (tested).
  memoization    : results are kept in an LRU memo keyed on the full
        request identity (`request_key`); a repeated query is answered
        without touching the engine.
  streaming      : `sweep_stream` partitions a large space into
        entry-aligned chunks and yields each chunk's batch as it is
        served, every chunk riding the same window/memo machinery.
  observability  : `stats()` reports request/window/dispatch counters,
        memo hit rate, slab occupancy and latency aggregates.

Run modes: `start()` launches the background dispatcher thread (true
concurrent micro-batching, used by `launch.serve`); without it, blocking
calls (`sweep`, `query_yield`) flush their own window inline, and
`submit` + `flush` give tests deterministic window control.

Every launch and every client use the thread's current stream, which is
the device's default stream unless a caller sets another: a client that
reads a result reads it behind the kernel that wrote it.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import OrderedDict
from concurrent.futures import Future
from dataclasses import dataclass, replace

import torch

from ..core import dse, transient
from ..core.batch import DesignBatch
from ..core.space import DesignSpace
from ..device import resolve_device

VALID_KINDS = ("sweep", "yield")

# how long `warm` waits for its response and `stop` for the dispatcher (s)
_WAIT_S = 600.0

# mc_summary keyword arguments a yield query's `spec` may carry
YIELD_SPEC_KEYS = ("margin_mv", "trc_ns", "disturbed", "q",
                   "min_feasible_frac")


def request_key(space: DesignSpace, with_transient: bool = True) -> tuple:
    """Memo key of one query: the full request identity, exactly.

    `DesignSpace` is a frozen dataclass of tuples and numbers — entries
    ((tech, scheme, layers), ...), corner axes with their *values*, the
    MC declaration (sample count, seed entropy, sigmas, corr, tail
    proposal) and the replica flag — so the space itself is the
    collision-free key: two spaces differing in any corner value, MC
    seed or flag produce different keys.  It holds no tensor (a tensor
    hashes by identity and would turn every repeat into a miss).
    """
    return (space, bool(with_transient))


@dataclass(frozen=True)
class Query:
    """One client request: score `space`, optionally reduce to yield."""
    space: DesignSpace
    kind: str = "sweep"
    with_transient: bool = True
    spec: tuple = ()        # sorted (name, value) mc_summary kwargs

    @classmethod
    def make(cls, space: DesignSpace, kind: str = "sweep",
             with_transient: bool = True, spec: dict | None = None) -> "Query":
        if not isinstance(space, DesignSpace):
            raise TypeError(f"query needs a DesignSpace, got {type(space)!r}")
        if kind not in VALID_KINDS:
            raise ValueError(f"unknown query kind {kind!r}; expected one "
                             f"of {VALID_KINDS}")
        spec = dict(spec or {})
        bad = sorted(k for k in spec if k not in YIELD_SPEC_KEYS)
        if bad:
            raise ValueError(f"unknown spec key(s) {bad}; yield specs "
                             f"take {YIELD_SPEC_KEYS}")
        if kind == "yield":
            if space.mc is None:
                raise ValueError(
                    "a yield query needs a Monte-Carlo space — declare "
                    "sampling with space.with_mc(samples, key)")
        elif spec:
            raise ValueError("spec= only applies to yield queries")
        return cls(space=space, kind=kind,
                   with_transient=bool(with_transient),
                   spec=tuple(sorted(spec.items())))

    @property
    def key(self) -> tuple:
        return request_key(self.space, self.with_transient)


@dataclass(frozen=True)
class Response:
    """One served query: the full scored batch, plus the yield-kind
    `mc_summary` reduction when requested."""
    batch: DesignBatch
    summary: DesignBatch | None = None
    memo_hit: bool = False
    elapsed_ms: float = 0.0


@dataclass
class ServiceStats:
    """Mutable counter block behind `DSEService.stats()`."""
    requests: int = 0
    sweep_queries: int = 0
    yield_queries: int = 0
    windows: int = 0
    dispatches: int = 0
    memo_hits: int = 0
    memo_misses: int = 0
    memo_evictions: int = 0
    coalesced: int = 0
    rows_requested: int = 0
    rows_dispatched: int = 0
    chunks_streamed: int = 0
    errors: int = 0
    total_latency_ms: float = 0.0
    max_latency_ms: float = 0.0


@dataclass
class _Pending:
    query: Query
    future: Future
    t0: float


@dataclass(frozen=True)
class StreamChunk:
    """One streamed partial result: chunk `index`'s sub-space and its
    served response (`response.batch` holds the rows)."""
    index: int
    space: DesignSpace
    response: Response


def _pack_operands(parts) -> transient.FusedOperands:
    """Concatenate per-request operand batches into one shared slab.

    All parts share the ladder width and the replica flag (grouped by the
    caller); replica parts have even row counts, so [replica, main] pairs
    stay adjacent across the seam.
    """
    return transient.FusedOperands(
        *(torch.cat([p[i] for p in parts]) for i in range(8)),
        replica=parts[0].replica)


class DSEService:
    """Long-lived co-design engine: warm dispatches, micro-batched
    windows, memoized results, all on `device` (default "cuda"; raises
    without a GPU unless `device="cpu"`).

    Thread-safe.  `start()`/`stop()` control the background dispatcher
    (also usable as a context manager); without it every blocking call
    serves its own window inline and `submit`/`flush` give deterministic
    window control.

    Lock discipline (the reference's, held by
    `tests/test_torch_dse_service.py`):

    - `self._cv` (Condition) protects the request-side state: `_queue`,
      `_stats`, `_running`, `_thread`.  Nothing blocking — in particular
      no engine dispatch — ever runs under it.
    - `self._dispatch_lock` (Lock) serializes serving and protects the
      memo (`_memo`).  The only permitted nesting is
      `_dispatch_lock -> _cv` (stats updates inside a serve); the
      reverse order never occurs, so the pair cannot deadlock.
    - shared attributes are always accessed as `self.<attr>` under the
      owning lock — never aliased into a local first.
    """

    def __init__(self, window_ms: float = 3.0, memo_entries: int = 64,
                 backend: str = "auto",
                 b_chunk: int = transient.DEFAULT_B_CHUNK,
                 device="cuda"):
        if memo_entries < 0:
            raise ValueError(f"memo_entries must be >= 0, got {memo_entries}")
        self.device = resolve_device(device)
        self.window_ms = float(window_ms)
        self.memo_entries = int(memo_entries)
        self.backend = backend
        self.b_chunk = transient.validate_b_chunk(b_chunk)
        self._memo: OrderedDict[tuple, DesignBatch] = OrderedDict()
        self._queue: list[_Pending] = []
        self._cv = threading.Condition()
        self._dispatch_lock = threading.Lock()
        self._stats = ServiceStats()
        self._thread: threading.Thread | None = None
        self._running = False

    # ------------------------------------------------------------ client --
    def submit(self, space: DesignSpace, kind: str = "sweep",
               with_transient: bool = True,
               spec: dict | None = None) -> Future:
        """Enqueue one query; returns a Future resolving to a `Response`.

        With the dispatcher running, the query is served at the close of
        the current micro-batch window alongside every other client's
        queued queries; otherwise it waits for `flush()` (or any blocking
        call, which flushes inline).
        """
        query = Query.make(space, kind=kind, with_transient=with_transient,
                           spec=spec)
        pending = _Pending(query=query, future=Future(),
                           t0=time.perf_counter())
        with self._cv:
            self._queue.append(pending)
            self._stats.requests += 1
            if query.kind == "yield":
                self._stats.yield_queries += 1
            else:
                self._stats.sweep_queries += 1
            self._cv.notify()
        return pending.future

    def sweep(self, space: DesignSpace, with_transient: bool = True,
              timeout: float | None = 60.0) -> DesignBatch:
        """Blocking sweep query -> `DesignBatch` (the `dse.sweep`
        equivalent, served through the shared engine)."""
        fut = self.submit(space, kind="sweep", with_transient=with_transient)
        if not self._dispatcher_running():
            self.flush()
        return fut.result(timeout=timeout).batch

    def query_yield(self, space: DesignSpace, timeout: float | None = 60.0,
                    **spec) -> Response:
        """Blocking yield query: MC sweep + `mc_summary(**spec)` reduction.

        The response's `batch` is the full sample-major MC batch and
        `summary` the one-row-per-design reduction (with
        `corners["yield_frac"]` / `corners["ess"]`).
        """
        fut = self.submit(space, kind="yield", spec=spec)
        if not self._dispatcher_running():
            self.flush()
        return fut.result(timeout=timeout)

    def sweep_stream(self, space: DesignSpace, chunk_rows: int | None = None,
                     timeout: float | None = 60.0):
        """Stream a large sweep as per-chunk partial results.

        Partitions the space into entry-aligned sub-spaces of at most
        `chunk_rows` lowered rows (default: the engine's `b_chunk`) and
        yields a `StreamChunk` per sub-space as it is served — each
        chunk's batch is exactly `dse.sweep(chunk.space)`.  Monte-Carlo
        spaces are rejected, because the MC draw stream depends on the
        lowered base length: a chunked MC sweep would silently differ
        from the monolithic one.
        """
        if space.mc is not None:
            raise ValueError(
                "sweep_stream cannot chunk a with_mc space: the MC draws "
                "depend on the lowered base length, so chunked results "
                "would differ from the monolithic sweep — sweep it whole, "
                "or stream the nominal space and run MC on the survivors")
        chunk_rows = int(chunk_rows if chunk_rows is not None
                         else self.b_chunk)
        if chunk_rows < 1:
            raise ValueError(f"chunk_rows must be >= 1, got {chunk_rows}")
        for i, sub in enumerate(_split_space(space, chunk_rows)):
            fut = self.submit(sub, kind="sweep")
            if not self._dispatcher_running():
                self.flush()
            resp = fut.result(timeout=timeout)
            with self._cv:
                self._stats.chunks_streamed += 1
            yield StreamChunk(index=i, space=sub, response=resp)

    def warm(self, space: DesignSpace | None = None) -> Response:
        """Build the kernel (on the card) and seed the memo with a small
        sweep — `DesignSpace.paper_targets()` by default — so the first
        real client never pays the build.  Call it before `start()`."""
        space = space if space is not None else DesignSpace.paper_targets()
        fut = self.submit(space, kind="sweep")
        if not self._dispatcher_running():
            self.flush()
        return fut.result(timeout=_WAIT_S)

    # --------------------------------------------------------- lifecycle --
    def _dispatcher_running(self) -> bool:
        with self._cv:
            return self._running

    def start(self) -> "DSEService":
        """Launch the background dispatcher (idempotent)."""
        with self._cv:
            if self._running:
                return self
            self._running = True
            thread = threading.Thread(target=self._dispatch_loop,
                                      name="dse-service", daemon=True)
            self._thread = thread
        thread.start()
        return self

    def stop(self) -> None:
        """Stop the dispatcher after draining the queue; raises if it has
        not ended within `_WAIT_S` seconds."""
        with self._cv:
            if not self._running:
                return
            self._running = False
            thread, self._thread = self._thread, None
            self._cv.notify_all()
        if thread is not None:
            thread.join(_WAIT_S)
            if thread.is_alive():
                raise TimeoutError(
                    f"the DSE dispatcher did not stop within {_WAIT_S} s")

    def __enter__(self) -> "DSEService":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def _dispatch_loop(self) -> None:
        while True:
            with self._cv:
                while not self._queue and self._running:
                    self._cv.wait(timeout=0.05)
                if not self._queue and not self._running:
                    return
            # window open: wait for concurrent clients to pile on
            time.sleep(self.window_ms / 1e3)
            self.flush()

    # ---------------------------------------------------------- serving --
    def flush(self) -> int:
        """Serve everything queued right now as one micro-batch window;
        returns the number of requests served."""
        with self._cv:
            pending, self._queue = self._queue, []
        if not pending:
            return 0
        with self._dispatch_lock:
            try:
                self._serve_window(pending)
            except Exception as e:       # safety net; errors surface via
                failed = [p for p in pending if not p.future.done()]
                with self._cv:           # the futures, never kill the loop
                    self._stats.errors += len(failed)
                for p in failed:
                    p.future.set_exception(e)
        return len(pending)

    def _serve_window(self, pending: list[_Pending]) -> None:
        ready: list[tuple[_Pending, DesignBatch, bool]] = []
        misses: OrderedDict[tuple, list[_Pending]] = OrderedDict()
        hits = coalesced = rows_requested = 0
        for p in pending:
            rows_requested += len(p.query.space)
            cached = self._memo_get(p.query.key)
            if cached is not None:
                hits += 1
                ready.append((p, cached, True))
            else:
                group = misses.setdefault(p.query.key, [])
                if group:
                    # identical concurrent queries coalesce onto one plan
                    coalesced += 1
                group.append(p)
        with self._cv:
            self._stats.windows += 1
            self._stats.rows_requested += rows_requested
            self._stats.memo_hits += hits
            self._stats.memo_misses += len(misses)
            self._stats.coalesced += coalesced

        # plan every unique miss (a bad request fails only its own
        # group), then pack compatible operand batches into shared
        # slabs: ONE fused engine call per (replica-mode) group
        plans: dict[tuple, dse.SweepPlan] = {}
        for key, group in misses.items():
            try:
                plans[key] = dse.plan_sweep(
                    group[0].query.space,
                    with_transient=group[0].query.with_transient,
                    device=self.device)
            except Exception as e:
                self._fail(group, e)
        results: dict[tuple, transient.RowCycleResult | None] = {
            k: None for k in plans if plans[k].operands is None}
        needs_engine = [k for k in plans if plans[k].operands is not None]
        for _, keys in itertools.groupby(
                sorted(needs_engine,
                       key=lambda k: plans[k].operands.replica),
                key=lambda k: plans[k].operands.replica):
            keys = list(keys)
            parts = [plans[k].operands for k in keys]
            packed = _pack_operands(parts)
            evt = transient.row_cycle_events(packed, backend=self.backend,
                                             b_chunk=self.b_chunk)
            with self._cv:
                self._stats.dispatches += 1
                self._stats.rows_dispatched += int(packed.c.shape[0])
            lo = 0
            for k, part in zip(keys, parts):
                b = int(part.c.shape[0])
                results[k] = transient.result_from_events(part,
                                                          evt[lo:lo + b])
                lo += b

        for key, group in misses.items():
            if key not in plans:
                continue   # plan failed; futures already carry the error
            try:
                batch = dse.finalize_sweep(plans[key], results[key])
            except Exception as e:
                self._fail(group, e)
                continue
            self._memo_put(key, batch)
            ready.extend((p, batch, False) for p in group)

        for p, batch, was_hit in ready:
            try:
                p.future.set_result(self._respond(p, batch, was_hit))
            except Exception as e:
                with self._cv:
                    self._stats.errors += 1
                if not p.future.done():
                    p.future.set_exception(e)

    def _fail(self, group: list[_Pending], exc: Exception) -> None:
        with self._cv:
            self._stats.errors += len(group)
        for p in group:
            if not p.future.done():
                p.future.set_exception(exc)

    def _respond(self, p: _Pending, batch: DesignBatch,
                 was_hit: bool) -> Response:
        summary = None
        if p.query.kind == "yield":
            summary = batch.mc_summary(**dict(p.query.spec))
        elapsed_ms = (time.perf_counter() - p.t0) * 1e3
        with self._cv:
            self._stats.total_latency_ms += elapsed_ms
            self._stats.max_latency_ms = max(self._stats.max_latency_ms,
                                             elapsed_ms)
        return Response(batch=batch, summary=summary, memo_hit=was_hit,
                        elapsed_ms=elapsed_ms)

    # -------------------------------------------------------------- memo --
    # `_memo_get`/`_memo_put` run on the serving path, which already holds
    # `_dispatch_lock` (flush acquires it around `_serve_window`); the
    # public `memo_clear` takes it explicitly.
    def _memo_get(self, key: tuple) -> DesignBatch | None:
        batch = self._memo.get(key)
        if batch is not None:
            self._memo.move_to_end(key)
        return batch

    def _memo_put(self, key: tuple, batch: DesignBatch) -> None:
        if not self.memo_entries:
            return
        self._memo[key] = batch
        self._memo.move_to_end(key)
        evicted = 0
        while len(self._memo) > self.memo_entries:
            self._memo.popitem(last=False)
            evicted += 1
        if evicted:
            with self._cv:
                self._stats.memo_evictions += evicted

    def memo_clear(self) -> int:
        """Drop every memoized result; returns how many were dropped."""
        with self._dispatch_lock:
            n = len(self._memo)
            self._memo.clear()
        return n

    # ------------------------------------------------------------- stats --
    def stats(self) -> dict:
        """Counters + derived rates — the service's `stats()` endpoint."""
        with self._cv:
            st = replace(self._stats)
            queued = len(self._queue)
        with self._dispatch_lock:
            memo_entries = len(self._memo)
        lookups = st.memo_hits + st.memo_misses
        served = st.memo_hits + st.memo_misses + st.coalesced
        return {
            "requests": st.requests,
            "queued": queued,
            "sweep_queries": st.sweep_queries,
            "yield_queries": st.yield_queries,
            "windows": st.windows,
            "dispatches": st.dispatches,
            "memo": {
                "entries": memo_entries,
                "capacity": self.memo_entries,
                "hits": st.memo_hits,
                "misses": st.memo_misses,
                "evictions": st.memo_evictions,
                "coalesced": st.coalesced,
                "hit_rate": st.memo_hits / lookups if lookups else 0.0,
            },
            "rows": {
                "requested": st.rows_requested,
                "dispatched": st.rows_dispatched,
            },
            "chunks_streamed": st.chunks_streamed,
            "errors": st.errors,
            "latency_ms": {
                "mean": st.total_latency_ms / served if served else 0.0,
                "max": st.max_latency_ms,
            },
        }


def _split_space(space: DesignSpace, chunk_rows: int):
    """Partition a (non-MC) space into sub-spaces of <= chunk_rows lowered
    rows each, entry-aligned and in entry order.

    Corner axes replicate into every chunk (the corner product rides each
    sub-space whole), so the per-entry row cost is len(grid) * reps; a
    single entry larger than the chunk budget is split along its layer
    grid.  For corner-free spaces, concatenating the chunks' batches in
    order reproduces the monolithic sweep's row order exactly.
    """
    reps = 1
    for _, vals in space.corner_axes:
        reps *= len(vals)
    per_chunk = max(1, chunk_rows // reps)
    pieces = []
    for tname, sname, grid in space.entries:
        for i in range(0, len(grid), per_chunk):
            pieces.append((tname, sname, tuple(grid[i:i + per_chunk])))
    out, rows = [], 0
    for piece in pieces:
        cost = len(piece[2])
        if out and rows + cost > per_chunk:
            yield replace(space, entries=tuple(out))
            out, rows = [], 0
        out.append(piece)
        rows += cost
    if out:
        yield replace(space, entries=tuple(out))
