"""Spans and counters of the port: where a call's host time goes, how many
bytes it copies to the card, how often the host waits for the card, and
how much work it does.

    from repro_torch.runtime import trace

    with trace.span("space.lower"):          # a nested, timed range
        ...
    trace.count("h2d.bytes", nbytes)         # a process-wide counter

    with trace.record(range_prefix="app.") as rec:
        dse.sweep(space)
    rec.spans["dse.plan"]          # {"calls", "total_ms", "self_ms"}
    rec.counters["syncs"]          # synchronizing CUDA calls
    rec.by_span["dse.plan"]        # the counts made inside that span
    rec.last                       # the last closed spans, with their ids

**Spans** cost one check of a global while no recording is open: they read
no clock and open no profiler range.  While one is open, a span takes its
start and end (`time.perf_counter_ns`), its thread, its parent and the id
of its root (the outermost span open on its thread), and opens a
`torch.profiler.record_function` range named `<range_prefix><name>`: a
profiler trace of the same seconds names what the host was doing by the
port's spans.  Each thread keeps its own stack of open spans; a span's self
time is its time less the time of the spans opened inside it on its
thread.  Spans never synchronize the device.

**Counters** (`count`) are always on and process-wide (`totals`); while a
recording is open each count is also kept in the recording, in total and
under the innermost span open on the counting thread.  A count is a host
integer: counting never reads the device.

**Synchronizations**: while a recording is open, every synchronizing CUDA
call counts as `syncs` under the innermost open span of the thread that
made it, with its site in the port (`rec.sync_sites`).  The recording
sets `torch.cuda.set_sync_debug_mode("warn")` and a warning filter for
its length, and restores both when it closes.

One recording is open at a time.  There is no exporter: the profiler's
trace is the export, and `Recording.summary()` the totals.
"""

from __future__ import annotations

import itertools
import os
import sys
import threading
import time
import warnings
from collections import Counter, defaultdict, deque

import torch

SYNCS = "syncs"
OUTSIDE = "(no span)"        # `by_span` key of counts made outside any span
KEEP = 4096                  # closed spans a recording keeps, newest last
# the warning a synchronizing CUDA call gives in the "warn" debug mode
SYNC_WARNING = "called a synchronizing CUDA operation"
# frames a synchronization's site skips: this module and the copy helpers
_HELPERS = (os.path.join("runtime", "trace.py"),
            os.path.join("repro_torch", "device.py"))

_totals: Counter = Counter()
_totals_lock = threading.Lock()
_local = threading.local()
_rec = None                  # the open `Recording`, or None


def _stack() -> list:
    """This thread's open spans, innermost last."""
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


def totals() -> dict:
    """The process-wide counters, since the process started."""
    with _totals_lock:
        return dict(_totals)


def count(name: str, n: int = 1) -> None:
    """Add the host integer `n` to the counter `name`."""
    with _totals_lock:
        _totals[name] += n
    rec = _rec
    if rec is not None:
        rec._add(name, n)


class span:
    """`with span(name):` a timed range of the port's host code while a
    recording is open; nothing otherwise."""

    __slots__ = ("name", "id", "parent", "root", "thread",
                 "_rec", "_range", "_t0", "_child_ns")

    def __init__(self, name: str):
        self.name = name
        self._rec = None

    def __enter__(self):
        rec = _rec
        if rec is None:
            return self
        stack = _stack()
        up = stack[-1] if stack else None
        self._rec = rec
        self.id = next(rec._ids)
        self.parent = up.id if up is not None else None
        self.root = up.root if up is not None else self.id
        self.thread = threading.get_ident()
        self._child_ns = 0
        stack.append(self)
        self._range = torch.profiler.record_function(rec.range_prefix
                                                     + self.name)
        self._range.__enter__()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        rec = self._rec
        if rec is None:
            return False
        t1 = time.perf_counter_ns()
        self._range.__exit__(None, None, None)
        stack = _stack()
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:
            stack.remove(self)
        dur = t1 - self._t0
        if stack:
            stack[-1]._child_ns += dur
        self._rec = None
        rec._close(self, t1, dur)
        return False


def _where() -> str:
    stack = _stack()
    return stack[-1].name if stack else OUTSIDE


def _site(frame) -> str:
    """`file:line function` of the innermost frame of the port outside
    this module and the copy helpers (`device.py`), or of `frame` where
    the port has none."""
    f = frame
    while f is not None:
        path = f.f_code.co_filename
        if "repro_torch" in path and not path.endswith(_HELPERS):
            break
        f = f.f_back
    f = f or frame
    return (f"{os.path.basename(f.f_code.co_filename)}:{f.f_lineno} "
            f"{f.f_code.co_name}")


class Recording:
    """What one `record()` saw: span totals by name (`spans`), counters in
    total (`counters`) and by innermost span (`by_span`), the sites of the
    synchronizations (`sync_sites`) and the last `KEEP` closed spans
    (`last`, dicts: name, id, parent, root, thread, start_ns,
    end_ns)."""

    def __init__(self, range_prefix: str = ""):
        self.range_prefix = range_prefix
        self.counters: Counter = Counter()
        self.by_span: dict = defaultdict(Counter)
        self.sync_sites: Counter = Counter()
        self.last: deque = deque(maxlen=KEEP)
        self._ns: dict = {}          # name -> [calls, total_ns, self_ns]
        self._ids = itertools.count(1)
        self._lock = threading.Lock()

    @property
    def spans(self) -> dict:
        """{name: {"calls", "total_ms", "self_ms"}} over the closed spans."""
        with self._lock:
            return {k: {"calls": c, "total_ms": t / 1e6, "self_ms": s / 1e6}
                    for k, (c, t, s) in self._ns.items()}

    def summary(self) -> dict:
        """The recording's totals as plain data."""
        with self._lock:
            counters = dict(self.counters)
            by_span = {k: dict(v) for k, v in self.by_span.items()}
            sites = dict(self.sync_sites)
        return {"spans": self.spans, "counters": counters,
                "by_span": by_span, "sync_sites": sites}

    def _close(self, s: span, end_ns: int, dur: int) -> None:
        with self._lock:
            calls, total, own = self._ns.get(s.name, (0, 0, 0))
            self._ns[s.name] = [calls + 1, total + dur,
                                own + dur - s._child_ns]
            self.last.append({"name": s.name, "id": s.id,
                              "parent": s.parent, "root": s.root,
                              "thread": s.thread, "start_ns": s._t0,
                              "end_ns": end_ns})

    def _add(self, name: str, n: int) -> None:
        where = _where()
        with self._lock:
            self.counters[name] += n
            self.by_span[where][name] += n

    def _sync(self, frame) -> None:
        where, site = _where(), _site(frame)
        with self._lock:
            self.counters[SYNCS] += 1
            self.by_span[where][SYNCS] += 1
            self.sync_sites[site] += 1


class record:
    """`with record(range_prefix="...") as rec:` opens a `Recording`.

    `range_prefix` starts the name of each span's profiler range.  The
    debug mode that reports synchronizing CUDA calls is set only where
    CUDA is initialized (nothing else can synchronize)."""

    def __init__(self, range_prefix: str = ""):
        self.rec = Recording(range_prefix)
        self._warn = None
        self._mode = None

    def __enter__(self) -> Recording:
        global _rec
        if _rec is not None:
            raise RuntimeError("a recording is already open")
        self._watch_syncs()
        _rec = self.rec
        return self.rec

    def __exit__(self, *exc):
        global _rec
        _rec = None
        if self._mode is not None:
            torch.cuda.set_sync_debug_mode(self._mode)
            self._mode = None
        self._warn.__exit__(None, None, None)
        return False

    def _watch_syncs(self) -> None:
        rec = self.rec
        self._warn = warnings.catch_warnings()
        self._warn.__enter__()
        previous = warnings.showwarning

        def note(message, category, filename, lineno, file=None,
                 line=None):
            if SYNC_WARNING not in str(message):
                return previous(message, category, filename, lineno, file,
                                line)
            rec._sync(sys._getframe(1))

        warnings.filterwarnings("always", message=f".*{SYNC_WARNING}")
        warnings.showwarning = note
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            self._mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("warn")
