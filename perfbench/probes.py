"""Spans the benchmark records around its calls into the program's layers.

`Probes` is what a run measures with: host spans (host clock), device
spans (CUDA events on the card, resolved once the window has closed) and
the least time of each kernel launch the roofline readers divide by.
Spans exist only inside `instrument` (a traced run); elsewhere every span
is a no-op and the program runs untouched.  They take times while
`timing` is set (the measured window) and are bare profiler ranges
after it (the profiled seconds).  `instrument` wraps the program's layer
entries:

    dse.plan_sweep                  host span "plan_sweep" (+ synchronize
                                    before and after where the loop's
                                    `sync_plan` says)
    dse.finalize_sweep              device span "score"
    transient.simulate_row_cycle_many   host span "row_cycle_call"
    kernels.ops.row_cycle_fused     device span "row_cycle", and the
                                    launch's least time (`roofline`)

and every span is also a `torch.profiler.record_function` range named
"perfbench.<span>", which names the device's idle gaps in the trace.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch

from . import roofline


class Probes:
    def __init__(self, device: torch.device, traced: bool, peaks=None):
        self.device = device
        self.traced = traced
        self.peaks = peaks
        self.host_ms = defaultdict(list)
        self.device_ms = defaultdict(list)
        self.bound_s = defaultdict(float)
        self._events = []          # (name, start, end) CUDA events
        self._bounds = []          # (name, least seconds: float or 0-d tensor)
        self.active = False        # spans exist: inside `instrument` only
        self.timing = False        # spans take times (the measured window)

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def host_span(self, name: str, sync: bool = False):
        if not self.active:
            yield
            return
        with torch.profiler.record_function(f"perfbench.{name}"):
            if not self.timing:
                yield
                return
            if sync:
                self.sync()
            t0 = time.perf_counter()
            yield
            if sync:
                self.sync()
            self.host_ms[name].append((time.perf_counter() - t0) * 1e3)

    @contextlib.contextmanager
    def device_span(self, name: str):
        """The span's time on the card's stream (CUDA events).  Off the
        card (the CPU tests) the host clock stands in: nothing measured
        there is a device number."""
        if not self.active:
            yield
            return
        with torch.profiler.record_function(f"perfbench.{name}"):
            if not self.timing:
                yield
            elif self.device.type == "cuda":
                start, end = (torch.cuda.Event(enable_timing=True)
                              for _ in range(2))
                start.record()
                yield
                end.record()
                self._events.append((name, start, end))
            else:
                t0 = time.perf_counter()
                yield
                self.device_ms[name].append((time.perf_counter() - t0) * 1e3)

    def add_bound(self, name: str, seconds) -> None:
        """Add a launch's least time (a float or a 0-d device tensor)."""
        if self.timing:
            self._bounds.append((name, seconds))

    def resolve(self) -> None:
        """Read every CUDA event pair and least time (after a sync)."""
        self.sync()
        for name, start, end in self._events:
            self.device_ms[name].append(start.elapsed_time(end))
        self._events.clear()
        for name, seconds in self._bounds:
            self.bound_s[name] += float(seconds)
        self._bounds.clear()

    @contextlib.contextmanager
    def instrument(self, sync_plan: bool):
        """Wrap the program's layer entries for the traced run; restored
        on exit."""
        if not self.traced:
            yield
            return
        from repro_torch.core import dse, transient
        from repro_torch.kernels import ops

        saved = [(dse, "plan_sweep", dse.plan_sweep),
                 (dse, "finalize_sweep", dse.finalize_sweep),
                 (transient, "simulate_row_cycle_many",
                  transient.simulate_row_cycle_many),
                 (ops, "row_cycle_fused", ops.row_cycle_fused)]
        plan, finalize, many, kernel = (f for _, _, f in saved)

        def plan_sweep(*a, **k):
            with self.host_span("plan_sweep", sync=sync_plan):
                return plan(*a, **k)

        def finalize_sweep(*a, **k):
            with self.device_span("score"):
                return finalize(*a, **k)

        def simulate_row_cycle_many(*a, **k):
            with self.host_span("row_cycle_call"):
                return many(*a, **k)

        def row_cycle_fused(c, g, gc_res, gc_pre, v0, params, dt,
                            n_act, n_res, n_pre, **k):
            with self.device_span("row_cycle"):
                evt, v_end = kernel(c, g, gc_res, gc_pre, v0, params, dt,
                                    n_act, n_res, n_pre, **k)
            if self.peaks and self.timing:
                self.add_bound("row_cycle", roofline.row_cycle_bound_s(
                    evt, params, c.shape[1], dt, (n_act, n_res, n_pre),
                    self.peaks))
            return evt, v_end

        dse.plan_sweep, dse.finalize_sweep = plan_sweep, finalize_sweep
        transient.simulate_row_cycle_many = simulate_row_cycle_many
        ops.row_cycle_fused = row_cycle_fused
        self.active = self.timing = True
        try:
            yield
        finally:
            self.active = self.timing = False
            for mod, name, fn in saved:
                setattr(mod, name, fn)
