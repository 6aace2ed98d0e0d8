"""Profile the traffic for a few seconds and reduce the trace to the
card's busy time, the device operations that took most of it, and the
card's idle gaps named by what the host was doing.

A traced run profiles `TRACE_S` more seconds of its traffic (whole
iterations) after its measured window, not during it: the window's spans
stay free of the profiler's cost, and a trace of the whole window would
take minutes to read back.  The profiler slows the host's side (the
targets-tail sweep's iteration from 9.2 to 13.4 ms, median), so the idle
share it gives is that of the profiled seconds.  The traced window is the
range "perfbench.window"; the host's doing is the innermost
"perfbench.<span>" range (see `probes`) around a gap's middle.  Device
intervals of every stream are merged, so an operation that overlaps
another counts once.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict

import torch

WINDOW = "perfbench.window"
TOP = 10
LOOKBACK = 64      # spans tried backwards from a gap's middle
NAME_CHARS = 120   # a device operation's name is cut to this length
TRACE_S = 4.0      # seconds of traffic the profiler covers


def _all_threads():
    """A profiler option that records every thread's ranges (the service's
    dispatcher and clients), where this PyTorch has it."""
    try:
        from torch._C._profiler import _ExperimentalConfig
        return _ExperimentalConfig(profile_all_threads=True)
    except (ImportError, TypeError):
        return None


class Tracer:
    """`torch.profiler` (host and card) around the traced phase, marked
    as the range "perfbench.window"; a context manager."""

    def __init__(self, on_card: bool):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if on_card:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts,
                                           experimental_config=_all_threads())
        self.range = torch.profiler.record_function(WINDOW)

    def __enter__(self):
        self.prof.__enter__()
        self.range.__enter__()
        return self

    def __exit__(self, *exc):
        self.range.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)

    def summary(self) -> dict:
        t = time.perf_counter()
        out = summarize(self.prof.events())
        out["read_s"] = time.perf_counter() - t
        return out


def _merge(intervals):
    out = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return out


def summarize(events) -> dict:
    """`prof.events()` -> busy_s, window_s, device_ops and idle_gaps
    (lists of [name, seconds], most first)."""
    is_dev = lambda e: getattr(e, "device_type", None) == \
        torch.autograd.DeviceType.CUDA
    win = [e for e in events if e.name == WINDOW and not is_dev(e)]
    if not win:
        raise RuntimeError("the trace holds no measured window")
    w0, w1 = win[0].time_range.start, win[0].time_range.end
    busy_by_op = defaultdict(float)
    intervals = []
    spans = []
    for e in events:
        lo, hi = e.time_range.start, e.time_range.end
        if is_dev(e) and e.name.startswith("perfbench."):
            continue                 # a range's shadow on the device row
        if is_dev(e):
            lo, hi = max(lo, w0), min(hi, w1)
            if hi > lo:
                intervals.append((lo, hi))
                busy_by_op[e.name[:NAME_CHARS]] += (hi - lo) / 1e6
        elif e.name.startswith("perfbench.") and e.name != WINDOW:
            spans.append((lo, hi, e.name[len("perfbench."):]))
    spans.sort()
    starts = [s[0] for s in spans]
    merged = _merge(intervals)
    busy_us = sum(hi - lo for lo, hi in merged)
    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    idle_by_span = defaultdict(float)
    for lo, hi in zip(edges[0::2], edges[1::2]):
        if hi <= lo:
            continue
        mid = (lo + hi) / 2
        name = "outside any span"
        i = bisect.bisect_right(starts, mid)
        for s in reversed(spans[max(0, i - LOOKBACK):i]):
            if s[1] >= mid:          # the latest-starting span around it
                name = s[2]
                break
        idle_by_span[name] += (hi - lo) / 1e6
    top = lambda d: [[k, v] for k, v in
                     sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
    return {"busy_s": busy_us / 1e6, "window_s": (w1 - w0) / 1e6,
            "device_ops": top(busy_by_op), "idle_gaps": top(idle_by_span)}
