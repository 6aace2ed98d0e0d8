"""The program's own process-wide counters (`repro_torch.runtime.trace`
`totals()`), for the metric readers that read them.

The counters count over the whole process: set-up, warm-up, the check,
the window and the profiled seconds after it.  A reader divides a counter
by the count of the calls that made it (`dse.plans`, `pareto.masks`), so
it gives the mean a call over the whole process, which is the window's
only while every call does the same work.  A program that keeps no such
counters gives None, and the metric is left out.
"""

from __future__ import annotations


def totals():
    """The program's counters, or None where it keeps none."""
    try:
        from repro_torch.runtime import trace
    except ImportError:
        return None
    return trace.totals()


def per_call(counter: str, calls: str, scale: float = 1.0):
    """`counter` over the count `calls`, divided by `scale`; None without
    a call counted."""
    got = totals()
    if not got or not got.get(calls):
        return None
    return got.get(counter, 0) / got[calls] / scale
