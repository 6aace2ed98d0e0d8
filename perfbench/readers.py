"""Arithmetic shared by the metric readers in `metrics/`.

A reader is `read(rec) -> float | None` over a run's `harness.Record`;
it returns None where the run gives it nothing to read, and the harness
then leaves the metric out of the line.
"""

from __future__ import annotations

import numpy as np


def rows_per_s(rec):
    """All rows of the window's whole iterations over all its time."""
    return rec.rows / rec.elapsed_s if rec.rows and rec.elapsed_s else None


def ms_per_iteration(spans: dict, name: str, rec):
    """A span's summed milliseconds over the window's iterations."""
    times = spans.get(name)
    return sum(times) / rec.iterations if times and rec.iterations else None


def roofline_pct(rec, name: str):
    """100 x the least time of a span's work over its measured device
    time; None without a bound (no peak for the card) or a time."""
    times = rec.device_ms.get(name)
    bound = rec.bound_s.get(name)
    if not times or not bound:
        return None
    return 100.0 * bound / (sum(times) / 1e3)


def idle_pct(rec):
    """100 x the share of the traced window the card ran nothing."""
    if not rec.window_s:
        return None
    return 100.0 * (1.0 - rec.busy_s / rec.window_s)


def p95(values):
    return float(np.percentile(values, 95)) if values else None
