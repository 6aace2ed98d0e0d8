"""The metrics read off the program's own counters (`counters`,
`metrics/h2d_mb.py`, `metrics/pareto_pairs.py`) in traced CPU runs of each
cell, their silence where the program keeps no counters, and the idle-gap
breakdown naming a gap by the program's own profiler range."""

from __future__ import annotations

import sys
from collections import Counter
from types import SimpleNamespace

import pytest
import torch

from conftest import SEED, small

CPU = torch.device("cpu")
NEW = {"grid-mc4096.select": {"pareto_pairs"},
       "targets-tail.sweep": {"h2d_mb.sweep"},
       "grid-mc4096.sweep": {"h2d_mb.sweep"}}


@pytest.fixture(autouse=True)
def short_trace(monkeypatch):
    from perfbench import devtrace
    monkeypatch.setattr(devtrace, "TRACE_S", 0.1)


@pytest.fixture
def fresh_counters(monkeypatch):
    """The program's process-wide counters from zero, as in a run's own
    process."""
    from repro_torch.runtime import trace
    monkeypatch.setattr(trace, "_totals", Counter())
    return trace


@pytest.mark.parametrize("cell", sorted(NEW))
def test_a_traced_run_reports_the_counter_metrics(bench, cell,
                                                  fresh_counters):
    from perfbench import harness
    spec = small(harness.cell_spec(bench, cell))
    line = harness.run_cell(spec, SEED, 0.3, True, CPU, 0.0)["line"]
    assert line["correct"] is True
    got = line["metrics"]
    assert NEW[cell] <= set(got)
    totals = fresh_counters.totals()
    if "pareto_pairs" in NEW[cell]:
        rows = 73 * 8                 # the grid at the tests' 8 samples
        assert got["pareto_pairs"] == {"value": rows ** 2 / 1e9,
                                       "unit": "Gpairs"}
        assert totals["pareto.pairs"] == rows ** 2 * totals["pareto.masks"]
    else:                             # no copy to a device on the CPU
        assert got["h2d_mb.sweep"] == {"value": 0.0, "unit": "MB"}
        assert totals["dse.plans"] >= 3


def test_the_readers_are_silent_without_the_program_counters(monkeypatch):
    from perfbench import harness
    # a program without the module, whether or not it was imported here
    import repro_torch.runtime as runtime
    monkeypatch.delattr(runtime, "trace", raising=False)
    monkeypatch.setitem(sys.modules, "repro_torch.runtime.trace", None)
    rec = harness.Record(iterations=3)
    for name in ("h2d_mb.sweep", "pareto_pairs"):
        assert harness.reader(name)(rec) is None


def _event(name, lo, hi, device=False):
    kind = (torch.autograd.DeviceType.CUDA if device
            else torch.autograd.DeviceType.CPU)
    return SimpleNamespace(name=name, device_type=kind,
                           time_range=SimpleNamespace(start=lo, end=hi))


def test_an_idle_gap_is_named_by_the_program_range_around_it():
    """Program ranges opened with the benchmark's prefix sit inside the
    benchmark's own span; a gap is named by the innermost one."""
    from perfbench import devtrace
    events = [_event(devtrace.WINDOW, 0, 1000),
              _event("perfbench.plan_sweep", 100, 900),
              _event("perfbench.dse.plan", 150, 850),
              _event("perfbench.space.lower", 200, 400),
              _event("kernel_a", 0, 100, device=True),
              _event("kernel_b", 400, 410, device=True),
              _event("kernel_c", 900, 1000, device=True)]
    out = devtrace.summarize(events)
    gaps = dict(out["idle_gaps"])
    assert gaps == {"space.lower": 300 / 1e6, "dse.plan": 490 / 1e6}
    assert out["busy_s"] == 210 / 1e6
