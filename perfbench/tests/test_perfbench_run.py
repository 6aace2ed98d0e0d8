"""A run's result line, its refusals (no card, the JAX package loaded, no
program beside the benchmark), and `correct` coming out false when the
timed path is broken underneath (the harness's look for a chip skipped).
"""

from __future__ import annotations

import dataclasses
import json
import shutil
import subprocess
import sys

import pytest
import torch

from conftest import ROOT, SEED, small, with_parked

CPU = torch.device("cpu")
CELLS = ["grid-mc4096.select", "targets-tail.sweep", "grid-mc4096.service",
         "grid-mc4096.sweep"]
KERNEL_CELLS = [c for c in CELLS if c != "targets-tail.sweep"]


@pytest.fixture
def bench(bench):
    """The benchmark with its parked service cell, whose mix is tested."""
    return with_parked(bench)


@pytest.fixture(autouse=True)
def short_trace(monkeypatch):
    """A traced run profiles a tenth of a second here, not 8 s."""
    from perfbench import devtrace
    monkeypatch.setattr(devtrace, "TRACE_S", 0.1)


def run(bench, cell, traced=False, seconds=0.3):
    from perfbench import harness
    spec = small(harness.cell_spec(bench, cell))
    return harness.run_cell(spec, SEED, seconds, traced, CPU, 0.0)["line"]


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_result_line_keys(bench, cell, traced):
    line = run(bench, cell, traced)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    keys += ["breakdown"] if traced else []
    assert list(line) == keys + ["check"]        # the numbers come last
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    kind = "per_layer" if traced else "end_to_end"
    want = {m["name"] for m in bench[kind]
            if cell in m.get("workloads", [cell])}
    got = set(line["metrics"])
    assert got <= want
    assert got >= want - {"pareto_roofline", "row_cycle_roofline.sweep"}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    if traced:
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert {"busy_s", "window_s"} <= set(line["device"])
    for v in line["check"].values():
        assert set(v) == {"value", "limit"}
    json.dumps(line, allow_nan=False)


def test_import_check_compares_whole_top_level_names():
    from perfbench.harness import forbidden_modules
    assert forbidden_modules(["repro_torch", "repro_torch.core", "numpy",
                              "jaxtyping", "reprox"]) == []
    assert forbidden_modules(["repro_torch", "repro.core.dse"]) == ["repro"]
    assert forbidden_modules(["jax", "jaxlib.xla", "flax.linen"]) == [
        "flax", "jax", "jaxlib"]


def test_refuses_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the refusal")
    from perfbench import harness
    rc = harness.main(["--workload", "grid-mc4096.select", "--seed", "1",
                       "--seconds", "1", "--trace", "0"], 0.0)
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""


def test_refuses_without_the_program(tmp_path):
    """In a directory holding only BENCHMARK.json and the benchmark's
    folder the command fails and prints no result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "grid-mc4096.sweep", "--seed", "3", "--seconds", "1", "--trace",
         "0"], cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout


# --- the timed path broken underneath: `correct` must come out false ---

def _kernel(monkeypatch, fn):
    from repro_torch.kernels import ops
    real = ops.row_cycle_fused
    monkeypatch.setattr(ops, "row_cycle_fused",
                        lambda *a, **k: fn(real, *a, **k))


def unchanged_state(real, c, *a, **k):
    """A step that returns its state unchanged: no event is ever taken."""
    evt, v = real(c, *a, **k)
    return torch.zeros_like(evt), v


def half_batch(real, c, g, gc_res, gc_pre, v0, params, *a, **k):
    """Half the rows left out: the second half repeats the first."""
    evt, v = real(c, g, gc_res, gc_pre, v0, params, *a, **k)
    h = (evt.shape[0] // 2) & ~1
    evt = evt.clone()
    evt[h:2 * h] = evt[:h]
    return evt, v


def altered_row(real, *a, **k):
    """One answer altered where it is produced: one row's tRC events."""
    evt, v = real(*a, **k)
    evt = evt.clone()
    evt[evt.shape[0] // 3, 3] += 0.1
    return evt, v


# one row of a service window's slab is one query's of many: the service's
# altered answer is the next test's
BROKEN = [(c, f) for c in KERNEL_CELLS for f in (unchanged_state, half_batch,
                                                 altered_row)
          if not (c == "grid-mc4096.service" and f is altered_row)]


@pytest.mark.parametrize("cell,fault", BROKEN)
def test_a_broken_kernel_is_not_correct(bench, monkeypatch, cell, fault):
    _kernel(monkeypatch, fault)
    assert run(bench, cell)["correct"] is False


def test_an_altered_service_answer_is_not_correct(bench, monkeypatch):
    """Each query's answer altered where the service produces it (one
    row's events, as the window slices them out for that query)."""
    from repro_torch.core import transient
    real = transient.result_from_events

    def altered(operands, evt):
        evt = evt.clone()
        evt[evt.shape[0] // 3, 3] += 0.1
        return real(operands, evt)

    monkeypatch.setattr(transient, "result_from_events", altered)
    assert run(bench, "grid-mc4096.service")["correct"] is False


def test_an_altered_static_answer_is_not_correct(bench, monkeypatch):
    """The cell without a transient: one row's sense margin altered where
    the program scores it."""
    from repro_torch.core import dse
    real = dse.score_columns

    def altered(*a, **k):
        cols = real(*a, **k)
        m = cols["margin_mv"].clone()
        m[m.shape[0] // 3] += 1.0
        return dict(cols, margin_mv=m)

    monkeypatch.setattr(dse, "score_columns", altered)
    assert run(bench, "targets-tail.sweep")["correct"] is False


def test_an_altered_pareto_mask_is_not_correct(bench, monkeypatch):
    from repro_torch.core import dse
    real = dse.pareto_mask

    def flipped(batch, *a, **k):
        m = real(batch, *a, **k).clone()
        m[int(torch.nonzero(m)[0])] = False
        return m

    monkeypatch.setattr(dse, "pareto_mask", flipped)
    line = run(bench, "grid-mc4096.select")
    assert line["correct"] is False
    assert line["check"]["mask_off"]["value"] >= 1


@pytest.mark.parametrize("cell,op", [("targets-tail.sweep", "yield_ppm"),
                                     ("grid-mc4096.sweep", "mc_summary")])
def test_a_reduction_over_half_the_samples_is_not_correct(
        bench, monkeypatch, cell, op):
    """Half the batch left out, the mean taken over the rest."""
    from repro_torch.core.batch import DesignBatch
    real = getattr(DesignBatch, op)

    def half(self, *a, **k):
        n = self.n_samples // 2 * self.base_len
        cut = dataclasses.replace(self.slice_rows(0, n),
                                  n_samples=self.n_samples // 2,
                                  base_len=self.base_len)
        return real(cut, *a, **k)

    monkeypatch.setattr(DesignBatch, op, half)
    assert run(bench, cell)["correct"] is False


def test_a_stale_service_answer_is_not_correct(bench, monkeypatch):
    """The service answers a query from another query's memo entry."""
    from repro_torch.serving import dse_service
    real = dse_service.DSEService._memo_get

    def stale(self, key):
        hit = real(self, key)
        if hit is None and self._memo:
            return next(iter(self._memo.values()))
        return hit

    monkeypatch.setattr(dse_service.DSEService, "_memo_get", stale)
    line = run(bench, "grid-mc4096.service", seconds=3.0)
    assert line["attempted"] > 24          # most answers come after the first
    assert line["correct"] is False


@pytest.mark.gpu
def test_a_cell_runs_correct_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "targets-tail.sweep", "--seed", str(SEED), "--seconds", "2",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["device"]["platform"] == "gpu"
