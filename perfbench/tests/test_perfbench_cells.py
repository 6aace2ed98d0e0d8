"""BENCHMARK.json, and every cell, configuration, mix and metric reader
it names, found by name (with the parked cells too); a dummy cell added
from files alone."""

from __future__ import annotations

import json
import re
import shutil

import pytest

from conftest import ROOT, SEED, with_parked

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_file_keeps_the_contract_shape(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["perfbench"]
    assert 1 <= bench["run_seconds"] <= 51
    assert (ROOT / bench["command"][1]).is_file()
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in bench[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("perfbench/")
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]
    used = {w["config"] for w in bench["workloads"]}
    assert used == {c["name"] for c in bench["configs"]}
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


PARKED = pytest.mark.parametrize("parked", [False, True],
                                 ids=["file", "parked"])


@PARKED
@pytest.mark.parametrize("kind", ["end_to_end", "per_layer"])
def test_every_metric_has_a_reader(bench, kind, parked):
    from perfbench import harness
    bench = with_parked(bench) if parked else bench
    for m in bench[kind]:
        assert callable(harness.reader(m["name"]))


@PARKED
def test_each_per_layer_metric_moves_what_its_cells_report(bench, parked):
    bench = with_parked(bench) if parked else bench
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m["workloads"]:
            assert cell in moved.get("workloads", [cell])
    for w in bench["workloads"]:
        rep = [m for m in bench["end_to_end"]
               if w["name"] in m.get("workloads", [w["name"]])]
        assert len(rep) >= 2                    # setup_s and one other
        assert any(w["name"] in m["workloads"] for m in bench["per_layer"])


@PARKED
def test_every_cell_loads_by_name(bench, parked):
    from perfbench import harness
    bench = with_parked(bench) if parked else bench
    for w in bench["workloads"]:
        spec = harness.cell_spec(bench, w["name"])
        assert callable(spec["mix"].make)
        assert spec["config"]["reduced"] == []
        assert spec["limits"]


def test_metric_files_serve_the_names_that_share_them():
    from perfbench import harness
    assert harness.reader("idle_share.sweep") is not None
    assert (harness.reader("plan_ms.select").__module__
            == harness.reader("plan_ms.sweep").__module__)


DUMMY_MIX = '''"""A client that sweeps the static metrics alone and asks for the
densest feasible design: a new entry and a new op, in this file only."""
import time

import torch


class DensestFeasible:
    name = "densest"

    def run(self, batch, probes):
        d = torch.where(batch.feasible & batch.valid, batch.density_gb_mm2,
                        torch.zeros_like(batch.density_gb_mm2))
        return float(d.max())

    def judge(self, got, ref_cols, prog_cols, device):
        ok = ref_cols["feasible"] & ref_cols["valid"]
        want = float(torch.where(ok, ref_cols["density_gb_mm2"],
                                 torch.zeros_like(ok, dtype=torch.float32))
                     .max())
        return {"densest_gap": abs(got - want)}

    def control(self, cols):
        return None


class StaticLoop:
    sync_plan = True

    def __init__(self, config, seed, device, probes):
        from perfbench.drive import decls, rng
        self.todo = decls(config["space"], rng(seed, "window"))
        self.device, self.ops = device, [DensestFeasible()]

    def warm(self):
        pass

    def reseed(self, seed):
        pass

    def window(self, seconds):
        from repro_torch.core import dse
        from perfbench.spaces import program_space
        decl = next(self.todo)
        t0 = time.perf_counter()
        batch = dse.sweep(program_space(decl), with_transient=False,
                          device=self.device)
        outs = {op.name: op.run(batch, None) for op in self.ops}
        item = {"decl": decl, "sweep": {"with_transient": False},
                "batch": batch, "outs": outs, "ops": self.ops}
        return {"rows": len(batch), "iterations": 1, "attempted": 1,
                "failed": 0, "errors": [], "kept": [item],
                "elapsed_s": time.perf_counter() - t0, "latencies_ms": [],
                "counters": {}}

    def close(self):
        pass


def make(config, seed, device, probes):
    return StaticLoop(config, seed, device, probes)
'''


def test_a_dummy_cell_comes_from_files_alone(bench, tmp_path, cpu):
    """A new configuration, a mix with a new entry and a new op, a metric
    and a cell, as new files and entries: no file of the harness
    changes."""
    from perfbench import harness
    before = {p: p.read_bytes() for p in (ROOT / "perfbench").rglob("*.py")}
    folder = tmp_path / "perfbench"
    shutil.copytree(ROOT / "perfbench" / "metrics", folder / "metrics")
    (folder / "traffic").mkdir()
    (folder / "configs").mkdir()
    conf = {"name": "aos-only", "space": [
        ["product", {"techs": ["aos"], "layers": [64, 87]}],
        ["with_mc", {"samples": 4}]], "reduced": [], "assumed": []}
    (folder / "configs/aos-only.json").write_text(json.dumps(conf))
    (folder / "traffic/densest.py").write_text(DUMMY_MIX)
    (folder / "traffic/densest.json").write_text(json.dumps(
        {"limits": {"rows_off": 0, "value_gap": 0.0, "time_gap_dt": 0.0,
                    "densest_gap": 0.0}}))
    (folder / "metrics/iterations_done.py").write_text(
        "def read(rec):\n    return float(rec.iterations)\n")
    bench = dict(bench)
    bench["configs"] = bench["configs"] + [{
        "name": "aos-only", "source": "x", "reduced": [], "why": "x",
        "file": "perfbench/configs/aos-only.json"}]
    bench["workloads"] = bench["workloads"] + [{
        "name": "aos-only.densest", "config": "aos-only",
        "traffic": "densest", "chips": 1, "why": "x"}]
    bench["end_to_end"] = bench["end_to_end"] + [{
        "name": "iterations_done", "unit": "count", "better": "higher",
        "bound": 0.1, "source": "host_clock",
        "workloads": ["aos-only.densest"]}]
    spec = harness.cell_spec(bench, "aos-only.densest", root=tmp_path,
                             folder=folder)
    out = harness.run_cell(spec, SEED, 0.2, False, cpu, 0.0)["line"]
    assert out["correct"], out["check"]
    assert out["check"]["densest_gap"] == {"value": 0.0, "limit": 0.0}
    assert out["metrics"]["iterations_done"]["value"] == 1
    assert set(out["metrics"]) == {"iterations_done", "setup_s"}
    assert before == {p: p.read_bytes()
                      for p in (ROOT / "perfbench").rglob("*.py")}


def test_configs_declare_their_rows(bench):
    from perfbench.spaces import reference_space, with_key
    for c in bench["configs"]:
        conf = json.loads((ROOT / c["file"]).read_text())
        space = reference_space(with_key(conf["space"], 1))
        assert len(space) == conf["rows"]
        assert sum(len(g) for _, _, g in space.entries) == conf["designs"]
