"""The plain reference agrees with the program's plain CPU path at tiny
sizes, imports nothing of the program, and its judges catch what they
should."""

from __future__ import annotations

import subprocess
import sys

import pytest
import torch

from conftest import ROOT

CPU = torch.device("cpu")
MC = "with_mc"
DECLS = {
    "grid": [["paper_grid", {"layer_grid": [32, 87, 137, 200]}],
             [MC, {"samples": 6, "key": 2**40 + 1}]],
    "targets": [["paper_targets", {}], ["with_replica", {}],
                [MC, {"samples": 32, "key": 5, "tail_shift": [4.5, 0.0]}]],
    "query": [["product", {"techs": ["si", "aos"], "layers": [48, 100, 160]}],
              [MC, {"samples": 5, "key": 77}]],
    "tail": [["paper_targets", {}],
             [MC, {"samples": 64, "key": 9, "corr": 1.0,
                   "tail_shift": [4.0, 0.0], "tail_scale": [1.2, 1.0]}]],
}
SWEEP = {"tail": {"with_transient": False}}


def both(name):
    from repro_torch.core import dse

    from perfbench import check
    from perfbench.reference import score
    from perfbench.spaces import program_space, reference_space
    decl, kw = DECLS[name], SWEEP.get(name, {})
    batch = dse.sweep(program_space(decl), device=CPU, **kw)
    return check.columns(batch), score.sweep(reference_space(decl), CPU,
                                             **kw), batch


@pytest.mark.parametrize("name", sorted(DECLS))
def test_reference_matches_the_program_bit_for_bit(name):
    from perfbench import check
    prog, ref, _ = both(name)
    assert check.compare_rows(prog, ref) == {
        "rows_off": 0, "time_gap_dt": 0.0, "value_gap": 0.0}


@pytest.mark.parametrize("op,margin", [("YieldPpm", 100.0),
                                       ("YieldPpm", 80.0),
                                       ("McSummary", 80.0),
                                       ("McSummary", 60.0)])
@pytest.mark.parametrize("name", ["grid", "targets", "tail"])
def test_reductions_match(name, op, margin):
    from perfbench import ops
    prog, ref, batch = both(name)
    op = getattr(ops, op)(margin)
    got = op.run(batch, _NoProbes())
    assert op.judge(got, ref, prog, CPU) == {"reduce_off": 0,
                                             "reduce_gap": 0.0}


class _NoProbes:
    peaks = None

    def device_span(self, name):
        import contextlib
        return contextlib.nullcontext()


def test_pareto_judge_accepts_the_front_and_catches_one_flip():
    from repro_torch.core import dse

    from perfbench.reference import pareto
    prog, _, batch = both("grid")
    mask = dse.pareto_mask(batch)
    assert 0 < int(mask.sum()) < len(batch)
    assert pareto.mask_mismatches(prog, mask) == 0
    for i in (int(torch.nonzero(mask)[0]), int(torch.nonzero(~mask)[0])):
        bad = mask.clone()
        bad[i] = ~bad[i]
        assert pareto.mask_mismatches(prog, bad) >= 1
    assert pareto.mask_mismatches(prog, torch.ones_like(mask)) > 0


def test_row_gaps_are_read_in_steps_and_column_shares():
    from perfbench import check
    prog, ref, _ = both("query")
    moved = dict(prog, trc_ns=prog["trc_ns"] + 0.04,
                 e_read_fj=prog["e_read_fj"] * 1.01)
    nums = check.compare_rows(moved, ref)
    assert nums["time_gap_dt"] == pytest.approx(2.0, rel=1e-3)
    assert nums["value_gap"] == pytest.approx(0.01, rel=1e-2)
    flag = prog["feasible"].clone()
    flag[3] = ~flag[3]
    assert check.compare_rows(dict(prog, feasible=flag), ref)["rows_off"] == 1
    nan = prog["trc_ns"].clone()
    nan[0] = float("nan")
    assert check.compare_rows(dict(prog, trc_ns=nan), ref)["rows_off"] == 1


@pytest.mark.parametrize("cell,name", [("grid-mc4096.select", "grid"),
                                       ("grid-mc4096.sweep", "grid"),
                                       ("targets-tail.sweep", "tail")])
def test_control_in_bfloat16_fails_the_limits(bench, cell, name):
    """The reference in bfloat16 in the program's place reads outside the
    committed limits (at a size a test holds; the card's readings at the
    cells' sizes are in PERF.md)."""
    from perfbench import check, control, harness
    spec = harness.cell_spec(bench, cell)
    loop = spec["mix"].make(spec["config"], 1, CPU, _NoProbes())
    _, _, batch = both(name)
    item = {"decl": DECLS[name], "sweep": SWEEP.get(name, {}),
            "batch": batch, "ops": loop.ops, "outs": {}}
    nums = check.judge(control.control_items([item], CPU), CPU)
    ok, _ = check.verdict(nums, spec["limits"])
    assert not ok


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r); "
            "import perfbench.reference.score, perfbench.reference.reduce, "
            "perfbench.reference.pareto; "
            "bad = {m.split('.')[0] for m in sys.modules} & "
            "{'repro_torch', 'repro', 'jax', 'jaxlib', 'flax'}; "
            "print(sorted(bad)); sys.exit(bool(bad))" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
