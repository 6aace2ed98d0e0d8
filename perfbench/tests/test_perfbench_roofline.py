"""The rooflines' counts against hand counts at tiny sizes, and the
readers' arithmetic."""

from __future__ import annotations

import math

import pytest
import torch

from perfbench import readers, roofline

DT = 0.02
CAPS = (800, 1000, 500)
PEAKS = {"hbm_bytes_per_s": 1e9, "f32_ops_per_s": 1e9}
NAN = float("nan")


def test_ops_and_bytes_of_a_six_node_row():
    assert roofline.ops_per_step(6) == 112          # 18 * 6 + 4
    # N = 6, params 6: inputs 4*(4*6 + 5 + 6) = 140 B, outputs 4*(4 + 6)
    assert roofline.row_cycle_bytes(1, 6, 6) == 180
    assert roofline.row_cycle_bytes(3, 6, 5) == 3 * (4 * 34 + 40)


def test_row_steps_by_hand():
    evt = torch.tensor([[0.10, 0.1, 0.40, 0.20],     # 5 + 20 + 10 steps
                        [NAN, 0.1, NAN, NAN],        # every window: 2300
                        [0.06, 0.1, 0.20, 0.02],     # replica: ACT only, 3
                        [0.10, 0.1, 0.40, 0.20]])    # inactive: 0
    params = torch.zeros(4, 6)
    params[:, 4] = torch.tensor([1.0, 1.0, 1.0, 0.0])
    params[2, 5] = 1.0
    steps = roofline.row_steps(evt, params, DT, CAPS)
    assert steps.tolist() == [35.0, 2300.0, 3.0, 0.0]


def test_row_cycle_bound_takes_the_larger_of_ops_and_bytes():
    evt = torch.tensor([[0.10, 0.1, 0.40, 0.20]] * 2)
    params = torch.zeros(2, 6)
    params[:, 4] = 1.0
    got = float(roofline.row_cycle_bound_s(evt, params, 6, DT, CAPS, PEAKS))
    ops = 2 * 35 * 112 / 1e9
    assert got == pytest.approx(max(ops, 2 * 180 / 1e9), rel=1e-12)
    slow_mem = dict(PEAKS, hbm_bytes_per_s=1.0)
    got = float(roofline.row_cycle_bound_s(evt, params, 6, DT, CAPS,
                                           slow_mem))
    assert got == pytest.approx(360.0)


def test_pareto_bound_is_19_bytes_a_row():
    assert roofline.PARETO_BYTES_PER_ROW == 19
    assert roofline.pareto_bound_s(1000, PEAKS) == pytest.approx(19e-6)


def test_peaks_table_names_the_h100():
    pk = roofline.peaks("NVIDIA H100 80GB HBM3")
    assert pk["hbm_bytes_per_s"] == 3.35e12
    assert roofline.peaks("cpu") is None


class Rec:
    def __init__(self, **kw):
        self.__dict__.update(kw)


def test_readers_arithmetic():
    rec = Rec(rows=600, elapsed_s=2.0, iterations=3,
              device_ms={"pareto": [10.0, 20.0, 30.0]},
              host_ms={}, bound_s={"pareto": 0.003},
              busy_s=1.5, window_s=2.0)
    assert readers.rows_per_s(rec) == 300.0
    assert readers.ms_per_iteration(rec.device_ms, "pareto", rec) == 20.0
    assert readers.ms_per_iteration(rec.host_ms, "plan_sweep", rec) is None
    assert readers.roofline_pct(rec, "pareto") == pytest.approx(5.0)
    assert readers.roofline_pct(rec, "row_cycle") is None
    assert readers.idle_pct(rec) == pytest.approx(25.0)
    assert readers.p95(list(range(101))) == 95.0
    assert readers.p95([]) is None
    assert not math.isnan(readers.rows_per_s(rec))
