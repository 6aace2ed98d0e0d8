"""The least time the card could take for a piece of work: the table of
peaks and the operation and byte counts of each measured kernel.

The row-cycle counts are copied from the program's measurement script
(`chip_smoke.py` `ops_per_step`, `bound_ms`) and the steps a row needs from
`src/repro_torch/kernels/bench.py` `row_steps`: 180 B a row at N = 6, and
18N + 4 float32 operations a step.  The Pareto mask's bound is bytes only:
its four float32 objectives, `valid` and `feasible` read once and the
mask written once, 19 B a row, which holds for any algorithm.
"""

from __future__ import annotations

import json
from pathlib import Path

import torch

PEAKS_FILE = Path(__file__).resolve().parent / "peaks.json"
PARETO_BYTES_PER_ROW = 4 * 4 + 1 + 1 + 1


def peaks(kind: str) -> dict | None:
    """The published peaks of the card named `kind`, or None if the table
    has none (a roofline reader then reports nothing)."""
    return json.loads(PEAKS_FILE.read_text()).get(kind)


def ops_per_step(n: int) -> int:
    """float32 operations of one implicit-Euler step of an N-node row:
    ramp 7, assembly 6N, Thomas 9(N-1)+3, crossings and event 3(N-1)+6."""
    return 18 * n + 4


def row_cycle_bytes(b: int, n: int, n_params: int) -> int:
    """Each input read once, each output written once."""
    return 4 * b * (4 * n + (n - 1) + n_params) + 4 * b * (4 + n)


def row_steps(evt, params, dt, caps):
    """Implicit-Euler steps each row takes on these inputs (a phase's
    crossing step, or its window on a timeout; replica rows stop after
    ACT, inactive rows take none)."""
    def phase(t, cap):
        return torch.where(torch.isnan(t), float(cap), torch.round(t / dt))

    act = phase(evt[:, 0], caps[0])
    rest = phase(evt[:, 2], caps[1]) + phase(evt[:, 3], caps[2])
    role = params[:, 5] if params.shape[1] > 5 else torch.zeros_like(act)
    replica = (role - 1.0).abs() < 0.5
    return torch.where(params[:, 4] > 0.5,
                       act + torch.where(replica, 0.0, rest), 0.0)


def row_cycle_bound_s(evt, params, n: int, dt, caps, pk: dict):
    """One launch's least time in seconds, as a 0-d tensor on the launch's
    device (no synchronization): the larger of its operations over the
    float32 peak and its bytes over the memory rate."""
    steps = row_steps(evt, params, dt, caps).to(torch.float64).sum()
    t_ops = steps * ops_per_step(n) / pk["f32_ops_per_s"]
    t_bytes = row_cycle_bytes(evt.shape[0], n, params.shape[1]) / \
        pk["hbm_bytes_per_s"]
    return torch.clamp_min(t_ops, t_bytes)


def pareto_bound_s(rows: int, pk: dict) -> float:
    return rows * PARETO_BYTES_PER_ROW / pk["hbm_bytes_per_s"]
