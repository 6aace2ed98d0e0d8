"""Shared fixtures of the benchmark's CPU tests: the checkout on the path,
cells shrunk to a size a CPU run holds (a few MC samples), and the parked
cells (`parked.json`: entries kept out of `BENCHMARK.json`, whose files
stay under test)."""

from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

SEED = 2**31 + 12345          # run seeds may pass 32 signed bits
PARKED = Path(__file__).resolve().parent / "parked.json"


def small(spec: dict, samples: int = 8) -> dict:
    """A cell spec with its MC fan-out cut to `samples` (CPU-sized)."""
    for name, kwargs in spec["config"]["space"]:
        if name == "with_mc":
            kwargs["samples"] = samples
    return spec


@pytest.fixture
def bench():
    from perfbench import harness
    return harness.load_benchmark()


def with_parked(bench: dict) -> dict:
    """`bench` with the parked cells' workloads and metrics added."""
    parked = json.loads(PARKED.read_text())
    return {k: v + parked.get(k, []) if isinstance(v, list) else v
            for k, v in bench.items()}


@pytest.fixture
def cpu():
    import torch
    return torch.device("cpu")
