"""The port's two-process `torch.distributed` smoke
(`repro_torch.launch.multiproc`) on the CPU: two gloo processes of two
mesh slots each, meeting through a file rendezvous.

`run_smoke` runs in a subprocess of its own with its own timeout (it
spawns the two children).  Every child's JSON record is checked: the
group formed, the three spaces were checked (the all_gather of the
operand slabs, the rank's own point slab, the sweep and the Pareto mask
over the 4-slot global mesh), and the ranks' slabs tile every space.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

SRC = str(Path(__file__).resolve().parents[1] / "src")
SPACES = {"targets": 3, "targets-mc": 24, "replica-mc": 24}   # points, mc=8

SCRIPT = (
    "import json\n"
    "from repro_torch.launch.multiproc import run_smoke\n"
    "records = run_smoke(num_processes=2, mc=8, local_devices=2, "
    "device='cpu', timeout_s=240.0)\n"
    "print(json.dumps(records))\n")


@pytest.fixture(scope="module")
def smoke():
    env = dict(os.environ, PYTHONPATH=SRC)
    r = subprocess.run([sys.executable, "-c", SCRIPT], capture_output=True,
                       text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    lines = r.stdout.strip().splitlines()
    return lines[:-1], json.loads(lines[-1])


def test_smoke_reports_ok(smoke):
    text, _ = smoke
    assert text[-1].startswith("multiproc smoke: OK (2 processes x 2 slots "
                               "on cpu, gloo, file rendezvous")


def test_every_child_reports_its_group(smoke):
    _, records = smoke
    assert sorted(r["process"] for r in records) == [0, 1]
    for r in records:
        assert r["ok"] is True
        assert (r["world"], r["global_slots"], r["local_slots"]) == (2, 4, 2)
        assert r["device"] == "cpu"


@pytest.mark.parametrize("label", sorted(SPACES))
def test_each_space_checked_on_every_rank(smoke, label):
    _, records = smoke
    for r in records:
        check = r["checks"][label]
        assert check["points"] == SPACES[label]
        assert check["pareto"] is True
        assert check["launches"] == 0          # the plain version, no card


@pytest.mark.parametrize("label", sorted(SPACES))
def test_slabs_tile_the_space(smoke, label):
    _, records = smoke
    slabs = sorted(r["checks"][label]["rows"] for r in records)
    n = SPACES[label]
    assert slabs[0][0] == 0 and slabs[-1][1] == n
    assert all(a[1] == b[0] and a[0] < a[1] for a, b in zip(slabs,
                                                             slabs[1:]))
    line = [ln for ln in smoke[0] if ln.startswith(f"{label}:")]
    assert line and f"{n} points tiled over 2 processes" in line[0]
