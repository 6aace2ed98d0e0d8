"""The port stands alone: `repro_torch` and `chip_smoke.py` import neither
JAX nor the reference package, and the port's entry points run on the GPU
unless the caller asks for the CPU."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import (calibration, density, dse, report,  # noqa: E402
                              space, transient)
from repro_torch import interop  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"
PORT_FILES = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def _module_names():
    return sorted(
        ".".join(p.relative_to(REPO / "src").with_suffix("").parts)
        .removesuffix(".__init__")
        for p in PORT.rglob("*.py"))


def test_import_pulls_in_no_jax_and_no_reference():
    """A fresh interpreter imports every port module; afterwards no `jax*`
    module and no `repro` / `repro.*` module may be loaded."""
    code = (
        "import importlib, sys\n"
        f"for m in {_module_names()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'jaxlib')) or m == 'repro' or "
        "m.startswith('repro.'))\n"
        "print('LOADED', len(sys.modules), 'BAD', bad)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120, check=False)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("BAD []"), out.stdout


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_source_never_imports_jax_or_reference(path):
    """AST scan: no `import jax*`, no `import repro` / `from repro...`
    (relative imports inside the port are fine)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            if top in ("jax", "jaxlib", "repro"):
                bad.append((node.lineno, name))
    assert not bad, f"{path}: {bad}"


ENTRY_POINTS = {
    "dse.sweep": lambda: dse.sweep(space.DesignSpace.paper_targets()),
    "dse.plan_sweep": lambda: dse.plan_sweep(space.DesignSpace.paper_targets()),
    "DesignSpace.lower": lambda: space.DesignSpace.paper_targets().lower(),
    "transient.simulate_row_cycle": lambda: transient.simulate_row_cycle(
        calibration.AOS, "sel_strap", [87]),
    "transient.simulate_row_cycle_many": lambda: (
        transient.simulate_row_cycle_many(
            [(calibration.AOS, "sel_strap", [87])])),
    "transient.nominal_trc_ns": lambda: transient.nominal_trc_ns(
        calibration.AOS),
    "transient.simulate_row_cycle(traces=True)": lambda: (
        transient.simulate_row_cycle(calibration.AOS, "sel_strap", [87],
                                     traces=True)),
    "transient.simulate_row_cycle_phased": lambda: (
        transient.simulate_row_cycle_phased(calibration.AOS, "sel_strap",
                                            [87])),
    "density.layers_for_density": lambda: density.layers_for_density(
        calibration.AOS, 2.6),
    "report.fig9a_stack_height": lambda: report.fig9a_stack_height(),
    "report.table1_summary": lambda: report.table1_summary(),
    "report.mc_tail_yield_table": lambda: report.mc_tail_yield_table(
        samples=8),
    "interop.operands_from_numpy": lambda: interop.operands_from_numpy(
        *([[[1.0] * 6]] * 5), [[1.0] * 6], [1.0], [1.0]),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_defaults_to_cuda_and_refuses_without_it(name):
    """Without a GPU, an entry point called with no `device=` raises and
    says how to ask for the CPU — it never carries on there silently."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ENTRY_POINTS[name]()
