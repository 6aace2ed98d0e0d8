"""The port stands alone: `repro_torch` and `chip_smoke.py` import neither
JAX nor the reference package, and the port's entry points run on the GPU
unless the caller asks for the CPU."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import (calibration, density,  # noqa: E402
                              device_models, disturb, dse, energy, netlist,
                              parasitics, report, routing, sense, space,
                              transient)
from repro_torch import interop  # noqa: E402
from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.core.batch import DesignBatch  # noqa: E402
from repro_torch.memory.strap_cache import (StrapCacheConfig,  # noqa: E402
                                            StrapKVCache)
from repro_torch.models import registry as models  # noqa: E402
from repro_torch.launch import (elastic, mesh, multiproc,  # noqa: E402
                                serve, shard)
from repro_torch.distributed import (collectives, context,  # noqa: E402, F401
                                     sharding, tensor_parallel)
from repro_torch.launch import group, optlevels  # noqa: E402, F401
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.train import loop  # noqa: E402
from repro_torch.serving.dse_service import DSEService  # noqa: E402
from repro_torch.serving.engine import ServeEngine  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"
PORT_FILES = sorted(PORT.rglob("*.py")) + [
    REPO / "chip_smoke.py", REPO / "examples" / "dram_codesign_torch.py",
    REPO / "examples" / "train_lm_torch.py",
    REPO / "examples" / "quickstart_torch.py",
    REPO / "examples" / "serve_lm_torch.py"]


FABRIC_FILES = ("runtime/fault.py", "launch/mesh.py", "launch/shard.py",
                "launch/elastic.py", "launch/multiproc.py")
DIST_TRAIN_FILES = ("distributed/context.py", "distributed/sharding.py",
                    "distributed/collectives.py", "launch/group.py",
                    "launch/optlevels.py")
DRYRUN_FILES = ("launch/dryrun.py", "roofline/__init__.py",
                "roofline/analytic.py", "roofline/analyze.py",
                "roofline/counts.py")


def test_fabric_modules_are_scanned():
    """The multi-GPU fabric's modules are among the files the AST scan
    below reads (and the import test loads)."""
    scanned = {p.relative_to(PORT).as_posix() for p in PORT_FILES
               if PORT in p.parents}
    assert set(FABRIC_FILES) <= scanned
    assert {"repro_torch.runtime.fault", "repro_torch.launch.mesh",
            "repro_torch.launch.shard", "repro_torch.launch.elastic",
            "repro_torch.launch.multiproc"} <= set(_module_names())


def test_distributed_training_modules_are_scanned():
    """The distributed-training slice's modules are among the files the
    AST scan reads and the import test loads."""
    scanned = {p.relative_to(PORT).as_posix() for p in PORT_FILES
               if PORT in p.parents}
    assert set(DIST_TRAIN_FILES) <= scanned
    assert {"repro_torch.distributed.context",
            "repro_torch.distributed.sharding",
            "repro_torch.distributed.collectives",
            "repro_torch.launch.group",
            "repro_torch.launch.optlevels"} <= set(_module_names())


def test_dryrun_and_roofline_modules_are_scanned():
    """The dry run's and the roofline's modules, and the example twins,
    are among the files the AST scan reads (and the import test loads)."""
    scanned = {p.relative_to(PORT).as_posix() for p in PORT_FILES
               if PORT in p.parents}
    assert set(DRYRUN_FILES) <= scanned
    assert {"quickstart_torch.py", "serve_lm_torch.py"} <= \
        {p.name for p in PORT_FILES}
    assert {"repro_torch.launch.dryrun", "repro_torch.roofline",
            "repro_torch.roofline.analytic", "repro_torch.roofline.analyze",
            "repro_torch.roofline.counts"} <= set(_module_names())


def test_tensor_parallel_module_is_scanned():
    """The "model" axis's module is among the files the AST scan reads and
    the import test loads."""
    scanned = {p.relative_to(PORT).as_posix() for p in PORT_FILES
               if PORT in p.parents}
    assert "distributed/tensor_parallel.py" in scanned
    assert "repro_torch.distributed.tensor_parallel" in _module_names()
    assert tensor_parallel.model_split is not None


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


def _points():
    """A legacy `list[DesignPoint]` (swept on the CPU)."""
    batch = dse.sweep(space.DesignSpace.paper_targets(), device="cpu")
    return [batch.point(i) for i in range(len(batch))]


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
    "DesignBatch.from_points": lambda: DesignBatch.from_points(_points()),
    "dse.pareto_front(list)": lambda: dse.pareto_front(_points()),
    "dse.best_design(list)": lambda: dse.best_design(_points()),
    "models.registry.init_params": lambda: models.init_params(
        get_arch("qwen2-1.5b-smoke"), torch.Generator()),
    "models.registry.init_cache": lambda: models.init_cache(
        get_arch("qwen2-1.5b-smoke"), 1, 8),
    "interop.params_from_numpy": lambda: interop.params_from_numpy(
        {"embed": np.zeros((4, 2), np.float32)}),
    "StrapKVCache.create": lambda: StrapKVCache.create(
        StrapCacheConfig(), 1, 64, 1, 8),
    "ServeEngine": lambda: ServeEngine(get_arch("qwen2-1.5b-smoke"),
                                       {"embed": torch.zeros(4, 2)}),
    "DSEService": lambda: DSEService(),
    "launch.serve.main": lambda: serve.main(["--smoke"]),
    "dse.evaluate_grid": lambda: dse.evaluate_grid(
        calibration.AOS, "sel_strap", np.asarray([87])),
    "transient.simulate_row_cycle_lowered(plan)": lambda: (
        transient.simulate_row_cycle_lowered(dse.plan_sweep(
            space.DesignSpace.paper_targets()).operands)),
    "sense.sense_margin_mv": lambda: sense.sense_margin_mv(
        calibration.AOS, "sel_strap", [87]),
    "sense.charge_share_mv": lambda: sense.charge_share_mv(
        calibration.AOS, "sel_strap", [87]),
    "sense.functional": lambda: sense.functional(
        calibration.AOS, "sel_strap", [87]),
    "energy.write_energy_fj": lambda: energy.write_energy_fj(
        calibration.AOS, "sel_strap", [87]),
    "energy.read_energy_fj": lambda: energy.read_energy_fj(
        calibration.AOS, "sel_strap", [87]),
    "netlist.effective_cbl_ff": lambda: netlist.effective_cbl_ff(
        calibration.AOS, "sel_strap", [87]),
    "parasitics.local_bl_cap_ff": lambda: parasitics.local_bl_cap_ff(
        calibration.AOS, [87]),
    "routing.bonding_geometry": lambda: routing.bonding_geometry(
        calibration.AOS, "sel_strap"),
    "routing.hcb_pitch_um": lambda: routing.hcb_pitch_um(
        calibration.AOS, "sel_strap"),
    "disturb.disturb_loss_mv": lambda: disturb.disturb_loss_mv(
        calibration.AOS, "sel_strap", [87]),
    "device_models.ids_ua": lambda: device_models.ids_ua(
        device_models.SI_ACCESS, 1.0, 0.5),
    "device_models.r_on_eff_kohm": lambda: device_models.r_on_eff_kohm(
        device_models.SI_ACCESS, 2.0, 0.55),
    "device_models.subthreshold_swing_mv_dec": lambda: (
        device_models.subthreshold_swing_mv_dec(device_models.SI_ACCESS)),
    "mesh.make_sweep_mesh": lambda: mesh.make_sweep_mesh(),
    "mesh.make_test_mesh": lambda: mesh.make_test_mesh(),
    "mesh.make_local_mesh": lambda: mesh.make_local_mesh(),
    "mesh.make_train_mesh": lambda: mesh.make_train_mesh(),
    "shard.sweep_sharding": lambda: shard.sweep_sharding(),
    "shard.sharded_sweep": lambda: shard.sharded_sweep(
        space.DesignSpace.paper_targets()),
    "shard.main(--smoke)": lambda: shard.main(["--smoke"]),
    "elastic.elastic_sweep": lambda: elastic.elastic_sweep(
        space.DesignSpace.paper_targets()),
    "multiproc.run_smoke": lambda: multiproc.run_smoke(),
    "multiproc.main(--smoke)": lambda: multiproc.main(["--smoke"]),
    "train.loop.train": lambda: loop.train(get_arch("qwen2-1.5b-smoke"),
                                           loop.TrainConfig(steps=1)),
    "launch.train.main(--smoke)": lambda: launch_train.main(
        ["--arch", "qwen2-1.5b", "--smoke"]),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_defaults_to_cuda_and_refuses_without_it(name):
    """Without a GPU, an entry point called with no `device=` raises and
    says how to ask for the CPU — it never carries on there silently."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ENTRY_POINTS[name]()
