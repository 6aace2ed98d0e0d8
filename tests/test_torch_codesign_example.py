"""`examples/dram_codesign_torch.py`, the port's twin of the co-design
example, on the CPU at the full paper grid, against the reference's
`dse.sweep(DesignSpace.paper_grid())`.

Gate: the same 73 design points in the same order, the same feasible set,
the same Pareto front, and the selected design
`aos / sel_strap @ 87 layers -> 2.60 Gb/mm2, tRC 10.50 ns`.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import dse as jdse  # noqa: E402
from repro.core.space import DesignSpace as JDesignSpace  # noqa: E402

EXAMPLE = (Path(__file__).resolve().parents[1] / "examples"
           / "dram_codesign_torch.py")
SELECTED = "aos / sel_strap @ 87 layers -> 2.60 Gb/mm2, tRC 10.50 ns"


@pytest.fixture(scope="module")
def example():
    spec = importlib.util.spec_from_file_location("dram_codesign_torch",
                                                  EXAMPLE)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def full_run(example):
    """(the twin's results, its stdout) at the full grid on the CPU."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = example.codesign(example.parse_args(["--device", "cpu"]))
    return out, buf.getvalue()


def rows(batch):
    return [(batch.tech_col[i], batch.scheme_col[i],
             int(np.asarray(batch.layers[i]).item()))
            for i in range(len(batch))]


def host(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_twin_scores_the_reference_points(full_run):
    out, text = full_run
    ref = jdse.sweep(JDesignSpace.paper_grid())
    batch = out["batch"]
    assert len(batch) == len(ref) == 73
    assert rows(batch) == rows(ref)
    np.testing.assert_array_equal(host(batch.feasible), host(ref.feasible))
    n_feas = int(host(ref.feasible).sum())
    assert f"73 design points, {n_feas} feasible" in text


def test_twin_pareto_front_is_the_reference_front(full_run):
    out, text = full_run
    ref_front = jdse.pareto_front(jdse.sweep(JDesignSpace.paper_grid()))
    assert rows(out["front"]) == rows(ref_front)
    assert f"Pareto front ({len(ref_front)} points):" in text


def test_twin_selects_the_paper_design(full_run):
    out, text = full_run
    best = out["best"]
    assert (best.tech, best.scheme, best.layers) == ("aos", "sel_strap", 87)
    assert SELECTED in text
    ref = jdse.best_design(jdse.sweep(JDesignSpace.paper_grid()))
    assert (ref.tech, ref.scheme, ref.layers) == (best.tech, best.scheme,
                                                  best.layers)


def test_twin_smoke(example, capsys):
    assert example.main(["--smoke", "--device", "cpu"]) == 0
    text = capsys.readouterr().out
    assert "sweeping design space (25 design points" in text
    assert SELECTED in text


def test_twin_options(example, capsys):
    """--replica (replica-closed timing moves tRC, not the selection),
    --mc and --mc-tail, at the smoke grid."""
    assert example.main(["--smoke", "--device", "cpu", "--replica",
                         "--mc", "8", "--mc-tail", "256"]) == 0
    text = capsys.readouterr().out
    assert "sweeping design space (25 design points" in text
    assert "aos / sel_strap @ 87 layers -> 2.60 Gb/mm2" in text
    for section in ("fixed t_sense vs replica-closed",
                    "== Monte-Carlo yield: 8 samples/design",
                    "== ppm-tail yield: 256 importance samples/design",
                    "vs D1b baseline"):
        assert section in text, section


def test_twin_sharded_is_not_ported(example):
    with pytest.raises(NotImplementedError, match="multi-GPU fabric"):
        example.main(["--sharded", "--device", "cpu"])


def test_twin_refuses_without_a_gpu(example):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        example.main(["--smoke"])
