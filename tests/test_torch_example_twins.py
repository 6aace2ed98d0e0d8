"""The port's twins of `examples/quickstart.py` and `examples/serve_lm.py`
on the CPU (`--device cpu`).

- `examples/quickstart_torch.py`: its Table-1 numbers (C_BL, margin, tRC
  of `dse.sweep(DesignSpace.paper_targets())`) against the reference's
  sweep of the same targets, within the port's sweep bars
  (tests/test_torch_sweep.py: C_BL at float32 rounding, rtol 1e-5; the
  margin at the SA fire at dv_sense's bar, rtol 1e-3 / atol 1e-2 mV; tRC
  within 3 dt + 0.05 ns); the training survives its injected crash with
  one restart; the strap-cache serve decodes 2 x 8 tokens; it prints
  `quickstart OK`;
- `examples/serve_lm_torch.py`: strap-exact == dense, bit for bit (the
  twin asserts it, as the original does), and the printed line says so.
"""

import contextlib
import importlib.util
import io
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import dse as jdse  # noqa: E402
from repro.core.space import DesignSpace as JDesignSpace  # noqa: E402
from repro_torch.core import transient  # noqa: E402

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
TRC_BAR_NS = 3 * transient.DT_NS + 0.05


@pytest.fixture(autouse=True)
def one_thread():
    """The twins' smoke-size models gain nothing from intra-op threads,
    and beside the suite's other workers those threads oversubscribe the
    cores (the quickstart's 20 training steps took minutes so)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run_twin(name: str, argv: list[str]):
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / name)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = module.main(argv)
    return out, buf.getvalue()


def test_quickstart_twin_on_the_cpu(tmp_path):
    out, text = run_twin("quickstart_torch.py",
                         ["--device", "cpu", "--ckpt-dir", str(tmp_path)])
    batch = out["batch"]
    ref = jdse.sweep(JDesignSpace.paper_targets())
    assert list(batch.tech_col) == list(ref.tech_col)
    np.testing.assert_allclose(batch.cbl_ff.numpy(), np.asarray(ref.cbl_ff),
                               rtol=1e-5)
    np.testing.assert_allclose(batch.margin_mv.numpy(),
                               np.asarray(ref.margin_mv), rtol=1e-3,
                               atol=1e-2)
    np.testing.assert_allclose(batch.trc_ns.numpy(), np.asarray(ref.trc_ns),
                               rtol=0, atol=TRC_BAR_NS)
    assert out["train"]["restarts"] == 1
    assert np.isfinite(out["train"]["final_loss"])
    assert out["tokens"].shape == (2, 8)
    assert 0 < out["traffic_reduction"] <= 1
    assert text.rstrip().endswith("quickstart OK")
    for tech in ref.tech_col:
        assert f"  {tech:4s}: C_BL=" in text


def test_serve_lm_twin_on_the_cpu():
    out, text = run_twin("serve_lm_torch.py", ["--device", "cpu"])
    assert (out["dense"] == out["strap-exact"]).all()
    assert out["dense"].shape == (4, 16)
    assert "strap-exact == dense: True (bit-identical greedy)" in text
