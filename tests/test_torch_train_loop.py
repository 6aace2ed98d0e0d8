"""The port's fault-tolerant training loop (`train/loop.py`), its CLI
(`python -m repro_torch.launch.train`) and the example twin
(`examples/train_lm_torch.py`), on the CPU at smoke size.

Gates, as the reference's own loop test reads them: one injected crash
gives one restart (its exception text recorded), the run completes its
steps, and the final loss is below the first.
"""

import contextlib
import importlib.util
import io
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.train.loop import TrainConfig, train  # noqa: E402
from repro_torch.train.optimizer import OptConfig  # noqa: E402

EXAMPLE = Path(__file__).resolve().parents[1] / "examples" / \
    "train_lm_torch.py"


def test_train_survives_an_injected_crash(tmp_path):
    tc = TrainConfig(steps=25, batch_size=4, seq_len=64, ckpt_every=8,
                     ckpt_dir=str(tmp_path), log_every=100,
                     opt=OptConfig(lr=3e-3, warmup_steps=2, total_steps=25),
                     failure_schedule={12: "crash"})
    out = train(get_arch("qwen2-1.5b-smoke"), tc, verbose=False,
                device="cpu")
    assert out["restarts"] == 1
    assert out["faults"] == ["RuntimeError: injected crash at step 12"]
    # steps 8..11 ran twice (restored from the step-8 checkpoint)
    assert len(out["losses"]) == 25 + 4
    assert [e["step"] for e in out["log"]] == list(range(12)) + list(
        range(8, 25))
    assert out["final_loss"] < out["first_loss"]
    assert sorted(int(p.name.split("_")[1]) for p in tmp_path.iterdir()) \
        == [16, 24]


def test_train_restarts_on_a_nan_loss(tmp_path):
    tc = TrainConfig(steps=6, batch_size=2, seq_len=32, ckpt_every=2,
                     ckpt_dir=str(tmp_path), failure_schedule={3: "nan"})
    out = train(get_arch("mamba2-780m-smoke"), tc, verbose=False,
                device="cpu")
    assert out["restarts"] == 1
    assert out["faults"] == ["FloatingPointError: non-finite loss at 3"]
    # step 3's NaN is not logged; steps 2.. replay from the step-2 save
    assert [e["step"] for e in out["log"]] == [0, 1, 2, 2, 3, 4, 5]


def test_cli_smoke_on_cpu(tmp_path):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = launch_train.main([
            "--arch", "qwen2-1.5b", "--smoke", "--steps", "25", "--batch",
            "4", "--seq", "64", "--ckpt-every", "8", "--inject-crash", "12",
            "--ckpt-dir", str(tmp_path), "--device", "cpu"])
    text = buf.getvalue()
    assert out["restarts"] == 1
    done = [ln for ln in text.splitlines() if ln.startswith("done:")]
    assert done == [f"done: first loss {out['first_loss']:.4f} -> final "
                    f"{out['final_loss']:.4f} (1 restarts)"]
    assert out["final_loss"] < out["first_loss"]
    assert "[fault] RuntimeError: injected crash at step 12" in text


def test_example_twin_on_cpu(tmp_path):
    """The twin's config and output lines at a few steps."""
    spec = importlib.util.spec_from_file_location("train_lm_torch", EXAMPLE)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    cfg = example.example_config()
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.head_dim,
            cfg.d_ff, cfg.vocab_size) == (8, 512, 8, 64, 2048, 50304)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = example.main(["--steps", "4", "--batch", "2", "--seq", "32",
                            "--device", "cpu", "--ckpt-dir", str(tmp_path)])
    lines = buf.getvalue().splitlines()
    assert lines[0] == ("training olmo-100m: 59M params, 4 steps x 2x32 "
                        "tokens")
    assert lines[-1] == (f"final: loss {out['first_loss']:.4f} -> "
                         f"{out['final_loss']:.4f} (0 restarts survived)")
