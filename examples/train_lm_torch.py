"""End-to-end driver on the GPU: train a ~100M-parameter LM for a few
hundred steps — the PyTorch port of `examples/train_lm.py` (same config,
same output, same final assertion).

Uses the port's subsystems: synthetic-corpus data pipeline, AdamW, remat,
checkpointing every 100 steps, fault injection at step 150 (the loop
restores and continues), loss curve printed.

~100M params: olmo-1b config scaled to d_model=512, 8 layers, vocab 50304.

Run:  PYTHONPATH=src python examples/train_lm_torch.py [--steps 200]
          [--batch 8] [--seq 256] [--device cuda|cpu] [--ckpt-dir DIR]

`--device` defaults to cuda and raises without a GPU; `--device cpu`
runs the plain PyTorch path.
"""

import argparse
import dataclasses
import os
import tempfile

from repro_torch.configs.registry import get_arch
from repro_torch.train.loop import TrainConfig, train
from repro_torch.train.optimizer import OptConfig


def example_config():
    """OLMo-1B cut to d_model 512, 8 layers, 8 heads of 64, d_ff 2048, in
    float32."""
    return dataclasses.replace(
        get_arch("olmo-1b"), name="olmo-100m", n_layers=8, d_model=512,
        n_heads=8, n_kv_heads=8, head_dim=64, d_ff=2048, attn_chunk=128,
        param_dtype="float32", compute_dtype="float32")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_train_lm"))
    args = ap.parse_args(argv)

    cfg = example_config()
    n = cfg.param_count()
    print(f"training {cfg.name}: {n / 1e6:.0f}M params, "
          f"{args.steps} steps x {args.batch}x{args.seq} tokens")

    tc = TrainConfig(
        steps=args.steps, batch_size=args.batch, seq_len=args.seq,
        ckpt_every=100, ckpt_dir=args.ckpt_dir, log_every=10,
        opt=OptConfig(lr=6e-4, warmup_steps=20, total_steps=args.steps),
        failure_schedule={150: "crash"} if args.steps > 150 else {})
    out = train(cfg, tc, device=args.device)
    print(f"\nfinal: loss {out['first_loss']:.4f} -> {out['final_loss']:.4f} "
          f"({out['restarts']} restarts survived)")
    assert out["final_loss"] < out["first_loss"], "training must improve"
    return out


if __name__ == "__main__":
    main()
