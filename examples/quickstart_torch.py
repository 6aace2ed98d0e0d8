"""Quickstart on the GPU: the whole system in a minute — the PyTorch port
of `examples/quickstart.py` (the same three parts, the same output).

1. Reproduce the paper's headline numbers with the STCO engine (one
   vectorized sweep of the Table-1 targets; the row cycle runs in the
   CUDA kernel `csrc/row_cycle.cu` on the card).
2. Train a tiny LM for a few steps (fault-tolerant loop, a crash at step
   11 restored from the checkpoint).
3. Serve it with the StrapCache (selector+strap) decode path.

Run:  PYTHONPATH=src python examples/quickstart_torch.py [--device cuda|cpu]
          [--ckpt-dir DIR]

`--device` defaults to cuda and raises without a GPU; `--device cpu`
runs the plain PyTorch path.  The checkpoints go to a fresh temporary
directory unless `--ckpt-dir` is given.
"""

import argparse
import tempfile

import numpy as np

from repro_torch.configs.registry import get_arch
from repro_torch.core import dse
from repro_torch.core.space import DesignSpace
from repro_torch.memory.strap_cache import StrapCacheConfig
from repro_torch.serving.engine import ServeEngine
from repro_torch.train.loop import TrainConfig, train


def quickstart(device: str, ckpt_dir: str) -> dict:
    print("== 1. Paper reproduction (selector+strap vs D1b) ==")
    # One vectorized sweep of the Table-1 target points; the printed
    # numbers are read straight off the DesignBatch columns.
    batch = dse.sweep(DesignSpace.paper_targets(), device=device)
    for i, tech in enumerate(batch.tech_col):
        print(f"  {tech:4s}: C_BL={float(batch.cbl_ff[i]):5.2f} fF  "
              f"margin={float(batch.margin_mv[i]):5.0f} mV  "
              f"tRC={float(batch.trc_ns[i]):5.2f} ns")

    print("\n== 2. Train a reduced qwen2 for 20 steps (with crash "
          "injection) ==")
    cfg = get_arch("qwen2-1.5b-smoke")
    out = train(cfg, TrainConfig(steps=20, batch_size=4, seq_len=64,
                                 ckpt_every=8, ckpt_dir=ckpt_dir,
                                 log_every=5, failure_schedule={11: "crash"}),
                device=device)
    print(f"  loss {out['first_loss']:.3f} -> {out['final_loss']:.3f} "
          f"({out['restarts']} fault restart)")

    print("\n== 3. Serve with StrapCache (exact mode == dense, verified) ==")
    params = out["state"]["params"]
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 32))
    eng = ServeEngine(cfg, params, max_tokens=48, cache_backend="strap",
                      strap_cfg=StrapCacheConfig(page_size=8,
                                                 pages_per_strap=2),
                      device=device)
    toks = eng.generate(prompts, 8).cpu().numpy()
    print(f"  decoded: {toks[0].tolist()}")
    print(f"  strap-cache traffic vs dense: "
          f"{100 * eng.stats.traffic_reduction:.0f}%")
    print("\nquickstart OK")
    return dict(batch=batch, train=out, tokens=toks,
                traffic_reduction=eng.stats.traffic_reduction)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: a fresh "
                         "temporary one)")
    args = ap.parse_args(argv)
    if args.ckpt_dir is not None:
        return quickstart(args.device, args.ckpt_dir)
    with tempfile.TemporaryDirectory() as tmp:
        return quickstart(args.device, tmp)


if __name__ == "__main__":
    main()
