"""Training launcher (single process, one device).

Port of `repro.launch.train`, with `--device` (default cuda; without a
GPU it refuses unless given `--device cpu`):

  PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b --smoke \
      --steps 100 --batch 8 --seq 256 [--device cpu]

Ends with `done: first loss <x> -> final <y> (<n> restarts)`.
"""

from __future__ import annotations

import argparse
import os
import tempfile


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-trainable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_train"))
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--inject-crash", type=int, default=-1,
                    help="inject a crash at this step (fault-tolerance demo)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from ..configs.registry import get_arch
    from ..train.loop import TrainConfig, train
    from ..train.optimizer import OptConfig

    name = args.arch + ("-smoke" if args.smoke else "")
    cfg = get_arch(name)
    schedule = {args.inject_crash: "crash"} if args.inject_crash >= 0 else {}
    tc = TrainConfig(
        steps=args.steps, batch_size=args.batch, seq_len=args.seq,
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
        microbatch=args.microbatch or None,
        opt=OptConfig(lr=args.lr, total_steps=args.steps),
        failure_schedule=schedule)
    out = train(cfg, tc, device=args.device)
    print(f"done: first loss {out['first_loss']:.4f} -> "
          f"final {out['final_loss']:.4f} ({out['restarts']} restarts)")
    return out


if __name__ == "__main__":
    main()
