"""Fault-tolerant training loop (the end-to-end driver).

Port of `repro.train.loop`: data pipeline -> train step -> checkpoint
manager -> `runtime.fault.FaultTolerantRunner` (crash / NaN restart), on
one device.  The runner catches every `RuntimeError`, so a real fault
(an out-of-memory error, a failed launch) would become a silent restore:
the loop records each restart's exception text in `faults` and prints
it.
"""

from __future__ import annotations

import os
import sys
import tempfile
import time
from dataclasses import dataclass, field

import torch

from ..ckpt.manager import CheckpointManager
from ..configs.base import ArchConfig
from ..data.pipeline import DataLoader, LoaderConfig, SyntheticSource
from ..device import resolve_device
from ..models import registry as M
from ..runtime.fault import FailureInjector, FaultTolerantRunner
from .optimizer import OptConfig
from .step import make_train_step


@dataclass
class TrainConfig:
    steps: int = 200
    batch_size: int = 8
    seq_len: int = 256
    ckpt_every: int = 50
    ckpt_dir: str = field(default_factory=lambda: os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    log_every: int = 10
    microbatch: int | None = None
    opt: OptConfig = field(default_factory=OptConfig)
    seed: int = 0
    failure_schedule: dict = field(default_factory=dict)


def train(cfg: ArchConfig, tc: TrainConfig, verbose: bool = True,
          device="cuda") -> dict:
    """Train `cfg` from seeded weights on `device` (default "cuda"; raises
    without a GPU unless `device="cpu"`).  Returns first / final loss,
    every step's loss (replayed steps again), restarts, the runner's log,
    the final state and `faults`, each restart's exception text."""
    dev = resolve_device(device)
    params = M.init_params(cfg, torch.Generator(dev).manual_seed(tc.seed),
                           dev)
    step_fn, opt = make_train_step(cfg, tc.opt, tc.microbatch)
    opt_state = opt.init(params)

    source = SyntheticSource(cfg.vocab_size, tc.seed)
    loader = DataLoader(source, LoaderConfig(batch_size=tc.batch_size,
                                             seq_len=tc.seq_len,
                                             seed=tc.seed))
    ckpt = CheckpointManager(tc.ckpt_dir, keep=2)

    state = dict(params=params, opt=opt_state)
    losses, faults = [], []
    t_start = time.time()

    def do_step(state, step):
        batch = {k: torch.as_tensor(v, device=dev)     # restart-safe
                 for k, v in loader.batch_at(step).items()}
        params, opt_state, metrics = step_fn(state["params"], state["opt"],
                                             batch)
        m = {k: float(v) for k, v in metrics.items()}
        losses.append(m["loss"])
        if verbose and step % tc.log_every == 0:
            dt = time.time() - t_start
            tps = (step + 1) * tc.batch_size * tc.seq_len / max(dt, 1e-9)
            print(f"step {step:5d} loss {m['loss']:.4f} "
                  f"gnorm {m['grad_norm']:.3f} tok/s {tps:,.0f}", flush=True)
        return dict(params=params, opt=opt_state), m

    def save(step, state):
        ckpt.save(step, state, blocking=False)

    def restore():
        # called by the runner inside its `except`: the fault at hand
        exc = sys.exc_info()[1]
        faults.append(f"{type(exc).__name__}: {exc}")
        ckpt.wait()
        restored, step = ckpt.restore(like=state, device=dev)
        if verbose:
            print(f"[fault] {faults[-1]}; restored from checkpoint @ step "
                  f"{step}", flush=True)
        return restored, step

    try:
        # initial checkpoint so a crash at step 0 can restore
        ckpt.save(0, state, blocking=True)
        runner = FaultTolerantRunner(
            do_step, save, restore,
            injector=FailureInjector(tc.failure_schedule),
            ckpt_every=tc.ckpt_every)
        state, log = runner.run(state, tc.steps)
    finally:
        ckpt.wait()
        loader.close()
    return dict(final_loss=losses[-1] if losses else None,
                first_loss=losses[0] if losses else None,
                losses=losses, restarts=runner.restarts, log=log,
                state=state, faults=faults)
