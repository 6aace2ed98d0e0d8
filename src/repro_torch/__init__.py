"""PyTorch port of the STCO design-space engine, with Hopper CUDA kernels.

The JAX package `repro` is the reference; this package computes the same
sweep in PyTorch and runs its hot loops in hand-written CUDA kernels
(`kernels/csrc/`): the fused row-cycle transient of the sweep, the
RC-ladder steps of the phased engine, and the strap-gated decode attention
of the LM server (`serving.engine.ServeEngine` over `memory.strap_cache`).
Its models also train, in one process (`train.step`, `train.loop`,
`data.pipeline`, `ckpt.manager`) and across processes on
`torch.distributed` (`distributed`, `train.step.make_sharded_train_step`),
in plain PyTorch: no Pallas kernel lies on the reference's training
path.  It imports neither JAX nor
`repro`: the calibration registries and the model configs are kept as
copies here and held equal to the reference by the `tests/test_torch_*`
parity tests.

Entry points (`core.dse.sweep`, `core.dse.plan_sweep`,
`core.transient.simulate_row_cycle*`, `core.transient.nominal_trc_ns`,
`serving.dse_service.DSEService`, `models.registry.init_params`,
`serving.engine.ServeEngine`, `train.loop.train`, ...) take `device=` and
default to "cuda"; pass `device="cpu"` to run the plain PyTorch path on
the CPU (`--device cpu` for `python -m repro_torch.launch.serve` and
`python -m repro_torch.launch.train`).
"""
