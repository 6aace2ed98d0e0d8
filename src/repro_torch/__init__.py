"""PyTorch port of the STCO design-space engine, with Hopper CUDA kernels.

The JAX package `repro` is the reference; this package computes the same
sweep in PyTorch and runs its hot loop (the fused row-cycle transient)
in a hand-written CUDA kernel (`kernels/csrc/row_cycle.cu`).  It imports
neither JAX nor `repro`: the calibration registries are kept as copies
here and held equal to the reference by the `tests/test_torch_*` parity
tests.

Entry points (`core.dse.sweep`, `core.dse.plan_sweep`,
`core.transient.simulate_row_cycle*`, `core.transient.nominal_trc_ns`)
take `device=` and default to "cuda"; pass `device="cpu"` to run the
plain PyTorch path on the CPU.
"""
