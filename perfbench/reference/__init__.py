"""The plain reference the benchmark holds the program to.

Plain PyTorch and NumPy.  It imports nothing of the program (`repro_torch`),
of the JAX package or of JAX, takes nothing the program made, and
recomputes every answer from the declared space and its MC seed:
calibration, lowering and the MC draws (`space`), parasitics and the
ladder, the fused row-cycle state machine (`engine`), scoring (`score`),
the MC reductions (`reduce`) and the Pareto rule (`pareto`).  The
physics modules are frozen copies of the program's, so a later change to
the program that moves a result shows against them.
"""
