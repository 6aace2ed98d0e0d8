"""Frozen copy of `src/repro_torch/core/units.py` for the benchmark's plain reference,
trimmed to the lowered path it takes (imports rewritten; nothing of the
program is imported).

Unit conventions for the STCO engine.

Copy of `repro.core.units` (the port imports nothing of `repro`);
`tests/test_torch_registry.py` holds the two equal.

Internally the engine uses a consistent scaled-SI system chosen so numbers
stay O(1) and products compose without conversion constants:

  capacitance : fF   (1e-15 F)
  resistance  : kOhm (1e3 Ohm)
  time        : ns   (1e-9 s)    -> tau[ns] = R[kOhm] * C[fF] * 1e-3
  voltage     : V
  current     : uA   (1e-6 A)    -> I = V/R : V/kOhm = mA -> use MA2UA
  energy      : fJ   (1e-15 J)   -> E = C[fF] * V^2  (exact)
  length      : nm / um as named
  density     : Gb/mm^2
"""

from __future__ import annotations

# tau[ns] = R[kOhm] * C[fF] * RC_TO_NS
RC_TO_NS = 1e-3
# I[uA] = V[V] / R[kOhm] * MA_TO_UA
MA_TO_UA = 1e3

NM2_PER_MM2 = 1e12
GBIT = 1e9


def tau_ns(r_kohm: float, c_ff: float) -> float:
    """RC time constant in ns."""
    return r_kohm * c_ff * RC_TO_NS
