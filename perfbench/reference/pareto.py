"""Judge a Pareto mask against the columns it was taken from.

Maximize density and disturbed margin, minimize tRC and read energy,
over rows that are valid and feasible (the program's `dse.pareto_mask`
rule; a NaN objective never dominates and is never dominated).  A mask P
is the front exactly when every row of P is a candidate that no candidate
dominates, and every other candidate is dominated by a row of P: a
dominated row is dominated by some undominated one.  Both tests cost
O(|P| * B), not the O(B^2) of computing the front from scratch.
"""

from __future__ import annotations

import torch

BLOCK = 4096


def objectives(cols):
    hi = torch.stack([cols["density_gb_mm2"], cols["margin_disturbed_mv"]],
                     dim=1)
    lo = torch.stack([cols["trc_ns"], cols["e_read_fj"]], dim=1)
    return hi, lo, cols["valid"] & cols["feasible"]


def dominated(hi_d, lo_d, hi, lo) -> torch.Tensor:
    """Which rows of (hi, lo) some row of (hi_d, lo_d) dominates."""
    out = torch.zeros((hi.shape[0],), dtype=torch.bool, device=hi.device)
    for i in range(0, hi_d.shape[0], BLOCK):
        h, l = hi_d[i:i + BLOCK, None, :], lo_d[i:i + BLOCK, None, :]
        ge = (h >= hi[None]).all(-1) & (l <= lo[None]).all(-1)
        gt = (h > hi[None]).any(-1) | (l < lo[None]).any(-1)
        out |= (ge & gt).any(dim=0)
    return out


def mask_mismatches(cols, mask: torch.Tensor) -> int:
    """Rows where `mask` is not the Pareto front of `cols`."""
    hi, lo, cand = objectives(cols)
    mask = mask.to(device=hi.device, dtype=torch.bool)
    bad = int((mask & ~cand).sum())
    front = mask & cand
    idx = torch.nonzero(front).flatten()
    cidx = torch.nonzero(cand).flatten()
    bad += int(dominated(hi[cidx], lo[cidx], hi[idx], lo[idx]).sum())
    rest = torch.nonzero(cand & ~front).flatten()
    covered = dominated(hi[idx], lo[idx], hi[rest], lo[rest])
    return bad + int((~covered).sum())
