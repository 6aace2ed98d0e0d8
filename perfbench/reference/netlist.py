"""Frozen copy of `src/repro_torch/core/netlist.py` for the benchmark's plain reference,
trimmed to the lowered path it takes (imports rewritten; nothing of the
program is imported).

RC netlist assembly for the sensing path (the paper's SPICE deck, Fig. 7).

Port of `repro.core.netlist`.  Topology (single-ended half of the
open-BL pair), node order:

   0: BLSA / global sense node      (C_global + C_hcb + C_sa [+ C_unsel])
   1..K: local-BL segments          (C_local split into K lumps)
   K+1: storage node                (Cs)

 branches:
   0-1        : R_global + R_selector (scheme dependent)
   i-(i+1)    : R_local / K  (distributed local BL)
   K-(K+1)    : access transistor (time-varying: scaled by the WL ramp)
"""

from __future__ import annotations

import torch

from .device import as_f32
from . import calibration as cal
from .parasitics import bl_parasitics_lowered

N_BL_SEGMENTS = 4
N_NODES = N_BL_SEGMENTS + 2


def assemble_ladder_arrays(par, r_local_bl_kohm):
    """(B, N) node caps + (B, N-1) branch conductances from a parasitic
    decomposition; `r_local_bl_kohm` is a scalar (one tech) or a (B,)
    array (the lowered DSE path)."""
    b = par.c_local_ff.shape[0]
    dev = par.c_local_ff.device
    k = N_BL_SEGMENTS

    c = torch.zeros((b, N_NODES), dtype=torch.float32, device=dev)
    # sense node: global metal + pad + SA input + (non-isolated straps)
    c[:, 0] = par.c_global_ff + par.c_sa_ff + par.c_unselected_ff
    # distributed local BL
    c[:, 1:k + 1] = (par.c_local_ff / k)[:, None]
    # storage node
    c[:, k + 1] = cal.CS_FF

    g = torch.zeros((b, N_NODES - 1), dtype=torch.float32, device=dev)
    r_local = as_f32(r_local_bl_kohm, dev)
    r_front = torch.clamp_min(par.r_path_kohm - r_local, 0.05)
    g[:, 0] = 1.0 / r_front
    inv_seg = 1.0 / torch.clamp_min(r_local / k, 0.05)
    g[:, 1:k] = inv_seg if inv_seg.ndim == 0 else inv_seg[:, None]
    g[:, k] = 1.0 / par.r_on_kohm                    # access transistor
    return c, g


def build_ladder_lowered(view, par=None):
    """(B, N) / (B, N-1) ladder tensors over a lowered design space.

    Pass `par` to reuse an already-assembled `BLParasitics`.
    """
    if par is None:
        par = bl_parasitics_lowered(view)
    return assemble_ladder_arrays(par, view.tech("r_local_bl_kohm"))


def replica_ladder_arrays(c: torch.Tensor, g_branch: torch.Tensor,
                          replica_cells):
    """Derive the replica-bitline ladder from a main-array ladder.

    The replica column shares every BL node and branch, but its
    `replica_cells` ganged dummy cells scale the storage capacitance and
    the access-transistor conductance together.
    """
    cells = as_f32(replica_cells, c.device)
    c_rep = c.clone()
    g_rep = g_branch.clone()
    c_rep[:, -1] = c[:, -1] * cells         # ganged storage caps
    g_rep[:, -1] = g_branch[:, -1] * cells  # parallel access transistors
    return c_rep, g_rep


def effective_cbl_lowered(view) -> torch.Tensor:
    """Array-native effective C_BL over a lowered design space."""
    return bl_parasitics_lowered(view).c_bl_total_ff
