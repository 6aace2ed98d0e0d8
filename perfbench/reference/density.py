"""Frozen copy of `src/repro_torch/core/density.py` for the benchmark's plain reference,
trimmed to the lowered path it takes (imports rewritten; nothing of the
program is imported).

Bit density, stack height and scaling projections (Fig. 9a).

Port of `repro.core.density`:

  density(L)  = L * array_efficiency / cell_area
  height(L)   = L * layer_height
  layers(rho) = ceil(rho * cell_area / array_efficiency)

The scalar helpers take one technology and a scalar or array of layer
counts (densities) and return float32 (int32) tensors on `device`; the
`*_lowered` functions work over a lowered design space.
"""

from __future__ import annotations

import torch

from .device import as_bool, as_f32
from .units import GBIT, NM2_PER_MM2


def bit_density_lowered(view) -> torch.Tensor:
    """Array-native bit density over a lowered design space."""
    dev = view.device
    area = as_f32(view.tech("cell_x_nm") * view.tech("cell_y_nm"), dev)
    per_layer = (as_f32(view.tech("array_efficiency"), dev)
                 / torch.where(area > 0, area, 1.0) * NM2_PER_MM2 / GBIT)
    return torch.where(as_bool(view.tech("baseline_2d"), dev),
                       as_f32(view.tech("fixed_density_gb_mm2"), dev),
                       view.layers * per_layer)


def stack_height_lowered(view) -> torch.Tensor:
    """Array-native stack height over a lowered design space."""
    return view.layers * as_f32(view.tech("layer_height_nm"), view.device) * 1e-3
