"""Bit density, stack height and scaling projections (Fig. 9a).

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

from ..device import as_bool, as_f32, resolve_device
from . import calibration as cal
from .calibration import TechCal
from .units import GBIT, NM2_PER_MM2


def cell_area_nm2(tech: TechCal) -> float:
    return tech.cell_x_nm * tech.cell_y_nm


def _per_layer(tech: TechCal) -> float:
    return tech.array_efficiency / cell_area_nm2(tech) * NM2_PER_MM2 / GBIT


def bit_density_gb_mm2(tech: TechCal, layers, device="cuda") -> torch.Tensor:
    layers = as_f32(layers, resolve_device(device))
    if tech.baseline_2d:
        return torch.full_like(layers, tech.fixed_density_gb_mm2)
    return layers * _per_layer(tech)


def layers_for_density(tech: TechCal, density_gb_mm2,
                       device="cuda") -> torch.Tensor:
    density = as_f32(density_gb_mm2, resolve_device(device))
    # a true division (a Python-scalar divisor is a reciprocal multiply on
    # CUDA, which can move the ceiling by one layer)
    per_layer = torch.tensor(_per_layer(tech), dtype=torch.float32,
                             device=density.device)
    return torch.ceil(density / per_layer).to(torch.int32)


def stack_height_um(tech: TechCal, layers, device="cuda") -> torch.Tensor:
    layers = as_f32(layers, resolve_device(device))
    return layers * tech.layer_height_nm * 1e-3


def density_scaling_vs_d1b(tech: TechCal, layers,
                           device="cuda") -> torch.Tensor:
    density = bit_density_gb_mm2(tech, layers, device)
    return density / torch.tensor(cal.D1B_BIT_DENSITY_GB_MM2,
                                  dtype=torch.float32, device=density.device)


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
