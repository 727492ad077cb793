"""The single-device query step: gather → refine → aggregate.

Port of :mod:`geomesa_tpu.ops.step`: one function composing the refine
(:func:`geomesa_tpu_torch.ops.refine.refine_points`) with the density grid
(:func:`geomesa_tpu_torch.ops.density.density_grid`) over one query's
candidate slots. PyTorch runs it eagerly; nothing fuses the shared gathers.
"""

from __future__ import annotations

import torch

from geomesa_tpu_torch.ops.density import density_grid
from geomesa_tpu_torch.ops.refine import refine_points


def query_step(x, y, bins, offs, idx, count, boxes, times, grid_bounds,
               width: int = 256, height: int = 256):
    """Arguments as :func:`~geomesa_tpu_torch.ops.refine.refine_points`'
    plus ``grid_bounds`` (4,) int32 for the density grid. Returns ``(count
    int32 0-d tensor, grid (height, width) float32, mask (C,) bool)``."""
    mask = refine_points(x, y, bins, offs, idx, count, boxes, times)
    n = mask.sum(dtype=torch.int32)
    grid = density_grid(x, y, idx, mask, grid_bounds, width=width, height=height)
    return n, grid, mask
