"""Density (heatmap) aggregation of one query's candidate slots.

Port of :mod:`geomesa_tpu.ops.density`: :func:`density_grid` snaps the
refine survivors among a query's candidate slots into a (height, width) f32
grid over an int-domain bounding box, the ``DensityScan`` role, with the
cell computed in f32 exactly as the reference computes it
(:func:`~geomesa_tpu_torch.ops.kernels.density_cells`). The batched form
over the whole resident store is ``parallel.query.batched_density_step``.
"""

from __future__ import annotations

import torch

from geomesa_tpu_torch.ops.kernels import density_cells, density_scale

DEFAULT_GRID = (256, 256)  # (width, height)


def density_grid(x, y, idx, mask, grid_bounds, width: int = 256, height: int = 256):
    """Accumulate masked candidate slots into a (height, width) f32 grid.

    ``x, y``: (N,) int32 normalized coordinates (index order, on the
    device); ``idx``: (C,) candidate slots; ``mask``: (C,) bool refine
    survivors; ``grid_bounds``: (4,) int32 [xlo, xhi, ylo, yhi] in the same
    normalized domain (inclusive). A survivor outside the bounds adds
    nothing. Returns (height, width) float32 counts, row 0 the ylo edge."""
    xi = x[idx].float()
    yi = y[idx].float()
    xlo, xhi, ylo, yhi = grid_bounds.float()
    cx = density_cells(xi, xlo, density_scale(xlo, xhi, width), width)
    cy = density_cells(yi, ylo, density_scale(ylo, yhi, height), height)
    in_grid = (xi >= xlo) & (xi <= xhi) & (yi >= ylo) & (yi <= yhi)
    w = (mask & in_grid).float()
    flat = torch.zeros(width * height, dtype=torch.float32, device=x.device)
    flat.index_add_(0, cy * width + cx, w)
    return flat.view(height, width)
