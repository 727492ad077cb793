"""The post-scan density reduce of a query's result set.

Port of the point branch of :func:`geomesa_tpu.store.reduce.density_grid`
(``store/reduce.py:138``), the ``density`` hint's exact f64 heatmap. The
port's schemas are points only, so the rasterization of extended
geometries (``_raster_cells``) is not ported.
"""

from __future__ import annotations

import numpy as np

__all__ = ["density_grid"]


def density_grid(table, opts) -> np.ndarray:
    """Exact f64 heatmap over the result set (the ``DensityScan`` role):
    each point snaps to its cell of a (height, width) grid over ``bbox``
    (default the whole world), weighted by the ``weight_by`` column when
    one is named. ``opts``: ``width``, ``height`` (256 each), ``bbox`` (x1,
    y1, x2, y2) and ``weight_by``, each optional."""
    width = int(opts.get("width", 256))
    height = int(opts.get("height", 256))
    bbox = opts.get("bbox")
    if bbox is None:
        bbox = (-180.0, -90.0, 180.0, 90.0)
    xmin, ymin, xmax, ymax = bbox
    weight = opts.get("weight_by")
    w = None
    if weight:
        w = table.columns[weight].values.astype(np.float64)
    col = table.geom_column()
    grid, _, _ = np.histogram2d(
        col.y, col.x, bins=[height, width], range=[[ymin, ymax], [xmin, xmax]], weights=w
    )
    return grid
