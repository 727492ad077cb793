"""The post-scan density reduce of a query's result set.

Port of :func:`geomesa_tpu.store.reduce.density_grid` (``store/reduce.py:138``)
and its rasterization of extended geometries, ``_raster_cells`` (``:77``),
the ``density`` hint's exact f64 heatmap: points snap to their cell; line
strings walk their segments and polygons fill the cells whose centres they
contain (the ``RenderingGrid`` role), each feature's weight spread evenly
over the cells it touches.
"""

from __future__ import annotations

import numpy as np

from geomesa_tpu_torch.geometry import predicates as P
from geomesa_tpu_torch.geometry.types import (
    LineString, MultiLineString, MultiPolygon, Point, Polygon)
from geomesa_tpu_torch.schema.columnar import representative_xy

__all__ = ["density_grid"]


def _raster_cells(geom, xmin, ymin, px, py, width, height):
    """Grid cells covered by a geometry's footprint, as a set of (col, row):
    lines walk their segments, polygons fill the cells whose centres they
    contain (a thin polygon that contains no centre falls back to its
    outline)."""

    def line_cells(coords):
        cells = set()
        cx = (coords[:, 0] - xmin) / px
        cy = (coords[:, 1] - ymin) / py
        for i in range(len(coords) - 1):
            steps = int(max(abs(cx[i + 1] - cx[i]), abs(cy[i + 1] - cy[i])) * 2) + 2
            t = np.linspace(0.0, 1.0, steps)
            gx = np.floor(cx[i] + (cx[i + 1] - cx[i]) * t).astype(int)
            gy = np.floor(cy[i] + (cy[i + 1] - cy[i]) * t).astype(int)
            ok = (gx >= 0) & (gx < width) & (gy >= 0) & (gy < height)
            cells.update(zip(gx[ok].tolist(), gy[ok].tolist()))
        return cells

    def poly_cells(poly):
        bx1, by1, bx2, by2 = poly.bbox
        jx1 = max(0, int(np.floor((bx1 - xmin) / px)))
        jx2 = min(width, int(np.ceil((bx2 - xmin) / px)))
        jy1 = max(0, int(np.floor((by1 - ymin) / py)))
        jy2 = min(height, int(np.ceil((by2 - ymin) / py)))
        if jx2 <= jx1 or jy2 <= jy1:
            return set()
        gxs = np.arange(jx1, jx2)
        gys = np.arange(jy1, jy2)
        ccx = xmin + (gxs + 0.5) * px
        ccy = ymin + (gys + 0.5) * py
        mx, my = np.meshgrid(ccx, ccy)
        inside = P.points_within_geom(mx.ravel(), my.ravel(), poly)
        gx, gy = np.meshgrid(gxs, gys)
        out = set(zip(gx.ravel()[inside].tolist(), gy.ravel()[inside].tolist()))
        return out or line_cells(poly.shell)

    if isinstance(geom, LineString):
        return line_cells(geom.coords)
    if isinstance(geom, MultiLineString):
        out = set()
        for part in geom.parts:
            out |= line_cells(part.coords)
        return out
    if isinstance(geom, Polygon):
        return poly_cells(geom)
    if isinstance(geom, MultiPolygon):
        out = set()
        for part in geom.parts:
            out |= poly_cells(part)
        return out
    return set()


def density_grid(table, opts) -> np.ndarray:
    """Exact f64 heatmap over the result set (the ``DensityScan`` role), a
    (height, width) grid over ``bbox`` (default the whole world), weighted
    by the ``weight_by`` column when one is named. ``opts``: ``width``,
    ``height`` (256 each), ``bbox`` (x1, y1, x2, y2) and ``weight_by``,
    each optional.

    A point schema snaps each point to its cell (one ``histogram2d``).
    Extended geometries rasterize their footprint (:func:`_raster_cells`)
    with the feature's weight spread over the touched cells, so a
    feature's mass in the grid is its weight when it touches a cell; a
    point of a mixed geometry column snaps to its cell; a null adds
    nothing."""
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
    gcol = table.geom_column()
    if gcol.x is not None:  # point schema: vectorized snap
        xs, ys = representative_xy(table)
        grid, _, _ = np.histogram2d(
            ys, xs, bins=[height, width], range=[[ymin, ymax], [xmin, xmax]], weights=w)
        return grid
    px = (xmax - xmin) / width
    py = (ymax - ymin) / height
    grid = np.zeros((height, width), dtype=np.float64)
    geoms = gcol.geometries()
    valid = gcol.is_valid()
    for i in range(len(table)):
        if not valid[i]:
            continue
        g = geoms[i]
        wi = 1.0 if w is None else float(w[i])
        if isinstance(g, Point):
            gx = int(np.floor((g.x - xmin) / px))
            gy = int(np.floor((g.y - ymin) / py))
            if 0 <= gx < width and 0 <= gy < height:
                grid[gy, gx] += wi
            continue
        cells = _raster_cells(g, xmin, ymin, px, py, width, height)
        if cells:
            share = wi / len(cells)
            for gx, gy in cells:
                grid[gy, gx] += share
    return grid
