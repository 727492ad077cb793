"""Geoprocessing operations over a store.

Port of :func:`geomesa_tpu.process.processes.density` (``processes.py:57``,
the ``DensityProcess`` role) and :func:`~geomesa_tpu.process.processes.tube_select`
(``:115``, the ``TubeSelectProcess`` role, the corridor engine's host
referee); the module's other processes are not ported.
"""

from __future__ import annotations

import numpy as np

from geomesa_tpu_torch.filter import ast
from geomesa_tpu_torch.planning.planner import Query
from geomesa_tpu_torch.schema.columnar import representative_xy


def density(ds, type_name: str, filter=None, bbox=None, width: int = 256, height: int = 256,
            weight_by=None):
    """Heatmap grid over the matching features, riding the ``density``
    query hint. Returns (height, width) float64."""
    opts = {"width": width, "height": height}
    if bbox is not None:
        opts["bbox"] = bbox
    if weight_by:
        opts["weight_by"] = weight_by
    return ds.query(type_name, Query(filter=filter, hints={"density": opts})).density


def tube_select(ds, type_name: str, track, buffer_deg: float, time_buffer_ms: int, filter=None):
    """Spatio-temporal corridor search: the features within ``buffer_deg``
    of the track's path and within ``time_buffer_ms`` of the track's local
    time. ``track``: ``[(lon, lat, epoch_ms), ...]`` ordered waypoints.

    One OR-of-segments query (each segment's buffered bbox and its time
    window) through the planned index path, then the exact f64 refine per
    (candidate, segment): point-to-segment distance and the segment's
    buffered time span (extended geometries refine by bbox centroid). The
    host path the corridor engine
    (:func:`geomesa_tpu_torch.trajectory.corridor.tube_select_device`) is
    held to."""
    sft = ds.get_schema(type_name)
    if len(track) < 2:
        raise ValueError("tube requires at least 2 waypoints")
    pts = np.asarray([(x, y) for x, y, _ in track], dtype=np.float64)
    ts = np.asarray([t for _, _, t in track], dtype=np.int64)
    parts = []
    for i in range(len(track) - 1):
        x1 = min(pts[i, 0], pts[i + 1, 0]) - buffer_deg
        x2 = max(pts[i, 0], pts[i + 1, 0]) + buffer_deg
        y1 = min(pts[i, 1], pts[i + 1, 1]) - buffer_deg
        y2 = max(pts[i, 1], pts[i + 1, 1]) + buffer_deg
        t1 = int(min(ts[i], ts[i + 1]) - time_buffer_ms)
        t2 = int(max(ts[i], ts[i + 1]) + time_buffer_ms)
        parts.append(ast.And([ast.BBox(sft.geom_field, x1, y1, x2, y2),
                              ast.During(sft.dtg_field, t1 - 1, t2 + 1)]))
    f = ast.Or(parts)
    if filter is not None:
        f = ast.And([f, Query(filter=filter).resolved_filter()])
    r = ds.query(type_name, Query(filter=f))
    if r.count == 0:
        return r.table
    xs, ys = representative_xy(r.table)
    cx, cy = xs[:, None], ys[:, None]
    ct = r.table.dtg_millis()[:, None]
    x1, y1 = pts[:-1, 0][None, :], pts[:-1, 1][None, :]
    x2, y2 = pts[1:, 0][None, :], pts[1:, 1][None, :]
    dx, dy = x2 - x1, y2 - y1
    len2 = dx * dx + dy * dy
    with np.errstate(divide="ignore", invalid="ignore"):
        tproj = np.where(len2 > 0, ((cx - x1) * dx + (cy - y1) * dy) / len2, 0.0)
    tproj = np.clip(tproj, 0.0, 1.0)
    d2 = (cx - (x1 + tproj * dx)) ** 2 + (cy - (y1 + tproj * dy)) ** 2
    t_lo = np.minimum(ts[:-1], ts[1:])[None, :] - time_buffer_ms
    t_hi = np.maximum(ts[:-1], ts[1:])[None, :] + time_buffer_ms
    ok = (d2 <= buffer_deg ** 2) & (ct >= t_lo) & (ct <= t_hi)
    return r.table.take(np.nonzero(ok.any(axis=1))[0])
