"""Track-oriented geoprocesses: route search, track labels.

Port of :mod:`geomesa_tpu.process.tracks`: :func:`route_search`
(``tracks.py:18``, the ``RouteSearchProcess`` role), the corridor engine's
host referee for routes with a heading, and :func:`track_label` (``:96``,
the ``TrackLabelProcess`` role), whose tie rule the track state's label
row follows (:mod:`geomesa_tpu_torch.trajectory.state`).
"""

from __future__ import annotations

import numpy as np

from geomesa_tpu_torch.filter import ast
from geomesa_tpu_torch.planning.planner import Query
from geomesa_tpu_torch.schema.columnar import FeatureTable, representative_xy


def route_search(ds, type_name: str, route, buffer_deg: float, heading_field: str | None = None,
                 heading_tolerance_deg: float = 45.0, bidirectional: bool = False, filter=None):
    """Features travelling along ``route``: ordered ``(lon, lat)``
    waypoints. A feature matches when it lies within ``buffer_deg`` of some
    segment and, with ``heading_field``, its heading is within
    ``heading_tolerance_deg`` of that segment's bearing (degrees clockwise
    from north; with ``bidirectional`` the reverse bearing too). A null or
    non-finite heading is never aligned.

    One OR of per-segment buffered bboxes through the planned index path,
    then the f64 point-to-segment distance and heading test over the
    candidates."""
    if len(route) < 2:
        raise ValueError("route requires at least 2 waypoints")
    sft = ds.get_schema(type_name)
    pts = np.asarray(route, dtype=np.float64)
    parts = []
    for i in range(len(pts) - 1):
        x1 = min(pts[i, 0], pts[i + 1, 0]) - buffer_deg
        x2 = max(pts[i, 0], pts[i + 1, 0]) + buffer_deg
        y1 = min(pts[i, 1], pts[i + 1, 1]) - buffer_deg
        y2 = max(pts[i, 1], pts[i + 1, 1]) + buffer_deg
        parts.append(ast.BBox(sft.geom_field, x1, y1, x2, y2))
    f = parts[0] if len(parts) == 1 else ast.Or(parts)
    if filter is not None:
        f = ast.And([f, Query(filter=filter).resolved_filter()])
    r = ds.query(type_name, Query(filter=f))
    if r.count == 0:
        return r.table
    xs, ys = representative_xy(r.table)
    cx, cy = xs[:, None], ys[:, None]
    x1, y1 = pts[:-1, 0][None, :], pts[:-1, 1][None, :]
    x2, y2 = pts[1:, 0][None, :], pts[1:, 1][None, :]
    dx, dy = x2 - x1, y2 - y1
    len2 = dx * dx + dy * dy
    with np.errstate(divide="ignore", invalid="ignore"):
        tproj = np.where(len2 > 0, ((cx - x1) * dx + (cy - y1) * dy) / len2, 0.0)
    tproj = np.clip(tproj, 0.0, 1.0)
    d2 = (cx - (x1 + tproj * dx)) ** 2 + (cy - (y1 + tproj * dy)) ** 2
    ok = d2 <= buffer_deg ** 2
    if heading_field is not None:
        seg_bearing = np.degrees(np.arctan2(dx, dy)) % 360.0  # (1, S)
        col = r.table.columns[heading_field]
        raw = col.values.astype(np.float64)[:, None]
        finite = np.isfinite(raw)  # a NaN heading is not aligned, by this mask
        with np.errstate(invalid="ignore"):
            heading = np.where(finite, raw, 0.0) % 360.0
            diff = np.abs((heading - seg_bearing + 180.0) % 360.0 - 180.0)
        if bidirectional:
            diff = np.minimum(diff, 180.0 - diff)
        aligned = finite & (diff <= heading_tolerance_deg)
        if col.valid is not None:
            aligned &= col.valid[:, None]
        ok &= aligned
    return r.table.take(np.nonzero(ok.any(axis=1))[0])


def track_label(table: FeatureTable, track_field: str) -> FeatureTable:
    """One label feature per track: its most recent row by the schema's
    date attribute, ties resolved to the lowest original row. A lexsort by
    (track, time, descending row) takes each group's last sorted row; the
    output rows stay in ascending original order."""
    n = len(table)
    if n == 0:
        return table
    t = table.dtg_millis()
    groups = table.columns[track_field].values.astype(object)
    _ents, codes = np.unique(groups, return_inverse=True)
    codes = codes.reshape(-1)
    order = np.lexsort((-np.arange(n), t, codes))
    sorted_codes = codes[order]
    last = np.nonzero(np.r_[sorted_codes[1:] != sorted_codes[:-1], True])[0]
    return table.take(np.sort(order[last]).astype(np.int64))
