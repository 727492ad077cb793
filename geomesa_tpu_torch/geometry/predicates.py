"""Planar point predicates in f64 on the host: the exact semantics the
joins are held to.

Port copy of the batched point kernels of
:mod:`geomesa_tpu.geometry.predicates` (``points_in_bbox``,
``classify_points_ring``, ``classify_points_polygon``,
``points_intersect_geom``, ``points_within_geom`` and ``_points_on_line``),
the ones :func:`geomesa_tpu_torch.process.join.join_rows_device` runs on its
candidates. Boundary semantics follow JTS: ``intersects`` includes
boundaries; ``within`` excludes boundary-only contact for points.
"""

from __future__ import annotations

import numpy as np

from geomesa_tpu_torch.geometry.types import (
    Geometry,
    LineString,
    MultiLineString,
    MultiPolygon,
    Point,
    Polygon,
    _Multi,
)

EXTERIOR, INTERIOR, BOUNDARY = 0, 1, 2


def points_in_bbox(xs, ys, bbox) -> np.ndarray:
    xmin, ymin, xmax, ymax = bbox
    xs = np.asarray(xs)
    ys = np.asarray(ys)
    return (xs >= xmin) & (xs <= xmax) & (ys >= ymin) & (ys <= ymax)


def classify_points_ring(xs, ys, ring: np.ndarray) -> np.ndarray:
    """Classify N points against one closed ring: 0 exterior / 1 interior / 2 boundary.

    Even-odd ray casting (rightward ray), with an explicit on-segment test so
    boundary contact is never misclassified by crossing parity.
    """
    xs = np.asarray(xs, dtype=np.float64)[:, None]  # (N, 1)
    ys = np.asarray(ys, dtype=np.float64)[:, None]
    x1 = ring[:-1, 0][None, :]  # (1, E)
    y1 = ring[:-1, 1][None, :]
    x2 = ring[1:, 0][None, :]
    y2 = ring[1:, 1][None, :]

    # on-segment: collinear and within the segment's bbox
    cross = (x2 - x1) * (ys - y1) - (y2 - y1) * (xs - x1)
    on_seg = (
        (cross == 0.0)
        & (xs >= np.minimum(x1, x2))
        & (xs <= np.maximum(x1, x2))
        & (ys >= np.minimum(y1, y2))
        & (ys <= np.maximum(y1, y2))
    )
    boundary = on_seg.any(axis=1)

    # crossing parity: edge straddles the horizontal line through the point,
    # and the intersection is strictly right of the point
    straddle = (y1 > ys) != (y2 > ys)
    with np.errstate(divide="ignore", invalid="ignore"):
        xint = x1 + (ys - y1) * (x2 - x1) / (y2 - y1)
    crossing = straddle & (xs < xint)
    inside = (crossing.sum(axis=1) % 2).astype(bool)

    out = np.where(inside, INTERIOR, EXTERIOR)
    return np.where(boundary, BOUNDARY, out).astype(np.int8)


def classify_points_polygon(xs, ys, poly: Polygon) -> np.ndarray:
    """0 exterior / 1 interior / 2 boundary vs a polygon with holes.

    A point on a hole's ring is on the polygon boundary; inside a hole is
    exterior.
    """
    cls = classify_points_ring(xs, ys, poly.shell)
    for hole in poly.holes:
        h = classify_points_ring(xs, ys, hole)
        cls = np.where(
            cls == INTERIOR,
            np.where(h == INTERIOR, EXTERIOR, np.where(h == BOUNDARY, BOUNDARY, cls)),
            cls,
        ).astype(np.int8)
    return cls


def points_intersect_geom(xs, ys, geom: Geometry) -> np.ndarray:
    """Batched JTS-style ``intersects(geom, POINT(x y))`` over N points."""
    xs = np.asarray(xs, dtype=np.float64)
    ys = np.asarray(ys, dtype=np.float64)
    if isinstance(geom, Point):
        return (xs == geom.x) & (ys == geom.y)
    if isinstance(geom, Polygon):
        return classify_points_polygon(xs, ys, geom) != EXTERIOR
    if isinstance(geom, LineString):
        return _points_on_line(xs, ys, geom.coords)
    if isinstance(geom, _Multi):
        out = np.zeros(len(xs), dtype=bool)
        for p in geom.parts:
            out |= points_intersect_geom(xs, ys, p)
        return out
    raise ValueError(f"unsupported geometry: {geom.geom_type}")


def points_within_geom(xs, ys, geom: Geometry) -> np.ndarray:
    """Batched ``within(POINT, geom)``: interior only (boundary excluded)."""
    xs = np.asarray(xs, dtype=np.float64)
    ys = np.asarray(ys, dtype=np.float64)
    if isinstance(geom, Polygon):
        return classify_points_polygon(xs, ys, geom) == INTERIOR
    if isinstance(geom, MultiPolygon):
        out = np.zeros(len(xs), dtype=bool)
        for p in geom.parts:
            out |= classify_points_polygon(xs, ys, p) == INTERIOR
        return out
    if isinstance(geom, Point):
        return (xs == geom.x) & (ys == geom.y)
    # a point is never *within* a line's interior in the JTS sense unless on
    # it and not at an endpoint; approximate as on-line
    if isinstance(geom, (LineString, MultiLineString)):
        return points_intersect_geom(xs, ys, geom)
    raise ValueError(f"unsupported geometry: {geom.geom_type}")


def _points_on_line(xs, ys, coords: np.ndarray) -> np.ndarray:
    xs = xs[:, None]
    ys = ys[:, None]
    x1, y1 = coords[:-1, 0][None, :], coords[:-1, 1][None, :]
    x2, y2 = coords[1:, 0][None, :], coords[1:, 1][None, :]
    cross = (x2 - x1) * (ys - y1) - (y2 - y1) * (xs - x1)
    on = (
        (cross == 0.0)
        & (xs >= np.minimum(x1, x2))
        & (xs <= np.maximum(x1, x2))
        & (ys >= np.minimum(y1, y2))
        & (ys <= np.maximum(y1, y2))
    )
    return on.any(axis=1)
