"""Planar predicates in f64 on the host: the exact semantics the joins and
KNN are held to.

Port copy of :mod:`geomesa_tpu.geometry.predicates`:

- the batched point kernels (``points_in_bbox``, ``classify_points_ring``,
  ``classify_points_polygon``, ``points_intersect_geom``,
  ``points_within_geom``, ``_points_on_line``), the ones
  :func:`geomesa_tpu_torch.process.join.join_rows_device` runs on its
  candidates, and the point-to-geometry distances (``points_dist2_geom``,
  ``_points_dist2_segments``);
- the scalar geometry x geometry predicates (``intersects``, ``disjoint``,
  ``within``, ``contains``, ``distance``, ``dwithin``) with the segment
  tests they reach (``_segments_intersect``,
  ``_segments_intersect_interior``, ``_bbox_disjoint``, ``_lines``,
  ``_vertices``): :func:`geomesa_tpu_torch.process.knn.knn` ranks a line or
  polygon store's features by :func:`distance`.

Boundary semantics follow JTS: ``intersects`` includes boundaries;
``contains``/``within`` exclude boundary-only contact for points. Extended
``within`` is the reference's planar approximation (every vertex inside or
on the boundary, no proper boundary crossing, one interior vertex).
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


def points_dist2_geom(xs, ys, geom: Geometry) -> np.ndarray:
    """Squared euclidean distance from N points to a geometry (0 if inside)."""
    xs = np.asarray(xs, dtype=np.float64)
    ys = np.asarray(ys, dtype=np.float64)
    if isinstance(geom, Point):
        return (xs - geom.x) ** 2 + (ys - geom.y) ** 2
    if isinstance(geom, LineString):
        return _points_dist2_segments(xs, ys, geom.coords)
    if isinstance(geom, Polygon):
        d2 = _points_dist2_segments(xs, ys, geom.shell)
        for h in geom.holes:
            d2 = np.minimum(d2, _points_dist2_segments(xs, ys, h))
        inside = classify_points_polygon(xs, ys, geom) == INTERIOR
        return np.where(inside, 0.0, d2)
    if isinstance(geom, _Multi):
        return np.min([points_dist2_geom(xs, ys, p) for p in geom.parts], axis=0)
    raise ValueError(f"unsupported geometry: {geom.geom_type}")


def _points_dist2_segments(xs, ys, coords: np.ndarray) -> np.ndarray:
    px = xs[:, None]
    py = ys[:, None]
    x1, y1 = coords[:-1, 0][None, :], coords[:-1, 1][None, :]
    x2, y2 = coords[1:, 0][None, :], coords[1:, 1][None, :]
    dx, dy = x2 - x1, y2 - y1
    len2 = dx * dx + dy * dy
    with np.errstate(divide="ignore", invalid="ignore"):
        t = np.where(len2 > 0, ((px - x1) * dx + (py - y1) * dy) / len2, 0.0)
    t = np.clip(t, 0.0, 1.0)
    cx, cy = x1 + t * dx, y1 + t * dy
    return ((px - cx) ** 2 + (py - cy) ** 2).min(axis=1)


# ---------------------------------------------------------------------------
# segment intersection (for line/polygon × line/polygon)
# ---------------------------------------------------------------------------

def _segments_intersect(a: np.ndarray, b: np.ndarray) -> bool:
    """Any segment of polyline ``a`` intersects any segment of polyline ``b``."""
    ax1, ay1 = a[:-1, 0][:, None], a[:-1, 1][:, None]
    ax2, ay2 = a[1:, 0][:, None], a[1:, 1][:, None]
    bx1, by1 = b[:-1, 0][None, :], b[:-1, 1][None, :]
    bx2, by2 = b[1:, 0][None, :], b[1:, 1][None, :]

    d1 = (ax2 - ax1) * (by1 - ay1) - (ay2 - ay1) * (bx1 - ax1)
    d2 = (ax2 - ax1) * (by2 - ay1) - (ay2 - ay1) * (bx2 - ax1)
    d3 = (bx2 - bx1) * (ay1 - by1) - (by2 - by1) * (ax1 - bx1)
    d4 = (bx2 - bx1) * (ay2 - by1) - (by2 - by1) * (ax2 - bx1)

    proper = ((d1 > 0) != (d2 > 0)) & ((d3 > 0) != (d4 > 0)) & (d1 != d2) & (d3 != d4)
    if proper.any():
        return True

    # collinear / endpoint touching
    def on(d, px, py, qx1, qy1, qx2, qy2):
        return (
            (d == 0)
            & (px >= np.minimum(qx1, qx2))
            & (px <= np.maximum(qx1, qx2))
            & (py >= np.minimum(qy1, qy2))
            & (py <= np.maximum(qy1, qy2))
        )

    touch = (
        on(d1, bx1, by1, ax1, ay1, ax2, ay2)
        | on(d2, bx2, by2, ax1, ay1, ax2, ay2)
        | on(d3, ax1, ay1, bx1, by1, bx2, by2)
        | on(d4, ax2, ay2, bx1, by1, bx2, by2)
    )
    return bool(touch.any())


# ---------------------------------------------------------------------------
# scalar geometry × geometry predicates (oracle semantics)
# ---------------------------------------------------------------------------

def _bbox_disjoint(a: Geometry, b: Geometry) -> bool:
    ax1, ay1, ax2, ay2 = a.bbox
    bx1, by1, bx2, by2 = b.bbox
    return ax2 < bx1 or bx2 < ax1 or ay2 < by1 or by2 < ay1


def _lines(geom: Geometry) -> list[np.ndarray]:
    """All polyline coordinate arrays making up a geometry's boundary/path."""
    if isinstance(geom, LineString):
        return [geom.coords]
    if isinstance(geom, Polygon):
        return list(geom.rings)
    if isinstance(geom, _Multi):
        out: list[np.ndarray] = []
        for p in geom.parts:
            out.extend(_lines(p))
        return out
    return []


def _vertices(geom: Geometry) -> np.ndarray:
    if isinstance(geom, Point):
        return np.array([[geom.x, geom.y]])
    vs = _lines(geom)
    return np.vstack(vs) if vs else np.empty((0, 2))


def intersects(a: Geometry, b: Geometry) -> bool:
    if _bbox_disjoint(a, b):
        return False
    if isinstance(a, Point):
        return bool(points_intersect_geom(np.array([a.x]), np.array([a.y]), b)[0])
    if isinstance(b, Point):
        return intersects(b, a)
    if isinstance(a, _Multi):
        return any(intersects(p, b) for p in a.parts)
    if isinstance(b, _Multi):
        return any(intersects(a, p) for p in b.parts)
    # line/polygon × line/polygon: any boundary crossing, or one inside the other
    for la in _lines(a):
        for lb in _lines(b):
            if _segments_intersect(la, lb):
                return True
    if isinstance(a, Polygon):
        v = _vertices(b)
        if bool(classify_points_polygon(v[:1, 0], v[:1, 1], a)[0] != EXTERIOR):
            return True
    if isinstance(b, Polygon):
        v = _vertices(a)
        if bool(classify_points_polygon(v[:1, 0], v[:1, 1], b)[0] != EXTERIOR):
            return True
    return False


def disjoint(a: Geometry, b: Geometry) -> bool:
    return not intersects(a, b)


def within(a: Geometry, b: Geometry) -> bool:
    """``a within b``. Exact for points; for extended ``a``: all vertices inside
    (or on boundary) of ``b`` with no boundary crossings and at least one
    interior vertex — the pragmatic planar approximation (documented in README;
    exact DE-9IM is out of scope for v1)."""
    if _bbox_disjoint(a, b):
        return False
    if isinstance(a, Point):
        return bool(points_within_geom(np.array([a.x]), np.array([a.y]), b)[0])
    if isinstance(a, _Multi):
        return all(within(p, b) for p in a.parts)
    if isinstance(b, (Polygon, MultiPolygon)):
        v = _vertices(a)
        polys = b.parts if isinstance(b, MultiPolygon) else (b,)
        cls = np.full(len(v), EXTERIOR, dtype=np.int8)
        for p in polys:
            c = classify_points_polygon(v[:, 0], v[:, 1], p)
            cls = np.maximum(cls, np.where(c == EXTERIOR, cls, c))
            if all(
                not _segments_intersect_interior(la, p) for la in _lines(a)
            ) and bool((c != EXTERIOR).all()) and bool((c == INTERIOR).any()):
                return True
        return False
    return False


def _segments_intersect_interior(line: np.ndarray, poly: Polygon) -> bool:
    """True if ``line`` properly crosses the polygon boundary (touch allowed)."""
    for ring in poly.rings:
        ax1, ay1 = line[:-1, 0][:, None], line[:-1, 1][:, None]
        ax2, ay2 = line[1:, 0][:, None], line[1:, 1][:, None]
        bx1, by1 = ring[:-1, 0][None, :], ring[:-1, 1][None, :]
        bx2, by2 = ring[1:, 0][None, :], ring[1:, 1][None, :]
        d1 = (ax2 - ax1) * (by1 - ay1) - (ay2 - ay1) * (bx1 - ax1)
        d2 = (ax2 - ax1) * (by2 - ay1) - (ay2 - ay1) * (bx2 - ax1)
        d3 = (bx2 - bx1) * (ay1 - by1) - (by2 - by1) * (ax1 - bx1)
        d4 = (bx2 - bx1) * (ay2 - by1) - (by2 - by1) * (ax2 - bx1)
        proper = (((d1 > 0) != (d2 > 0)) & ((d3 > 0) != (d4 > 0))
                  & (d1 != 0) & (d2 != 0) & (d3 != 0) & (d4 != 0))
        if proper.any():
            return True
    return False


def contains(a: Geometry, b: Geometry) -> bool:
    return within(b, a)


def distance(a: Geometry, b: Geometry) -> float:
    """Min euclidean distance (degrees); 0 when intersecting."""
    if intersects(a, b):
        return 0.0
    va = _vertices(a)
    vb = _vertices(b)
    best = np.inf
    for lb in _lines(b) or [vb]:
        if len(lb) > 1:
            best = min(best, float(np.sqrt(_points_dist2_segments(va[:, 0], va[:, 1], lb)).min()))
    for la in _lines(a) or [va]:
        if len(la) > 1:
            best = min(best, float(np.sqrt(_points_dist2_segments(vb[:, 0], vb[:, 1], la)).min()))
    if not np.isfinite(best):  # point × point
        best = float(np.sqrt(((va[:, None, :] - vb[None, :, :]) ** 2).sum(-1)).min())
    return best


def dwithin(a: Geometry, b: Geometry, d: float) -> bool:
    return distance(a, b) <= d
