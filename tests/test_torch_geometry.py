"""The port's geometry copies (``geomesa_tpu_torch/geometry``) against
geomesa_tpu's: the value types (closed rings, bboxes, holes, multi parts)
and the f64 host predicates the joins decide with, on seeded points and on
the cases where a crossing number can go wrong: points on vertices, on
horizontal and vertical edges, inside a hole and on its ring.

No tolerance: the predicates are the same f64 numpy expressions, so every
classification must be equal.
"""

import numpy as np
import pytest

from geomesa_tpu.geometry import predicates as ref_P
from geomesa_tpu.geometry import types as ref_types

from geomesa_tpu_torch.geometry import predicates as P
from geomesa_tpu_torch.geometry import types


def _pair(kind: str):
    """The same geometry built by both packages."""
    shell = [[0.0, 0.0], [10.0, 0.0], [10.0, 10.0], [5.0, 14.0], [0.0, 10.0]]
    hole = [[3.0, 3.0], [7.0, 3.0], [7.0, 7.0], [3.0, 7.0]]
    star = [[2.0 * np.cos(a) * (1.5 if i % 2 else 0.6), 2.0 * np.sin(a) * (1.5 if i % 2 else 0.6)]
            for i, a in enumerate(np.linspace(0, 2 * np.pi, 17)[:-1])]
    line = [[-2.0, -2.0], [12.0, 12.0], [12.0, 0.0]]
    out = []
    for m in (types, ref_types):
        if kind == "polygon":
            out.append(m.Polygon(np.array(shell)))
        elif kind == "holed":
            out.append(m.Polygon(np.array(shell), (np.array(hole),)))
        elif kind == "star":
            out.append(m.Polygon(np.array(star)))
        elif kind == "multipolygon":
            out.append(m.MultiPolygon([m.Polygon(np.array(shell), (np.array(hole),)),
                                       m.Polygon(np.array(star) + 20.0)]))
        elif kind == "line":
            out.append(m.LineString(np.array(line)))
        elif kind == "multiline":
            out.append(m.MultiLineString([m.LineString(np.array(line)),
                                          m.LineString(np.array(line)[::-1] + 1.0)]))
        elif kind == "point":
            out.append(m.Point(5.0, 5.0))
        elif kind == "box":
            out.append(m.box(-1.5, -2.5, 3.25, 4.0))
    return out


KINDS = ["polygon", "holed", "star", "multipolygon", "line", "multiline", "point", "box"]


def _points(seed: int = 3) -> tuple[np.ndarray, np.ndarray]:
    """Seeded points over the geometries plus the hard cases: every vertex
    of the shell and hole, points on the horizontal, vertical and slanted
    edges, inside the hole, on the line, at the point."""
    rng = np.random.default_rng(seed)
    xs = list(rng.uniform(-4.0, 24.0, 4000))
    ys = list(rng.uniform(-4.0, 24.0, 4000))
    grid = np.arange(-3.0, 16.0, 0.5)  # on-grid rows meet vertices and edges exactly
    gx, gy = np.meshgrid(grid, grid)
    xs += list(gx.ravel()) + [0, 10, 10, 5, 0, 3, 7, 7, 3, 5.0, 2.5, 7.5, 5.0, 12.0, 1.0]
    ys += list(gy.ravel()) + [0, 0, 10, 14, 10, 3, 3, 7, 7, 0.0, 12.0, 12.0, 3.0, 6.0, 1.0]
    return np.array(xs), np.array(ys)


@pytest.mark.parametrize("kind", KINDS)
def test_types_equal_reference(kind):
    got, want = _pair(kind)
    assert got.geom_type == want.geom_type
    assert np.array_equal(np.asarray(got.bbox), np.asarray(want.bbox))
    if kind in ("polygon", "holed", "star", "box"):
        assert np.array_equal(got.shell, want.shell)  # closed on construction
        assert np.array_equal(got.shell[0], got.shell[-1])
        assert len(got.holes) == len(want.holes)
        for a, b in zip(got.holes, want.holes):
            assert np.array_equal(a, b)
        assert len(got.rings) == len(want.rings)
    if kind in ("multipolygon", "multiline"):
        assert len(got.parts) == len(want.parts)


def test_types_refuse_what_the_reference_refuses():
    for m in (types, ref_types):
        with pytest.raises(ValueError):
            m.Polygon(np.array([[0.0, 0.0], [1.0, 1.0]]))
        with pytest.raises(ValueError):
            m.LineString(np.zeros((3, 3)))
        with pytest.raises(ValueError):
            m.bbox_union([])
    assert types.Point(1.0, 2.0) == types.Point(1.0, 2.0)  # by value
    assert types.Point(1.0, 2.0).is_point and not types.box(0, 0, 1, 1).is_point


@pytest.mark.parametrize("kind", KINDS)
def test_predicates_equal_reference(kind):
    got, want = _pair(kind)
    xs, ys = _points()
    if kind in ("polygon", "holed", "star", "box"):  # every vertex: boundary points
        xs, ys = np.concatenate([xs, got.shell[:, 0]]), np.concatenate([ys, got.shell[:, 1]])
    assert np.array_equal(P.points_in_bbox(xs, ys, got.bbox), ref_P.points_in_bbox(xs, ys,
                                                                                    want.bbox))
    assert np.array_equal(P.points_intersect_geom(xs, ys, got),
                          ref_P.points_intersect_geom(xs, ys, want))
    assert np.array_equal(P.points_within_geom(xs, ys, got),
                          ref_P.points_within_geom(xs, ys, want))
    if kind in ("polygon", "holed", "star", "box"):
        cls = P.classify_points_polygon(xs, ys, got)
        assert np.array_equal(cls, ref_P.classify_points_polygon(xs, ys, want))
        assert np.array_equal(P.classify_points_ring(xs, ys, got.shell),
                              ref_P.classify_points_ring(xs, ys, want.shell))
        assert (cls == P.BOUNDARY).any() and (cls == P.INTERIOR).any()  # the cases occur
    if kind == "line":
        assert np.array_equal(P._points_on_line(xs, ys, got.coords),
                              ref_P._points_on_line(xs, ys, want.coords))


def test_boundary_and_hole_cases():
    """Vertices and horizontal edges are boundary (not within, but
    intersecting); a point in the hole is exterior, on its ring boundary."""
    holed, _ = _pair("holed")
    xs = np.array([0.0, 5.0, 10.0, 5.0, 3.0, 5.0, 1.0])
    ys = np.array([0.0, 0.0, 10.0, 5.0, 5.0, 3.0, 1.0])
    assert P.classify_points_polygon(xs, ys, holed).tolist() == [
        P.BOUNDARY, P.BOUNDARY, P.BOUNDARY, P.EXTERIOR, P.BOUNDARY, P.BOUNDARY, P.INTERIOR]
    assert P.points_within_geom(xs, ys, holed).tolist() == [False] * 6 + [True]
    assert P.points_intersect_geom(xs, ys, holed).tolist() == [True] * 3 + [False] + [True] * 3
    with pytest.raises(ValueError):
        P.points_within_geom(xs, ys, types.MultiPoint([types.Point(0.0, 0.0)]))
