"""The port's scalar geometry predicates (``geometry/predicates.py``:
``intersects``, ``disjoint``, ``within``, ``contains``, ``distance``,
``dwithin`` and the segment tests they reach) against geomesa_tpu's, on
the same geometries built by both packages: seeded points, line strings,
polygons with holes and multi-geometries, and the cases where a segment
test can go wrong: touching and corner-touching polygons, collinear
overlapping and collinear disjoint segments, zero-length segments, points
on vertices, on edges and inside holes, a line through a hole.

No tolerance: the predicates are the same f64 numpy expressions, so every
answer and every distance must be equal bit for bit.
"""

import numpy as np
import pytest

from geomesa_tpu.geometry import predicates as ref_P
from geomesa_tpu.geometry import types as ref_types

from geomesa_tpu_torch.geometry import predicates as P
from geomesa_tpu_torch.geometry import types

SQUARE = [[0.0, 0.0], [4.0, 0.0], [4.0, 4.0], [0.0, 4.0]]
HOLE = [[1.0, 1.0], [3.0, 1.0], [3.0, 3.0], [1.0, 3.0]]


def _seeded_specs(seed: int = 13) -> list:
    """Geometry specs: ("point", (x, y)), ("line", coords), ("polygon",
    shell, holes), ("mline", [coords, ...]), ("mpolygon", [(shell, holes),
    ...])."""
    rng = np.random.default_rng(seed)
    specs = [("point", tuple(rng.uniform(-6, 10, 2))) for _ in range(6)]
    for _ in range(5):
        n = int(rng.integers(2, 6))
        specs.append(("line", rng.uniform(-6, 10, (n, 2))))
    for _ in range(4):
        c = rng.uniform(-4, 8, 2)
        ang = np.sort(rng.uniform(0, 2 * np.pi, 7))
        r = rng.uniform(1.5, 4.0, 7)
        shell = np.stack([c[0] + r * np.cos(ang), c[1] + r * np.sin(ang)], axis=1)
        hole = c + 0.4 * np.array([[-1.0, -1.0], [1.0, -1.0], [0.0, 1.0]])
        specs.append(("polygon", shell, (hole,) if rng.random() < 0.5 else ()))
    specs.append(("mline", [rng.uniform(-6, 10, (3, 2)), rng.uniform(-6, 10, (2, 2))]))
    specs.append(("mpolygon", [(np.array(SQUARE) + 9.0, ()),
                               (np.array(SQUARE) * 0.5 - 5.0, (np.array(HOLE) * 0.5 - 5.0,))]))
    return specs


EDGE_SPECS = [
    ("polygon", np.array(SQUARE), (np.array(HOLE),)),           # a square with a hole
    ("polygon", np.array(SQUARE) + [4.0, 0.0], ()),             # shares an edge with it
    ("polygon", np.array(SQUARE) + [4.0, 4.0], ()),             # touches it at a corner
    ("polygon", np.array(HOLE) * 0.5 + 1.0, ()),                # inside its hole
    ("line", np.array([[0.0, 2.0], [4.0, 2.0]])),               # through the hole
    ("line", np.array([[0.0, 0.0], [2.0, 0.0]])),               # on its edge
    ("line", np.array([[1.0, 0.0], [3.0, 0.0]])),               # collinear, overlapping
    ("line", np.array([[5.0, 0.0], [6.0, 0.0]])),               # collinear, disjoint
    ("line", np.array([[2.0, 5.0], [2.0, 5.0]])),               # zero length
    ("line", np.array([[0.5, 0.5], [0.5, 3.5], [0.8, 0.8]])),   # inside the shell ring
    ("point", (4.0, 4.0)),                                      # on a vertex
    ("point", (2.0, 0.0)),                                      # on an edge
    ("point", (2.0, 2.0)),                                      # inside the hole
    ("point", (0.5, 0.5)),                                      # in the interior
    ("point", (2.0, 5.0)),                                      # on the zero-length line
    ("mline", [np.array([[-1.0, -1.0], [0.0, 0.0]]), np.array([[8.0, 8.0], [9.0, 9.0]])]),
]


def _build(m, spec):
    kind = spec[0]
    if kind == "point":
        return m.Point(float(spec[1][0]), float(spec[1][1]))
    if kind == "line":
        return m.LineString(np.array(spec[1], dtype=np.float64))
    if kind == "polygon":
        return m.Polygon(np.array(spec[1]), tuple(np.array(h) for h in spec[2]))
    if kind == "mline":
        return m.MultiLineString([m.LineString(np.array(c)) for c in spec[1]])
    return m.MultiPolygon([m.Polygon(np.array(s), tuple(np.array(h) for h in hs))
                           for s, hs in spec[1]])


@pytest.fixture(scope="module")
def geoms():
    specs = _seeded_specs() + EDGE_SPECS
    return [_build(types, s) for s in specs], [_build(ref_types, s) for s in specs]


@pytest.mark.parametrize("name", ["intersects", "disjoint", "within", "contains", "distance"])
def test_scalar_predicate_equals_reference(geoms, name):
    """Every ordered pair of the seeded and edge geometries."""
    ours, theirs = geoms
    fn, ref_fn = getattr(P, name), getattr(ref_P, name)
    got = [[fn(a, b) for b in ours] for a in ours]
    want = [[ref_fn(a, b) for b in theirs] for a in theirs]
    assert got == want
    if name != "distance":
        assert any(any(r) for r in got) and not all(all(r) for r in got)


@pytest.mark.parametrize("d", [0.0, 0.5, 2.0])
def test_dwithin_equals_reference(geoms, d):
    ours, theirs = geoms
    got = [[P.dwithin(a, b, d) for b in ours] for a in ours]
    assert got == [[ref_P.dwithin(a, b, d) for b in theirs] for a in theirs]


def test_segment_helpers_equal_reference(geoms):
    """``_lines``, ``_vertices`` and ``_bbox_disjoint`` of every geometry,
    ``_segments_intersect`` over every pair of their polylines and
    ``_segments_intersect_interior`` of every polyline against every
    polygon."""
    ours, theirs = geoms
    lines, ref_lines = [], []
    for a, ra in zip(ours, theirs):
        la, rla = P._lines(a), ref_P._lines(ra)
        assert len(la) == len(rla) and all(np.array_equal(x, y) for x, y in zip(la, rla))
        assert np.array_equal(P._vertices(a), ref_P._vertices(ra))
        lines += la
        ref_lines += rla
        for b, rb in zip(ours, theirs):
            assert P._bbox_disjoint(a, b) == ref_P._bbox_disjoint(ra, rb)
    got = [[P._segments_intersect(x, y) for y in lines] for x in lines]
    assert got == [[ref_P._segments_intersect(x, y) for y in ref_lines] for x in ref_lines]
    polys = [(a, ra) for a, ra in zip(ours, theirs) if isinstance(a, types.Polygon)]
    got = [[P._segments_intersect_interior(x, a) for a, _ in polys] for x in lines]
    want = [[ref_P._segments_intersect_interior(x, ra) for _, ra in polys] for x in ref_lines]
    assert got == want and any(any(r) for r in got)


def test_point_distances_equal_reference(geoms):
    """``points_dist2_geom`` (and ``_points_dist2_segments`` through it) of
    seeded points and every geometry's own vertices."""
    ours, theirs = geoms
    rng = np.random.default_rng(17)
    xs, ys = rng.uniform(-8, 12, 400), rng.uniform(-8, 12, 400)
    for a, ra in zip(ours, theirs):
        v = P._vertices(a)
        px, py = np.concatenate([xs, v[:, 0]]), np.concatenate([ys, v[:, 1]])
        got = P.points_dist2_geom(px, py, a)
        assert np.array_equal(got, ref_P.points_dist2_geom(px, py, ra))
        if len(v):
            assert (got[len(xs):] <= 1e-24).all()  # a geometry's vertices lie on it
        for line, ref_line in zip(P._lines(a), ref_P._lines(ra)):
            assert np.array_equal(P._points_dist2_segments(px, py, line),
                                  ref_P._points_dist2_segments(px, py, ref_line))


EDGE = {s[0] + str(i): _build(types, s) for i, s in enumerate(EDGE_SPECS)}


@pytest.mark.parametrize("a,b,intersects,within,distance", [
    ("polygon0", "polygon1", True, False, 0.0),    # a shared edge
    ("polygon0", "polygon2", True, False, 0.0),    # a shared corner
    ("polygon3", "polygon0", False, False, 0.5),   # inside the hole, off its ring
    ("line4", "polygon0", True, False, 0.0),       # through the hole
    ("line5", "polygon0", True, False, 0.0),       # on the boundary only
    ("line6", "line5", True, False, 0.0),          # collinear, overlapping
    ("line7", "line5", False, False, 3.0),         # collinear, disjoint
    ("line8", "polygon0", False, False, 1.0),      # zero length, outside
    ("point14", "line8", True, True, 0.0),         # on the zero-length line
    ("line9", "polygon0", True, True, 0.0),        # inside, off the hole
    ("point10", "polygon0", True, False, 0.0),     # on a vertex
    ("point11", "polygon0", True, False, 0.0),     # on an edge
    ("point12", "polygon0", False, False, 1.0),    # inside the hole
    ("point13", "polygon0", True, True, 0.0),      # in the interior
])
def test_edge_cases(a, b, intersects, within, distance):
    """The edge cases' answers, stated, on the port (the pairs above hold
    them equal to the reference)."""
    ga, gb = EDGE[a], EDGE[b]
    assert P.intersects(ga, gb) is intersects and P.intersects(gb, ga) is intersects
    assert P.disjoint(ga, gb) is (not intersects)
    assert P.within(ga, gb) is within and P.contains(gb, ga) is within
    assert P.distance(ga, gb) == distance and P.distance(gb, ga) == distance
    assert P.dwithin(ga, gb, distance) and (distance == 0.0 or not P.dwithin(ga, gb,
                                                                               distance / 2))
