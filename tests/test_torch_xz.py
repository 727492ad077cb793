"""The port's XZ curves, XZ indexes, extended schemas and geometry columns
against the reference's, on the CPU.

- ``curve.xz``: ``XZSFC.index`` codes of XZ2 and XZ3 equal the reference's
  on seeded bboxes, points, whole-world boxes and out-of-range boxes that
  the curve clips; ``ranges`` are equal for single and OR'd windows at
  several ``max_ranges``;
- ``XZ2Index`` / ``XZ3Index``: permutations, sorted codes and plans equal
  the reference's (its stable host sorts), on tie-heavy codes too;
- ``parse_spec`` of the extended geometry types and
  ``geomesa.xz.precision``; ``build_indices`` gives xz3 + xz2 (xz2 without
  a date), as the reference's does minus ``id``;
- geometry columns: bounds from geometry values and WKT strings, ``take``
  and ``concat``, ``linestring_column``; ``from_wkt``/``to_wkt``;
  ``BBox.mask`` on bounds, the antimeridian form included.

Tolerance: none — codes, ranges, permutations, intervals, bounds and masks
compare exactly.
"""

import numpy as np
import pytest
import torch

import geomesa_tpu  # noqa: F401  (x64 on)
from geomesa_tpu.curve.binned_time import TimePeriod as RefTimePeriod
from geomesa_tpu.curve.xz import xz2_sfc as ref_xz2_sfc
from geomesa_tpu.curve.xz import xz3_sfc as ref_xz3_sfc
from geomesa_tpu.filter import ast as ref_ast
from geomesa_tpu.filter.bounds import extract as ref_extract
from geomesa_tpu.filter.cql import parse as ref_parse
from geomesa_tpu.geometry import types as ref_types
from geomesa_tpu.geometry.wkt import from_wkt as ref_from_wkt
from geomesa_tpu.geometry.wkt import to_wkt as ref_to_wkt
from geomesa_tpu.index.z2 import XZ2Index as RefXZ2Index
from geomesa_tpu.index.z3 import XZ3Index as RefXZ3Index
from geomesa_tpu.planning.planner import build_indices as ref_build_indices
from geomesa_tpu.schema import columnar as ref_columnar
from geomesa_tpu.schema.sft import parse_spec as ref_parse_spec

from geomesa_tpu_torch.curve.binned_time import TimePeriod
from geomesa_tpu_torch.curve.xz import xz2_sfc, xz3_sfc
from geomesa_tpu_torch.filter import ast
from geomesa_tpu_torch.filter.bounds import extract
from geomesa_tpu_torch.filter.cql import parse
from geomesa_tpu_torch.geometry import types
from geomesa_tpu_torch.geometry.wkt import from_wkt, to_wkt
from geomesa_tpu_torch.index.z2 import XZ2Index
from geomesa_tpu_torch.index.z3 import XZ3Index
from geomesa_tpu_torch.planning.planner import build_indices
from geomesa_tpu_torch.schema import columnar
from geomesa_tpu_torch.schema.sft import parse_spec
from geomesa_tpu_torch.workload import T0, box_linestrings, xz_boxes

CPU = torch.device("cpu")
LINES = "dtg:Date,*geom:LineString:srid=4326;geomesa.z3.interval='day'"
EXTENDED = ("LineString", "Polygon", "MultiLineString", "MultiPolygon", "MultiPoint")


def _boxes(n: int, seed: int):
    """Config-5 bboxes with points, world boxes, boxes past the world's
    edges (the curve clips them) and exact duplicates spliced in."""
    rng = np.random.default_rng(seed)
    xmin, ymin, xmax, ymax = (np.array(c) for c in xz_boxes(n, seed))
    k = n // 10
    sl = rng.choice(n, 4 * k, replace=False).reshape(4, k)
    xmax[sl[0]], ymax[sl[0]] = xmin[sl[0]], ymin[sl[0]]  # points
    xmin[sl[1]], ymin[sl[1]], xmax[sl[1]], ymax[sl[1]] = -180.0, -90.0, 180.0, 90.0
    xmin[sl[2]] -= 400.0  # out of range: clipped
    ymax[sl[2]] += 200.0
    src = rng.choice(sl[3], k // 2)
    dup = sl[3][: k // 2]
    for c in (xmin, ymin, xmax, ymax):  # ties: the same box many times
        c[dup] = c[src[0]]
    return xmin, ymin, xmax, ymax


@pytest.mark.parametrize("g", [12, 6])
def test_xz_index_codes_equal_reference(g):
    xmin, ymin, xmax, ymax = _boxes(20_000, 3)
    got2 = xz2_sfc(g).index((xmin, ymin), (xmax, ymax))
    want2 = ref_xz2_sfc(g).index((xmin, ymin), (xmax, ymax))
    assert got2.dtype == want2.dtype == np.uint64
    assert np.array_equal(got2, want2)
    t = np.random.default_rng(4).uniform(0, 86_400_000, len(xmin))
    got3 = xz3_sfc(TimePeriod.DAY, g).index((xmin, ymin, t), (xmax, ymax, t))
    want3 = ref_xz3_sfc(RefTimePeriod.DAY, g).index((xmin, ymin, t), (xmax, ymax, t))
    assert np.array_equal(got3, want3)
    assert int(got3.max()) < 2**63  # the port sorts codes as int64


WINDOWS2 = [
    [((-10.0, 40.0), (5.0, 55.0))],
    [((-74.5, 40.2), (-73.5, 41.2)), ((0.0, 51.0), (0.5, 51.9))],  # OR'd
    [((-180.0, -90.0), (180.0, 90.0))],
    [((139.0, 35.0), (139.0, 35.0))],  # a point window
]


@pytest.mark.parametrize("max_ranges", [8, 64, 2000])
@pytest.mark.parametrize("w", range(len(WINDOWS2)))
def test_xz_ranges_equal_reference(max_ranges, w):
    wins = WINDOWS2[w]
    assert np.array_equal(xz2_sfc(12).ranges(wins, max_ranges),
                          ref_xz2_sfc(12).ranges(wins, max_ranges))
    wins3 = [((*lo, 3600e3), (*hi, 7200e3)) for lo, hi in wins]
    got = xz3_sfc(TimePeriod.DAY, 12).ranges(wins3, max_ranges)
    want = ref_xz3_sfc(RefTimePeriod.DAY, 12).ranges(wins3, max_ranges)
    assert got.dtype == np.uint64 and np.array_equal(got, want)


def _line_coords(n: int, seed: int):
    """``n`` line strings (2-5 vertices) on config-5 boxes with tie-heavy
    duplicates, as coordinate arrays."""
    coords, offsets = box_linestrings(*_boxes(n, seed), seed=seed)
    return [coords[offsets[i]:offsets[i + 1]] for i in range(n)]


def _line_tables(lines, t=None, spec=LINES, name="l"):
    """The same features as a reference and a port FeatureTable, built from
    geometry objects of each package."""
    out = []
    for mod, gmod, parse_fn in ((ref_columnar, ref_types, ref_parse_spec),
                                (columnar, types, parse_spec)):
        sft = parse_fn(name, spec)
        recs = [{"geom": gmod.LineString(c.copy())} for c in lines]
        if t is not None:
            for r, v in zip(recs, t):
                r["dtg"] = int(v)
        out.append((sft, mod.FeatureTable.from_records(
            sft, recs, [f"f{i}" for i in range(len(lines))])))
    return out


CQLS = [
    "BBOX(geom, -10, 40, 5, 55)",
    "BBOX(geom, -74.5, 40.2, -73.5, 41.2) OR BBOX(geom, 0, 51, 0.5, 51.9)",
    "BBOX(geom, 170, -20, -170, 20)",
    "BBOX(geom, -80, 35, -70, 45) AND dtg DURING 2017-07-02T00:00:00Z/2017-07-05T12:00:00Z",
    "dtg DURING 2017-07-03T00:00:00Z/2017-07-04T00:00:00Z",
    "INCLUDE",
]


@pytest.mark.parametrize("g", [12, 4])
def test_xz_index_perms_and_plans_equal_reference(g):
    """Builds on the port's device route (here the CPU) against the
    reference's stable host sorts; ``g = 4`` makes nearly every code tie."""
    n = 12_000
    lines = _line_coords(n, 7)
    t = T0 + np.random.default_rng(8).integers(0, 10 * 86_400_000, n)
    spec = LINES + f",geomesa.xz.precision={g}"
    (rsft, rtab), (sft, tab) = _line_tables(lines, t, spec)
    assert sft.xz_precision == rsft.xz_precision == g
    for ref_cls, cls in ((RefXZ2Index, XZ2Index), (RefXZ3Index, XZ3Index)):
        ref, port = ref_cls(rsft), cls(sft)
        want = ref.build(rtab)
        got = port.build(tab, CPU)
        assert np.array_equal(got, want)
        assert np.array_equal(port.codes, ref.codes)
        if cls is XZ3Index:
            assert np.array_equal(port.bins, ref.bins)
        if g == 4:  # tie-heavy: most features share their code with others
            assert len(np.unique(port.codes)) < n // 4
        for q in CQLS:
            e, re_ = extract(parse(q), "geom", "dtg"), ref_extract(ref_parse(q), "geom", "dtg")
            for budget in (16, 2000):
                assert np.array_equal(port.plan(e, budget).intervals,
                                      ref.plan(re_, budget).intervals), (cls.name, q, budget)
        # install takes the reference's permutation without a sort
        again = cls(sft)
        again.install(tab, want)
        assert np.array_equal(again.codes, ref.codes)
        with pytest.raises(ValueError, match="does not sort"):
            cls(sft).install(tab, want[::-1].copy())


@pytest.mark.parametrize("kind", EXTENDED + ("Geometry",))
def test_parse_spec_extended_types(kind):
    spec = f"name:String,dtg:Date,*geom:{kind}:srid=4326;geomesa.xz.precision=10"
    got, want = parse_spec("e", spec), ref_parse_spec("e", spec)
    assert got.attr("geom").type.value == want.attr("geom").type.value == kind
    assert got.attr("geom").type.is_geometry and want.attr("geom").type.is_geometry
    assert got.geom_is_points == want.geom_is_points is False
    assert got.xz_precision == want.xz_precision == 10
    assert got.geom_field == want.geom_field == "geom"
    assert parse_spec("p", "*geom:Point").xz_precision == 12


@pytest.mark.parametrize("spec,names", [
    ("dtg:Date,*geom:Polygon", {"xz3", "xz2"}),
    ("*geom:LineString:srid=4326", {"xz2"}),
    ("dtg:Date,*geom:MultiPolygon;geomesa.indices='xz2'", {"xz2"}),
    ("dtg:Date,*geom:Point", {"z3", "z2"}),
])
def test_build_indices_extended(spec, names):
    """The reference's index set minus ``id`` (not ported, ROADMAP A.8.1)."""
    assert set(build_indices(parse_spec("t", spec))) == names
    assert set(ref_build_indices(ref_parse_spec("t", spec))) - {"id"} == names


WKTS = [
    "POINT (1.5 -2.25)",
    "LINESTRING (0 0, 1 1.5, 2.25 -3)",
    "POLYGON ((0 0, 4 0, 4 4, 0 4, 0 0), (1 1, 2 1, 2 2, 1 1))",
    "MULTIPOINT ((1 2), (3 4))",
    "MULTILINESTRING ((0 0, 1 1), (5 5, 6 7.125))",
    "MULTIPOLYGON (((0 0, 1 0, 1 1, 0 0)), ((5 5, 6 5, 6 6, 5 5)))",
    "POLYGON ((-179.5 10, 179.25 10, 179.25 12, -179.5 12, -179.5 10))",
]


@pytest.mark.parametrize("wkt", WKTS)
def test_wkt_round_trip_and_bounds_equal_reference(wkt):
    got, want = from_wkt(wkt), ref_from_wkt(wkt)
    assert type(got).__name__ == type(want).__name__
    assert np.array_equal(np.array(got.bbox), np.array(want.bbox))
    assert to_wkt(got) == ref_to_wkt(want)
    assert to_wkt(from_wkt(to_wkt(got))) == to_wkt(got)


def _mixed(mod, gmod, rng, n: int):
    """Geometry values of every extended type, WKT strings and nulls."""
    vals = []
    for i in range(n):
        x, y = rng.uniform(-170, 170), rng.uniform(-80, 80)
        k = i % 6
        if k == 0:
            vals.append(gmod.LineString(np.array([[x, y], [x + 1, y - 0.5]])))
        elif k == 1:
            vals.append(gmod.Polygon(np.array([[x, y], [x + 2, y], [x + 1, y + 1]])))
        elif k == 2:
            vals.append(f"LINESTRING ({x} {y}, {x + 0.25} {y + 3})")
        elif k == 3:
            vals.append(gmod.MultiLineString((gmod.LineString(np.array([[x, y], [x, y + 1]])),
                                              gmod.LineString(np.array([[x - 2, y], [x, y]])))))
        elif k == 4:
            vals.append(None)
        else:
            vals.append(f"POLYGON (({x} {y}, {x + 1} {y}, {x + 1} {y + 1}, {x} {y}))")
    return vals


def test_geometry_columns_equal_reference():
    """Bounds and validity of extended columns from values, WKT and nulls;
    ``take`` and ``concat`` keep them; ``linestring_column`` gives the
    bounds of its line strings, and its ``take`` and ``concat`` their
    vertices."""
    n = 300
    ref_sft = ref_parse_spec("m", "*geom:Geometry")
    sft = parse_spec("m", "*geom:Geometry")
    ref_t = ref_columnar.FeatureTable.from_records(
        ref_sft, [{"geom": g} for g in _mixed(ref_columnar, ref_types,
                                              np.random.default_rng(5), n)])
    tab = columnar.FeatureTable.from_records(
        sft, [{"geom": g} for g in _mixed(columnar, types, np.random.default_rng(5), n)])
    rc, pc = ref_t.geom_column(), tab.geom_column()
    assert np.array_equal(pc.bounds, rc.bounds, equal_nan=True)
    assert np.array_equal(pc.is_valid(), rc.is_valid())
    idx = np.random.default_rng(6).permutation(n)[:100]
    assert np.array_equal(tab.take(idx).geom_column().bounds, rc.bounds[idx], equal_nan=True)
    cat = columnar.FeatureTable.concat([tab.take(idx), tab])
    rcat = ref_columnar.FeatureTable.concat([ref_t.take(idx), ref_t])
    assert np.array_equal(cat.geom_column().bounds, rcat.geom_column().bounds, equal_nan=True)
    assert np.array_equal(cat.geom_column().is_valid(), rcat.geom_column().is_valid())

    lines = _line_coords(500, 9)
    coords = np.concatenate(lines)
    offsets = np.concatenate([[0], np.cumsum([len(c) for c in lines])])
    col = columnar.linestring_column(coords, offsets)
    (_, rtab), _ = _line_tables(lines)
    assert np.array_equal(col.bounds, rtab.geom_column().bounds)
    sel = np.array([7, 3, 3, 499, 0])
    part = col.take(sel)
    for k, i in enumerate(sel):
        assert np.array_equal(part.geometries()[k].coords, lines[i])
    lsft = parse_spec("l", "*geom:LineString")
    joined = columnar.FeatureTable.concat([
        columnar.FeatureTable.from_columns(lsft, np.array(["a"] * 5), {"geom": part}),
        columnar.FeatureTable.from_columns(lsft, np.array(["b"] * 500), {"geom": col})])
    jc = joined.geom_column()
    assert jc.coords is not None and len(jc) == 505
    assert np.array_equal(jc.geometries()[6].coords, lines[1])
    assert np.array_equal(jc.bounds[5:], col.bounds)
    with pytest.raises(ValueError, match="two vertices"):
        columnar.linestring_column(coords[:3], np.array([0, 1, 3]))


BOXES = [(-10.0, 40.0, 5.0, 55.0), (170.0, -20.0, -170.0, 20.0), (0.0, 0.0, 0.0, 0.0),
         (-180.0, -90.0, 180.0, 90.0), (130.0, 20.0, -90.0, 60.0)]


@pytest.mark.parametrize("box", BOXES)
def test_bbox_mask_on_bounds_equal_reference(box):
    """``BBox.mask`` on line bounds (the antimeridian form included) and on
    points, whose bounds are (x, y, x, y)."""
    rng = np.random.default_rng(12)
    lines = [np.stack([rng.uniform(-180, 180, 2), rng.uniform(-90, 90, 2)], 1)
             for _ in range(2000)] + [np.array([[0.0, 0.0], [0.0, 0.0]])]
    (rsft, rtab), (sft, tab) = _line_tables(lines, spec="*geom:LineString")
    assert np.array_equal(ast.BBox("geom", *box).mask(tab), ref_ast.BBox("geom", *box).mask(rtab))
    lon, lat = rng.uniform(-180, 180, 3000), rng.uniform(-90, 90, 3000)
    lon[:3], lat[:3] = box[0], box[1],
    pts = columnar.FeatureTable.from_columns(parse_spec("p", "*geom:Point"), np.arange(3000)
                                             .astype(str), {"geom": columnar.point_column(lon, lat)})
    rpts = ref_columnar.FeatureTable.from_columns(
        ref_parse_spec("p", "*geom:Point"), np.arange(3000).astype(str),
        {"geom": ref_columnar.point_column(lon, lat)})
    assert np.array_equal(ast.BBox("geom", *box).mask(pts), ref_ast.BBox("geom", *box).mask(rpts))
