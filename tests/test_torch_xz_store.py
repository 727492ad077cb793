"""The slice as a whole: line and polygon stores in the port's DataStore
against geomesa_tpu's DataStore (TpuBackend on the 8-device CPU mesh) and
its OracleBackend.

Three schemas: ~20k line strings with a date (xz3 + xz2), polygons with a
date, and line strings without one (xz2 alone). For each:

- ``count_many(loose=True)``: port == JAX TpuBackend (the overlap count);
- ``count_many(loose=False)``: port == JAX == Oracle, the pure bbox+time
  queries batched (only the others fall back to ``query()``);
- ``query()`` fid sets and ``select_many`` row sets: port == JAX == Oracle;
- the index each query plans on is the reference heuristic's
  (``StrategyDecider._heuristic``);
- the port's own build gives the reference's resident bbox columns, and
  ``load_reference_state`` reproduces them from the reference's
  permutations and geometry coordinates;
- ``knn`` and ``knn_many`` (the window loop over ``query()``, distances by
  the exact f64 ``predicates.distance``): the same fids in the same order
  as the reference's, distances within 1e-12 degrees;
- the device joins raise the reference's ``ValueError`` with its message
  (no z2 residency; the bulk join needs points), and
  ``measured_pair_density`` answers None as the reference's does;
  ``aggregate_many`` and density there are held to the reference in
  ``tests/test_torch_extended_agg.py``.

Tolerance: none but the KNN distances' — counts, fid sets, permutations and
int32 columns compare exactly.
"""

import numpy as np
import pytest
import torch

import geomesa_tpu  # noqa: F401  (x64 on)
from geomesa_tpu.filter.bounds import extract as ref_extract
from geomesa_tpu.process import join as ref_join, knn as ref_knn
from geomesa_tpu.filter.cql import parse as ref_parse
from geomesa_tpu.geometry import types as ref_types
from geomesa_tpu.planning.planner import StrategyDecider
from geomesa_tpu.schema import columnar as ref_columnar
from geomesa_tpu.store.datastore import DataStore as RefDataStore

from geomesa_tpu_torch.geometry import types
from geomesa_tpu_torch.geometry.types import Point, box
from geomesa_tpu_torch.planning.planner import FULL_SCAN
from geomesa_tpu_torch.process import join, knn
from geomesa_tpu_torch.schema import columnar
from geomesa_tpu_torch.store.convert import load_reference_state
from geomesa_tpu_torch.store.datastore import DataStore
from geomesa_tpu_torch.workload import (
    T0, bbox_cql, bbox_time_cql, box_linestrings, make_queries, xz_boxes)

N = 20_000
LINES = "name:String,dtg:Date,*geom:LineString:srid=4326;geomesa.z3.interval='day'"
POLYS = "name:String,dtg:Date,*geom:Polygon:srid=4326;geomesa.z3.interval='week'"
DATELESS = "name:String,*geom:LineString:srid=4326"
A = "2017-07-02T00:00:00.000Z/2017-07-05T00:00:00.000Z"
B = "2017-07-20T06:30:00.000Z/2017-07-22T00:00:00.000Z"

TIMED = [
    f"BBOX(geom, 170, -40, -170, 40) AND dtg DURING {A}",  # dateline
    f"(BBOX(geom, -80, 35, -70, 45) OR BBOX(geom, 0, 45, 5, 55)) AND dtg DURING {A}",
    f"BBOX(geom, -20, 30, 40, 60) AND (dtg DURING {A} OR dtg DURING {B})",
    f"NOT BBOX(geom, -100, -60, 100, 60) AND dtg DURING {B}",
    f"BBOX(geom, -80, 35, -70, 45) AND dtg DURING {A} AND name = 'n1'",
    f"dtg DURING {B}",
    f"dtg DURING {A} AND dtg DURING {B}",  # disjoint in time
]
SPATIAL = [
    "INCLUDE",
    "BBOX(geom, 100, 20, 150, 50)",
    "BBOX(geom, 130, 20, -90, 60)",  # wraps the antimeridian
    "BBOX(geom, 0, 0, 10, 10) AND BBOX(geom, 20, 20, 30, 30)",  # disjoint
    "BBOX(geom, -74.5, 40.2, -73.5, 41.2) OR BBOX(geom, 116, 39, 117, 41)",
    "name IN ('n0', 'n3')",
]


def _queries(dated: bool, n_city: int = 16):
    boxes, windows = make_queries(n_city, seed=7)
    if dated:
        return [bbox_time_cql(b, w) for b, w in zip(boxes, windows)] + TIMED + SPATIAL
    return [bbox_cql(b) for b in boxes] + SPATIAL


def _lines(n: int, seed: int):
    """Line strings on config-5 boxes, a tenth of them degenerate (both
    vertices on one point) or shared by many features (ties)."""
    b = [np.array(c) for c in xz_boxes(n, seed)]
    k = n // 10
    b[2][:k], b[3][:k] = b[0][:k], b[1][:k]
    for c in b:
        c[k:2 * k] = c[2 * k]
    coords, offsets = box_linestrings(*b, seed=seed)
    return [coords[offsets[i]:offsets[i + 1]] for i in range(n)]


def _polygons(n: int, seed: int):
    """Triangles and boxes (some with a hole) around config-5 boxes."""
    xmin, ymin, xmax, ymax = xz_boxes(n, seed)
    out = []
    for i in range(n):
        x0, y0, x1, y1 = xmin[i], ymin[i], xmax[i], ymax[i]
        if i % 3 == 0:
            out.append((np.array([[x0, y0], [x1, y0], [x1, y1]]), ()))
        else:
            shell = np.array([[x0, y0], [x1, y0], [x1, y1], [x0, y1]])
            dx, dy = (x1 - x0) / 4, (y1 - y0) / 4
            hole = () if i % 3 == 1 else (np.array([[x0 + dx, y0 + dy], [x0 + 2 * dx, y0 + dy],
                                                    [x0 + 2 * dx, y0 + 2 * dy]]),)
            out.append((shell, hole))
    return out


def _records(gmod, kind: str, geoms, t, names):
    recs = []
    for i, g in enumerate(geoms):
        geom = (gmod.LineString(g.copy()) if kind == "lines"
                else gmod.Polygon(g[0].copy(), tuple(h.copy() for h in g[1])))
        r = {"geom": geom, "name": names[i]}
        if t is not None:
            r["dtg"] = int(t[i])
        recs.append(r)
    return recs


SCHEMAS = {"lines": (LINES, "lines", True), "polygons": (POLYS, "polygons", True),
           "dateless": (DATELESS, "lines", False)}


@pytest.fixture(scope="module", params=sorted(SCHEMAS))
def stores(request):
    spec, kind, dated = SCHEMAS[request.param]
    rng = np.random.default_rng(5)
    n = N if kind == "lines" else N // 2
    geoms = _lines(n, 11) if kind == "lines" else _polygons(n, 12)
    t = T0 + rng.integers(0, 30 * 86_400_000, n) if dated else None
    names = [f"n{i % 5}" for i in range(n)]
    fids = [f"x.{i}" for i in range(n)]
    ref = RefDataStore(backend="tpu")
    oracle = RefDataStore(backend="oracle")
    for s in (ref, oracle):
        s.create_schema("x", spec)
        s.write("x", ref_columnar.FeatureTable.from_records(
            s.get_schema("x"), _records(ref_types, kind, geoms, t, names), fids))
        s.compact("x")
    port = DataStore(device="cpu")
    port.create_schema("x", spec)
    port.write("x", columnar.FeatureTable.from_records(
        port.get_schema("x"), _records(types, kind, geoms, t, names), fids))
    port.compact("x")
    return request.param, port, ref, oracle, _queries(dated)


def test_count_many_matches_reference(stores):
    name, port, ref, oracle, queries = stores
    loose = port.count_many("x", queries, loose=True)
    assert loose == ref.count_many("x", queries, loose=True)
    before = port.exact_fallbacks
    exact = port.count_many("x", queries, loose=False)
    assert exact == ref.count_many("x", queries, loose=False)
    assert exact == oracle.count_many("x", queries, loose=False)
    assert all(lo >= ex for lo, ex in zip(loose, exact))
    assert sum(exact[:16]) > 0
    # only the queries the batched pass cannot take fall back: OR'd boxes or
    # windows, NOT and attribute filters (four timed, two spatial)
    assert port.exact_fallbacks - before == (2 if name == "dateless" else 6)


def test_query_and_select_many_match_reference(stores):
    name, port, ref, oracle, queries = stores
    many = port.select_many("x", queries)
    ref_many = ref.select_many("x", queries)
    for q, m, rm in zip(queries, many, ref_many):
        got = port.query("x", q)
        want = set(oracle.query("x", q).table.fids.tolist())
        assert set(got.table.fids.tolist()) == want, q
        assert set(ref.query("x", q).table.fids.tolist()) == want, q
        assert np.array_equal(m.row_ids, got.row_ids), q
        assert set(rm.table.fids.tolist()) == want, q
        assert m.plan_info.scan_index == got.plan_info.scan_index


def test_index_choice_follows_reference_heuristic(stores):
    name, port, ref, _, queries = stores
    st = port._state("x")
    ref_indices = ref._types["x"].indices
    for q in queries:
        info = port.query("x", q).plan_info
        e = ref_extract(ref_parse(q), "geom", st.sft.dtg_field)
        want = StrategyDecider._heuristic(ref_indices, e)
        if info.index_name == FULL_SCAN:
            assert info.scan_index == want, q
            assert not (e.temporally_bounded or e.spatially_bounded) or e.disjoint, q
        else:
            assert info.index_name == want, q
    assert set(st.indices) == ({"xz2"} if name == "dateless" else {"xz3", "xz2"})


def _ref_state(ref):
    st = ref._types["x"]
    return st, {name: {k: np.asarray(v)[: dev.n] for k, v in dev.cols.items()}
                for name, dev in st.backend_state.items() if dev is not None}


def test_residency_and_load_reference_state(stores):
    name, port, ref, oracle, queries = stores
    st, want = _ref_state(ref)
    pst = port._state("x")
    for idx, cols in want.items():
        state = pst.backend_state[idx]
        assert state.kind == "bboxes" and state.rows_per_shard % 4096 == 0
        assert np.array_equal(pst.indices[idx].perm, st.indices[idx].perm)
        assert set(state.cols) == set(cols)
        for k, v in cols.items():
            assert state.cols[k].dtype == torch.int32
            assert np.array_equal(state.cols[k][: state.n].numpy(), v), (idx, k)
    # carry the reference's main tier across: coordinates, not WKT
    table = st.table
    geom = table.columns["geom"].geometries()
    if name == "polygons":
        coords = [("Polygon", [g.shell, *g.holes]) for g in geom]
    else:
        coords = [("LineString", g.coords) for g in geom]
    cols = {"name": table.columns["name"].values, "geom": coords}
    if "dtg" in table.columns:
        cols["dtg"] = table.columns["dtg"].values
    spec = {"lines": LINES, "polygons": POLYS, "dateless": DATELESS}[name]
    loaded = DataStore(device="cpu")
    load_reference_state(loaded, "x", spec, cols, table.fids,
                         {idx: st.indices[idx].perm for idx in want})
    lst = loaded._state("x")
    for idx, cols_ in want.items():
        for k, v in cols_.items():
            assert np.array_equal(lst.backend_state[idx].cols[k][: len(v)].numpy(), v)
    assert loaded.count_many("x", queries, loose=False) == oracle.count_many(
        "x", queries, loose=False)


KNN_POINTS = [(0.0, 0.0), (2.3, 48.9), (-74.0, 40.7), (179.5, 0.0), (120.0, 30.0),
              (-150.0, -70.0)]
KNN_ATOL = 1e-12  # degrees: the same f64 formulas, held nearly bit for bit


def test_knn_equals_reference(stores):
    """``knn`` and ``knn_many`` on a line or polygon store: the window loop
    over ``query()`` with the exact f64 distance, as the reference's."""
    _, port, ref, _, _ = stores
    got = knn.knn_many(port, "x", [Point(*p) for p in KNN_POINTS], k=5)
    want = ref_knn.knn_many(ref, "x", [ref_types.Point(*p) for p in KNN_POINTS], k=5)
    for (gt, gd), (wt, wd) in zip(got, want):
        assert gt.fids.tolist() == wt.fids.tolist()
        np.testing.assert_allclose(gd, wd, rtol=0, atol=KNN_ATOL)
    for p, (gt, gd) in zip(KNN_POINTS[:2], got):
        one, d = knn.knn(port, "x", Point(*p), k=5)
        assert one.fids.tolist() == gt.fids.tolist() and np.array_equal(d, gd)
    wt, wd = ref_knn.knn(ref, "x", ref_types.Point(1.0, 45.0), k=7, filter="name = 'n1'")
    gt, gd = knn.knn(port, "x", Point(1.0, 45.0), k=7, filter="name = 'n1'")
    assert gt.fids.tolist() == wt.fids.tolist() and len(gt) == 7
    np.testing.assert_allclose(gd, wd, rtol=0, atol=KNN_ATOL)


def test_unported_surfaces_raise(stores):
    """The device joins on a line or polygon store: the reference's
    ``ValueError`` and message (no z2 residency for the block join, the bulk
    join needs points, ``join_counts_auto`` falls to the bulk join), and
    ``measured_pair_density`` None."""
    _, port, ref, _, _ = stores
    poly = box(-10.0, 40.0, 5.0, 55.0)
    ref_poly = ref_types.Polygon(np.array(poly.shell))
    for fn in ("join_rows_device", "join_within_device", "join_counts_auto"):
        with pytest.raises(ValueError) as want:
            getattr(ref_join, fn)(ref, "x", [ref_poly])
        with pytest.raises(ValueError) as got:
            getattr(join, fn)(port, "x", [poly])
        assert str(got.value) == str(want.value), fn
    assert join.measured_pair_density(port, "x", [poly]) is None
    assert ref_join.measured_pair_density(ref, "x", [ref_poly]) is None
