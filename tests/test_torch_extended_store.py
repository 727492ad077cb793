"""Aggregation on line and polygon stores through the port's ``DataStore``,
against geomesa_tpu's on the same seeded records, on the CPU (the overlap
fold's step is ``tests/test_torch_extended_agg.py``'s; density over the same
geometries is ``tests/test_torch_extended_density.py``'s).

- ``aggregate_many`` on line-string, polygon and date-less line-string
  stores against the reference's ``DataStore`` (``TpuBackend`` on a
  one-device mesh, pyramid off; ``tests/test_sql_mesh_agg.py:363-409``'s
  path) and, for the row sets, against the Oracle's exact counts; queries
  whose box edges sit on features' opposing bounds, so that the host
  re-test adds boundary rows.

Tolerance: counts, value counts, min, max, group keys and their order
compare exactly; f64 sums within a relative 1e-12 (another fold order).
"""

import numpy as np
import pytest

import geomesa_tpu  # noqa: F401  (x64 on)
from geomesa_tpu.geometry import types as ref_types
from geomesa_tpu.parallel.mesh import make_mesh
from geomesa_tpu.planning.planner import Query as RefQuery
from geomesa_tpu.schema import columnar as ref_columnar
from geomesa_tpu.store.backends import TpuBackend
from geomesa_tpu.store.datastore import DataStore as RefDataStore

from geomesa_tpu_torch.geometry import types
from geomesa_tpu_torch.ops import kernels
from geomesa_tpu_torch.schema import columnar
from geomesa_tpu_torch.store.datastore import DataStore

from test_torch_xz_store import T0, _lines, _polygons, _queries

RTOL = 1e-12


SPECS = {
    "lines": "cat:Integer,name:String,val:Double,dtg:Date,*geom:LineString:srid=4326;"
             "geomesa.z3.interval='day'",
    "polygons": "cat:Integer,name:String,val:Double,dtg:Date,*geom:Polygon:srid=4326;"
                "geomesa.z3.interval='week'",
    "dateless": "cat:Integer,name:String,val:Double,*geom:LineString:srid=4326",
}
NS = {"lines": 6_000, "polygons": 4_000, "dateless": 4_000}


def _agg_records(gmod, kind, geoms, t, cat, name, val, valid):
    recs = []
    for i, g in enumerate(geoms):
        geom = (gmod.LineString(g.copy()) if kind != "polygons"
                else gmod.Polygon(g[0].copy(), tuple(h.copy() for h in g[1])))
        r = {"geom": geom, "cat": int(cat[i]), "name": name[i],
             "val": float(val[i]) if valid[i] else None}
        if t is not None:
            r["dtg"] = int(t[i])
        recs.append(r)
    return recs


@pytest.fixture(scope="module", params=sorted(SPECS))
def agg_stores(request):
    kind = request.param
    n = NS[kind]
    geoms = _polygons(n, 12) if kind == "polygons" else _lines(n, 11)
    rng = np.random.default_rng(31)
    t = None if kind == "dateless" else T0 + rng.integers(0, 30 * 86_400_000, n)
    cat = rng.integers(0, 40, n)
    name = [f"g{i % 5}" for i in range(n)]
    val = np.round(rng.normal(50.0, 20.0, n), 3)
    valid = rng.random(n) > 0.1
    fids = [f"x.{i}" for i in range(n)]
    ref = RefDataStore(backend=TpuBackend(mesh=make_mesh(1)))
    oracle = RefDataStore(backend="oracle")
    for s in (ref, oracle):
        s.create_schema("x", SPECS[kind])
        s.write("x", ref_columnar.FeatureTable.from_records(
            s.get_schema("x"), _agg_records(ref_types, kind, geoms, t, cat, name, val, valid),
            fids))
        s.compact("x")
    port = DataStore(device="cpu")
    port.create_schema("x", SPECS[kind])
    port.write("x", columnar.FeatureTable.from_records(
        port.get_schema("x"), _agg_records(types, kind, geoms, t, cat, name, val, valid), fids))
    port.compact("x")
    queries = _queries(kind != "dateless") + ["BBOX(geom, -1000, -1000, -999, -999)"]
    return kind, port, ref, oracle, queries


def _assert_agg_equal(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert (g is None) == (w is None), i
        if g is None:
            continue
        assert g["groups"] == w["groups"], i
        assert np.array_equal(g["count"], w["count"]), i
        assert g["cols"].keys() == w["cols"].keys()
        for c, wc in w["cols"].items():
            gc = g["cols"][c]
            assert np.array_equal(gc["count"], wc["count"]), (i, c)
            for f in ("min", "max"):
                assert np.array_equal(gc[f], wc[f], equal_nan=True), (i, c, f)
            assert np.allclose(gc["sum"], wc["sum"], rtol=RTOL, atol=0, equal_nan=True), (i, c)


@pytest.mark.parametrize("group_by,value_cols", [
    (["cat"], ["val"]),
    (["name", "cat"], ["val"]),
    (None, ["val"]),
    (["name"], []),
])
def test_aggregate_many_equals_reference(agg_stores, monkeypatch, group_by, value_cols):
    monkeypatch.setenv("GEOMESA_TPU_PYRAMID", "0")
    kind, port, ref, oracle, queries = agg_stores
    before = kernels.launches["grouped_agg"]
    got = port.aggregate_many("x", queries, group_by=group_by, value_cols=value_cols)
    want = ref.aggregate_many("x", queries, group_by=group_by, value_cols=value_cols)
    _assert_agg_equal(got, want)
    assert kernels.launches["grouped_agg"] == before  # the CPU launches nothing
    answered = [i for i, g in enumerate(got) if g is not None]
    assert len(answered) >= len(queries) - 8
    assert sum(int(got[i]["count"].sum()) for i in answered) > 0
    # the rows each answer folds are the Oracle's exact rows
    for i in answered[:6]:
        rows = oracle.query("x", RefQuery(filter=queries[i])).table
        assert int(got[i]["count"].sum()) == len(rows), queries[i]


def test_aggregate_many_host_retest_adds_boundary_rows(agg_stores, monkeypatch):
    """Queries whose box edges sit on features' opposing bounds: the
    boundary rows the f64 filter passes are added to their groups."""
    monkeypatch.setenv("GEOMESA_TPU_PYRAMID", "0")
    kind, port, ref, oracle, _ = agg_stores
    b = port._state("x").table.geom_column().bounds
    qs = []
    for i in (5, 17, 333):
        x0, y0, x1, y1 = (float(v) for v in b[i])
        qs.append(f"BBOX(geom, {x1!r}, {y0 - 1.0!r}, {x1 + 2.0!r}, {y1 + 1.0!r})")  # xmin == xmax_i
        qs.append(f"BBOX(geom, {x0 - 2.0!r}, {y0 - 1.0!r}, {x0!r}, {y1 + 1.0!r})")  # xmax == xmin_i
    seen = []
    assemble = DataStore._assemble_agg

    def spy(q, main, keys, value_cols, cnt, *rest):
        seen.append(len(rest[5]))
        return assemble(q, main, keys, value_cols, cnt, *rest)

    monkeypatch.setattr(DataStore, "_assemble_agg", staticmethod(spy))
    got = port.aggregate_many("x", qs, group_by=["cat"], value_cols=["val"])
    want = ref.aggregate_many("x", qs, group_by=["cat"], value_cols=["val"])
    _assert_agg_equal(got, want)
    assert all(s > 0 for s in seen)
    for g, q in zip(got, qs):
        assert int(g["count"].sum()) == oracle.count_many("x", [q], loose=False)[0]
