"""Density over line and polygon geometries through the port, against
geomesa_tpu's on the same seeded records, on the CPU (aggregation on the
same stores is ``tests/test_torch_extended_store.py``'s).

- ``density_grid`` over lines, multilines, polygons, multipolygons, a thin
  polygon and mixed points, weighted and not
  (``tests/test_density_raster.py``), and the ``density`` hint and
  ``density_many`` (loose and exact) on a line store, against the
  reference's.

Tolerance: density grids within 1e-12 (the same f64 arithmetic).
"""

import numpy as np
import pytest

import geomesa_tpu  # noqa: F401  (x64 on)
from geomesa_tpu.geometry import types as ref_types
from geomesa_tpu.planning.planner import Query as RefQuery
from geomesa_tpu.schema import columnar as ref_columnar
from geomesa_tpu.schema.sft import parse_spec as ref_parse_spec
from geomesa_tpu.store.datastore import DataStore as RefDataStore
from geomesa_tpu.store.reduce import density_grid as ref_density_grid

from geomesa_tpu_torch.geometry import types
from geomesa_tpu_torch.ops import kernels
from geomesa_tpu_torch.planning.planner import Query
from geomesa_tpu_torch.schema import columnar
from geomesa_tpu_torch.schema.sft import parse_spec
from geomesa_tpu_torch.store.datastore import DataStore
from geomesa_tpu_torch.store.reduce import density_grid

from test_torch_extended_store import SPECS, _agg_records
from test_torch_xz_store import T0, _lines, _queries

BBOX = (0.0, 0.0, 16.0, 16.0)
OPTS = {"bbox": BBOX, "width": 16, "height": 16}


def _geoms(gmod):
    return {
        "line": [gmod.LineString(np.array([[0.5, 8.5], [15.5, 8.5]]))],
        "diagonal": [gmod.LineString(np.array([[0.1, 0.1], [15.9, 15.9]])),
                     gmod.LineString(np.array([[-3.0, 2.0], [20.0, 9.5], [4.0, 30.0]]))],
        "multiline": [gmod.MultiLineString((gmod.LineString(np.array([[1.0, 1.0], [7.0, 3.0]])),
                                            gmod.LineString(np.array([[9.0, 9.0], [12.0, 15.0]]))
                                            ))],
        "polygon": [gmod.Polygon(np.array([[2, 2], [10, 2], [10, 10], [2, 10]], float)),
                    gmod.Polygon(np.array([[1, 1], [15, 1], [15, 15], [1, 15]], float),
                                 (np.array([[4, 4], [12, 4], [12, 12], [4, 12]], float),))],
        "multipolygon": [gmod.MultiPolygon((
            gmod.Polygon(np.array([[0.5, 0.5], [3.5, 0.5], [3.5, 3.5]], float)),
            gmod.Polygon(np.array([[8, 8], [14, 8], [14, 12], [8, 12]], float))))],
        "thin": [gmod.Polygon(np.array([[3.0, 3.01], [12.0, 3.01], [12.0, 3.02], [3.0, 3.02]]))],
        "mixed": [gmod.Point(4.5, 4.5), gmod.LineString(np.array([[0.5, 1.5], [7.5, 1.5]])),
                  gmod.Point(40.0, 4.0)],
        "outside": [gmod.LineString(np.array([[20.0, 20.0], [30.0, 25.0]]))],
    }


def _geom_table(mod, parse, gmod, geoms, weights=None):
    sft = parse("d", "name:String,w:Double,*geom:Geometry")
    recs = [{"name": f"g{i}", "w": 1.0 if weights is None else weights[i], "geom": g}
            for i, g in enumerate(geoms)]
    return mod.FeatureTable.from_records(sft, recs, fids=[f"g{i}" for i in range(len(recs))])


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("case", sorted(_geoms(types)))
def test_density_grid_equals_reference(case, weighted):
    port_geoms, ref_geoms = _geoms(types)[case], _geoms(ref_types)[case]
    w = [2.5, 0.5, 1.0][: len(port_geoms)] if weighted else None
    opts = {**OPTS, **({"weight_by": "w"} if weighted else {})}
    got = density_grid(_geom_table(columnar, parse_spec, types, port_geoms, w), opts)
    want = ref_density_grid(_geom_table(ref_columnar, ref_parse_spec, ref_types, ref_geoms, w),
                            opts)
    assert got.shape == want.shape == (16, 16)
    assert np.allclose(got, want, rtol=0, atol=1e-12)
    if case in ("line", "polygon", "thin", "multipolygon"):
        assert got.sum() == pytest.approx(sum(w) if weighted else len(port_geoms))
    if case == "outside":
        assert got.sum() == 0


@pytest.fixture(scope="module")
def line_stores():
    n = 3000
    geoms = _lines(n, 11)
    rng = np.random.default_rng(4)
    t = T0 + rng.integers(0, 30 * 86_400_000, n)
    cat = rng.integers(0, 9, n)
    name = [f"g{i % 5}" for i in range(n)]
    val = rng.normal(5.0, 2.0, n)
    valid = np.ones(n, dtype=bool)
    fids = [f"x.{i}" for i in range(n)]
    ref = RefDataStore(backend="tpu")
    ref.create_schema("x", SPECS["lines"])
    ref.write("x", ref_columnar.FeatureTable.from_records(
        ref.get_schema("x"), _agg_records(ref_types, "lines", geoms, t, cat, name, val, valid),
        fids))
    ref.compact("x")
    port = DataStore(device="cpu")
    port.create_schema("x", SPECS["lines"])
    port.write("x", columnar.FeatureTable.from_records(
        port.get_schema("x"), _agg_records(types, "lines", geoms, t, cat, name, val, valid),
        fids))
    port.compact("x")
    return port, ref, _queries(True)[:12]


@pytest.mark.parametrize("loose", [True, False])
def test_density_many_on_a_line_store_equals_reference(line_stores, loose):
    port, ref, queries = line_stores
    vp = (-130.0, -50.0, 150.0, 65.0)
    got = port.density_many("x", queries, vp, width=64, height=48, loose=loose)
    want = ref.density_many("x", queries, vp, width=64, height=48, loose=loose)
    assert len(got) == len(want) == len(queries)
    for g, w in zip(got, want):
        assert g.shape == w.shape == (48, 64)
        assert np.allclose(g, w, rtol=0, atol=1e-12)
    assert sum(float(g.sum()) for g in got) > 0
    assert kernels.launches["batched_density"] == 0  # the batched point step is not taken


def test_density_hint_on_a_line_store_equals_reference(line_stores):
    port, ref, queries = line_stores
    for q in queries[:6] + ["INCLUDE"]:
        opts = {"bbox": (-130.0, -50.0, 150.0, 65.0), "width": 40, "height": 30,
                "weight_by": "val"}
        got = port.query("x", Query(filter=q, hints={"density": opts}))
        want = ref.query("x", RefQuery(filter=q, hints={"density": opts}))
        assert np.allclose(got.density, want.density, rtol=0, atol=1e-12), q
        assert sorted(got.table.fids) == sorted(want.table.fids)
