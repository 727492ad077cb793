"""The slice as a whole: the port's DataStore against geomesa_tpu's DataStore
(TpuBackend on the 8-device CPU mesh) and its OracleBackend, on ~20k
GDELT-shaped points and ~30 queries.

- ``count_many(loose=True)``: port == JAX TpuBackend;
- ``count_many(loose=False)``: port == JAX == Oracle;
- ``query()`` fid sets: port == JAX == Oracle;
- ``load_reference_state`` reproduces the JAX store's resident columns,
  from the z3 permutation alone or from both point indexes' permutations;
- spatial-only queries plan on z2, temporal ones on z3, and ``count_many``
  batches on the z3 state;
- a date-less point schema (``*geom:Point:srid=4326``, z2 only) gives the
  reference's counts and fid sets; nulls are refused; temporal filters
  behave as in the reference.

Tolerance: none — counts, fid sets and int32 columns compare exactly.
"""

import numpy as np
import pytest
import torch

import geomesa_tpu  # noqa: F401  (x64 on)
from geomesa_tpu.schema import columnar as ref_columnar
from geomesa_tpu.schema.sft import parse_spec as ref_parse_spec
from geomesa_tpu.store.datastore import DataStore as RefDataStore

from geomesa_tpu_torch.planning.planner import FULL_SCAN, build_indices
from geomesa_tpu_torch.schema import columnar
from geomesa_tpu_torch.store import datastore as datastore_mod
from geomesa_tpu_torch.store.convert import load_reference_state
from geomesa_tpu_torch.store.datastore import DataStore
from geomesa_tpu_torch.workload import bbox_cql, bbox_time_cql, make_queries, synth_gdelt

N = 20_000
SPEC = "name:String,dtg:Date,*geom:Point:srid=4326;geomesa.z3.interval='day'"
A = "2017-07-02T00:00:00.000Z/2017-07-05T00:00:00.000Z"
B = "2017-07-20T06:30:00.000Z/2017-07-22T00:00:00.000Z"

EXTRA = [
    "INCLUDE",
    f"BBOX(geom, 170, -40, -170, 40) AND dtg DURING {A}",  # dateline
    f"(BBOX(geom, -80, 35, -70, 45) OR BBOX(geom, 0, 45, 5, 55)) AND dtg DURING {A}",
    f"BBOX(geom, -20, 30, 40, 60) AND (dtg DURING {A} OR dtg DURING {B})",
    f"NOT BBOX(geom, -100, -60, 100, 60) AND dtg DURING {B}",
    f"BBOX(geom, -80, 35, -70, 45) AND dtg DURING {A} AND name = 'n1'",
    "BBOX(geom, 100, 20, 150, 50)",  # spatial only: planned on z2
    f"dtg DURING {B}",
    "BBOX(geom, 0, 0, 10, 10) AND BBOX(geom, 20, 20, 30, 30)",  # disjoint
    f"dtg DURING {A} AND dtg DURING {B}",  # disjoint in time
    "name IN ('n0', 'n3') AND dtg AFTER 2017-07-25T00:00:00Z",
]


@pytest.fixture(scope="module")
def data():
    lon, lat, t = synth_gdelt(N, seed=42)
    names = np.array([f"n{i % 5}" for i in range(N)], dtype=object)
    fids = [f"gdelt.{i}" for i in range(N)]
    boxes, windows = make_queries(20, seed=7)
    queries = [bbox_time_cql(b, w) for b, w in zip(boxes, windows)] + EXTRA
    return lon, lat, t, names, fids, queries


def _table(mod, sft, data):
    lon, lat, t, names, fids, _ = data
    cols = {
        "name": mod.Column(sft.attr("name").type, names.copy()),
        "dtg": mod.Column(sft.attr("dtg").type, t.copy()),
        "geom": mod.point_column(lon.copy(), lat.copy()),
    }
    return mod.FeatureTable.from_columns(sft, fids, cols)


@pytest.fixture(scope="module")
def stores(data):
    ref = RefDataStore(backend="tpu")
    oracle = RefDataStore(backend="oracle")
    for s in (ref, oracle):
        sft = s.create_schema("gdelt", SPEC)
        s.write("gdelt", _table(ref_columnar, sft, data))
        s.compact("gdelt")
    port = DataStore(device="cpu")
    sft = port.create_schema("gdelt", SPEC)
    port.write("gdelt", _table(columnar, sft, data))
    port.compact("gdelt")
    return port, ref, oracle


def test_count_many_loose_matches_reference(stores, data):
    port, ref, _ = stores
    queries = data[-1]
    got = port.count_many("gdelt", queries, loose=True)
    assert got == ref.count_many("gdelt", queries, loose=True)
    assert sum(got[:20]) > 0


def test_count_many_exact_matches_reference_and_oracle(stores, data):
    port, ref, oracle = stores
    queries = data[-1]
    got = port.count_many("gdelt", queries, loose=False)
    assert got == ref.count_many("gdelt", queries, loose=False)
    assert got == oracle.count_many("gdelt", queries, loose=False)
    loose = port.count_many("gdelt", queries, loose=True)
    assert all(lo >= ex for lo, ex in zip(loose, got))  # loose is a superset


def test_query_fid_sets_match(stores, data):
    port, ref, oracle = stores
    for q in data[-1]:
        got = set(port.query("gdelt", q).table.fids.tolist())
        assert got == set(ref.query("gdelt", q).table.fids.tolist()), q
        assert got == set(oracle.query("gdelt", q).table.fids.tolist()), q


def _ref_cols(ref):
    st = ref._types["gdelt"]
    dev = st.backend_state["z3"]
    return st, {k: np.asarray(v)[: dev.n] for k, v in dev.cols.items()}


def test_own_build_equals_reference_residency(stores):
    """The port's own index sort and staging give the same device columns
    as the reference's (same stable (bin, z) order)."""
    port, ref, _ = stores
    st, want = _ref_cols(ref)
    state = port._state("gdelt").backend_state["z3"]
    assert np.array_equal(port._state("gdelt").indices["z3"].perm, st.indices["z3"].perm)
    for name, col in state.cols.items():
        assert col.dtype == torch.int32
        assert state.rows_per_shard % 4096 == 0
        assert np.array_equal(col[: state.n].numpy(), want[name])


def test_load_reference_state(stores, data):
    _, ref, oracle = stores
    st, want = _ref_cols(ref)
    table = st.table
    geom = table.columns["geom"]
    port = DataStore(device="cpu")
    load_reference_state(
        port, "gdelt", SPEC,
        {"name": table.columns["name"].values, "dtg": table.columns["dtg"].values,
         "geom": (geom.x, geom.y)},
        table.fids, st.indices["z3"].perm,
    )
    state = port._state("gdelt").backend_state["z3"]
    assert state.n == len(table)
    for name in ("x", "y", "bins", "offs"):
        assert np.array_equal(state.cols[name][: state.n].numpy(), want[name])
    queries = data[-1][:6]
    assert port.count_many("gdelt", queries, loose=False) == oracle.count_many(
        "gdelt", queries, loose=False)


def test_load_reference_state_rejects_unsorted_perm(stores):
    _, ref, _ = stores
    st = ref._types["gdelt"]
    table = st.table
    geom = table.columns["geom"]
    with pytest.raises(ValueError, match="does not sort"):
        load_reference_state(
            DataStore(device="cpu"), "gdelt", SPEC,
            {"name": table.columns["name"].values, "dtg": table.columns["dtg"].values,
             "geom": (geom.x, geom.y)},
            table.fids, np.arange(len(table)),
        )


def test_oracle_backend_and_record_writes():
    port = DataStore(backend="oracle", device="cpu")
    port.create_schema("p", "dtg:Date,*geom:Point")
    port.write("p", [{"dtg": 1_498_867_200_000, "geom": columnar.Point(1.0, 2.0)},
                     {"dtg": 1_498_867_300_000, "geom": (50.0, 10.0)}])
    assert port.count_many("p", ["BBOX(geom, 0, 0, 5, 5)", "INCLUDE"]) == [1, 2]
    with pytest.raises(ValueError, match="null geometry"):
        port.write("p", [{"dtg": 1_498_867_200_000, "geom": None}])
    poly = port.create_schema("poly", "dtg:Date,*geom:Polygon")
    assert not poly.geom_is_points
    assert set(build_indices(poly)) == {"xz3", "xz2"}


# -- both point indexes on a point + date store ------------------------------


def test_spatial_queries_plan_on_z2_and_temporal_on_z3(stores, data):
    port, _, oracle = stores
    assert set(port._state("gdelt").indices) == {"z3", "z2"}
    assert set(port._state("gdelt").backend_state) == {"z3", "z2"}
    boxes, _ = make_queries(8, seed=7)
    spatial = [bbox_cql(b) for b in boxes]
    spatial += ["BBOX(geom, 170, -40, -170, 40)", "BBOX(geom, 100, 20, 150, 50) AND name = 'n1'"]
    temporal = data[-1][:5] + [f"dtg DURING {B}"]
    for cqls, want in ((spatial, "z2"), (temporal, "z3"), (["INCLUDE", "name = 'n2'"], FULL_SCAN)):
        for cql in cqls:
            res = port.query("gdelt", cql)
            assert res.plan_info.index_name == want, cql
            assert res.plan_info.scan_index == ("z3" if want == FULL_SCAN else want)
            assert set(res.table.fids.tolist()) == set(
                oracle.query("gdelt", cql).table.fids.tolist()), cql
    assert port.count_many("gdelt", spatial, loose=False) == oracle.count_many(
        "gdelt", spatial, loose=False)


def test_count_many_batches_on_z3(stores, data, monkeypatch):
    port, ref, _ = stores
    seen = []
    real = datastore_mod.batched_count

    def spy(x, *rest):
        seen.append(x)
        return real(x, *rest)

    monkeypatch.setattr(datastore_mod, "batched_count", spy)
    queries = data[-1]
    assert port.count_many("gdelt", queries, loose=True) == ref.count_many(
        "gdelt", queries, loose=True)
    state = port._state("gdelt").backend_state
    assert len(seen) == 1 and seen[0] is state["z3"].cols["x"]


def test_z2_residency_equals_reference(stores):
    """The z2 state holds the same columns as the reference's z2 state, in
    the z2 order (real bins/offs: the schema has a date)."""
    port, ref, _ = stores
    st = ref._types["gdelt"]
    dev = st.backend_state["z2"]
    pst = port._state("gdelt")
    assert np.array_equal(pst.indices["z2"].perm, st.indices["z2"].perm)
    state = pst.backend_state["z2"]
    for name, col in state.cols.items():
        assert np.array_equal(col[: state.n].numpy(), np.asarray(dev.cols[name])[: dev.n])


def test_load_reference_state_with_both_permutations(stores, data, monkeypatch):
    _, ref, oracle = stores
    st = ref._types["gdelt"]
    table = st.table
    geom = table.columns["geom"]

    def no_sort(*_):
        raise AssertionError("an index was re-sorted")

    from geomesa_tpu_torch.index.z2 import Z2Index
    from geomesa_tpu_torch.index.z3 import Z3Index

    monkeypatch.setattr(Z3Index, "build", no_sort)
    monkeypatch.setattr(Z2Index, "build", no_sort)
    port = DataStore(device="cpu")
    load_reference_state(
        port, "gdelt", SPEC,
        {"name": table.columns["name"].values, "dtg": table.columns["dtg"].values,
         "geom": (geom.x, geom.y)},
        table.fids, {"z3": st.indices["z3"].perm, "z2": st.indices["z2"].perm},
    )
    pst = port._state("gdelt")
    for name in ("z3", "z2"):
        assert np.array_equal(pst.indices[name].perm, st.indices[name].perm)
    queries = data[-1]
    assert port.count_many("gdelt", queries, loose=False) == oracle.count_many(
        "gdelt", queries, loose=False)
    assert port.count_many("gdelt", queries, loose=True) == ref.count_many(
        "gdelt", queries, loose=True)
    for q in queries[-6:]:
        assert set(port.query("gdelt", q).table.fids.tolist()) == set(
            oracle.query("gdelt", q).table.fids.tolist()), q


# -- a point schema without a date --------------------------------------------

POINT_SPEC = "*geom:Point:srid=4326"


@pytest.fixture(scope="module")
def pt_data():
    lon, lat, _ = synth_gdelt(N, seed=43)
    lon[:30], lat[:30] = -74.0, 40.7  # duplicates: tie order in the z2 sort
    fids = [f"pt.{i}" for i in range(N)]
    boxes, _ = make_queries(16, seed=7)
    queries = [bbox_cql(b) for b in boxes]
    queries += [
        "INCLUDE",
        "BBOX(geom, 170, -40, -170, 40)",
        "BBOX(geom, -80, 35, -70, 45) OR BBOX(geom, 0, 45, 5, 55)",
        "NOT BBOX(geom, -100, -60, 100, 60)",
        "BBOX(geom, 0, 0, 10, 10) AND BBOX(geom, 20, 20, 30, 30)",
        "BBOX(geom, -74, 40.7, -74, 40.7)",
    ]
    return lon, lat, fids, queries


@pytest.fixture(scope="module")
def pt_stores(pt_data):
    lon, lat, fids, _ = pt_data
    out = []
    for s, mod in ((RefDataStore(backend="tpu"), ref_columnar),
                   (RefDataStore(backend="oracle"), ref_columnar),
                   (DataStore(device="cpu"), columnar)):
        sft = s.create_schema("pts", POINT_SPEC)
        s.write("pts", mod.FeatureTable.from_columns(
            sft, fids, {"geom": mod.point_column(lon.copy(), lat.copy())}))
        s.compact("pts")
        out.append(s)
    ref, oracle, port = out
    return port, ref, oracle


def test_dateless_schema_builds_z2_only(pt_stores):
    port, ref, _ = pt_stores
    pst, rst = port._state("pts"), ref._types["pts"]
    assert set(pst.indices) == set(pst.backend_state) == {"z2"}
    assert np.array_equal(pst.indices["z2"].perm, rst.indices["z2"].perm)
    state, dev = pst.backend_state["z2"], rst.backend_state["z2"]
    for name in ("x", "y", "bins", "offs"):
        assert np.array_equal(state.cols[name][: state.n].numpy(),
                              np.asarray(dev.cols[name])[: dev.n])
    assert not state.cols["bins"].any() and not state.cols["offs"].any()
    assert set(port.last_rebuild("pts")["indices"]) == {"z2"}


def test_dateless_counts_and_fid_sets(pt_stores, pt_data):
    port, ref, oracle = pt_stores
    queries = pt_data[-1]
    loose = port.count_many("pts", queries, loose=True)
    assert loose == ref.count_many("pts", queries, loose=True)
    exact = port.count_many("pts", queries, loose=False)
    assert exact == ref.count_many("pts", queries, loose=False)
    assert exact == oracle.count_many("pts", queries, loose=False)
    assert sum(exact[:16]) > 0 and exact[-1] == 30
    for q in queries:
        res = port.query("pts", q)
        assert res.plan_info.index_name == ("z2" if "BBOX" in q and not q.startswith("NOT")
                                            else FULL_SCAN), q
        got = set(res.table.fids.tolist())
        assert got == set(ref.query("pts", q).table.fids.tolist()), q
        assert got == set(oracle.query("pts", q).table.fids.tolist()), q


def test_dateless_rejects_null_geometry_and_temporal_filters():
    port = DataStore(device="cpu")
    ref = RefDataStore(backend="tpu")
    port.create_schema("p", POINT_SPEC)
    ref.create_schema("p", POINT_SPEC)
    port.write("p", [{"geom": columnar.Point(1.0, 2.0)}, {"geom": (3.0, 4.0)}])
    ref.write("p", [{"geom": ref_columnar.Point(1.0, 2.0)},
                    {"geom": ref_columnar.Point(3.0, 4.0)}])
    ref.compact("p")
    for s in (port, ref):
        with pytest.raises(ValueError, match="null geometry"):
            s.write("p", [{"geom": None}])
    assert port.count_many("p", ["BBOX(geom, 0, 0, 2, 3)", "INCLUDE"]) == [1, 2]
    # no date attribute: a temporal filter names a missing column in both
    for cql in (f"dtg DURING {A}", f"BBOX(geom, 0, 0, 5, 5) AND dtg DURING {A}"):
        for call in (lambda s: s.query("p", cql), lambda s: s.count_many("p", [cql])):
            for s in (port, ref):
                with pytest.raises(KeyError):
                    call(s)


def test_date_attribute_without_default_date():
    """``geomesa.index.dtg=''`` pins no default date: the schema is indexed
    by z2 alone, and a temporal filter on the date column is answered by the
    exact residual, as in the reference."""
    spec = "when:Date,*geom:Point:srid=4326;geomesa.index.dtg=''"
    lon, lat, t = synth_gdelt(3000, seed=44)
    fids = [f"w.{i}" for i in range(3000)]
    stores = []
    for s, mod in ((DataStore(device="cpu"), columnar), (RefDataStore(backend="tpu"), ref_columnar),
                   (RefDataStore(backend="oracle"), ref_columnar)):
        sft = s.create_schema("w", spec)
        assert sft.dtg_field is None
        s.write("w", mod.FeatureTable.from_columns(sft, fids, {
            "when": mod.Column(sft.attr("when").type, t.copy()),
            "geom": mod.point_column(lon.copy(), lat.copy())}))
        s.compact("w")
        stores.append(s)
    port, ref, oracle = stores
    assert set(port._state("w").indices) == {"z2"}
    queries = [f"when DURING {A}", f"BBOX(geom, -20, 30, 40, 60) AND when DURING {A}",
               "BBOX(geom, -20, 30, 40, 60)"]
    assert port.count_many("w", queries, loose=False) == oracle.count_many(
        "w", queries, loose=False)
    assert port.count_many("w", queries, loose=True) == ref.count_many("w", queries, loose=True)
    for q in queries:
        assert set(port.query("w", q).table.fids.tolist()) == set(
            oracle.query("w", q).table.fids.tolist()), q


def test_load_reference_state_dateless(pt_stores, pt_data):
    _, ref, oracle = pt_stores
    st = ref._types["pts"]
    geom = st.table.columns["geom"]
    port = DataStore(device="cpu")
    load_reference_state(port, "pts", POINT_SPEC, {"geom": (geom.x, geom.y)},
                         st.table.fids, {"z2": st.indices["z2"].perm})
    assert np.array_equal(port._state("pts").indices["z2"].perm, st.indices["z2"].perm)
    queries = pt_data[-1]
    assert port.count_many("pts", queries, loose=False) == oracle.count_many(
        "pts", queries, loose=False)
