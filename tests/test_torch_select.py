"""The exact main path batched: the port's ``select_many``, its planned
block-pair gather and the exact batched ``count_many`` against geomesa_tpu
(TpuBackend on the 8-device CPU mesh) and its OracleBackend.

- ``intervals_to_block_pairs``: port == reference, on empty, overlapping and
  block-straddling interval lists;
- ``DeviceBackend.select_many_positions`` == ``TpuBackend.select_many_positions``
  on stores carried across by ``load_reference_state``, for z3 and z2 plans,
  ``INCLUDE`` and an empty result included, with the planned gather in one
  chunk and in chunks of a few blocks;
- ``count_many(loose=False)`` == JAX == Oracle, batched (no ``query()`` call
  for pure bbox+time queries that fit their lanes), on GDELT-shaped points
  and on rows planted on box edges; it falls back to ``query()`` with the
  same answers for mixed filters, more than 8 boxes and truncated lanes;
- ``select_many`` == ``[query(q)]`` == JAX ``select_many``, with the
  reference test's query set, a residual attribute predicate, a date-less
  schema and the Oracle backend.

Tolerance: none — counts, positions, row ids and fid sets compare exactly.
"""

import numpy as np
import pytest

import geomesa_tpu  # noqa: F401  (x64 on)
from geomesa_tpu.filter.bounds import extract as ref_extract
from geomesa_tpu.filter.cql import parse as ref_parse
from geomesa_tpu.parallel.query import intervals_to_block_pairs as ref_block_pairs
from geomesa_tpu.schema import columnar as ref_columnar
from geomesa_tpu.store.datastore import DataStore as RefDataStore

from geomesa_tpu_torch.parallel import query as query_mod
from geomesa_tpu_torch.parallel.query import intervals_to_block_pairs
from geomesa_tpu_torch.planning.planner import Query, QueryPlanner
from geomesa_tpu_torch.schema import columnar
from geomesa_tpu_torch.store import datastore as datastore_mod
from geomesa_tpu_torch.store.convert import load_reference_state
from geomesa_tpu_torch.store.datastore import DataStore
from geomesa_tpu_torch.workload import bbox_time_cql, make_queries, synth_gdelt

T0 = 1_498_867_200_000
N = 20_000
SPEC = "name:String,val:Double,dtg:Date,*geom:Point:srid=4326;geomesa.z3.interval='day'"
A = "2017-07-02T00:00:00.000Z/2017-07-05T00:00:00.000Z"
MIXED = [
    f"BBOX(geom, -80, 35, -70, 45) AND dtg DURING {A} AND name = 'n1'",
    f"NOT BBOX(geom, -100, -60, 100, 60) AND dtg DURING {A}",
    "name IN ('n0', 'n3') AND dtg AFTER 2017-07-25T00:00:00Z",
]
# nine boxes: more than MAX_BOXES, packed to their envelope (not exactable)
NINE = " OR ".join(f"BBOX(geom, {x}, {y}, {x + 4}, {y + 3})"
                   for x, y in [(-75, 38), (-2, 49), (114, 37), (35, 53), (-101, 17),
                                (26, -28), (75, 26), (137, 33), (29, 28)])


def _queries():
    boxes, windows = make_queries(16, seed=7)
    return [bbox_time_cql(b, w) for b, w in zip(boxes, windows)] + [
        "INCLUDE",
        f"BBOX(geom, 170, -40, -170, 40) AND dtg DURING {A}",  # dateline: two boxes
        "BBOX(geom, 100, 20, 150, 50)",
        f"dtg DURING {A}",
        "BBOX(geom, 0, 0, 10, 10) AND BBOX(geom, 20, 20, 30, 30)",  # disjoint
        "BBOX(geom, 170, 80, 179, 89)",  # empty results, on z2 and on z3
        f"BBOX(geom, 170, 80, 179, 89) AND dtg DURING {A}",
    ]


def _columns(mod, sft, lon, lat, t, names, vals):
    return {
        "name": mod.Column(sft.attr("name").type, names.copy()),
        "val": mod.Column(sft.attr("val").type, vals.copy()),
        "dtg": mod.Column(sft.attr("dtg").type, t.copy()),
        "geom": mod.point_column(lon.copy(), lat.copy()),
    }


@pytest.fixture(scope="module")
def stores():
    """Port, JAX and Oracle stores over the same GDELT-shaped rows."""
    lon, lat, t = synth_gdelt(N, seed=42)
    names = np.array([f"n{i % 5}" for i in range(N)], dtype=object)
    vals = (np.arange(N) % 100).astype(np.float64)
    fids = [f"g.{i}" for i in range(N)]
    out = []
    for s, mod in ((DataStore(device="cpu"), columnar), (RefDataStore(backend="tpu"), ref_columnar),
                   (RefDataStore(backend="oracle"), ref_columnar)):
        sft = s.create_schema("g", SPEC)
        s.write("g", mod.FeatureTable.from_columns(sft, fids, _columns(mod, sft, lon, lat, t,
                                                                      names, vals)))
        s.compact("g")
        out.append(s)
    return tuple(out)


def _fids(res):
    return sorted(res.table.fids.tolist())


# -- intervals_to_block_pairs ---------------------------------------------------


@pytest.mark.parametrize("intervals", [
    [],
    [np.empty((0, 2), np.int64), np.array([[5, 5]])],
    [np.array([[0, 10], [5, 4200], [4100, 4300]]), np.array([[9000, 9001]])],
    [np.array([[4095, 4097], [8191, 12289]]), np.empty((0, 2)), np.array([[0, 1], [40000, 40960]])],
], ids=["none", "empty", "overlapping", "straddling"])
def test_intervals_to_block_pairs_equal_reference(intervals):
    got_q, got_b = intervals_to_block_pairs(intervals, 4096)
    want_q, want_b = ref_block_pairs(intervals, 4096)
    assert got_q.dtype == got_b.dtype == np.int32
    assert np.array_equal(got_q, want_q) and np.array_equal(got_b, want_b)


# -- DeviceBackend.select_many_positions ----------------------------------------


def _select_many_positions_equal_reference(stores, index_name):
    _, ref, _ = stores
    st = ref._types["g"]
    table = st.table
    geom = table.columns["geom"]
    port = DataStore(device="cpu")
    load_reference_state(
        port, "g", SPEC,
        {k: table.columns[k].values for k in ("name", "val", "dtg")} | {"geom": (geom.x, geom.y)},
        table.fids, {name: st.indices[name].perm for name in ("z3", "z2")})
    pst = port._state("g")
    planner = QueryPlanner(pst.sft, pst.indices)
    cqls = [c for c in _queries() if planner.plan(Query(c))[2].scan_index == index_name]
    assert "INCLUDE" in cqls if index_name == "z3" else len(cqls) >= 2
    plans = [planner.plan(Query(c)) for c in cqls]
    intervals = [pl.intervals for pl, _, _ in plans]
    got = port.backend.select_many_positions(
        pst.backend_state[index_name], pst.indices[index_name],
        [info.extraction for _, _, info in plans], intervals)
    want = ref.backend.select_many_positions(
        st.backend_state[index_name], st.indices[index_name],
        [ref_extract(ref_parse(c), "geom", "dtg") for c in cqls], intervals)
    assert len(got) == len(want) == len(cqls)
    assert sum(len(w) for w in want) > 0 and any(len(w) == 0 for w in want)
    for c, g, w in zip(cqls, got, want):
        assert g.dtype == np.int64 and np.array_equal(g, w), c
        assert np.array_equal(g, np.sort(g))


@pytest.mark.parametrize("index_name", ["z3", "z2"])
def test_select_many_positions_equal_reference(stores, index_name):
    _select_many_positions_equal_reference(stores, index_name)


@pytest.mark.parametrize("index_name,blocks", [("z3", 3), ("z2", 1)], ids=["z3", "z2"])
def test_planned_gather_chunks_equal_reference(stores, index_name, blocks, monkeypatch):
    """The planned gather in chunks of a few blocks (three for the z3 plans,
    whose chunks cross query boundaries and split ``INCLUDE``'s five blocks;
    one for the z2 plans' two pairs): every chunk boundary is held against
    the reference."""
    monkeypatch.setattr(query_mod, "PLANNED_CHUNK_ROWS", blocks * query_mod.JOIN_BLOCK)
    chunks = []
    real = query_mod.row_masks

    def spy(*args):
        chunks.append(args[0].shape[0])
        return real(*args)

    monkeypatch.setattr(query_mod, "row_masks", spy)
    _select_many_positions_equal_reference(stores, index_name)
    assert len(chunks) > 1 and max(chunks) == blocks


def test_select_many_positions_rejects_unaligned_residency(stores):
    port, _, _ = stores
    pst = port._state("g")
    dev = pst.backend_state["z3"]
    cols = {k: v[:-1] for k, v in dev.cols.items()}
    dev_bad = type(dev)(cols=cols, rows_per_shard=dev.rows_per_shard - 1, n=dev.n)
    plan, _, info = QueryPlanner(pst.sft, pst.indices).plan(Query("INCLUDE"))
    with pytest.raises(ValueError, match="block-aligned"):
        port.backend.select_many_positions(dev_bad, pst.indices["z3"], [info.extraction],
                                           [plan.intervals])


# -- count_many(loose=False) ----------------------------------------------------


def _spy_queries(monkeypatch, store):
    seen = []
    real = DataStore.query

    def spy(self, type_name, q=None):
        seen.append(q)
        return real(self, type_name, q)

    monkeypatch.setattr(DataStore, "query", spy)
    return seen


def test_exact_count_many_is_batched_and_equals_reference(stores, monkeypatch):
    port, ref, oracle = stores
    queries = _queries()
    seen = _spy_queries(monkeypatch, port)
    before = port.exact_fallbacks
    got = port.count_many("g", queries, loose=False)
    assert seen == [] and port.exact_fallbacks == before
    assert got == ref.count_many("g", queries, loose=False)
    assert got == oracle.count_many("g", queries, loose=False)
    assert sum(got[:16]) > 0 and got[-3:] == [0, 0, 0]


def test_exact_count_many_falls_back_with_the_same_answers(stores, monkeypatch):
    port, ref, oracle = stores
    queries = MIXED + [NINE, f"({NINE}) AND dtg DURING {A}"] + _queries()[:4]
    seen = _spy_queries(monkeypatch, port)
    before = port.exact_fallbacks
    got = port.count_many("g", queries, loose=False)
    assert [q.filter for q in seen] == queries[:5] and port.exact_fallbacks == before + 5
    assert got == ref.count_many("g", queries, loose=False)
    assert got == oracle.count_many("g", queries, loose=False)
    # the nine boxes batch in loose mode: their envelope's int count
    assert port.count_many("g", [NINE], loose=True) == ref.count_many("g", [NINE], loose=True)


@pytest.fixture(scope="module")
def edge_stores():
    """``tests/test_count_many.py::test_exact_mode_boundary_adversarial``'s
    rows, ported: rows planted exactly on (and 1e-9 off) three boxes'
    corners, in a port store and a JAX store, with the boxes as queries
    alone and with a half-day window."""
    rng = np.random.default_rng(99)
    n = 8_000
    boxes = [(-10.0, -10.0, 10.0, 10.0), (3.33333333, -20.0, 47.77777, 5.5),
             (-123.456789, 12.3456789, -100.0001, 44.4)]
    lon = rng.uniform(-170, 170, n)
    lat = rng.uniform(-85, 85, n)
    k = 0
    for x1, y1, x2, y2 in boxes:
        for bx in (x1, x2):
            for by in (y1, y2):
                for dx in (-1e-9, 0.0, 1e-9):
                    lon[k], lat[k] = bx + dx, by + dx
                    k += 1
    t = T0 + rng.integers(0, 86_400_000, n)
    fids = [str(i) for i in range(n)]
    qs = [f"BBOX(geom, {x1}, {y1}, {x2}, {y2})" for x1, y1, x2, y2 in boxes]
    qs += [f"{q} AND dtg DURING 2017-07-01T00:00:00.000Z/2017-07-01T12:00:00.000Z" for q in qs]
    out = []
    for s, mod in ((DataStore(device="cpu"), columnar), (RefDataStore(backend="tpu"), ref_columnar)):
        sft = s.create_schema("edge", "dtg:Date,*geom:Point")
        s.write("edge", mod.FeatureTable.from_columns(sft, fids, {
            "dtg": mod.Column(sft.attr("dtg").type, t.copy()),
            "geom": mod.point_column(lon.copy(), lat.copy())}))
        s.compact("edge")
        out.append(s)
    want = [int(((lon >= x1) & (lon <= x2) & (lat >= y1) & (lat <= y2)).sum())
            for x1, y1, x2, y2 in boxes]
    return (*out, qs, want)


def test_exact_mode_boundary_adversarial(edge_stores, monkeypatch):
    """The planted rows count as the f64 predicate says, batched, equal to
    the JAX store."""
    port, ref, qs, want = edge_stores
    seen = _spy_queries(monkeypatch, port)
    got = port.count_many("edge", qs, loose=False)
    assert seen == [] and got[:3] == want
    assert got == ref.count_many("edge", qs, loose=False)
    assert got != port.count_many("edge", qs, loose=True)  # the loose count differs here


def test_exact_count_many_falls_back_on_truncated_lanes(edge_stores, monkeypatch):
    """No candidate lanes: exactly the queries with an edge candidate
    truncate and go through ``query()``, answers unchanged."""
    port, ref, qs, _ = edge_stores
    want = ref.count_many("edge", qs, loose=False)
    edged = []
    real = datastore_mod.batched_edge_gather

    def spy(*args, **kwargs):
        out = real(*args, **kwargs)
        edged.append(int((out[2][:, 0] > 0).sum()))
        return out

    monkeypatch.setattr(datastore_mod, "batched_edge_gather", spy)
    monkeypatch.setattr(datastore_mod, "EDGE_CAPACITY", 0)
    seen = _spy_queries(monkeypatch, port)
    before = port.exact_fallbacks
    assert port.count_many("edge", qs, loose=False) == want
    assert edged[0] > 0 and len(seen) == edged[0] == port.exact_fallbacks - before


# -- select_many ----------------------------------------------------------------


@pytest.fixture(scope="module")
def sel_stores():
    """The reference select_many test's data (``tests/test_select_many.py``),
    in a port store and a JAX store."""
    rng = np.random.default_rng(17)
    n = 12_000
    lon, lat = rng.uniform(-60, 60, n), rng.uniform(-60, 60, n)
    t = T0 + rng.integers(0, 10 * 86_400_000, n)
    names = np.array([f"c{i % 7}" for i in range(n)], dtype=object)
    vals = (np.arange(n) % 100).astype(np.float64)
    fids = [f"e{i}" for i in range(n)]
    out = []
    for s, mod in ((DataStore(device="cpu"), columnar), (RefDataStore(backend="tpu"), ref_columnar)):
        sft = s.create_schema("ev", "name:String,val:Double,dtg:Date,*geom:Point")
        s.write("ev", mod.FeatureTable.from_columns(sft, fids, _columns(mod, sft, lon, lat, t,
                                                                       names, vals)))
        s.compact("ev")
        out.append(s)
    return tuple(out)


def _assert_select_many(port, ref, type_name, cqls):
    got = port.select_many(type_name, cqls)
    want = ref.select_many(type_name, cqls)
    assert len(got) == len(want) == len(cqls)
    for c, g, w in zip(cqls, got, want):
        one = port.query(type_name, c)
        assert np.array_equal(g.row_ids, one.row_ids), c
        assert g.table.fids.tolist() == one.table.fids.tolist(), c
        assert g.plan_info.index_name == one.plan_info.index_name, c
        assert _fids(g) == _fids(w), c
    return got


def test_select_many_equals_query_and_reference(sel_stores):
    from tests.test_select_many import _cqls

    port, ref = sel_stores
    got = _assert_select_many(port, ref, "ev", _cqls())
    assert got[-2].count == 0 and got[-1].count == 12_000


def test_select_many_residual_and_mixed(stores, sel_stores):
    port, ref = sel_stores
    [r] = _assert_select_many(port, ref, "ev", ["BBOX(geom, -40, -40, 40, 40) AND val > 90"])
    assert r.count > 0 and (r.table.columns["val"].values > 90).all()
    port, ref, _ = stores
    got = _assert_select_many(port, ref, "g", _queries() + MIXED + [NINE])
    assert {r.plan_info.index_name for r in got} >= {"z3", "z2", "full-scan"}


def test_select_many_dateless_and_oracle():
    rng = np.random.default_rng(5)
    n = 6_000
    lon, lat = rng.uniform(-60, 60, n), rng.uniform(-60, 60, n)
    fids = [f"p{i}" for i in range(n)]
    cqls = ["BBOX(geom, -10, -10, 10, 10)", "BBOX(geom, 170, 80, 179, 89)", None,
            "BBOX(geom, -50, -5, -20, 30) OR BBOX(geom, 0, 45, 5, 55)",
            "NOT BBOX(geom, -50, -50, 50, 50)"]
    stores = []
    for s, mod in ((DataStore(device="cpu"), columnar), (RefDataStore(backend="tpu"), ref_columnar),
                   (DataStore(backend="oracle", device="cpu"), columnar)):
        sft = s.create_schema("p", "*geom:Point:srid=4326")
        s.write("p", mod.FeatureTable.from_columns(sft, fids, {
            "geom": mod.point_column(lon.copy(), lat.copy())}))
        s.compact("p")
        stores.append(s)
    port, ref, oracle = stores
    got = _assert_select_many(port, ref, "p", cqls)
    assert [r.count for r in got][1:3] == [0, n]
    for g, o in zip(got, oracle.select_many("p", cqls)):
        assert np.array_equal(g.row_ids, o.row_ids)
    empty = DataStore(device="cpu")
    empty.create_schema("p", "*geom:Point:srid=4326")
    assert [r.count for r in empty.select_many("p", cqls)] == [0] * len(cqls)
