"""Bench config 9's product path: the port's GeoBlocks pyramid and query
cache (``ops/geoblocks.py``, ``DataStore.aggregate_many``) against
geomesa_tpu's on the same seeded data, on the CPU.

- ``AggPyramid``: the levels built from the same rows equal the
  reference's, and ``answer`` equals the reference's (partials and boundary
  rows) with the finest level at each of ``LEVEL_KS``, for an interior box,
  a box inside one finest cell (boundary only), the whole world (no box and
  the full box), one finest cell and a box on bucket edges, over windows of
  full bins, of partial end bins only, and no window;
- ``aggregate_many`` with the pyramid on (``GEOMESA_TPU_PYRAMID=1``; the
  port's default is the fused path) against the reference's with the
  pyramid on (the reference takes its pyramid on the CPU by default) and
  against the port's own fused path with ``GEOMESA_TPU_PYRAMID=0``: group
  keys and a value column with nulls, city boxes with 2-7 day windows,
  windows of whole weeks, no window, rows on a box's edge, a disjoint
  filter and filters the pyramid cannot take;
- ``QueryCache``: a hit equals the cold answer on either path; a write or
  a compact makes it stale; LRU eviction at ``max_entries``; copies on put
  and get;
- refusals: the byte cap (checked on the rows' O(N) share before any input
  is prepared), more than ``_AGG_MAX_GROUPS`` groups, a line store (the
  fused overlap path serves) and a filter that is not one bbox+time
  conjunction; the switch (unset or off: the fused path; on: the
  pyramid); ``to_cql`` equal to the reference's and an unrenderable filter
  uncacheable.

Tolerance: groups and their order, counts, value counts, first rows, min,
max and boundary rows exact; sums within a relative 1e-12 (the pyramid's
partials against a fold in another order).
"""

import numpy as np
import pytest

import geomesa_tpu  # noqa: F401  (x64 on)
from geomesa_tpu.filter import ast as ref_ast
from geomesa_tpu.filter.cql import parse as ref_parse
from geomesa_tpu.geometry import types as ref_types
from geomesa_tpu.ops import geoblocks as ref_geoblocks
from geomesa_tpu.parallel.mesh import make_mesh
from geomesa_tpu.schema import columnar as ref_columnar
from geomesa_tpu.store.backends import TpuBackend
from geomesa_tpu.store.datastore import DataStore as RefDataStore

from geomesa_tpu_torch.filter import ast
from geomesa_tpu_torch.filter.cql import parse
from geomesa_tpu_torch.geometry import types
from geomesa_tpu_torch.ops import geoblocks
from geomesa_tpu_torch.planning.planner import Query, choose_agg_path
from geomesa_tpu_torch.schema import columnar
from geomesa_tpu_torch.store.datastore import DataStore
from geomesa_tpu_torch.workload import T0, bbox_cql, bbox_time_cql, make_queries, synth_gdelt

RTOL = 1e-12
SPEC = "cat:Integer,kind:String,w:Double,dtg:Date,*geom:Point"
N = 12_000
WEEK = 7 * 86_400_000
EDGE_X = 2.25  # rows planted on a query box's west edge


def _iso(ms: int) -> str:
    import datetime

    return datetime.datetime.fromtimestamp(ms / 1000, datetime.timezone.utc).strftime(
        "%Y-%m-%dT%H:%M:%S.") + f"{ms % 1000:03d}Z"


@pytest.fixture(scope="module")
def data():
    """GDELT-shaped points over 30 days, a nullable Integer and String group
    key, a value column with nulls and NaN, and rows on one box's edge."""
    lon, lat, t = synth_gdelt(N, seed=8)
    lon[:200], lat[:200] = EDGE_X, np.linspace(45.0, 52.0, 200)
    rng = np.random.default_rng(31)
    cat = rng.integers(0, 9, N).astype(np.int32)
    kind = np.array([f"k{i}" for i in rng.integers(0, 4, N)], dtype=object)
    w = rng.normal(10.0, 4.0, N)
    w[rng.random(N) < 0.03] = np.nan
    valid = {c: rng.random(N) > 0.15 for c in ("cat", "kind", "w")}
    return lon, lat, t, cat, kind, w, valid


def _table(mod, sft, d):
    lon, lat, t, cat, kind, w, valid = d
    return mod.FeatureTable.from_columns(sft, [f"g.{i}" for i in range(N)], {
        "cat": mod.Column(sft.attr("cat").type, cat.copy(), valid["cat"].copy()),
        "kind": mod.Column(sft.attr("kind").type, kind.copy(), valid["kind"].copy()),
        "w": mod.Column(sft.attr("w").type, w.copy(), valid["w"].copy()),
        "dtg": mod.Column(sft.attr("dtg").type, t.copy()),
        "geom": mod.point_column(lon.copy(), lat.copy())})


def _port_store(d):
    ds = DataStore(device="cpu")
    ds.write("g", _table(columnar, ds.create_schema("g", SPEC), d))
    ds.compact("g")
    return ds


def _ref_store(d):
    ref = RefDataStore(backend=TpuBackend(mesh=make_mesh(1)))
    ref.write("g", _table(ref_columnar, ref.create_schema("g", SPEC), d))
    ref.compact("g")
    return ref


@pytest.fixture(scope="module")
def stores(data):
    return _port_store(data), _ref_store(data)


def _queries():
    boxes, windows = make_queries(12, seed=7)
    long = f"{_iso(T0 + 86_400_000)}/{_iso(T0 + 26 * 86_400_000)}"  # whole weeks inside
    return ([bbox_time_cql(b, w) for b, w in zip(boxes, windows)]
            + [bbox_cql(b) for b in boxes[:3]]
            + [f"BBOX(geom, -20, 30, 40, 60) AND dtg DURING {long}",
               f"dtg DURING {long}",
               "INCLUDE",
               f"BBOX(geom, {EDGE_X}, 44, 6, 53)",  # the planted rows on its edge
               "BBOX(geom, 0, 0, 10, 10) AND BBOX(geom, 20, 20, 30, 30)",  # disjoint
               f"BBOX(geom, -80, 35, -70, 45) AND dtg DURING {long} AND cat = 3",
               "BBOX(geom, -80, 35, -70, 45) OR BBOX(geom, 0, 45, 5, 55)"])


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


# -- AggPyramid alone ----------------------------------------------------------------

def _pyramid_inputs(seed: int = 3, n: int = 20_000):
    """Int-domain rows spread over the world with a dense patch, 4 time bins,
    12 groups and two value columns (NaN = null)."""
    rng = np.random.default_rng(seed)
    xi = rng.integers(0, 2**31, n)
    yi = rng.integers(0, 2**31, n)
    patch = slice(0, n // 4)  # a dense patch a few finest cells wide
    xi[patch] = rng.integers(5 << 25, 9 << 25, n // 4)
    yi[patch] = rng.integers(5 << 25, 9 << 25, n // 4)
    bins = rng.integers(2500, 2504, n)
    gid = rng.integers(0, 12, n).astype(np.int32)
    vals = rng.normal(0.0, 5.0, (2, n))
    vals[rng.random(vals.shape) < 0.1] = np.nan
    return xi, yi, bins, gid, [(k,) for k in range(12)], vals


def _cap_for(k: int, inputs) -> int:
    """The byte cap whose ladder ends at level ``k``."""
    xi, _, bins, _, keys, vals = inputs
    t, g, v = len(np.unique(bins)), len(keys), len(vals)
    base = len(xi) * (4 + 4 + 4 + 8 * v)
    return base + int(geoblocks._level_bytes(t, k, g, v) * 1.1) + 1


@pytest.fixture(scope="module", params=geoblocks.LEVEL_KS)
def pyramids(request):
    inputs = _pyramid_inputs()
    cap = _cap_for(request.param, inputs)
    ours = geoblocks.AggPyramid(*inputs, byte_cap=cap)
    theirs = ref_geoblocks.AggPyramid(*inputs, byte_cap=cap)
    assert ours.levels[-1].k == request.param
    return request.param, ours, theirs


def test_pyramid_levels_equal_reference(pyramids):
    k, ours, theirs = pyramids
    assert [lv.k for lv in ours.levels] == [lv.k for lv in theirs.levels]
    for a, b in zip(ours.levels, theirs.levels):
        for f in ("cnt", "first", "vcnt", "vsum", "vmin", "vmax"):
            assert np.array_equal(getattr(a, f), getattr(b, f)), (a.k, f)
    assert ours.nbytes == theirs.nbytes and np.array_equal(ours.bins_present,
                                                           theirs.bins_present)


def _boxes(k: int) -> dict:
    s = 31 - k  # the finest cell's shift
    c = (6 << 25) >> s  # the finest cell holding the dense patch's middle
    return {
        "interior": ((5 << 25) - 1, (9 << 25), (5 << 25) - 1, (9 << 25)),
        "boundary_only": ((c << s) + 5, (c << s) + 1000, (c << s) + 5, (c << s) + 2000),
        "world": None,
        "world_box": (0, 2**31 - 1, 0, 2**31 - 1),
        "one_cell": (c << s, ((c + 1) << s) - 1, c << s, ((c + 1) << s) - 1),
        "bucket_edges": (max(c - 1, 0) << s, (c + 2) << s, c << s, (c + 1) << s),
    }


@pytest.mark.parametrize("window", [(2500, 100, 2503, 7), (2501, 50, 2501, 9_000_000), None],
                         ids=["full_bins", "partial_bins", "no_date"])
def test_answer_equals_reference(pyramids, window):
    k, ours, theirs = pyramids
    served = 0
    for name, box in _boxes(k).items():
        got = ours.answer(box, window)
        want = theirs.answer(box, window)
        for a, b in zip(got, want):
            assert np.array_equal(a, b), (name, window)
        served += int(got[0].sum()) + len(got[6])  # interior rows, boundary rows
    assert served > 0


# -- the store --------------------------------------------------------------------

@pytest.mark.parametrize("group_by,value_cols", [
    (["cat"], ["w"]),
    (["kind", "cat"], ["w"]),
    (None, ["w"]),
])
def test_aggregate_many_pyramid_equals_reference(stores, monkeypatch, group_by, value_cols):
    port, ref = stores
    monkeypatch.setenv("GEOMESA_TPU_PYRAMID", "1")
    queries = _queries()
    port.agg_cache.invalidate()
    ref.agg_cache.invalidate()
    served = ref.metrics.counter("store.agg.pyramid_served").count
    got = port.aggregate_many("g", queries, group_by=group_by, value_cols=value_cols)
    tally = port.last_aggregate_many
    want = ref.aggregate_many("g", queries, group_by=group_by, value_cols=value_cols)
    _assert_agg_equal(got, want)
    assert ref.metrics.counter("store.agg.pyramid_served").count > served
    # every single bbox+time conjunction rode the pyramid; the attribute
    # filter and the OR are declined, the disjoint filter answered empty
    assert tally["pyramid"] == len(queries) - 3 and tally["declined"] == 2
    assert got[-1] is None and got[-2] is None and got[-3]["count"].size == 0
    assert len(tally["pyramid_boundary_rows"]) == tally["pyramid"]
    monkeypatch.setenv("GEOMESA_TPU_PYRAMID", "0")
    port.agg_cache.invalidate()
    fused = port.aggregate_many("g", queries, group_by=group_by, value_cols=value_cols)
    assert port.last_aggregate_many["pyramid"] == 0
    _assert_agg_equal(got, fused)


@pytest.mark.parametrize("switch", ["0", "1"], ids=["fused", "pyramid"])
def test_cache_hit_equals_cold_answer(stores, monkeypatch, switch):
    port, _ = stores
    monkeypatch.setenv("GEOMESA_TPU_PYRAMID", switch)
    queries = _queries()[:6]
    port.agg_cache.invalidate()
    cold = port.aggregate_many("g", queries, group_by=["cat"], value_cols=["w"])
    assert port.last_aggregate_many["pyramid" if switch == "1" else "fused"] == len(queries)
    hits = port.agg_cache.hits
    warm = port.aggregate_many("g", queries, group_by=["cat"], value_cols=["w"])
    assert port.agg_cache.hits == hits + len(queries)
    assert port.last_aggregate_many["cache"] == len(queries)
    for a, b in zip(cold, warm):
        assert a["groups"] == b["groups"] and np.array_equal(a["count"], b["count"])
        for f in ("count", "sum", "min", "max"):
            assert np.array_equal(a["cols"]["w"][f], b["cols"]["w"][f], equal_nan=True)
    # another GROUP BY or value column list is another key
    port.aggregate_many("g", queries, group_by=["kind"], value_cols=["w"])
    assert port.last_aggregate_many["cache"] == 0


def test_write_and_compact_make_the_cache_stale(data, monkeypatch):
    monkeypatch.setenv("GEOMESA_TPU_PYRAMID", "1")
    port = _port_store(data)
    q = ["BBOX(geom, -20, 30, 40, 60)"]
    first = port.aggregate_many("g", q, group_by=["cat"])[0]
    port.compact("g")
    again = port.aggregate_many("g", q, group_by=["cat"])[0]
    assert port.last_aggregate_many["cache"] == 0  # stale after the compact
    assert np.array_equal(first["count"], again["count"])
    port.write("g", [{"cat": 99, "kind": "new", "w": 1.5, "dtg": T0 + 5,
                      "geom": types.Point(10.0, 45.0)}], fids=["fresh"])
    after = port.aggregate_many("g", q, group_by=["cat"])[0]
    assert port.last_aggregate_many["cache"] == 0 and port.last_aggregate_many["pyramid"] == 1
    assert after["groups"][-1] == (99,) and int(after["count"].sum()) == int(
        first["count"].sum()) + 1
    assert port.aggregate_many("g", q, group_by=["cat"])[0]["groups"] == after["groups"]
    assert port.last_aggregate_many["cache"] == 1


def test_query_cache_lru_and_copies():
    cache = geoblocks.QueryCache(max_entries=3)
    res = {"groups": [(1,)], "count": np.array([4]),
           "cols": {"w": {"count": np.array([4]), "sum": np.array([2.0]),
                          "min": np.array([0.5]), "max": np.array([1.0])}}}
    for i in range(4):
        cache.put("g", i, (1, 0), res)
    assert cache.evictions == 1 and cache.get("g", 0, (1, 0)) is None  # the oldest went
    assert cache.get("g", 1, (1, 0)) is not None  # 1 is now the newest
    cache.put("g", 4, (1, 0), res)
    assert cache.get("g", 2, (1, 0)) is None and cache.get("g", 1, (1, 0)) is not None
    res["count"][0] = 7  # a put copied the arrays
    got = cache.get("g", 1, (1, 0))
    assert got["count"][0] == 4
    got["cols"]["w"]["sum"][0] = -1.0  # a get hands out copies
    assert cache.get("g", 1, (1, 0))["cols"]["w"]["sum"][0] == 2.0
    assert cache.get("g", 1, (2, 0)) is None and cache.get("g", 1, (1, 0)) is None  # stale drops
    cache.invalidate("g")
    assert cache.snapshot()["entries"] == 0


def _line_stores():
    rng = np.random.default_rng(4)
    recs = {m: [] for m in (types, ref_types)}
    for i in range(3000):
        x, y = rng.uniform(-30, 30), rng.uniform(-20, 40)
        c = np.array([[x, y], [x + rng.uniform(0, 2), y + rng.uniform(-1, 1)]])
        for m in recs:
            recs[m].append({"cat": int(i % 7), "kind": "k", "w": float(i % 13), "dtg": T0 + i,
                            "geom": m.LineString(c.copy())})
    spec = SPEC.replace("Point", "LineString")
    fids = [f"l.{i}" for i in range(3000)]
    port = DataStore(device="cpu")
    port.create_schema("g", spec)
    port.write("g", recs[types], fids=fids)
    ref = RefDataStore(backend=TpuBackend(mesh=make_mesh(1)))
    ref.create_schema("g", spec)
    ref.write("g", recs[ref_types], fids=fids)
    ref.compact("g")
    return port, ref


@pytest.mark.parametrize("case", ["byte_cap", "groups", "line_store", "not_one_conjunction"])
def test_refusals(data, monkeypatch, case):
    """Shapes the pyramid refuses: the fused path (or the caller's host
    fold) answers, as the reference's does, and a refusal is remembered for
    the epoch."""
    monkeypatch.setenv("GEOMESA_TPU_PYRAMID", "1")
    queries = _queries()[:4]
    if case == "byte_cap":
        monkeypatch.setenv("GEOMESA_TPU_PYRAMID_BYTES", "4096")
    elif case == "groups":
        monkeypatch.setattr(DataStore, "_AGG_MAX_GROUPS", 8)
        monkeypatch.setattr(RefDataStore, "_AGG_MAX_GROUPS", 8)
    elif case == "not_one_conjunction":
        queries = ["BBOX(geom, 170, -40, -170, 40)",  # two boxes across the antimeridian
                   "BBOX(geom, -80, 35, -70, 45) OR BBOX(geom, 0, 45, 5, 55)",
                   bbox_time_cql((-20, 30, 40, 60), (T0, T0 + 3 * 86_400_000)) + " OR "
                   + bbox_time_cql((-20, 30, 40, 60), (T0 + 9 * 86_400_000, T0 + 12 * 86_400_000))]
    port, ref = _line_stores() if case == "line_store" else (_port_store(data), _ref_store(data))
    got = port.aggregate_many("g", queries, group_by=["cat"], value_cols=["w"])
    assert port.last_aggregate_many["pyramid"] == 0
    _assert_agg_equal(got, ref.aggregate_many("g", queries, group_by=["cat"], value_cols=["w"]))
    pyr = port._state("g").pyramids
    if case == "not_one_conjunction":
        assert pyr == {}  # nothing asked for one
        assert got[0] is not None and got[1:] == [None, None]  # the fused path's own rule
    else:
        assert list(pyr.values()) == [(None, port._state("g").epoch)]
        # the fused path declines past its group cap too
        assert all((g is None) == (case == "groups") for g in got)


@pytest.mark.parametrize("switch", [None, "0", "1"], ids=["unset", "off", "on"])
def test_switch_selects_the_path(stores, monkeypatch, switch):
    """Unset or off, the fused path answers (the port's fixed rule); on, the
    pyramid does."""
    port, _ = stores
    for spelling in ("0", "false", "off", "no", "1", "true", "On", "yes"):
        monkeypatch.setenv(geoblocks.PYRAMID_ENV, spelling)
        assert geoblocks.enabled() == (spelling in ("1", "true", "On", "yes")), spelling
    if switch is None:
        monkeypatch.delenv(geoblocks.PYRAMID_ENV)
    else:
        monkeypatch.setenv(geoblocks.PYRAMID_ENV, switch)
    on = switch == "1"
    assert geoblocks.enabled() == on
    assert choose_agg_path() == ("pyramid" if on else "scan")
    port.agg_cache.invalidate()
    port.aggregate_many("g", _queries()[:3], group_by=["cat"], value_cols=["w"])
    tally = port.last_aggregate_many
    assert (tally["pyramid"], tally["fused"]) == ((3, 0) if on else (0, 3))


def test_byte_cap_refuses_before_the_inputs(data, monkeypatch):
    """Rows whose O(N) share alone passes the cap are refused before the
    group keys are factorized, and the refusal is remembered for the epoch;
    a cap between that share and the ladder refuses in ``AggPyramid``."""
    port = _port_store(data)
    st = port._state("g")
    base = N * (4 + 4 + 4 + 8)  # one value column

    def boom(*_):
        raise AssertionError("the inputs were prepared")

    monkeypatch.setenv("GEOMESA_TPU_PYRAMID_BYTES", str(base - 1))
    with monkeypatch.context() as m:
        m.setattr(DataStore, "_agg_group_ids", boom)
        assert port._pyramid(st, st.table, ["cat"], ["w"], st.epoch) is None
    assert st.pyramids[(("cat",), ("w",))] == (None, st.epoch)
    monkeypatch.setenv("GEOMESA_TPU_PYRAMID_BYTES", str(base + 1))
    assert port._pyramid(st, st.table, ["cat"], ["w"], st.epoch + 1) is None
    monkeypatch.delenv("GEOMESA_TPU_PYRAMID_BYTES")
    assert port._pyramid(st, st.table, ["cat"], ["w"], st.epoch + 2) is not None


def test_to_cql_equals_reference():
    texts = _queries() + [
        "NOT (cat = 3) AND kind IN ('a', 'b''c')",
        "w BETWEEN 1.5 AND 3 OR cat <> 4",
        f"dtg BEFORE {_iso(T0)} AND dtg AFTER {_iso(T0 - WEEK)}",
        "EXCLUDE",
    ]
    for text in texts:
        f = parse(text)
        cql = ast.to_cql(f)
        assert cql == ref_ast.to_cql(ref_parse(text)), text
        assert parse(cql) == f, text


def test_unrenderable_filter_is_uncacheable(stores):
    port, _ = stores

    class Opaque(ast.Filter):
        def mask(self, table):
            return np.ones(len(table), dtype=bool)

    with pytest.raises(ValueError, match="cannot render"):
        ast.to_cql(Opaque())
    assert DataStore._agg_cache_key(Query(filter=Opaque()), ["cat"], ["w"]) is None
    assert DataStore._agg_cache_key(Query(filter=parse("INCLUDE")), ["cat"], ["w"]) == (
        "INCLUDE", ("cat",), ("w",))
    assert DataStore._agg_cache_key(Query(filter="INCLUDE", hints={"density": {}}), None,
                                    ()) is None
    entries = port.agg_cache.snapshot()["entries"]
    assert port.aggregate_many("g", [Query(filter=Opaque())], group_by=["cat"]) == [None]
    assert port.agg_cache.snapshot()["entries"] == entries
