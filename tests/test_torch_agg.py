"""Grouped aggregation: the port's ``grouped_agg`` (its plain version on the
CPU) against geomesa_tpu's ``make_grouped_agg_step`` on a one-device mesh,
and the port's ``DataStore.aggregate_many`` against the reference
``DataStore(backend="tpu").aggregate_many`` on its fused path (pyramid off,
``GEOMESA_TPU_PYRAMID=0``) with one shard, on the same seeded tables.

- the step: V = 0, 1 and 2 value columns, NaN values, empty groups, a group
  that only boundary rows hold, and lanes that overflow, on GDELT-shaped
  rows in z3 order, grid rows and the count kernels' edge rows;
- the store: group order, every field, which lanes are ``None`` (a filter
  beyond bbox+time, truncated lanes, NaN keys, a string value column, a
  missing column), GROUP BY on two keys, ``group_by=None``, a disjoint
  filter, queries snapped onto rows so that the host re-test adds rows;
- the fold's work list (``agg_work_list``): the kept (chunk, query) pairs
  of ``chunk_query_pairs`` in query-major order, cut into runs that cover
  each query's list once, over per-chunk extents equal to a numpy min/max
  (padding rows included) and cached when a state is staged; the card's
  block-by-block split (``agg_work_list_segments``: segments placed by the
  counts of the earlier ones) equal to the plain version for any number of
  segments, on the column makers and on made-up extents of up to 5000
  chunks;
- on the card (``cuda`` marker): the kernels against their plain versions,
  in both fold modes (group partials in shared memory, and the global fold
  of a G x V above the shared budget).

Tolerance: counts, first rows, value counts, min, max, positions and group
keys compare exactly; f64 sums within a relative 1e-12, because the device
folds them in another order (segment sums, ``index_add_``, atomics).
"""

import numpy as np
import pytest
import torch

import geomesa_tpu  # noqa: F401  (x64 on)
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec
from geomesa_tpu.parallel.mesh import DATA_AXIS, make_mesh, shard_columns
from geomesa_tpu.parallel.query import make_grouped_agg_step
from geomesa_tpu.schema import columnar as ref_columnar
from geomesa_tpu.schema.sft import parse_spec as ref_parse_spec
from geomesa_tpu.store.backends import TpuBackend
from geomesa_tpu.store.datastore import DataStore as RefDataStore

from geomesa_tpu_torch.ops import kernels
from geomesa_tpu_torch.ops.kernels import grouped_agg, grouped_agg_plain
from geomesa_tpu_torch.parallel.query import grouped_agg_step
from geomesa_tpu_torch.schema import columnar
from geomesa_tpu_torch.store.datastore import DataStore
from geomesa_tpu_torch.workload import (
    bbox_time_cql, edge_columns, edge_payload, grid_columns, grid_payload, grouped_columns,
    make_queries, synth_gdelt)

from test_torch_kernels import CULL_MAKERS, _city_payload, _cull_inputs, _store_columns

RTOL = 1e-12
N, Q, CAP, GROUPS = 40_000, 7, 512, 50
G_PAD = 64  # 1 << ceil(log2 GROUPS): groups 50..63 stay empty


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


_STEPS: dict = {}


def _ref_step(cols, gid, rowid, vals, true_n, boxes, times):
    """``make_grouped_agg_step`` on a one-device mesh (one shard, as the
    port's one card), its columns padded to 4096 rows as the store pads."""
    mesh = make_mesh(1)
    key = (vals.shape[0], boxes.shape, times.shape)
    step = _STEPS.get(key)
    if step is None:
        step = _STEPS[key] = make_grouped_agg_step(mesh, G_PAD, vals.shape[0], CAP,
                                                   impl="segment")
    sharded, padded, _ = shard_columns(
        mesh, {**dict(zip(("x", "y", "bins", "offs"), cols)), "gid": gid}, multiple=4096)
    rid, _, _ = shard_columns(mesh, {"rowid": rowid}, multiple=4096,
                              pad_value=np.iinfo(np.int32).max)
    pv = np.zeros((vals.shape[0], padded))
    pv[:, : vals.shape[1]] = vals
    dv = jax.device_put(pv, NamedSharding(mesh, PartitionSpec(None, DATA_AXIS)))
    out = step(sharded["x"], sharded["y"], sharded["bins"], sharded["offs"], sharded["gid"],
               rid["rowid"], dv, jnp.int32(true_n), jnp.asarray(boxes), jnp.asarray(times))
    return [np.asarray(o) for o in out], padded


def _inputs(maker, n_vals, seed):
    """Host rows, payloads, group ids, row ids and values for one maker:
    group ids in [0, GROUPS - 1) but for the boundary rows of the query
    that has the most of them, which alone hold group GROUPS - 1; about a
    tenth of the values NaN."""
    if maker == "gdelt":
        cols, ds, sft = _store_columns(seed)
        boxes, times = _city_payload(ds, sft, seed)
    elif maker == "grid":
        cols = grid_columns(N, seed=seed)
        boxes, times = grid_payload(cols, Q, 8, 16, seed=seed + 1)
    else:
        cols = edge_columns(N, seed=seed)
        boxes, times = edge_payload(cols, Q, 8, 16, seed=seed + 1, single=False)
    rng = np.random.default_rng(seed + 7)
    gid = rng.integers(0, GROUPS - 1, N).astype(np.int32)
    _, _, _, edge = next(kernels._plain_masks(*(_t(c) for c in cols), 0, N - 300, _t(boxes),
                                              _t(times), N, edges=True))
    gid[edge[int(edge.sum(dim=1).argmax())].numpy()] = GROUPS - 1
    rowid = rng.permutation(N).astype(np.int32)
    vals = rng.normal(50.0, 20.0, (n_vals, N))
    vals[rng.random((n_vals, N)) < 0.1] = np.nan
    return cols, boxes, times, gid, rowid, vals


def _assert_step_equal(got, want, fits=None):
    """The eight outputs, exact but for the sums; lanes only where
    ``fits`` (all of them when None)."""
    names = ("cnt", "first", "vcnt", "vsum", "vmin", "vmax", "positions", "hits")
    for name, g, w in zip(names, got, want):
        g = g.cpu().numpy()
        assert g.shape == w.shape and g.dtype == w.dtype, name
        if name == "vsum":
            assert np.allclose(g, w, rtol=RTOL, atol=0), name
        elif name == "positions" and fits is not None:
            assert np.array_equal(g[fits], w[fits]), name
        else:
            assert np.array_equal(g, w), name


@pytest.mark.parametrize("n_vals", [0, 1, 2])
@pytest.mark.parametrize("maker", ["gdelt", "grid", "edge"])
def test_plain_equals_jax_step(maker, n_vals):
    cols, boxes, times, gid, rowid, vals = _inputs(maker, n_vals, seed=11 + n_vals)
    true_n = N - 300
    want, padded = _ref_step(cols, gid, rowid, vals, true_n, boxes, times)

    def pad(a, value):
        out = np.full(a.shape[:-1] + (padded,), value, dtype=a.dtype)
        out[..., : a.shape[-1]] = a
        return _t(out)

    tc = [pad(c, 0) for c in cols]
    args = (pad(gid, 0), pad(rowid, np.iinfo(np.int32).max), pad(vals, 0.0))
    got = grouped_agg_plain(*tc, *args, 0, true_n, _t(boxes), _t(times), G_PAD, CAP,
                            chunk=4096 * 3)
    _assert_step_equal(got, want)  # the plain lanes keep the first CAP in row order too
    _assert_step_equal(grouped_agg_step(tc, *args, true_n, _t(boxes), _t(times), G_PAD, CAP),
                       want)
    cnt, first, vcnt = want[0], want[1], want[2]
    assert (cnt[:, GROUPS:] == 0).all() and (first[:, GROUPS:] == 2**31 - 1).all()
    assert cnt.sum() > 0
    if maker != "gdelt":  # city boxes at this size hold no row in an edge bucket
        qb = int(want[7][:, 0].argmax())
        assert want[7][qb, 0] > 0 and cnt[qb, GROUPS - 1] == 0  # boundary rows only
    if n_vals:
        assert (vcnt <= cnt[:, None, :]).all() and (vcnt < cnt[:, None, :]).any()  # NaNs
    if maker == "grid":
        assert (want[7][:, 0] > CAP).any() and (want[7][:, 0] <= CAP).any()


def test_wrapper_rejects_bad_inputs():
    cols = [torch.zeros(4096, dtype=torch.int32) for _ in range(4)]
    boxes = torch.zeros((2, 1, 4), dtype=torch.int32)
    times = torch.zeros((2, 1, 4), dtype=torch.int32)
    gid = torch.zeros(4096, dtype=torch.int32)
    vals = torch.zeros((1, 4096), dtype=torch.float64)
    with pytest.raises(TypeError):
        grouped_agg(*cols, gid.long(), gid, vals, 0, 4096, boxes, times, 4)
    with pytest.raises(TypeError):
        grouped_agg(*cols, gid, gid, vals.float(), 0, 4096, boxes, times, 4)
    with pytest.raises(ValueError):
        grouped_agg(*cols, gid, gid, vals[:, :100], 0, 4096, boxes, times, 4)
    with pytest.raises(ValueError):
        grouped_agg(*cols, gid, gid, vals, 0, 4096, boxes, times, 0)
    out = grouped_agg(*cols, gid, gid, vals, 0, 4096, boxes, times, 4)
    assert [tuple(o.shape) for o in out] == [(2, 4), (2, 4), (2, 1, 4), (2, 1, 4), (2, 1, 4),
                                             (2, 1, 4), (2, 1, 512), (2, 1)]


# -- the store: port aggregate_many == reference fused path ----------------------

SPEC = "cat:Integer,kind:String,val:Double,w:Double,dtg:Date,*geom:Point"
NS = 30_000
PLANT = 3000  # rows on one point: about 700 fall in a week's window
TWINS = 6  # anchor rows of the snapped queries, each with a twin
A = "2017-07-02T00:00:00.000Z/2017-07-09T00:00:00.000Z"


@pytest.fixture(scope="module")
def agg_data():
    """Config 9's columns on GDELT-shaped points, plus a string key, a
    second value column with nulls and NaN, and PLANT rows on one point."""
    lon, lat, t = synth_gdelt(NS, seed=42)
    lon[:PLANT], lat[:PLANT] = 2.25, 48.75  # one cell: a query with an edge on it truncates
    for i in range(TWINS):  # a twin one f64 step west of each anchor row, in its bucket
        a, b = PLANT + i, PLANT + TWINS + i
        lon[b], lat[b], t[b] = np.nextafter(lon[a], -np.inf), lat[a], t[a]
    cat, val = grouped_columns(NS, n_groups=40, seed=17)
    rng = np.random.default_rng(3)
    kind = np.array([f"k{i}" for i in rng.integers(0, 3, NS)], dtype=object)
    w = rng.normal(0.0, 5.0, NS)
    w[rng.random(NS) < 0.05] = np.nan
    w_valid = rng.random(NS) > 0.05
    return lon, lat, t, cat, kind, val, w, w_valid


def _agg_table(mod, sft, d):
    lon, lat, t, cat, kind, val, w, w_valid = d
    cols = {
        "cat": mod.Column(sft.attr("cat").type, cat.copy()),
        "kind": mod.Column(sft.attr("kind").type, kind.copy()),
        "val": mod.Column(sft.attr("val").type, val.copy()),
        "w": mod.Column(sft.attr("w").type, w.copy(), w_valid.copy()),
        "dtg": mod.Column(sft.attr("dtg").type, t.copy()),
        "geom": mod.point_column(lon.copy(), lat.copy()),
    }
    return mod.FeatureTable.from_columns(sft, [f"a.{i}" for i in range(NS)], cols)


def _snapped(d, k: int):
    """Queries whose west edge and window start sit on an anchor row: the
    anchor is a boundary row that passes the f64 filter, its twin one that
    does not."""
    lon, lat, t = d[0], d[1], d[2]
    out = []
    for i in range(k):
        a = PLANT + i
        box = (lon[a], lat[a] - 3.0, lon[a] + 4.0, lat[a] + 3.0)
        out.append(bbox_time_cql(box, (int(t[a]) - 1, int(t[a]) + 3 * 86_400_000)))
    return out


@pytest.fixture(scope="module")
def agg_stores(agg_data):
    # the TpuBackend on a one-device mesh: one shard, as the port's one card
    # (its boundary lanes overflow per shard, the port's per query)
    ref = RefDataStore(backend=TpuBackend(mesh=make_mesh(1)))
    sft = ref.create_schema("agg", SPEC)
    ref.write("agg", _agg_table(ref_columnar, sft, agg_data))
    ref.compact("agg")
    port = DataStore(device="cpu")
    sft = port.create_schema("agg", SPEC)
    port.write("agg", _agg_table(columnar, sft, agg_data))
    port.compact("agg")
    boxes, windows = make_queries(16, seed=7)
    queries = [bbox_time_cql(b, w) for b, w in zip(boxes, windows)] + _snapped(agg_data, TWINS) + [
        "INCLUDE",
        f"BBOX(geom, 2.0, 48.5, 2.25, 49.0) AND dtg DURING {A}",  # PLANT rows on its edge
        "BBOX(geom, 0, 0, 10, 10) AND BBOX(geom, 20, 20, 30, 30)",  # disjoint
        f"BBOX(geom, -80, 35, -70, 45) AND dtg DURING {A} AND cat = 3",  # not bbox+time
        f"(BBOX(geom, -80, 35, -70, 45) OR BBOX(geom, 0, 45, 5, 55)) AND dtg DURING {A}",
    ]
    return port, ref, queries


def _assert_agg_equal(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert (g is None) == (w is None), i
        if g is None:
            continue
        assert g["groups"] == w["groups"], i
        assert g["count"].dtype == np.int64 and np.array_equal(g["count"], w["count"]), i
        assert g["cols"].keys() == w["cols"].keys()
        for c, wc in w["cols"].items():
            gc = g["cols"][c]
            assert np.array_equal(gc["count"], wc["count"]), (i, c)
            for f in ("min", "max"):
                assert np.array_equal(gc[f], wc[f], equal_nan=True), (i, c, f)
            assert np.allclose(gc["sum"], wc["sum"], rtol=RTOL, atol=0, equal_nan=True), (i, c)


@pytest.mark.parametrize("group_by,value_cols", [
    (["cat"], ["val"]),
    (["cat", "kind"], ["val", "w"]),
    (None, ["val", "w"]),
    (["kind"], []),
])
def test_aggregate_many_equals_reference(agg_stores, monkeypatch, group_by, value_cols):
    monkeypatch.setenv("GEOMESA_TPU_PYRAMID", "0")
    port, ref, queries = agg_stores
    got = port.aggregate_many("agg", queries, group_by=group_by, value_cols=value_cols)
    want = ref.aggregate_many("agg", queries, group_by=group_by, value_cols=value_cols)
    _assert_agg_equal(got, want)
    n = len(queries)
    assert got[n - 3] == {"groups": [], "count": got[n - 3]["count"],
                          "cols": got[n - 3]["cols"]} and len(got[n - 3]["count"]) == 0
    assert got[n - 2] is None  # not a bbox+time conjunction
    assert got[n - 4] is None  # the planted rows overflow the boundary lanes
    assert all(g is not None for g in got[:16])
    if group_by:
        firsts = [len(g["groups"]) for g in got if g is not None]
        assert max(firsts) > 1


NULL_SPEC = "cat:Integer,kind:String,w:Double,dtg:Date,*geom:Point"
NULL_ROWS = 20_000


@pytest.fixture(scope="module")
def null_key_stores():
    """A point store whose group keys (Integer and String) and value column
    hold ~20% nulls, in both packages from the same columns: the reference
    on a one-device mesh."""
    lon, lat, t = synth_gdelt(NULL_ROWS, seed=5)
    rng = np.random.default_rng(29)
    cat = rng.integers(0, 12, NULL_ROWS).astype(np.int32)
    kind = np.array([f"k{i}" for i in rng.integers(0, 4, NULL_ROWS)], dtype=object)
    w = rng.normal(0.0, 3.0, NULL_ROWS)
    valid = {c: rng.random(NULL_ROWS) > 0.2 for c in ("cat", "kind", "w")}

    def table(mod, sft):
        return mod.FeatureTable.from_columns(sft, [f"n.{i}" for i in range(NULL_ROWS)], {
            "cat": mod.Column(sft.attr("cat").type, cat.copy(), valid["cat"].copy()),
            "kind": mod.Column(sft.attr("kind").type, kind.copy(), valid["kind"].copy()),
            "w": mod.Column(sft.attr("w").type, w.copy(), valid["w"].copy()),
            "dtg": mod.Column(sft.attr("dtg").type, t.copy()),
            "geom": mod.point_column(lon.copy(), lat.copy())})

    ref = RefDataStore(backend=TpuBackend(mesh=make_mesh(1)))
    sft = ref.create_schema("nk", NULL_SPEC)
    ref.write("nk", table(ref_columnar, sft))
    ref.compact("nk")
    port = DataStore(device="cpu")
    sft = port.create_schema("nk", NULL_SPEC)
    port.write("nk", table(columnar, sft))
    port.compact("nk")
    boxes, windows = make_queries(8, seed=7)
    return port, ref, [bbox_time_cql(b, w) for b, w in zip(boxes, windows)] + ["INCLUDE"]


@pytest.mark.parametrize("group_by", [["cat"], ["kind"], ["cat", "kind"]])
def test_aggregate_many_null_group_keys_equal_reference(null_key_stores, monkeypatch, group_by):
    """Null keys in ``group_by`` (Integer, String, both) and a nullable
    value column: the port's groups, counts and value folds equal the
    reference's exactly (sums within RTOL)."""
    monkeypatch.setenv("GEOMESA_TPU_PYRAMID", "0")
    port, ref, queries = null_key_stores
    got = port.aggregate_many("nk", queries, group_by=group_by, value_cols=["w"])
    want = ref.aggregate_many("nk", queries, group_by=group_by, value_cols=["w"])
    _assert_agg_equal(got, want)
    assert got[-1] is not None and sum(got[-1]["count"]) == NULL_ROWS


def test_host_retest_adds_boundary_rows(agg_stores, agg_data, monkeypatch):
    """The snapped queries' boundary rows that pass the f64 filter are
    added to their groups: the port's answer equals an f64 numpy fold,
    which the device fold alone would miss."""
    monkeypatch.setenv("GEOMESA_TPU_PYRAMID", "0")
    port, _, queries = agg_stores
    snapped = queries[16:16 + TWINS]
    seen = []
    assemble = DataStore._assemble_agg

    def spy(q, main, keys, value_cols, cnt, *rest):
        seen.append((len(rest[5]), int(cnt.sum())))  # boundary rows, device-folded rows
        return assemble(q, main, keys, value_cols, cnt, *rest)

    monkeypatch.setattr(DataStore, "_assemble_agg", staticmethod(spy))
    port.agg_cache.invalidate("agg")  # an earlier test's answers would be cache hits
    got = port.aggregate_many("agg", snapped, group_by=["cat"], value_cols=["val"])
    assert len(seen) == TWINS
    added = [int(g["count"].sum()) - folded for g, (_, folded) in zip(got, seen)]
    assert all(b > 0 for b, _ in seen) and all(a > 0 for a in added)
    assert all(a < b for a, (b, _) in zip(added, seen))  # the twins fail the f64 filter
    lon, lat, t, cat, _, val = agg_data[:6]
    from geomesa_tpu_torch.filter.cql import parse

    for g, c in zip(got, snapped):
        mask = parse(c).mask(port._state("agg").table)
        rows = np.nonzero(mask)[0]
        keys, first = np.unique(cat[rows], return_index=True)
        order = np.argsort(first, kind="stable")
        assert g["groups"] == [(k,) for k in keys[order]]
        assert np.array_equal(g["count"], np.bincount(cat[rows])[keys[order]])
    st = port._state("agg").backend_state["z3"]
    assert ("gid", ("cat",)) in st.agg_cache and ("val", "val") in st.agg_cache


def test_aggregate_many_declines(agg_stores, monkeypatch):
    monkeypatch.setenv("GEOMESA_TPU_PYRAMID", "0")
    port, ref, queries = agg_stores
    qs = queries[:3]
    for group_by, value_cols in ((["w"], ["val"]),      # NaN keys
                                 (["cat"], ["kind"]),   # a string value column
                                 (["nope"], ["val"]),   # a missing column
                                 (["geom"], []),        # a geometry key
                                 (["cat"], ["geom"])):  # a geometry value
        got = port.aggregate_many("agg", qs, group_by=group_by, value_cols=value_cols)
        assert got == [None] * 3, (group_by, value_cols)
        if "geom" not in group_by + value_cols:
            assert ref.aggregate_many("agg", qs, group_by=group_by,
                                      value_cols=value_cols) == [None] * 3
    oracle = DataStore(backend="oracle", device="cpu")
    oracle.create_schema("agg", SPEC)
    assert oracle.aggregate_many("agg", qs, group_by=["cat"]) == [None] * 3


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernel has no CPU mode")
    dev = torch.device("cuda")
    for maker in ("gdelt", "grid", "edge"):
        for n_vals in (0, 1, 2):
            cols, boxes, times, gid, rowid, vals = _inputs(maker, n_vals, seed=3 + n_vals)
            args = ([_t(c).to(dev) for c in cols], _t(gid).to(dev), _t(rowid).to(dev),
                    _t(vals).to(dev))
            for base, true_n in ((0, N), (4096, 4096 + N - 300)):
                call = (*args[0], *args[1:], base, true_n, _t(boxes).to(dev),
                        _t(times).to(dev), G_PAD, CAP)
                before = kernels.launches["grouped_agg"]
                got = grouped_agg(*call)
                want = grouped_agg_plain(*call)
                torch.cuda.synchronize()
                assert kernels.launches["grouped_agg"] == before + 1
                fits = (want[7][:, 0] <= CAP).cpu().numpy()
                _assert_step_equal(got, [w.cpu().numpy() for w in want], fits=fits)


@pytest.mark.cuda
def test_kernel_modes_match_plain_on_card():
    """Both fold modes against the plain version, with the columns'
    extents passed as the store passes them: G x V within the shared budget
    (G = 64; G = 2048 with V = 2, one block an SM) and above it (G = 8192
    and aggregate_many's largest, 65536: the global fold), group ids spread
    over all G, on each column maker."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernel has no CPU mode")
    dev = torch.device("cuda")
    for g, n_vals, mode in ((64, 1, "shared"), (2048, 2, "shared"), (8192, 1, "global"),
                            (65536, 1, "global")):
        for maker in ("gdelt", "grid", "edge"):
            cols, boxes, times, _, rowid, vals = _inputs(maker, n_vals, seed=9)
            gid = np.random.default_rng(g).integers(0, g, N).astype(np.int32)
            tc = [_t(c).to(dev) for c in cols]
            call = (*tc, _t(gid).to(dev), _t(rowid).to(dev), _t(vals).to(dev), 0, N - 300,
                    _t(boxes).to(dev), _t(times).to(dev), g, CAP)
            assert kernels.grouped_agg_mode(boxes.shape[1], times.shape[1], n_vals, g) == mode
            got = grouped_agg(*call, extents=kernels.chunk_extents(*tc))
            want = grouped_agg_plain(*call)
            torch.cuda.synchronize()
            assert kernels.grouped_agg_last_work()["mode"] == mode
            fits = (want[7][:, 0] <= CAP).cpu().numpy()
            _assert_step_equal(got, [w.cpu().numpy() for w in want], fits=fits)
            assert int(want[0].long().sum()) > 0


# -- the fold's work list ----------------------------------------------------------


def _numpy_extents(cols):
    """Per 4096-row chunk: min and max of x, y and the biased time key over
    every row, the last chunk padded with zero rows."""
    n = len(cols[0])
    c = -(-n // 4096)

    def span(a):
        v = np.pad(a.astype(np.int64), (0, c * 4096 - n)).reshape(c, 4096)
        return v.min(axis=1), v.max(axis=1)

    key = cols[2].astype(np.int64) * 2**32 + ((cols[3].astype(np.int64) ^ 0x80000000)
                                              & 0xFFFFFFFF)
    return (*span(cols[0]), *span(cols[1]), *span(key))


def _extent_columns(ext):
    xy = ext[:, :2].contiguous().view(torch.int32).long().numpy()
    return (*(xy[:, i] for i in range(4)), ext[:, 2].numpy(), ext[:, 3].numpy())


@pytest.mark.parametrize("n", [1, 4095, 4096, 40_000])
def test_chunk_extents_equal_numpy(n):
    """``chunk_extents`` equals a numpy min/max over each 4096-row chunk,
    the zero padding of the last chunk included, at steps that split the
    rows; negative offsets and extreme coordinates keep their order."""
    rng = np.random.default_rng(n)
    cols = [rng.integers(-2**31, 2**31, n, dtype=np.int64).astype(np.int32) for _ in range(2)]
    cols += [rng.integers(0, 40, n).astype(np.int32),
             rng.integers(-2**31, 2**31, n, dtype=np.int64).astype(np.int32)]
    want = _numpy_extents(cols)
    for step in (4096, 3 * 4096, 1 << 22):
        ext = kernels.chunk_extents(*(_t(c) for c in cols), step=step)
        assert ext.dtype == torch.int64 and tuple(ext.shape) == (-(-n // 4096), 4)
        for g, w in zip(_extent_columns(ext), want):
            assert np.array_equal(g, w)
    with pytest.raises(ValueError):
        kernels.chunk_extents(*(_t(c) for c in cols), step=1000)


def test_staged_state_caches_extents():
    """``DeviceBackend.load`` keeps each state's extents beside its columns:
    equal to numpy over the padded columns, padding rows included."""
    _, ds, _ = _store_columns(5)
    for name in ("z3", "z2"):
        state = ds._state("g").backend_state[name]
        cols = [c.numpy() for c in state.spatial_cols()]
        assert len(cols[0]) == state.rows_per_shard > state.n  # padded
        for g, w in zip(_extent_columns(state.extents), _numpy_extents(cols)):
            assert np.array_equal(g, w)
        assert state.extents_s >= 0.0


def _assert_work_list(chunks, kept, runs, work, keep, target, min_run=kernels.AGG_MIN_RUN):
    """The work list against ``keep`` (chunks, Q), the cull's pairs."""
    n_chunks, q = keep.shape
    pairs = int(keep.sum())
    run_len = max(min_run, -(-pairs // target))
    assert work.tolist() == [q, 0, int(work[kernels.W_RUNS]), run_len, pairs, 0]
    assert tuple(chunks.shape) == (q, n_chunks) and tuple(runs.shape) == (3, q + target)
    seen = set()
    n_runs = int(work[kernels.W_RUNS])
    rq, rs, re = (runs[i, :n_runs].long().numpy() for i in range(3))
    assert (runs[:, n_runs:] == -1).all()
    assert np.array_equal(rq, np.sort(rq))  # query-major
    for qi in range(q):
        want = np.nonzero(keep[:, qi].numpy())[0]
        assert kept[qi] == len(want)
        assert np.array_equal(chunks[qi, : len(want)].numpy(), want)  # chunk order
        assert (chunks[qi, len(want):] == -1).all()
        mine = np.nonzero(rq == qi)[0]
        spans = [np.arange(rs[r], re[r]) for r in mine]
        got = np.concatenate(spans) if spans else np.empty(0, np.int64)
        assert np.array_equal(got, np.arange(len(want)))  # each kept chunk once, in order
        assert all(0 < re[r] - rs[r] <= run_len for r in mine)
        seen |= {(int(chunks[qi, k]), qi) for k in got}
    # every kept pair of the chunk-major scan appears exactly once
    assert seen == {(int(c), int(qi)) for c, qi in zip(*np.nonzero(keep.numpy()))}
    assert n_runs <= q + target


@pytest.mark.parametrize("shuffled", [False, True], ids=["z3", "shuffled"])
@pytest.mark.parametrize("maker", CULL_MAKERS)
def test_work_list_equals_chunk_query_pairs(maker, shuffled):
    """``agg_work_list`` (its plain version here) lists the pairs of
    ``chunk_query_pairs`` query by query in chunk order and cuts them into
    runs that cover each query's list once, at several run targets; on rows
    in z3 order most pairs are culled, on the same rows shuffled none
    are."""
    cols, boxes, times, base, true_n = _cull_inputs(maker, 5)
    if shuffled:
        perm = np.random.default_rng(3).permutation(len(cols[0]))
        cols = tuple(c[perm] for c in cols)
    tc = [_t(c) for c in cols]
    keep = kernels.chunk_query_pairs(*tc, base, true_n, _t(boxes), _t(times))
    ext = kernels.chunk_extents(*tc)
    for target in (1, 7, 1000):
        out = kernels.agg_work_list(ext, len(cols[0]), base, true_n, _t(boxes), _t(times),
                                    target)
        _assert_work_list(*out, keep, target)
    if maker == "gdelt-z3":
        assert keep.all() if shuffled else (keep.float().mean() < 0.5 and keep.any())


def test_work_list_empty_and_bad_inputs():
    """No query or no kept pair gives no run; bad extents, payloads and
    targets raise."""
    cols, boxes, times, base, true_n = _cull_inputs("gdelt-z3", 6)
    ext = kernels.chunk_extents(*(_t(c) for c in cols))
    n = len(cols[0])
    chunks, kept, runs, work = kernels.agg_work_list(ext, n, 0, 0, _t(boxes), _t(times), 4)
    assert kept.sum() == 0 and work[kernels.W_RUNS] == 0 and (chunks == -1).all()
    out = kernels.agg_work_list(ext, n, 0, n, _t(boxes[:0]), _t(times[:0]), 4)
    assert out[3].tolist() == [0, 0, 0, kernels.AGG_MIN_RUN, 0, 0]
    for bad, exc in ((ext[:-1], ValueError), (ext.int(), TypeError)):
        with pytest.raises(exc):
            kernels.agg_work_list(bad, n, 0, n, _t(boxes), _t(times), 4)
    with pytest.raises(ValueError):
        kernels.agg_work_list(ext, n, 0, n, _t(boxes), _t(times), 0)
    with pytest.raises(ValueError):
        kernels.agg_work_list(ext, n, 0, n, _t(boxes).long(), _t(times), 4)
    with pytest.raises(ValueError):
        grouped_agg(*(_t(c) for c in cols), _t(np.zeros(n, np.int32)),
                    _t(np.zeros(n, np.int32)), _t(np.zeros((1, n))), 0, n, _t(boxes),
                    _t(times), 4, extents=ext[:-1])


_CULL_CACHE: dict = {}


def _cached_cull_inputs(maker, seed, shuffled):
    """:func:`_cull_inputs` once per (maker, seed, order): a CPU store write
    each."""
    key = (maker, seed, shuffled)
    if key not in _CULL_CACHE:
        cols, boxes, times, base, true_n = _cull_inputs(maker, seed)
        if shuffled:
            perm = np.random.default_rng(3).permutation(len(cols[0]))
            cols = tuple(c[perm] for c in cols)
        _CULL_CACHE[key] = cols, boxes, times, base, true_n
    return _CULL_CACHE[key]


@pytest.mark.parametrize("segments", [1, 2, 7, 64])
@pytest.mark.parametrize("shuffled", [False, True], ids=["z3", "shuffled"])
@pytest.mark.parametrize("maker", CULL_MAKERS)
def test_work_list_segments_equal_plain(maker, shuffled, segments):
    """The model of the card's work list, each query's chunks cut into
    ``segments`` blocks placed by the counts of the earlier ones (empty
    segments past the last chunk included), gives the plain version's
    lists, counts, runs and work ints exactly, at several run targets."""
    cols, boxes, times, base, true_n = _cached_cull_inputs(maker, 5, shuffled)
    ext = kernels.chunk_extents(*(_t(c) for c in cols))
    for target in (1, 7, 1000):
        args = (ext, len(cols[0]), base, true_n, _t(boxes), _t(times), target)
        got = kernels.agg_work_list_segments(*args, segments=segments)
        want = kernels.agg_work_list_plain(*args)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


def _made_extents(n_chunks: int, q: int, seed: int):
    """Made-up per-chunk extents (``chunk_extents``' layout: xlo, xhi, ylo,
    yhi as int32 pairs, then the time key's min and max) and a payload of
    ``q`` queries with dead slots and one query with none live: (extents,
    boxes, times) as numpy arrays."""
    rng = np.random.default_rng(seed)
    lo = rng.integers(0, 2**31 - 2**26, (n_chunks, 2))
    span = rng.integers(0, 2**24, (n_chunks, 2))
    xy = np.stack([lo[:, 0], lo[:, 0] + span[:, 0], lo[:, 1], lo[:, 1] + span[:, 1]],
                  axis=1).astype(np.int32)
    kmin = rng.integers(0, 40, n_chunks) * 2**32 + rng.integers(0, 2**31, n_chunks)
    keys = np.stack([kmin, kmin + rng.integers(0, 2**33, n_chunks)], axis=1)
    ext = np.concatenate([xy.view(np.int64), keys], axis=1)
    blo = rng.integers(0, 2**31 - 2**28, (q, 3, 2))
    boxes = np.concatenate([blo, blo + rng.integers(0, 2**28, (q, 3, 2))], axis=2)
    boxes = boxes[..., [0, 2, 1, 3]].astype(np.int32)  # xlo, xhi, ylo, yhi
    boxes[:, 2] = [1, 0, 1, 0]  # a dead slot
    bins = np.sort(rng.integers(0, 40, (q, 2, 2)), axis=2)
    times = np.stack([bins[..., 0], rng.integers(0, 2**31, (q, 2)), bins[..., 1],
                      rng.integers(0, 2**31, (q, 2))], axis=2).astype(np.int32)
    times[:, 1] = [5, 0, 4, 0]  # a dead window
    boxes[-1] = [1, 0, 1, 0]  # a query with no live box
    return ext, boxes, times


@pytest.mark.parametrize("n_chunks", [1, 1023, 1024, 1025, 5000])
def test_work_list_segments_on_made_extents(n_chunks):
    """Over made-up extents of up to 5000 chunks (the card's blocks of
    ``AGG_LIST_CHUNKS``, a query's last one short or one chunk long), the
    model at the card's split and at 64 segments equals the plain version,
    with the last three chunks past ``true_n``."""
    ext, boxes, times = _made_extents(n_chunks, 9, n_chunks)
    n = n_chunks * kernels.JOIN_BLOCK - 7
    true_n = n - 3 * kernels.JOIN_BLOCK if n_chunks > 3 else n
    for target in (1, 50):
        args = (_t(ext), n, 0, true_n, _t(boxes), _t(times), target)
        want = kernels.agg_work_list_plain(*args)
        if n_chunks > 1000:  # most pairs culled, some kept
            assert 0 < int(want[1].sum()) < n_chunks * 8 // 2
        for segments in (None, 64):
            got = kernels.agg_work_list_segments(*args, segments=segments)
            for g, w in zip(got, want):
                assert torch.equal(g, w)


@pytest.mark.cuda
def test_work_list_matches_plain_on_card():
    """The ``agg_work_list`` kernel equals its plain version exactly (lists,
    counts, runs, work ints) on every column maker, sorted and shuffled, at
    several run targets; it counts one launch per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernel has no CPU mode")
    dev = torch.device("cuda")
    for maker in CULL_MAKERS:
        cols, boxes, times, base, true_n = _cull_inputs(maker, 5)
        for shuffled in (False, True):
            if shuffled:
                perm = np.random.default_rng(3).permutation(len(cols[0]))
                cols = tuple(c[perm] for c in cols)
            ext = kernels.chunk_extents(*(_t(c).to(dev) for c in cols))
            for target in (1, 7, 1000):
                args = (ext, len(cols[0]), base, true_n, _t(boxes).to(dev), _t(times).to(dev),
                        target)
                before = kernels.launches["agg_work_list"]
                got = kernels.agg_work_list(*args)
                want = kernels.agg_work_list_plain(*args)
                torch.cuda.synchronize()
                assert kernels.launches["agg_work_list"] == before + 1
                for g, w in zip(got, want):
                    assert torch.equal(g, w)
    # several blocks a query, back to back on one stream (the scratch is left
    # zeroed by each launch)
    for n_chunks in (1, 1023, 1024, 1025, 5000, 40000):
        ext, boxes, times = (_t(a).to(dev) for a in _made_extents(n_chunks, 9, n_chunks))
        n = n_chunks * kernels.JOIN_BLOCK - 7
        for true_n in (n, max(0, n - 3 * kernels.JOIN_BLOCK), 0):
            args = (ext, n, 0, true_n, boxes, times, 50)
            got = [kernels.agg_work_list(*args) for _ in range(3)]
            want = kernels.agg_work_list_plain(*args)
            torch.cuda.synchronize()
            for out in got:
                for g, w in zip(out, want):
                    assert torch.equal(g, w)


def _key_columns(n: int, seed: int):
    rng = np.random.default_rng(seed)
    late = np.zeros(n, dtype=np.int32)
    late[-3:] = [7, 9, 7]  # groups that first appear at the end
    objs = np.array([None if v == 0 else f"s{v}" for v in rng.integers(0, 4, n)], dtype=object)
    return {
        "small": rng.integers(-5, 40, n).astype(np.int32),
        "wide": rng.choice(np.array([-2**40, 3, 2**41, 17], dtype=np.int64), n),  # a sort
        "late": late,
        "flag": rng.random(n) < 0.3,
        "label": np.array([f"k{v}" for v in rng.integers(0, 5, n)], dtype=object),
        "maybe": objs,  # None among strings: the dict factorize
    }


@pytest.mark.parametrize("group_by", [["small"], ["wide"], ["late"], ["flag"], ["label"],
                                      ["maybe"], ["small", "label"], ["late", "flag", "wide"]])
def test_group_ids_equal_reference(group_by):
    """``_agg_group_ids`` gives the reference's group ids and keys, through
    the bincount factorization and the chunked first-row scan as well as
    through ``np.unique`` and the dict factorize."""
    n = 200_003
    cols = _key_columns(n, 8)
    types = {np.dtype(np.int32): "Integer", np.dtype(np.int64): "Long",
             np.dtype(np.bool_): "Boolean", np.dtype(object): "String"}
    spec = ",".join(f"{k}:{types[v.dtype]}" for k, v in cols.items()) + ",*geom:Point"
    got_want = []
    for mod, parse_fn, store in ((columnar, None, DataStore(device="cpu")),
                                 (ref_columnar, ref_parse_spec, RefDataStore(backend="oracle"))):
        sft = store.create_schema("k", spec)
        table = mod.FeatureTable.from_columns(sft, [f"f{i}" for i in range(n)], {
            **{k: mod.Column(sft.attr(k).type, v.copy()) for k, v in cols.items()},
            "geom": mod.point_column(np.zeros(n), np.zeros(n))})
        got_want.append(store._agg_group_ids(table, group_by))
    (gid, keys), (ref_gid, ref_keys) = got_want
    assert gid.dtype == ref_gid.dtype == np.int32 and np.array_equal(gid, ref_gid)
    assert keys == ref_keys and len(keys) > 1
