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
import torch

import geomesa_tpu  # noqa: F401  (x64 on)
from geomesa_tpu.filter.bounds import extract as ref_extract
from geomesa_tpu.filter.cql import parse as ref_parse
from geomesa_tpu.parallel.query import intervals_to_block_pairs as ref_block_pairs
from geomesa_tpu.schema import columnar as ref_columnar
from geomesa_tpu.store.datastore import DataStore as RefDataStore

from geomesa_tpu_torch.ops import kernels
from geomesa_tpu_torch.parallel import query as query_mod
from geomesa_tpu_torch.parallel.query import intervals_to_block_pairs
from geomesa_tpu_torch.parallel.residency import stage_columns
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
        assert g.dtype == np.int32 and np.array_equal(g, w), c  # the device's int32 positions
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
    monkeypatch.setattr(kernels, "PLANNED_CHUNK_ROWS", blocks * query_mod.JOIN_BLOCK)
    chunks = []
    real = kernels.row_masks

    def spy(*args):
        chunks.append(args[0].shape[0])
        return real(*args)

    monkeypatch.setattr(kernels, "row_masks", spy)
    _select_many_positions_equal_reference(stores, index_name)
    assert len(chunks) > 1 and max(chunks) == blocks


_GATHER_STEPS: dict = {}
GATHER_PAIRS = 64  # the reference step's pair budget (a multiple of its chunk)


def _ref_planned_gather(cols, true_n, pair_q, pair_blk, boxes, times):
    """``make_planned_gather_step`` on a one-device mesh (one shard, as the
    port's one card): positions in pair order and the per-pair counts."""
    import jax.numpy as jnp

    from geomesa_tpu.parallel.mesh import make_mesh, shard_columns
    from geomesa_tpu.parallel.query import make_planned_gather_step, pad_block_pairs

    mesh = make_mesh(1)
    capacity = GATHER_PAIRS * query_mod.JOIN_BLOCK
    key = (boxes.shape, times.shape)
    step = _GATHER_STEPS.get(key)
    if step is None:
        step = _GATHER_STEPS[key] = make_planned_gather_step(
            mesh, query_mod.JOIN_BLOCK, GATHER_PAIRS, capacity)
    sharded, _, _ = shard_columns(mesh, dict(zip(("x", "y", "bins", "offs"), cols)),
                                  multiple=query_mod.JOIN_BLOCK)
    pq, pb = pad_block_pairs(pair_q, pair_blk, GATHER_PAIRS)
    buf, hits = step(sharded["x"], sharded["y"], sharded["bins"], sharded["offs"],
                     jnp.int32(true_n), jnp.asarray(pq), jnp.asarray(pb), jnp.asarray(boxes),
                     jnp.asarray(times))
    hits = np.asarray(hits)[: len(pair_q)].astype(np.int64)
    return np.asarray(buf)[0, : hits.sum()].astype(np.int64), hits


@pytest.mark.parametrize("seed", [5, 6])
@pytest.mark.parametrize("maker", ["gdelt-z3", "grid", "edge", "dateless", "tail"])
def test_planned_gather_plain_equals_jax_step(maker, seed):
    """``planned_gather_step`` on the CPU (``planned_gather_plain``) equals
    the JAX ``make_planned_gather_step`` on GDELT-shaped rows in z3 order,
    grid rows, ``edge_payload``'s multi-slot and dead-slot payloads, a
    date-less store and a ``true_n`` tail: random pairs with repeated
    blocks, one block for every query and the last block."""
    from test_torch_kernels import _cull_inputs

    cols, boxes, times, _, true_n = _cull_inputs(maker, seed)
    if maker == "tail":
        true_n -= 3 * 4096  # the same cut, with no base
    staged, padded = stage_columns(
        dict(zip(("x", "y", "bins", "offs"), cols)), torch.device("cpu"))
    n_blocks = padded // query_mod.JOIN_BLOCK
    rng = np.random.default_rng(seed)
    q = boxes.shape[0]
    pair_q = np.concatenate([rng.integers(0, q, 40), np.arange(q), [0, q - 1]])
    pair_blk = np.concatenate([rng.integers(0, n_blocks, 40), np.full(q, n_blocks // 2),
                               [n_blocks - 1] * 2])
    pair_q, pair_blk = pair_q.astype(np.int32), pair_blk.astype(np.int32)
    got_p, got_h = query_mod.planned_gather_step(
        [staged[k] for k in ("x", "y", "bins", "offs")], true_n, pair_q, pair_blk,
        torch.from_numpy(boxes), torch.from_numpy(times))
    want_p, want_h = _ref_planned_gather(cols, true_n, pair_q, pair_blk, boxes, times)
    assert got_p.dtype == torch.int32 and got_h.dtype == torch.int64
    assert np.array_equal(got_h.numpy(), want_h) and np.array_equal(got_p.numpy(), want_p)
    assert want_h.sum() > 0


def test_planned_gather_rejects_bad_arguments():
    """``planned_gather`` raises on anything its kernel does not take:
    columns that are not int32, 1-D, contiguous, of one length or
    block-aligned; pair lists that are not 1-D int32 tensors of one length
    on the columns' device; bad payloads; a device other than cuda or
    cpu. ``planned_gather_step`` raises on pairs out of range."""
    n = 2 * query_mod.JOIN_BLOCK
    cols = [torch.zeros(n, dtype=torch.int32) for _ in range(4)]
    pq = torch.zeros(3, dtype=torch.int32)
    boxes = torch.zeros((2, 1, 4), dtype=torch.int32)
    times = torch.zeros((2, 1, 4), dtype=torch.int32)
    ok = (*cols, n, pq, pq, boxes, times)
    assert [t.shape[0] for t in kernels.planned_gather(*ok)] == [3 * query_mod.JOIN_BLOCK, 3]
    bad = [
        (TypeError, (cols[0].long(), *cols[1:], n, pq, pq, boxes, times)),
        (ValueError, (cols[0][:-1], *cols[1:], n, pq, pq, boxes, times)),
        (ValueError, (*(c[: n - 8] for c in cols), n, pq, pq, boxes, times)),
        (ValueError, (torch.zeros(2 * n, dtype=torch.int32)[::2], *cols[1:], n, pq, pq, boxes,
                      times)),
        (TypeError, (*cols, n, pq.long(), pq, boxes, times)),
        (TypeError, (*cols, n, pq, pq[None], boxes, times)),
        (ValueError, (*cols, n, pq, pq[:2], boxes, times)),
        (ValueError, (*cols, n, torch.zeros(6, dtype=torch.int32)[::2], pq, boxes, times)),
        (ValueError, (*cols, n, pq.to("meta"), pq, boxes, times)),
        (TypeError, (*cols, n, pq, pq, boxes.long(), times)),
        (ValueError, (*cols, n, pq, pq, boxes[:, :, :3].contiguous(), times)),
        (ValueError, (*cols, n, pq, pq, boxes, times[:1])),
        (ValueError, (*(c.to("meta") for c in cols), n, pq.to("meta"), pq.to("meta"),
                      boxes.to("meta"), times.to("meta"))),
    ]
    for exc, args in bad:
        with pytest.raises(exc):
            kernels.planned_gather(*args)
    host = [np.array([0, 1], np.int32), np.array([0, 2], np.int32)]
    with pytest.raises(ValueError, match="blocks"):
        query_mod.planned_gather_step(cols, n, *host, boxes, times)
    with pytest.raises(ValueError, match="queries"):
        query_mod.planned_gather_step(cols, n, np.array([2]), np.array([0]), boxes, times)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_block_runs_cover_every_pair_once(seed):
    """``block_runs`` (the count pass's block-major order, built on the host
    by ``planned_gather_step``) holds every pair exactly once, its runs
    start at each distinct block in ascending order, and a block's pairs
    keep their pair order."""
    rng = np.random.default_rng(seed)
    n_pairs = [0, 1, 500][seed]
    pair_q = rng.integers(0, 64, n_pairs)
    pair_blk = rng.integers(0, 40, n_pairs)
    pair_blk[: n_pairs // 3] = 7  # a block shared by many pairs
    order, order_q, starts, blocks = kernels.block_runs(pair_q, pair_blk)
    assert all(a.dtype == np.int32 for a in (order, order_q, starts, blocks))
    assert np.array_equal(np.sort(order), np.arange(n_pairs))
    assert np.array_equal(order_q, pair_q[order])
    assert np.array_equal(blocks, np.unique(pair_blk))
    assert starts[0] == 0 and starts[-1] == n_pairs and (np.diff(starts) > 0).all()
    for d, blk in enumerate(blocks):
        run = order[starts[d]:starts[d + 1]]
        assert (pair_blk[run] == blk).all() and np.array_equal(run, np.sort(run))


@pytest.mark.cuda
def test_planned_gather_kernel_matches_plain_on_card():
    """The kernel equals ``planned_gather_plain`` exactly (positions and
    per-pair counts) on every column maker, with a whole-world query (every
    row of a block matches: the write pass's shortcut) beside the maker's
    payloads, at random pairs, one block shared by 250 pairs (more than one
    staged tile) and a full block's one pair; an empty pair list launches
    nothing, and the launch counter counts one per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernel has no CPU mode")
    from geomesa_tpu_torch.ops.refine import pack_boxes, pack_times
    from test_torch_kernels import CULL_MAKERS, _cull_inputs

    dev = torch.device("cuda")
    for maker in CULL_MAKERS:
        cols, boxes, times, _, true_n = _cull_inputs(maker, 5)
        boxes = np.ascontiguousarray(np.concatenate([boxes, pack_boxes(None, 8)[None]]))
        times = np.ascontiguousarray(np.concatenate([times, pack_times(None, 16)[None]]))
        staged, padded = stage_columns(
            dict(zip(("x", "y", "bins", "offs"), cols)), dev)
        c = [staged[k] for k in ("x", "y", "bins", "offs")]
        n_blocks = padded // query_mod.JOIN_BLOCK
        rng = np.random.default_rng(2)
        world = boxes.shape[0] - 1
        cases = [(rng.integers(0, boxes.shape[0], k), rng.integers(0, n_blocks, k))
                 for k in (0, 1, 300)]
        # one block shared by more pairs than a staged tile holds, the world
        # query among them; and the world query alone on a full block
        every = torch.arange(n_blocks, dtype=torch.int32)
        _, world_h = kernels.planned_gather_plain(
            *(t.cpu() for t in c), true_n, torch.full_like(every, world), every,
            torch.from_numpy(boxes), torch.from_numpy(times))
        full = np.nonzero(world_h.numpy() == query_mod.JOIN_BLOCK)[0]
        assert len(full) or maker != "gdelt-z3"
        cases += [(rng.integers(0, boxes.shape[0], 250), np.full(250, n_blocks // 2)),
                  (np.array([world]), full[:1])]
        for pq_np, pb_np in cases:
            pq_np = pq_np[: len(pb_np)]  # a maker with no full block: an empty list
            n_pairs = len(pq_np)
            pq = torch.from_numpy(pq_np.astype(np.int32))
            pb = torch.from_numpy(pb_np.astype(np.int32))
            args = (*c, true_n, pq.to(dev), pb.to(dev), torch.from_numpy(boxes).to(dev),
                    torch.from_numpy(times).to(dev))
            before = kernels.launches["planned_gather"]
            got_p, got_h = kernels.planned_gather(*args)
            want_p, want_h = kernels.planned_gather_plain(*args)
            torch.cuda.synchronize()
            assert torch.equal(got_p, want_p) and torch.equal(got_h, want_h)
            assert kernels.launches["planned_gather"] - before == (1 if n_pairs else 0)
            if n_pairs == 1 and pq_np[0] == world:
                assert int(want_h[0]) == query_mod.JOIN_BLOCK  # the write pass's shortcut


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
