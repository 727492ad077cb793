"""Bench config 7's resident count steps: the port against geomesa_tpu on
the same seeded inputs, on the CPU (the port's plain versions).

- ``repeated_count_step`` against ``make_repeated_count_step(make_mesh(1),
  impl="jnp")``: N = 20,003 GDELT-shaped rows in (bin, z3) order, R = 1 and
  3 batches of Q = 8, (B, T) = (1, 1) and (8, 16) with the packers'
  sentinel slots;
- ``planned_count_step`` against ``make_planned_count_step(make_mesh(1), q,
  block_rows, n_pairs, chunk=8)``: block_rows 64 and 1024, R = 2 batches
  with different pair counts padded with query -1, a query with no pairs
  and one with pairs but no match, ``true_n`` inside the last block, and
  the overlap form on bbox columns against ``overlap=True``; the pruned
  counts equal the full scan's;
- ``pad_block_pairs`` against the reference's, its overflow ``ValueError``
  included;
- ``resident_store``'s keys and order against the reference's host build,
  and ``bin_spans`` / ``plan_query_intervals`` against ``bench.py``'s
  ``_bin_spans`` / ``_plan_query_intervals`` on a seeded 200,000-row store.

Tolerance: none. Counts, keys, spans and intervals compare exactly.
"""

import importlib.util

import numpy as np
import pytest
import torch

import geomesa_tpu  # noqa: F401  (x64 on)
import jax.numpy as jnp
from geomesa_tpu.curve.binned_time import BinnedTime as RefBinnedTime
from geomesa_tpu.curve.sfc import z3_sfc as ref_z3_sfc
from geomesa_tpu.parallel.mesh import make_mesh, shard_columns
from geomesa_tpu.parallel.query import (
    make_planned_count_step, make_repeated_count_step, pad_block_pairs as ref_pad_block_pairs)

from geomesa_tpu_torch.ops.kernels import planned_count, planned_count_plain
from geomesa_tpu_torch.ops.refine import pack_boxes, pack_times
from geomesa_tpu_torch.parallel.query import (
    intervals_to_block_pairs, pad_block_pairs, planned_count_step, repeated_count_step)
from geomesa_tpu_torch.store.backends import int_boxes
from geomesa_tpu_torch.workload import (
    RESIDENT_PERIOD, T0, bin_spans, make_queries, pack_query_boxes, pack_query_times,
    plan_query_intervals, resident_store, synth_gdelt, xz_boxes)

N = 20_003
Q = 8
COLS = ("x", "y", "bins", "offs")


def _bench():
    spec = importlib.util.spec_from_file_location("bench_resident_mod", "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def store():
    lon, lat, t = synth_gdelt(N, seed=42)
    return resident_store(lon, lat, t, "cpu"), (lon, lat, t)


def _host_cols(st):
    return tuple(c.numpy() for c in st["cols"])


def _payloads(r: int, nb: int, nt: int, seed: int):
    """(R, Q, nb, 4) boxes and (R, Q, nt, 4) times: each batch's city
    queries, with nb > 1 one to three live boxes a query (a second and third
    box shifted from the first) and nt > 1 one or two windows, the rest
    the packers' sentinel slots."""
    rng = np.random.default_rng(seed)
    binned = RefBinnedTime(RESIDENT_PERIOD)
    boxes_r, times_r = [], []
    for b in range(r):
        bf, wm = make_queries(Q, seed=seed + b)
        bq, tq = [], []
        for (x1, y1, x2, y2), (lo, hi) in zip(bf, wm):
            k = int(rng.integers(1, 4)) if nb > 1 else 1
            boxes = [(x1 + 3 * j, y1, x2 + 3 * j, y2) for j in range(k)]
            bq.append(pack_boxes(int_boxes(boxes), slots=nb))
            ws = [(lo, hi)] + ([(hi + 86_400_000, hi + 2 * 86_400_000)]
                               if nt > 1 and rng.random() < 0.5 else [])
            quads = []
            for a, e in ws:
                (blo,), (olo,) = binned.to_bin_and_offset(np.array([a]))
                (bhi,), (ohi,) = binned.to_bin_and_offset(np.array([e]))
                quads.append([blo, olo, bhi, ohi])
            tq.append(pack_times(np.array(quads, dtype=np.int32), slots=nt))
        boxes_r.append(np.stack(bq))
        times_r.append(np.stack(tq))
    return (np.ascontiguousarray(np.stack(boxes_r)), np.ascontiguousarray(np.stack(times_r)))


def _ref_cols(cols, block_rows):
    mesh = make_mesh(1)
    sharded, _, _ = shard_columns(mesh, dict(zip(COLS, cols)), multiple=block_rows)
    return mesh, [sharded[k] for k in COLS]


@pytest.mark.parametrize("r", [1, 3])
@pytest.mark.parametrize("nb,nt", [(1, 1), (8, 16)])
def test_repeated_count_step_equals_jax(store, r, nb, nt):
    """(R, Q) counts, exact, against the reference's ``lax.scan`` of R
    full passes."""
    st, _ = store
    cols = _host_cols(st)
    boxes_r, times_r = _payloads(r, nb, nt, seed=100 + nb)
    got = repeated_count_step(st["cols"], st["true_n"], torch.from_numpy(boxes_r),
                              torch.from_numpy(times_r))
    mesh, rc = _ref_cols(cols, 1024)
    want = make_repeated_count_step(mesh, impl="jnp")(
        *rc, jnp.int32(st["true_n"]), jnp.asarray(boxes_r), jnp.asarray(times_r))
    assert got.shape == (r, Q) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.sum() > 0


def _planned_pairs(st, boxes_f64, windows, block_rows):
    spans = bin_spans(st["bins_sorted"])
    ivs = plan_query_intervals(boxes_f64, windows, st["binned"], st["sfc"], st["z_sorted"],
                               spans)
    return intervals_to_block_pairs(ivs, block_rows)


def _batches(st, block_rows):
    """R = 2 batches of Q city queries, planned: batch 0's query 3 has a
    window past the data (no pairs), query 5 a box in the Pacific (pairs,
    no match) and query 7 the whole world over the whole span (every block,
    the last with ``true_n`` inside it)."""
    batches = []
    for b in range(2):
        bf, wm = make_queries(Q, seed=300 + b)
        bf, wm = list(bf), list(wm)
        if b == 0:
            wm[3] = (T0 + 90 * 86_400_000, T0 + 92 * 86_400_000)
            bf[5] = (-150.0, -40.0, -149.9, -39.9)
            bf[7] = (-180.0, -90.0, 180.0, 90.0)
            wm[7] = (T0 - 86_400_000, T0 + 40 * 86_400_000)
        pq, pb = _planned_pairs(st, bf, wm, block_rows)
        batches.append((bf, wm, pq, pb))
    return batches


@pytest.mark.parametrize("block_rows", [64, 1024])
def test_planned_count_step_equals_jax_and_full_scan(store, block_rows):
    """The pruned counts over the planned pairs, padded with -1 to a common
    length, equal the reference's ``make_planned_count_step`` and the full
    scan's, exactly."""
    st, _ = store
    batches = _batches(st, block_rows)
    lens = [len(pq) for _, _, pq, _ in batches]
    assert lens[0] != lens[1]
    assert 3 not in batches[0][2]  # the window past the data plans no pair
    last = (st["true_n"] - 1) // block_rows  # the last block of rows, true_n inside it
    assert last in batches[0][3][batches[0][2] == 7] and st["true_n"] % block_rows
    n_pairs = -(-max(lens) // 8) * 8 + 8
    padded = [pad_block_pairs(pq, pb, n_pairs) for _, _, pq, pb in batches]
    pq_r = np.stack([p[0] for p in padded])
    pb_r = np.stack([p[1] for p in padded])
    assert (pq_r == -1).any(axis=1).all()
    boxes_r = np.ascontiguousarray(np.stack([pack_query_boxes(bf) for bf, _, _, _ in batches]))
    times_r = np.ascontiguousarray(np.stack([pack_query_times(wm) for _, wm, _, _ in batches]))
    got = planned_count_step(st["cols"], st["true_n"], pq_r, pb_r, torch.from_numpy(boxes_r),
                             torch.from_numpy(times_r), block_rows)
    mesh, rc = _ref_cols(_host_cols(st), block_rows)
    step = make_planned_count_step(mesh, Q, block_rows, n_pairs, chunk=8)
    want = step(*rc, jnp.int32(st["true_n"]), jnp.asarray(pq_r), jnp.asarray(pb_r),
                jnp.asarray(boxes_r), jnp.asarray(times_r))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    full = repeated_count_step(st["cols"], st["true_n"], torch.from_numpy(boxes_r),
                               torch.from_numpy(times_r))
    np.testing.assert_array_equal(got.numpy(), full.numpy())
    assert got[0, 3] == 0 and got[0, 5] == 0 and got[0, 7] == N
    assert (got > 0).sum() >= Q


def _bbox_columns(m: int, seed: int):
    """Config 5's bboxes as int32 (xmin, ymin, xmax, ymax, bins, offs) host
    columns, with times over the span, padded to whole 1024-row blocks."""
    from geomesa_tpu_torch.curve import normalize

    x0, y0, x1, y1 = xz_boxes(m, seed=seed)
    t = T0 + np.random.default_rng(seed).integers(0, 30 * 86_400_000, m)
    bins, offs = RefBinnedTime(RESIDENT_PERIOD).to_bin_and_offset(t)
    lon, lat = normalize.lon(31), normalize.lat(31)
    cols = [lon.normalize(x0), lat.normalize(y0), lon.normalize(x1), lat.normalize(y1), bins, offs]
    padded = -(-m // 1024) * 1024
    return tuple(np.concatenate([c.astype(np.int32), np.zeros(padded - m, np.int32)])
                 for c in cols)


@pytest.mark.parametrize("block_rows", [64, 1024])
def test_planned_count_overlap_equals_jax(block_rows):
    """The overlap form on bbox columns against ``overlap=True``: random
    pairs over every block (repeated blocks and queries, the last block
    with ``true_n`` inside it), padded with -1."""
    m = 10_007
    cols = _bbox_columns(m, seed=9)
    rng = np.random.default_rng(4)
    bf, wm = make_queries(Q, seed=17)
    boxes = np.ascontiguousarray(np.stack([pack_query_boxes(bf, overlap=True)] * 2))
    times = np.ascontiguousarray(np.stack([pack_query_times(wm)] * 2))
    n_blocks = len(cols[0]) // block_rows
    lists = []
    for k in (40, 23):
        pq = rng.integers(0, Q, k).astype(np.int32)
        pb = rng.integers(0, n_blocks, k).astype(np.int32)
        pb[0] = n_blocks - 1
        lists.append(pad_block_pairs(pq, pb, 48))
    pq_r, pb_r = (np.stack([p[i] for p in lists]) for i in (0, 1))
    got = planned_count_step(tuple(torch.from_numpy(c) for c in cols), m, pq_r, pb_r,
                             torch.from_numpy(boxes), torch.from_numpy(times), block_rows)
    mesh = make_mesh(1)
    names = ("xmin", "ymin", "xmax", "ymax", "bins", "offs")
    sharded, _, _ = shard_columns(mesh, dict(zip(names, cols)), multiple=block_rows)
    step = make_planned_count_step(mesh, Q, block_rows, 48, chunk=8, overlap=True)
    want = step(*(sharded[k] for k in names), jnp.int32(m), jnp.asarray(pq_r),
                jnp.asarray(pb_r), jnp.asarray(boxes), jnp.asarray(times))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.sum() > 0


def test_planned_count_checks_its_arguments(store):
    st, _ = store
    cols = st["cols"]
    boxes = torch.from_numpy(pack_query_boxes(make_queries(2, seed=1)[0]))
    times = torch.from_numpy(pack_query_times(make_queries(2, seed=1)[1]))
    pq = torch.tensor([0, -1], dtype=torch.int32)
    pb = torch.tensor([0, 0], dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple of block_rows"):
        planned_count(cols, st["true_n"], pq, pb, boxes, times, 1000)
    with pytest.raises(ValueError, match="multiple of block_rows"):
        planned_count_step(tuple(c[:-1] for c in cols), st["true_n"], pq[None].numpy(),
                           pb[None].numpy(), boxes[None], times[None], 1024)
    with pytest.raises(TypeError):
        planned_count(cols, st["true_n"], pq.long(), pb, boxes, times, 1024)
    with pytest.raises(ValueError, match="pair queries"):
        planned_count_step(cols, st["true_n"], np.array([[5]]), np.array([[0]]), boxes[None],
                           times[None], 1024)
    empty = torch.empty(0, dtype=torch.int32)
    assert planned_count(cols, st["true_n"], empty, empty, boxes, times, 1024).tolist() == [0, 0]
    assert torch.equal(planned_count(cols, st["true_n"], pq, pb, boxes, times, 1024),
                       planned_count_plain(cols, st["true_n"], pq, pb, boxes, times, 1024))


@pytest.mark.parametrize("budget", [0, 5, 7, 64])
def test_pad_block_pairs_equals_reference(budget):
    pq = np.arange(7, dtype=np.int32) % 3
    pb = np.arange(7, dtype=np.int32) * 5
    if budget < 7:
        with pytest.raises(ValueError, match="exceed budget"):
            pad_block_pairs(pq, pb, budget)
        with pytest.raises(ValueError, match="exceed budget"):
            ref_pad_block_pairs(pq, pb, budget)
        return
    got, want = pad_block_pairs(pq, pb, budget), ref_pad_block_pairs(pq, pb, budget)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_resident_store_keys_equal_reference(store):
    """The keys built by ``z3_encode`` and the device sort equal the
    reference's host encode and a stable lexsort by (bin, z), and the
    columns follow that order, zero-padded to whole blocks."""
    st, (lon, lat, t) = store
    binned = RefBinnedTime(RESIDENT_PERIOD)
    bins, offs = binned.to_bin_and_offset(t)
    z = ref_z3_sfc(RESIDENT_PERIOD).index(lon, lat, offs)
    perm = np.lexsort((z, bins))
    np.testing.assert_array_equal(st["z_sorted"], z[perm].astype(np.uint64))
    np.testing.assert_array_equal(st["bins_sorted"], bins[perm])
    cols = _host_cols(st)
    assert len(cols[0]) == 20_480 and st["true_n"] == N
    np.testing.assert_array_equal(cols[3][:N], offs[perm])
    assert all((c[N:] == 0).all() for c in cols)


def test_planning_equals_bench():
    """``bin_spans`` and ``plan_query_intervals`` equal ``bench.py``'s on
    a seeded 200,000-row store: the same spans and, query by query, the same
    row intervals."""
    bench = _bench()
    n = 200_000
    lon, lat, t = synth_gdelt(n, seed=42)
    st = resident_store(lon, lat, t, "cpu")
    binned = RefBinnedTime(RESIDENT_PERIOD)
    sfc = ref_z3_sfc(RESIDENT_PERIOD)
    bins, offs = binned.to_bin_and_offset(t)
    z = sfc.index(lon, lat, offs)
    perm = np.lexsort((z, bins))
    ref_spans = bench._bin_spans(bins[perm].astype(np.int32))
    spans = bin_spans(st["bins_sorted"])
    assert spans == ref_spans
    bf, wm = make_queries(16, seed=100)
    got = plan_query_intervals(bf, wm, st["binned"], st["sfc"], st["z_sorted"], spans)
    want = bench._plan_query_intervals(bf, wm, binned, sfc, z[perm], ref_spans)
    assert len(got) == len(want) == 16
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert sum(len(g) for g in got) > 16


def test_intervals_to_block_pairs_equals_reference():
    """The port's vectorized block expansion equals the reference's loop on
    intervals that are empty, inverted, overlapping, one row long and
    spanning many blocks, and on a query with none."""
    from geomesa_tpu.parallel.query import intervals_to_block_pairs as ref_pairs

    rng = np.random.default_rng(8)
    ivs = []
    for q in range(12):
        k = int(rng.integers(0, 40))
        a = rng.integers(0, 200_000, k)
        b = a + rng.integers(-5, 9000, k)
        iv = np.stack([a, b], axis=1)
        if q == 3:
            iv = np.empty((0, 2), np.int64)
        if q == 4:
            iv = np.array([[7, 7], [9, 3]])  # empty and inverted only
        if q == 5:
            iv = np.array([[0, 1], [1023, 1025], [5000, 200_000], [6000, 7000]])
        ivs.append(iv)
    for block_rows in (1, 64, 1024, 4096):
        got = intervals_to_block_pairs(ivs, block_rows)
        want = ref_pairs(ivs, block_rows)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype == np.int32
            np.testing.assert_array_equal(g, w)
