"""The model of the card's ``batched_knn`` tile skip (``knn_tile_extents_plain``,
``knn_tile_bound_plain``, ``knn_tile_keep_plain``) against the rows it
stands for, and the restated floor of ``chip_smoke.knn_work`` against a
brute-force count. No jax.

Row sets:
- ``z3``: GDELT-shaped points through a CPU ``DataStore`` (its z3 order,
  bench config 3's generator), with a ``true_n`` that cuts a tile;
- ``cells``: ``workload.grid_columns`` rows ordered by small cells
  (``chip_smoke.knn_cell_rows``), full of ties at the k-th distance across
  tile edges, under points placed on rows;
- ``rounding``: coordinates on and around the f32 rounding boundaries of
  the decode (ints past 2^24 that ``int -> f32`` rounds, half-way cases),
  under queries on the tiles' decoded extents and one ulp off them.

Each set also meets bench config 3's points, a NaN query and a query far
outside every row. Tolerance: none — every bound and count compares
exactly, in f32 as the kernel computes it.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from geomesa_tpu_torch.ops.kernels import (
    KNN_CHUNK_ROWS, KNN_MIN_STRIDE, KNN_SAMPLE_ROWS, KNN_TILE_ROWS, batched_knn_plain,
    knn_degrees, knn_sample_rows, knn_tile_bound_plain, knn_tile_extents_plain,
    knn_tile_keep_plain)
from geomesa_tpu_torch.schema.columnar import Column, FeatureTable, point_column
from geomesa_tpu_torch.schema.sft import AttributeType
from geomesa_tpu_torch.store.datastore import DataStore
from geomesa_tpu_torch.workload import SPEC, knn_points, synth_gdelt

N = 9_000  # rows of a set: 36 tiles, the last cut
F32 = np.float32
ROW_SETS = ("z3", "cells", "rounding")


def _z3_rows(n: int, seed: int):
    lon, lat, t = synth_gdelt(n, seed=seed)
    ds = DataStore(device="cpu")
    sft = ds.create_schema("g", SPEC)
    ds.write("g", FeatureTable.from_columns(sft, np.arange(n).astype("U9"), {
        "dtg": Column(AttributeType.DATE, t), "geom": point_column(lon, lat)}))
    ds.compact("g")
    state = ds._state("g").backend_state["z3"]
    return tuple(c[:n].numpy().copy() for c in state.spatial_cols()[:2])


def _rounding_rows(n: int, seed: int):
    """Ints on and next to the points where ``f32(v)`` rounds (half-way
    cases between f32 neighbours past 2^24) and the ends of the range; x
    sorted and half of y sorted, so that tiles hold neighbouring values."""
    vals = [0, 1, 2**31 - 1, 2**31 - 2, 2**30]
    for e in range(24, 31):
        ulp = 2 ** (e - 23)
        for m in (0, 1, 5, 2**22, 2**23 - 1):
            mid = 2**e + m * ulp + ulp // 2
            vals += [mid - 1, mid, mid + 1, 2**e + m * ulp]
    vals = np.unique(np.array(vals, np.int64))
    rng = np.random.default_rng(seed)
    x = np.sort(rng.choice(vals, n))
    y = rng.choice(vals, n)
    y[: n // 2] = np.sort(y[: n // 2])
    return x.astype(np.int32), y.astype(np.int32)


def _rows(kind: str):
    if kind == "z3":
        x, y = _z3_rows(N, 7)
        return x, y, N - 77  # true_n cuts the last tile
    if kind == "cells":
        x, y = chip_smoke.knn_cell_rows(N, 11, values=40)
        return x, y, N
    x, y = _rounding_rows(N, 5)
    return x, y, N - 300


def _queries(kind: str, x, y, true_n: int):
    """(qx, qy) f32: config 3's points, points on rows, a NaN and a far
    query; for the rounding rows also the tiles' decoded extents and one
    ulp either side of them."""
    pts = knn_points(12).astype(F32)
    xf, yf = (v.numpy() for v in knn_degrees(torch.from_numpy(x), torch.from_numpy(y)))
    on = np.random.default_rng(3).integers(0, true_n, 8)
    qx = np.concatenate([pts[:, 0], xf[on], [np.nan, 400.0]]).astype(F32)
    qy = np.concatenate([pts[:, 1], yf[on], [10.0, -300.0]]).astype(F32)
    if kind == "rounding":
        ext = knn_tile_extents_plain(torch.from_numpy(x), torch.from_numpy(y), 0, true_n).numpy()
        ext = ext[ext[:, 0] <= ext[:, 1]][:6]
        ex = np.concatenate([ext[:, 0], ext[:, 1], np.nextafter(ext[:, 0], F32(-np.inf)),
                             np.nextafter(ext[:, 1], F32(np.inf))])
        ey = np.concatenate([ext[:, 2], ext[:, 3], np.nextafter(ext[:, 3], F32(np.inf)),
                             np.nextafter(ext[:, 2], F32(-np.inf))])
        qx, qy = np.concatenate([qx, ex]).astype(F32), np.concatenate([qy, ey]).astype(F32)
    return qx, qy


def _d2(x, y, qx, qy):
    """(n, Q) f32 d2 of every row, each step rounded alone."""
    xf, yf = (v.numpy() for v in knn_degrees(torch.from_numpy(x), torch.from_numpy(y)))
    dx = xf[:, None] - qx[None, :]
    dy = yf[:, None] - qy[None, :]
    return dx * dx + dy * dy


def _kth_d2(x, y, true_n, qx, qy, k):
    """Each query's final k-th d2 from ``batched_knn_plain``'s answer
    (``chip_smoke.knn_kth_d2``)."""
    args = (torch.from_numpy(x), torch.from_numpy(y))
    q = (torch.from_numpy(qx), torch.from_numpy(qy))
    dist, rows = batched_knn_plain(*args, 0, true_n, *q, k)
    return dist, rows, chip_smoke.knn_kth_d2(*args, *q, dist, rows)


@pytest.mark.parametrize("kind", ROW_SETS)
def test_bound_is_at_most_every_row_d2(kind):
    """``lb`` of a (tile, query) pair is at most the d2 of every valid row
    of the tile, bit for bit in f32; NaN only for the NaN query."""
    x, y, true_n = _rows(kind)
    qx, qy = _queries(kind, x, y, true_n)
    ext = knn_tile_extents_plain(torch.from_numpy(x), torch.from_numpy(y), 0, true_n)
    lb = knn_tile_bound_plain(ext, torch.from_numpy(qx), torch.from_numpy(qy)).numpy()
    assert lb.dtype == np.float32
    d2 = _d2(x, y, qx, qy)
    for t in range(lb.shape[0]):
        rows = d2[t * KNN_TILE_ROWS: min(true_n, (t + 1) * KNN_TILE_ROWS)]
        if not len(rows):
            continue
        ok = np.isnan(qx)
        assert np.array_equal(np.isnan(lb[t]), ok)
        assert (lb[t][~ok][None, :] <= rows[:, ~ok]).all(), t
        # the bound is reached where a query sits on the extent's corner row
        assert (lb[t][~ok] >= 0).all()


@pytest.mark.parametrize("k", [1, 10, 64])
@pytest.mark.parametrize("kind", ROW_SETS)
def test_answer_rows_lie_in_kept_tiles(kind, k):
    """Every row of ``batched_knn_plain``'s answer lies in a tile kept
    against its query's final k-th d2 and against the sample's cap (every
    query's cap is its k-th d2 over the sampled rows, as the card's sample
    pass takes it, at most +inf); each tile kept against the k-th is kept
    against the cap."""
    x, y, true_n = _rows(kind)
    qx, qy = _queries(kind, x, y, true_n)
    dist, rows, kth = _kth_d2(x, y, true_n, qx, qy, k)
    ext = knn_tile_extents_plain(torch.from_numpy(x), torch.from_numpy(y), 0, true_n)
    keep = knn_tile_keep_plain(ext, torch.from_numpy(qx), torch.from_numpy(qy), kth).numpy()
    d2 = _d2(x[:true_n], y[:true_n], qx, qy)
    stride = KNN_MIN_STRIDE  # at these sizes: every 16th valid row
    sampled = d2[::stride]
    cap = np.full(len(qx), np.inf, F32)
    for qi in range(len(qx)):
        v = np.sort(sampled[:, qi][~np.isnan(sampled[:, qi])])
        if len(v) >= k:
            cap[qi] = v[k - 1]
    keep_cap = knn_tile_keep_plain(ext, torch.from_numpy(qx), torch.from_numpy(qy),
                                   torch.from_numpy(cap)).numpy()
    fin = np.isfinite(dist.numpy())
    for qi in range(len(qx)):
        tiles = rows.numpy()[qi][fin[qi]] // KNN_TILE_ROWS
        assert keep[tiles, qi].all(), qi
        assert keep_cap[tiles, qi].all(), qi
    assert (keep <= keep_cap).all()
    if kind == "cells" and k > 1:  # the case holds ties at the k-th distance
        d = dist.numpy()
        assert ((d[:, -1] == d[:, -2]) & fin[:, -1]).any()


def test_queries_no_row_can_skip():
    """A NaN query keeps every tile with a valid row (its lb is NaN); a
    query far from every row keeps only the tiles its answer needs; k above
    the eligible rows keeps every tile with a valid row (the k-th is
    +inf); a tile past true_n is empty and never kept."""
    x, y, _ = _rows("z3")
    true_n = 300  # two tiles: one whole, one cut; the other 34 empty
    qx = np.array([np.nan, 400.0, 10.0], F32)
    qy = np.array([0.0, -300.0, 20.0], F32)
    dist, rows, kth = _kth_d2(x, y, true_n, qx, qy, 10)
    ext = knn_tile_extents_plain(torch.from_numpy(x), torch.from_numpy(y), 0, true_n)
    assert (ext[2:, 0] > ext[2:, 1]).all()  # empty extents past true_n
    keep = knn_tile_keep_plain(ext, torch.from_numpy(qx), torch.from_numpy(qy), kth).numpy()
    assert keep[:2, 0].all() and not keep[2:].any()
    assert torch.isinf(kth[0]) and torch.isfinite(kth[1:]).all()
    _, _, kth_all = _kth_d2(x, y, true_n, qx, qy, 400)  # k above the 300 eligible rows
    assert torch.isinf(kth_all).all()
    keep_all = knn_tile_keep_plain(ext, torch.from_numpy(qx), torch.from_numpy(qy),
                                   kth_all).numpy()
    assert keep_all[:2].all() and not keep_all[2:].any()
    never = knn_tile_keep_plain(ext, torch.from_numpy(qx), torch.from_numpy(qy),
                                torch.full((3,), float("inf"))).numpy()
    assert not never[2:].any()


def _brute_work(x, y, true_n, qx, qy, kth):
    """``chip_smoke.knn_work``'s counts by loops over tiles and queries in
    numpy f32."""
    limit = min(len(x), true_n)
    xf, yf = (v.numpy() for v in knn_degrees(torch.from_numpy(x), torch.from_numpy(y)))
    tile_pairs = kept_pairs = kept_rows = 0
    for t in range(-(-len(x) // KNN_TILE_ROWS)):
        lo, hi = t * KNN_TILE_ROWS, min(limit, (t + 1) * KNN_TILE_ROWS)
        if hi <= lo:
            continue
        tile_pairs += len(qx)
        xlo, xhi, ylo, yhi = xf[lo:hi].min(), xf[lo:hi].max(), yf[lo:hi].min(), yf[lo:hi].max()
        for qi in range(len(qx)):
            with np.errstate(invalid="ignore"):
                dx = np.maximum(F32(xlo - qx[qi]), F32(qx[qi] - xhi))
                dy = np.maximum(F32(ylo - qy[qi]), F32(qy[qi] - yhi))
                dx, dy = (F32(0) if v < 0 else v for v in (dx, dy))
                lb = F32(F32(dx * dx) + F32(dy * dy))
                if not lb > kth[qi]:
                    kept_pairs += 1
                    kept_rows += hi - lo
    stride, sampled = knn_sample_rows(len(x), 0, true_n)
    return {"tile_pairs": tile_pairs, "kept_pairs": kept_pairs, "kept_rows": kept_rows,
            "sample_pairs": sampled * len(qx)}


@pytest.mark.parametrize("kind,n", [("z3", N), ("cells", 40_000)])
def test_floor_count_equals_brute_force(kind, n):
    """The restated floor's counts (tile tests, kept pairs and their rows
    against the answer's k-th d2, sample pairs) equal a brute-force count;
    at 40,000 rows the sample pass runs."""
    x, y = _z3_rows(n, 9) if kind == "z3" else chip_smoke.knn_cell_rows(n, 13, values=300)
    true_n = n - 1000
    pts = knn_points(6).astype(F32)
    qx = np.concatenate([pts[:, 0], [np.nan]]).astype(F32)
    qy = np.concatenate([pts[:, 1], [0.0]]).astype(F32)
    _, _, kth = _kth_d2(x, y, true_n, qx, qy, 10)
    args = (torch.from_numpy(x), torch.from_numpy(y), true_n, torch.from_numpy(qx),
            torch.from_numpy(qy), kth)
    got = chip_smoke.knn_work(*args)
    want = _brute_work(x, y, true_n, qx, qy, kth.numpy())
    assert got == want
    assert (want["sample_pairs"] > 0) == (n >= 16 * KNN_CHUNK_ROWS + 1000)
    ops, nbytes = chip_smoke.knn_floor(true_n, len(qx), 10, got)
    assert nbytes == 8 * true_n + 8 * len(qx) + 80 * len(qx)
    assert ops[1] >= chip_smoke.KNN_PAIR_OPS[1] * (want["kept_rows"] + want["sample_pairs"])


def test_sample_rows_follow_the_kernel_rule():
    """``knn_sample_rows``: every stride-th valid row, stride at least 16
    and about ``limit / 2^18``; no sample pass below 16 x 2048 valid rows."""
    assert knn_sample_rows(16 * KNN_CHUNK_ROWS - 1, 0, 10**9) == (0, 0)
    assert knn_sample_rows(16 * KNN_CHUNK_ROWS, 0, 10**9) == (16, KNN_CHUNK_ROWS)
    assert knn_sample_rows(40_000, 0, 40_000 - 777) == (16, -(-(40_000 - 777) // 16))
    assert knn_sample_rows(10**8, 0, 10**8) == (10**8 // KNN_SAMPLE_ROWS,
                                               -(-10**8 // (10**8 // KNN_SAMPLE_ROWS)))
    assert knn_sample_rows(10**6, 4096, 4096 + 50_000) == (16, 3125)
