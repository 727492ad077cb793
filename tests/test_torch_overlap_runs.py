"""The overlap form's work list on the CPU: its window runs, the model of
the card's work list that makes them, the point form's runs left as they
were, and the model of the overlap fold's walk over them. No jax.

- ``agg_work_list(..., overlap=True)`` (its plain version here): each kept
  (chunk, query) pair of the cull lies in exactly one run; a run holds one
  query's kept chunks of one aligned window of ``AGG_WINDOW`` chunks, in
  list order; the runs come in (window, query) order, as the card's last
  work-list block writes them, with -1 after them; the work ints;
- ``agg_work_list_segments(..., overlap=True)``, the block-by-block model
  of the card's work list, equals it at the card's split and at others;
- the point form's runs are what they were: query-major, ``run_len =
  max(min_run, ceil(pairs / target_runs))`` chunks each but a query's last,
  checked against a cutting written here;
- ``overlap_fold_walk``: the fold's blocks take the runs ``k`` at a time
  and walk the union of their chunks in order; every kept pair is folded
  exactly once, each chunk read once an item;
- on config-5 bboxes (``chunk_extents_bbox`` of xz-ordered rows) the
  window runs cover every kept pair;
- on a card (``cuda`` marker): the ``agg_work_list`` kernel's window runs
  equal the plain version's, with its look-back over several segments.

Everything compares exactly.
"""

import numpy as np
import pytest
import torch

from geomesa_tpu_torch.curve.normalize import lat as norm_lat, lon as norm_lon
from geomesa_tpu_torch.ops import kernels
from geomesa_tpu_torch.ops.refine import pack_boxes, pack_times
from geomesa_tpu_torch.workload import xz_boxes

W = kernels.AGG_WINDOW


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _made_extents(n_chunks: int, q: int, seed: int):
    """Made-up per-chunk extents (``chunk_extents``' layout) whose time keys
    rise with the chunk, as a store's do, and ``q`` queries of a few live
    boxes and windows each (a dead slot each, the last query with no live
    box): (extents, boxes, times) as numpy arrays."""
    rng = np.random.default_rng(seed)
    lo = rng.integers(0, 2**31 - 2**27, (n_chunks, 2))
    span = rng.integers(0, 2**26, (n_chunks, 2))
    xy = np.stack([lo[:, 0], lo[:, 0] + span[:, 0], lo[:, 1], lo[:, 1] + span[:, 1]],
                  axis=1).astype(np.int32)
    kmin = np.sort(rng.integers(0, 40, n_chunks)) * 2**32 + rng.integers(0, 2**31, n_chunks)
    keys = np.stack([kmin, kmin + rng.integers(0, 2**33, n_chunks)], axis=1)
    ext = np.concatenate([xy.view(np.int64), keys], axis=1)
    blo = rng.integers(0, 2**31 - 2**30, (q, 3, 2))
    boxes = np.concatenate([blo, blo + rng.integers(2**28, 2**30, (q, 3, 2))], axis=2)
    boxes = boxes[..., [0, 2, 1, 3]].astype(np.int32)  # xlo, xhi, ylo, yhi
    boxes[:, 2] = [1, 0, 1, 0]  # a dead slot
    bins = np.sort(rng.integers(0, 40, (q, 2, 2)), axis=2)
    times = np.stack([bins[..., 0], rng.integers(0, 2**31, (q, 2)), bins[..., 1],
                      rng.integers(0, 2**31, (q, 2))], axis=2).astype(np.int32)
    times[:, 1] = [5, 0, 4, 0]  # a dead window
    boxes[-1] = [1, 0, 1, 0]  # a query with no live box
    return ext, boxes, times


def _args(n_chunks: int, q: int = 9, seed: int = 0, target: int = 7):
    ext, boxes, times = _made_extents(n_chunks, q, seed + n_chunks)
    n = n_chunks * kernels.JOIN_BLOCK - 5
    true_n = n - 2 * kernels.JOIN_BLOCK if n_chunks > 2 else n
    return (_t(ext), n, 0, true_n, _t(boxes), _t(times), target)


def _assert_window_runs(chunks, kept, runs, work, keep):
    """The window runs against ``keep`` (Q, C), the cull's pairs."""
    q, c = keep.shape
    nw = -(-c // W)
    pairs = int(keep.sum())
    n_runs = int(work[kernels.W_RUNS])
    assert work.tolist() == [q, 0, n_runs, W, pairs, 0]
    assert tuple(runs.shape) == (3, q * nw) and (runs[:, n_runs:] == -1).all()
    seen = np.zeros((q, c), dtype=np.int64)
    order = []
    for r in range(n_runs):
        qi, s, e = (int(v) for v in runs[:, r])
        assert 0 <= s < e <= int(kept[qi])
        cs = chunks[qi, s:e].numpy()
        assert (cs >= 0).all() and (np.diff(cs) > 0).all()
        w = int(cs[0]) // W
        assert (cs // W == w).all()  # one window
        # the whole of the query's kept chunks in the window
        assert s == 0 or int(chunks[qi, s - 1]) // W < w
        assert e == int(kept[qi]) or int(chunks[qi, e]) // W > w
        seen[qi, cs] += 1
        order.append((w, qi))
    assert order == sorted(order) and len(set(order)) == len(order)
    assert np.array_equal(seen, keep.numpy().astype(np.int64))


@pytest.mark.parametrize("n_chunks", [1, W - 1, W, W + 1, 1025, 5000])
def test_window_runs_cover_each_pair_once(n_chunks):
    """Each kept pair lies in exactly one run; a run is one query's kept
    chunks of one window; runs in (window, query) order."""
    args = _args(n_chunks)
    out = kernels.agg_work_list(*args, overlap=True)
    keep = kernels._pairs_from_extents(*args[:6]).T
    if n_chunks > 100:
        assert 0 < int(keep.sum()) < keep.numel()
    _assert_window_runs(*out, keep)
    point = kernels.agg_work_list(*args)
    for g, p in zip(out[:2], point[:2]):  # the same lists: only the runs differ
        assert torch.equal(g, p)


@pytest.mark.parametrize("segments", [None, 64])
@pytest.mark.parametrize("n_chunks", [1, 1023, 1025, 5000])
def test_window_runs_model_equals_plain(n_chunks, segments):
    """The model of the card's work list (segments of chunks, placed by
    the look-back; the window cells from each segment's ballots) gives the
    plain version's window runs exactly."""
    args = _args(n_chunks, seed=1)
    want = kernels.agg_work_list_plain(*args, overlap=True)
    got = kernels.agg_work_list_segments(*args, segments=segments, overlap=True)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("n_chunks", [1, 1025, 5000])
def test_point_runs_unchanged(n_chunks):
    """The point form's runs are query-major, ``run_len`` chunks each but
    a query's last, at several targets: a cutting written here."""
    for target in (1, 7, 1000):
        args = _args(n_chunks, seed=2, target=target)
        chunks, kept, runs, work = kernels.agg_work_list(*args)
        k = kept.long().numpy()
        run_len = max(kernels.AGG_MIN_RUN, -(-int(k.sum()) // target))
        want = [(qi, s, min(int(n), s + run_len)) for qi, n in enumerate(k)
                for s in range(0, int(n), run_len)]
        n_runs = int(work[kernels.W_RUNS])
        assert work.tolist() == [len(k), 0, len(want), run_len, int(k.sum()), 0]
        assert [tuple(int(v) for v in runs[:, r]) for r in range(n_runs)] == want
        assert tuple(runs.shape) == (3, len(k) + target) and (runs[:, n_runs:] == -1).all()


@pytest.mark.parametrize("k", [1, 2, kernels.AGG_FOLD_K])
@pytest.mark.parametrize("n_chunks", [W + 1, 1025, 5000])
def test_fold_walk_folds_each_pair_once(n_chunks, k):
    """The fold's items (``k`` runs a block) walk their chunks in order,
    each once an item, and fold every kept pair exactly once; items of
    several runs read fewer chunks than their pairs."""
    args = _args(n_chunks, seed=3)
    chunks, kept, runs, work = kernels.agg_work_list(*args, overlap=True)
    keep = kernels._pairs_from_extents(*args[:6]).T.numpy()
    items = kernels.overlap_fold_walk(chunks, runs, work, k)
    assert len(items) == -(-int(work[kernels.W_RUNS]) // k)
    folded = np.zeros_like(keep, dtype=np.int64)
    reads = 0
    for i, walk in enumerate(items):
        cs = [c for c, _ in walk]
        assert cs == sorted(set(cs))  # in order, each chunk once
        reads += len(cs)
        for c, ks in walk:
            for kk in ks:
                folded[int(runs[0, i * k + kk]), c] += 1
    assert np.array_equal(folded, keep.astype(np.int64))
    if k > 1 and n_chunks > 100:
        assert reads < int(keep.sum())


def _bbox_store(n: int, q: int, seed: int):
    """Config-5 bboxes of ``n`` rows in xmin order as int32 columns with
    day bins and offsets, and ``q`` queries as ``DataStore`` packs them:
    (columns, boxes, times)."""
    rng = np.random.default_rng(seed)
    b = xz_boxes(n, seed)
    nlon, nlat = norm_lon(31), norm_lat(31)
    cols = [nlon.normalize(b[0]), nlat.normalize(b[1]), nlon.normalize(b[2]),
            nlat.normalize(b[3])]
    bins = np.sort(rng.integers(0, 30, n))
    order = np.lexsort((cols[0], bins))
    cols = [c[order].astype(np.int32) for c in cols]
    cols += [bins.astype(np.int32), rng.integers(0, 86_400_000, n).astype(np.int32)]
    boxes, times = [], []
    for _ in range(q):
        i = int(rng.integers(n))
        d = int(rng.integers(2**26, 2**28))
        x, y = int(cols[0][i]), int(cols[1][i])
        bq = np.array([[max(0, x - d), min(2**31 - 1, x + d), max(0, y - d),
                        min(2**31 - 1, y + d)]], np.int32)
        boxes.append(pack_boxes(bq, slots=2, overlap=True))
        d0 = int(rng.integers(0, 25))
        times.append(pack_times(np.array([[d0, 0, d0 + int(rng.integers(2, 6)), 0]], np.int32),
                                slots=2))
    return cols, np.ascontiguousarray(np.stack(boxes)), np.ascontiguousarray(np.stack(times))


@pytest.mark.parametrize("seed", [5, 6])
def test_window_runs_on_bbox_extents(seed):
    """Over the extents of config-5 bboxes in (day, xmin) order the window
    runs cover each pair the bbox cull keeps, and most windows are shared
    by several queries' runs."""
    n = 60 * kernels.JOIN_BLOCK + 123
    cols, boxes, times = _bbox_store(n, 24, seed)
    ext = kernels.chunk_extents_bbox(*(_t(c) for c in cols))
    args = (ext, n, 0, n, _t(boxes), _t(times), 5)
    out = kernels.agg_work_list(*args, overlap=True)
    keep = kernels.overlap_chunk_pairs(tuple(_t(c) for c in cols), 0, n, _t(boxes),
                                       _t(times)).T
    _assert_window_runs(*out, keep)
    n_runs = int(out[3][kernels.W_RUNS])
    windows = out[2][1, :n_runs]  # first slots, then their windows below
    wins = [int(out[0][int(out[2][0, r]), int(windows[r])]) // W for r in range(n_runs)]
    assert len(set(wins)) < n_runs


def test_window_runs_empty():
    """No query, or no kept pair, gives no run and -1 tables."""
    ext, n, base, true_n, boxes, times, target = _args(40)
    chunks, kept, runs, work = kernels.agg_work_list(ext, n, 0, 0, boxes, times, target,
                                                     overlap=True)
    assert int(kept.sum()) == 0 and int(work[kernels.W_RUNS]) == 0 and (runs == -1).all()
    assert tuple(runs.shape) == (3, boxes.shape[0] * -(-40 // W))
    out = kernels.agg_work_list(ext, n, 0, n, boxes[:0], times[:0], target, overlap=True)
    assert out[3].tolist() == [0, 0, 0, W, 0, 0] and out[2].shape[1] == 0


@pytest.mark.cuda
def test_window_runs_match_plain_on_card():
    """The card's work list gives the plain version's lists, counts, window
    runs and work ints exactly, over one segment of chunks and several."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernel has no CPU mode")
    for n_chunks in (W + 1, 1025, 5000):
        ext, n, base, true_n, boxes, times, target = _args(n_chunks, seed=4)
        card = (ext.cuda(), n, base, true_n, boxes.cuda(), times.cuda(), target)
        got = kernels.agg_work_list(*card, overlap=True)
        want = kernels.agg_work_list_plain(*card, overlap=True)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g, w)
