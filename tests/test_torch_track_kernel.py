"""The ``track_stats`` kernel and the overlap form of ``grouped_agg``:
their plain versions against numpy, here on the CPU, and the kernels
against their plain versions on a card (``cuda`` marker). No jax.

- ``track_stats_plain`` against an f64 numpy fold of the reference's step
  semantics on track layouts: random tracks, parked tracks (dwell),
  one-row entities, an entity holding half the rows, a row count that is
  not a multiple of 32, empty entities in the offsets, and no row at all;
- on the card: ``track_stats`` against ``track_stats_plain`` at those
  shapes, at 1,000,003 rows with one entity holding half of them and on
  the layouts of ``tests/test_torch_track_tiles.py`` built around the
  kernel's tiles of ``TRACK_TILE`` rows (an entity over many tiles, empty
  entities on and between tile edges, entities starting on a tile's first
  row, a zero-length step and a turn across tile edges, E = 1, fewer rows
  than a tile, a ragged row count), two calls equal bit for bit, and
  ``grouped_agg_overlap`` against ``grouped_agg_overlap_plain`` on
  config-5 bboxes with dead and inverted slots, an all-dead query and
  ``true_n`` inside the last chunk, in both fold modes.

Tolerance: the f32 sums against the f64 fold within rtol 1e-4 + atol 1e-3
(f32 rounding of ~2,500-term sums); the kernel against the plain version
within rtol 1e-4 + atol 1e-3 (the sums' order, atomics on the card; atan2f
may differ in the last bit). The grouped fold's integer outputs, min, max
and lanes exactly, its f64 sums within a relative 1e-12.
"""

import numpy as np
import pytest
import torch

from geomesa_tpu_torch.curve.normalize import lat as norm_lat, lon as norm_lon
from geomesa_tpu_torch.ops import kernels
from geomesa_tpu_torch.ops.kernels import track_stats, track_stats_plain
from geomesa_tpu_torch.ops.refine import pack_boxes, pack_times
from geomesa_tpu_torch.parallel.residency import stage_columns
from geomesa_tpu_torch.workload import xz_boxes

RTOL, ATOL = 1e-4, 1e-3
EPS = 1e-4
T0 = 1_600_000_000_000


def _layout(kind: str, seed: int, n_rows: int = 5000):
    """(offsets int64, dt f32 seconds, x f32, y f32) of a track layout."""
    rng = np.random.default_rng(seed)
    if kind == "random":
        sizes = rng.integers(1, 40, n_rows // 20)
    elif kind == "dwell":
        sizes = rng.integers(2, 30, n_rows // 16)
    elif kind == "singles":
        sizes = np.ones(n_rows // 10, dtype=np.int64)
    elif kind == "giant":  # one entity holds half the rows
        side = rng.integers(1, 20, n_rows // 20)
        sizes = np.r_[side, n_rows // 2, side[::-1]]
    elif kind == "empties":  # entities without rows between others
        sizes = rng.integers(0, 5, 300)
        sizes[0] = 1
    elif kind == "none":
        sizes = np.zeros(0, dtype=np.int64)
    else:  # "odd": 1001 rows
        sizes = rng.integers(1, 60, 30)
        sizes[-1] += 1001 - sizes.sum()
    offsets = np.r_[0, np.cumsum(sizes)].astype(np.int64)
    n = int(offsets[-1])
    x = rng.uniform(-30, 30, n).astype(np.float32)
    y = rng.uniform(-20, 20, n).astype(np.float32)
    if kind == "dwell":
        for k in range(0, max(n - 4, 0), 7):
            x[k + 1:k + 4], y[k + 1:k + 4] = x[k], y[k]
    dt = rng.integers(0, 90, n).astype(np.float32)
    dt[offsets[:-1][sizes > 0]] = 0
    return offsets, dt, x, y


def _f64_fold(offsets, dt, x, y, eps):
    """The reference's step semantics in f64 numpy over the f32 inputs."""
    n, e = len(x), len(offsets) - 1
    x, y, dt = (a.astype(np.float64) for a in (x, y, dt))
    first = np.zeros(n, dtype=bool)
    starts = offsets[:-1][np.diff(offsets) > 0]
    first[starts] = True
    dx = np.diff(x, prepend=x[:1])
    dy = np.diff(y, prepend=y[:1])
    dist = np.where(first, 0.0, np.hypot(dx, dy))
    step = np.where(first, 0.0, dt)
    sid = np.repeat(np.arange(e), np.diff(offsets))
    brg = np.degrees(np.arctan2(dx, dy))
    moved = ~first & (dist > 0)
    pmoved = np.r_[False, moved[:-1]]
    turn = np.abs(np.mod(brg - np.r_[brg[:1], brg[:-1]] + 180.0, 360.0) - 180.0)
    turn = np.where(moved & pmoved, turn, 0.0)
    return [np.bincount(sid, weights=w, minlength=e) for w in
            (dist, step, turn, np.where(dist <= eps, step, 0.0))]


KINDS = ("random", "dwell", "singles", "giant", "empties", "none", "odd")


def _tensors(layout, device="cpu"):
    offsets, dt, x, y = layout
    return [torch.from_numpy(a).to(device) for a in (x, y, dt, offsets)]


@pytest.mark.parametrize("kind", KINDS)
def test_plain_equals_f64_fold(kind):
    layout = _layout(kind, KINDS.index(kind) + 1)
    x, y, dt, off = _tensors(layout)
    got = track_stats_plain(x, y, dt, off, EPS)
    want = _f64_fold(*layout, EPS)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == (len(layout[0]) - 1,)
        np.testing.assert_allclose(g.numpy(), w, rtol=RTOL, atol=ATOL)
    assert all(torch.equal(g, p) for g, p in zip(track_stats(x, y, dt, off, EPS), got))
    if kind == "dwell":
        assert float(got[3].sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS + ("million",))
def test_track_stats_kernel_matches_plain_on_card(kind):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernel has no CPU mode")
    layout = (_layout("giant", 9, 1_000_003) if kind == "million"
              else _layout(kind, KINDS.index(kind) + 1))
    args = _tensors(layout, "cuda")
    before = kernels.launches["track_stats"]
    got = track_stats(*args, EPS)
    want = track_stats_plain(*args, EPS)
    torch.cuda.synchronize()
    assert kernels.launches["track_stats"] == before + (len(layout[0]) > 1)
    for g, w in zip(got, want):
        assert g.device.type == "cuda" and g.dtype == torch.float32
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), rtol=RTOL, atol=ATOL)


TILE_KINDS = ("span", "edge_empties", "aligned", "edge_steps", "one", "small", "ragged")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", TILE_KINDS)
def test_track_stats_kernel_on_tile_edges_on_card(kind):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernel has no CPU mode")
    # beside this file (pytest puts tests/ on the path; `tests.` may name another package)
    from test_torch_track_tiles import tile_layout

    layout = tile_layout(kind, kernels.TRACK_TILE, TILE_KINDS.index(kind) + 11)
    args = _tensors(layout, "cuda")
    got = track_stats(*args, EPS)
    want = track_stats_plain(*args, EPS)
    torch.cuda.synchronize()
    empty = np.diff(layout[0]) == 0
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), rtol=RTOL, atol=ATOL)
        assert (g.cpu().numpy()[empty] == 0).all()


@pytest.mark.cuda
def test_track_stats_kernel_repeats_bit_for_bit_on_card():
    """Each sum is added in an order the layout fixes: two calls agree to
    the bit, with an entity over hundreds of tiles."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernel has no CPU mode")
    args = _tensors(_layout("giant", 9, 1_000_003), "cuda")
    first = track_stats(*args, EPS)
    for _ in range(3):
        again = track_stats(*args, EPS)
        assert all(torch.equal(a, b) for a, b in zip(first, again))


def _bbox_inputs(n: int, q: int, nb: int, nt: int, seed: int):
    rng = np.random.default_rng(seed)
    b = xz_boxes(n, seed)
    nlon, nlat = norm_lon(31), norm_lat(31)
    cols = [nlon.normalize(b[0]), nlat.normalize(b[1]), nlon.normalize(b[2]),
            nlat.normalize(b[3])]
    order = np.argsort(cols[0], kind="stable")
    cols = [c[order].astype(np.int32) for c in cols]
    cols += [rng.integers(0, 5, n).astype(np.int32),
             rng.integers(0, 86_400_000, n).astype(np.int32)]
    boxes, times = [], []
    for qi in range(q):
        bq = []
        for _ in range(int(rng.integers(1, nb + 1))):
            i = int(rng.integers(n))
            d = int(rng.integers(2**22, 2**27))
            x, y = int(cols[0][i]), int(cols[1][i])
            bq.append([max(0, x - d), min(2**31 - 1, x + d), max(0, y - d), min(2**31 - 1, y + d)])
        if qi == 1:
            bq.append([500, 100, 500, 100])  # inverted: dead
        if qi == 2:
            bq = [[7, 3, 7, 3]]  # no live slot
        bq = np.array(bq[:nb], np.int32)
        boxes.append(pack_boxes(bq, slots=nb, overlap=True))
        tq = np.array([[0, int(rng.integers(0, 86_400_000)), int(rng.integers(2, 5)), 0]],
                      np.int32)
        times.append(pack_times(tq, slots=nt))
    gid = rng.integers(0, 64, n).astype(np.int32)
    rowid = rng.permutation(n).astype(np.int32)
    vals = rng.normal(50.0, 20.0, (2, n))
    vals[rng.random((2, n)) < 0.1] = np.nan
    return cols, np.ascontiguousarray(np.stack(boxes)), np.ascontiguousarray(np.stack(times)), \
        gid, rowid, vals


@pytest.mark.cuda
@pytest.mark.parametrize("groups", [64, 8192])
def test_grouped_agg_overlap_kernel_matches_plain_on_card(groups):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernel has no CPU mode")
    dev = torch.device("cuda")
    n = 300_001
    cols, boxes, times, gid, rowid, vals = _bbox_inputs(n, 12, 8, 4, seed=5)
    staged, padded = stage_columns(dict(zip("abcdef", cols)), dev)
    tc = tuple(staged[k] for k in "abcdef")

    def pad(a, value):
        out = np.full(a.shape[:-1] + (padded,), value, dtype=a.dtype)
        out[..., :n] = a
        return torch.from_numpy(out).to(dev)

    args = (tc, pad(gid, 0), pad(rowid, 2**31 - 1), pad(vals, 0.0), 0, n - 999,
            torch.from_numpy(boxes).to(dev), torch.from_numpy(times).to(dev), groups, 512)
    before = kernels.launches["grouped_agg_overlap"]
    got = kernels.grouped_agg_overlap(*args)
    want = kernels.grouped_agg_overlap_plain(*args)
    torch.cuda.synchronize()
    assert kernels.launches["grouped_agg_overlap"] == before + 1
    fits = (want[7][:, 0] <= 512).cpu()
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = g.cpu(), w.cpu()
        if i == 3:
            assert torch.allclose(g, w, rtol=1e-12, atol=0)
        elif i == 6:
            assert torch.equal(g[fits], w[fits])
        else:
            assert torch.equal(g, w), i
    assert int(want[0].long().sum()) > 0 and int(want[0][2].long().sum()) == 0
