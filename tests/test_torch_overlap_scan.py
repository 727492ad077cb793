"""The overlap scan's per-warp skip of the edge test, on the CPU.

``batched_edge_gather_overlap``'s kernel runs the edge test of a (warp,
query) pair only where :func:`overlap_edge_possible` (its plain version)
allows a candidate. These tests hold that rule to the edge predicate of
``overlap_masks(..., edges=True)`` (which ``tests/test_torch_overlap.py``
holds to the reference): over seeded chunks grouped as the kernel's warps
hold them, with payloads from ``workload.edge_payload`` and boxes and
windows placed on rows' opposing bounds and keys, no group that holds a
candidate is ever skipped. Exact: no tolerance.
"""

import numpy as np
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from geomesa_tpu_torch.curve.normalize import lat as norm_lat, lon as norm_lon
from geomesa_tpu_torch.ops.kernels import (
    JOIN_BLOCK, OVERLAP_WARP_ROWS, _time_keys, overlap_edge_possible, overlap_masks,
    overlap_warp_rows)
from geomesa_tpu_torch.workload import edge_payload, xz_boxes

TOP = 2**31 - 1
BOT = -2**31
DAY = 86_400_000


def _chunk(seed: int, sort: bool):
    """One chunk of config-5 bounds normalized at 31 bits (sorted by xmin
    or not), with zero-size, whole-world and stamped rows and the zeros the
    kernel loads past a column's end; day bins and ms offsets, some offsets
    0 and some negative."""
    rng = np.random.default_rng(seed)
    b = xz_boxes(JOIN_BLOCK, seed)
    cols = [norm_lon(31).normalize(b[0]), norm_lat(31).normalize(b[1]),
            norm_lon(31).normalize(b[2]), norm_lat(31).normalize(b[3])]
    if sort:
        order = np.argsort(cols[0], kind="stable")
        cols = [c[order] for c in cols]
    cols = [c.astype(np.int64) for c in cols]
    spots = rng.choice(JOIN_BLOCK, (3, 24), replace=False)
    for c in (0, 1):
        cols[c + 2][spots[0]] = cols[c][spots[0]]  # zero size
        cols[c][spots[1]], cols[c + 2][spots[1]] = 0, TOP  # the whole world
        cols[c][spots[2]], cols[c + 2][spots[2]] = TOP, -1  # stamped invalid
    bins = rng.integers(0, 4, JOIN_BLOCK)
    offs = rng.integers(-DAY, DAY, JOIN_BLOCK)
    offs[rng.random(JOIN_BLOCK) < 0.05] = 0
    tail = int(rng.integers(0, 600))  # rows past n arrive as zeros
    out = [c.astype(np.int32) for c in cols + [bins, offs]]
    if tail:
        for c in out:
            c[-tail:] = 0
    return out, spots[2]


def _payload(rows, stamped, q: int, seed: int):
    """``edge_payload``'s boxes and windows around the rows, with slots
    replaced by boxes whose edges sit on a row's opposing bounds, zero-size
    boxes on a row's corner and windows ending at a row's exact key."""
    rng = np.random.default_rng(seed)
    x0, y0, x1, y1, bins, offs = rows
    boxes, times = edge_payload((x0, y0, bins, offs), q, 4, 3, seed, single=bool(seed % 2))
    ok = np.setdiff1d(np.arange(JOIN_BLOCK), stamped)
    for qi in range(q):
        for k in rng.choice(4, int(rng.integers(0, 3)), replace=False):
            r = int(rng.choice(ok))
            d = int(rng.integers(0, 2**22))
            side = int(rng.integers(5))
            if side == 0:  # west edge on the row's xmax
                boxes[qi, k] = [x1[r], min(TOP, int(x1[r]) + d), y0[r], y1[r]]
            elif side == 1:  # east edge on the row's xmin
                boxes[qi, k] = [max(0, int(x0[r]) - d), x0[r], y0[r], y1[r]]
            elif side == 2:  # south edge on the row's ymax
                boxes[qi, k] = [x0[r], x1[r], y1[r], min(TOP, int(y1[r]) + d)]
            elif side == 3:  # north edge on the row's ymin
                boxes[qi, k] = [x0[r], x1[r], max(0, int(y0[r]) - d), y0[r]]
            else:  # zero size, on the row's corner
                boxes[qi, k] = [x1[r], x1[r], y1[r], y1[r]]
        if rng.random() < 0.5:
            r = int(rng.choice(ok))
            times[qi, int(rng.integers(3))] = ([bins[r], offs[r], TOP, TOP] if rng.random() < 0.5
                                               else [BOT, BOT, bins[r], offs[r]])
    times[0, 0] = [BOT, BOT, TOP, TOP]  # query 0: a live box on a row's edge, any time
    r = int(ok[0])
    boxes[0, 0] = [x1[r], min(TOP, int(x1[r]) + 5), y0[r], y1[r]]
    return torch.from_numpy(boxes), torch.from_numpy(times)


def _groups(rows):
    """The chunk's columns as (16, 256): the rows each warp of the scan
    holds; the time columns as biased keys."""
    idx = overlap_warp_rows()
    t = [torch.from_numpy(c)[idx] for c in rows]
    return t[:4] + [_time_keys(t[4], t[5])]


def test_warp_rows_are_the_kernel_layout():
    """Warp w holds rows 128w .. 128w + 127 and 2048 + 128w .. 2048 + 128w
    + 127 of a chunk: the 16 warps together hold every row once."""
    rows = overlap_warp_rows()
    assert rows.shape == (16, OVERLAP_WARP_ROWS)
    assert torch.equal(torch.sort(rows.flatten()).values, torch.arange(JOIN_BLOCK))
    for w in range(16):
        want = torch.cat([torch.arange(128 * w, 128 * w + 128),
                          torch.arange(2048 + 128 * w, 2048 + 128 * w + 128)])
        assert torch.equal(torch.sort(rows[w]).values, want)


@settings(max_examples=25, deadline=None, derandomize=True)
@given(seed=st.integers(0, 2**31 - 1), sort=st.booleans())
def test_edge_skip_never_skips_a_candidate(seed, sort):
    rows, stamped = _chunk(seed, sort)
    boxes, times = _payload(rows, stamped, 24, seed + 1)
    m, on_edge = overlap_masks(*(torch.from_numpy(c)[None] for c in rows), boxes, times,
                               edges=True)
    cand = (m & on_edge)[:, overlap_warp_rows()]  # (Q, 16, 256)
    held = cand.any(dim=2).T  # (16, Q): the group holds a candidate of the query
    possible = overlap_edge_possible(*_groups(rows), boxes, times)
    assert possible.shape == held.shape
    assert not (held & ~possible).any()
    assert held[:, 0].any()  # query 0 has a candidate by construction


def test_edge_skip_bounds_are_inclusive():
    """Each range's two ends allow a candidate, one past them does not, and
    dead slots allow none."""
    n = OVERLAP_WARP_ROWS
    rng = np.random.default_rng(3)
    x0 = torch.from_numpy(rng.integers(100, 201, n))
    x1 = torch.from_numpy(rng.integers(300, 401, n))
    y0 = torch.from_numpy(rng.integers(1000, 1101, n))
    y1 = torch.from_numpy(rng.integers(1300, 1401, n))
    x0[0], x0[1], x1[0], x1[1] = 100, 200, 300, 400
    y0[0], y0[1], y1[0], y1[1] = 1000, 1100, 1300, 1400
    keys = torch.from_numpy(rng.integers(5000, 6001, n))
    keys[0], keys[1] = 5000, 6000
    group = [v[None] for v in (x0, y0, x1, y1, keys)]
    far = [50, 60, 500, 2000]  # no end in any range: qxhi 60, qxlo 50, qyhi 2000, qylo 500
    boxes, want = [], []
    for axis, (lo, hi) in ((1, (100, 200)), (0, (300, 400)), (3, (1000, 1100)),
                           (2, (1300, 1400))):
        for v, inside in ((lo, True), (hi, True), (lo - 1, False), (hi + 1, False)):
            b = list(far)
            b[axis] = v
            if axis == 0:  # keep the slot live: qxhi past qxlo, outside [100, 200]
                b[1] = 2**30
            boxes.append(b)
            want.append(inside)
    boxes.append([150, 120, 500, 2000])  # dead (xlo > xhi) with qxhi inside [100, 200]
    want.append(False)
    q = len(boxes)
    pad = [1, 0, 1, 0]
    bx = torch.tensor([[b, pad] for b in boxes], dtype=torch.int32)
    none = torch.tensor([[[1, 0, 0, -1]]] * q, dtype=torch.int32)  # a dead window
    got = overlap_edge_possible(*group, bx, none)[0]
    assert got.tolist() == want
    # windows: an endpoint key in [5000, 6000] allows a candidate
    far_box = torch.tensor([[far]] * 5, dtype=torch.int32)
    wins = []
    for lo_key, hi_key in ((4000, 5000), (6000, 7000), (4000, 4999), (6001, 7000),
                           (6000, 5000)):  # the last is dead: lo > hi
        wins.append([[lo_key >> 32, (lo_key & 0xFFFFFFFF) - 2**31,
                      hi_key >> 32, (hi_key & 0xFFFFFFFF) - 2**31]])
    tm = torch.tensor(wins, dtype=torch.int32)
    assert (_time_keys(tm[:, 0, 0].long(), tm[:, 0, 1].long()).tolist()
            == [4000, 6000, 4000, 6001, 6000])
    assert overlap_edge_possible(*group, far_box, tm)[0].tolist() == [True, True, False, False,
                                                                       False]
