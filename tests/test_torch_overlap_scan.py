"""The overlap scan's per-warp skip of the edge test, on the CPU.

``batched_edge_gather_overlap``'s kernel runs the edge test of a (warp,
query) pair only where :func:`overlap_edge_possible` (its plain version)
allows a candidate. These tests hold that rule to the edge predicate of
``overlap_masks(..., edges=True)`` (which ``tests/test_torch_overlap.py``
holds to the reference): over seeded chunks grouped as the kernel's warps
hold them, with payloads from ``workload.edge_payload`` and boxes and
windows placed on rows' opposing bounds and keys, no group that holds a
candidate is ever skipped. Exact: no tolerance.

The planned overlap count pass holds a block's rows 8 a thread
(``planned_overlap_rows``) and regroups each pair's match bits into the
write pass's uint16 words:
``overlap_mask_words`` (its plain version) puts row r at bit r % 16 of word
r // 16. On the card (``cuda`` marker) the planned gather's overlap form
equals its plain version on adversarial pair lists.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from geomesa_tpu_torch.curve.normalize import lat as norm_lat, lon as norm_lon
from geomesa_tpu_torch.ops.kernels import (
    JOIN_BLOCK, OVERLAP_WARP_ROWS, _time_keys, overlap_edge_possible, overlap_mask_words,
    overlap_masks, overlap_warp_rows, planned_overlap_rows)
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


@pytest.mark.parametrize("pattern", ["each row alone", "all rows", "random"])
def test_mask_words_are_the_write_pass_layout(pattern):
    """The planned overlap count pass's regrouping of a thread's 8 match
    bits (rows ``planned_overlap_rows``: each row of the block held once)
    into uint16 words puts row r at bit r % 16 of word r // 16, for every
    row alone, all rows and random masks."""
    rows_of = planned_overlap_rows()
    assert torch.equal(torch.sort(rows_of.flatten()).values, torch.arange(JOIN_BLOCK))
    if pattern == "each row alone":
        masks = torch.eye(JOIN_BLOCK, dtype=torch.bool)
    elif pattern == "all rows":
        masks = torch.ones((1, JOIN_BLOCK), dtype=torch.bool)
    else:
        masks = torch.from_numpy(np.random.default_rng(11).random((64, JOIN_BLOCK)) < 0.3)
    bits = (masks[:, rows_of].long() << torch.arange(8)).sum(dim=2)
    words = overlap_mask_words(bits).long() & 0xFFFF
    want = (masks.view(masks.shape[0], -1, 16).long() << torch.arange(16)).sum(dim=2)
    assert torch.equal(words, want)


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


def _card_columns(n: int, seed: int):
    """``n`` config-5 bounds normalized at 31 bits, padded to whole blocks
    with stamped rows, and day bins and ms offsets: the six int32 columns
    of a bbox store, and the valid rows."""
    rng = np.random.default_rng(seed)
    b = xz_boxes(n, seed)
    cols = [norm_lon(31).normalize(b[0]), norm_lat(31).normalize(b[1]),
            norm_lon(31).normalize(b[2]), norm_lat(31).normalize(b[3]),
            rng.integers(0, 4, n), rng.integers(-DAY, DAY, n)]
    pad = -(-n // JOIN_BLOCK) * JOIN_BLOCK - n
    fill = (TOP, TOP, -1, -1, 0, 0)
    return [np.concatenate([c, np.full(pad, f)]).astype(np.int32) for c, f in zip(cols, fill)]


def _card_payload(cols, q: int, seed: int):
    """(q, 8, 4) boxes and (q, 16, 4) windows around random rows' bounds and
    keys, 1..8 live boxes and 1..16 live windows a query, the rest dead; the
    last query has no live box."""
    rng = np.random.default_rng(seed)
    x0, y0, x1, y1, bins, offs = cols
    boxes = np.tile(np.array([1, 0, 1, 0], np.int64), (q, 8, 1))
    times = np.tile(np.array([5, 0, 4, 0], np.int64), (q, 16, 1))
    for qi in range(q - 1):
        for k in range(int(rng.integers(1, 9))):
            r, d = int(rng.integers(len(x0))), int(rng.integers(0, 2**26))
            boxes[qi, k] = [max(0, x0[r] - d), min(TOP, x1[r] + d), max(0, y0[r] - d),
                            min(TOP, y1[r] + d)]
        for k in range(int(rng.integers(1, 17))):
            r, d = int(rng.integers(len(x0))), int(rng.integers(0, DAY))
            times[qi, k] = [bins[r], offs[r] - d, bins[r] + int(rng.integers(0, 2)), offs[r] + d]
    return (np.clip(boxes, BOT, TOP).astype(np.int32), np.clip(times, BOT, TOP).astype(np.int32))


@pytest.mark.cuda
def test_planned_gather_overlap_matches_plain_on_card():
    """The overlap count pass (a block a half of each distinct block, masks
    regrouped for the write pass, the counts' prefix sum by a one-block
    scan of several passes) and the write pass equal the plain version, one
    launch counted a call: more distinct blocks than the card holds blocks
    at once, more pairs than one pass of the scan, one block with more pairs
    than a tile stages, pairs duplicated, out of order and out of range, a
    query with no live box, true_n inside a block."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernel has no CPU mode")
    from geomesa_tpu_torch.ops import kernels

    dev = torch.device("cuda")
    n = 600 * JOIN_BLOCK - 1000
    cols = [torch.from_numpy(c).to(dev) for c in _card_columns(n, 13)]
    n_blocks = cols[0].shape[0] // JOIN_BLOCK
    boxes, times = (torch.from_numpy(a).to(dev) for a in _card_payload(_card_columns(n, 13), 40,
                                                                       14))
    rng = np.random.default_rng(15)
    rand_q, rand_b = rng.integers(0, 40, 8500), rng.integers(0, n_blocks, 8500)
    cases = [
        ([i % 40 for i in range(300)], [7] * 300, n),
        ([3] * n_blocks, list(range(n_blocks)), n - 5000),
        (list(rand_q) + list(rand_q[:700]), list(rand_b) + list(rand_b[:700]), n),
        ([39, 0], [n_blocks - 1] * 2, n),
    ]
    for pq, pb, true_n in cases:
        pq_t, pb_t = (torch.tensor(np.asarray(a, np.int32), device=dev) for a in (pq, pb))
        before = kernels.launches["planned_gather_overlap"]
        got = kernels.planned_gather_overlap(cols, true_n, pq_t, pb_t, boxes, times)
        want = kernels.planned_gather_overlap_plain(cols, true_n, pq_t, pb_t, boxes, times)
        torch.cuda.synchronize()
        assert kernels.launches["planned_gather_overlap"] == before + 1
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert int(want[1].sum()) > 0
    oq = np.concatenate([rand_q[:200], [-1, 40, 3, 4]]).astype(np.int32)
    ob = np.concatenate([rand_b[:200], [0, 1, -1, n_blocks + 3]]).astype(np.int32)
    got_p, got_h = kernels.planned_gather_overlap(cols, n, torch.from_numpy(oq).to(dev),
                                                  torch.from_numpy(ob).to(dev), boxes, times)
    want_p, want_h = kernels.planned_gather_overlap_plain(
        cols, n, torch.from_numpy(oq[:200]).to(dev), torch.from_numpy(ob[:200]).to(dev), boxes,
        times)
    assert torch.equal(got_p, want_p) and torch.equal(got_h[:200], want_h)
    assert int(got_h[200:].abs().sum()) == 0
