"""The overlap kernels' plain versions against the reference's steps, on the
CPU.

- ``batched_overlap_plain`` (both forms) equals ``make_batched_overlap_step``
  (``with_time`` False and True) on the 8-device CPU mesh;
- ``batched_edge_gather_overlap_plain`` equals
  ``make_batched_edge_gather_step(overlap=True)``: counts, hits summed over
  shards, lanes where nothing truncated, and its counts equal
  ``batched_overlap``'s with time (the reference's invariant);
- ``planned_gather_overlap_plain`` equals
  ``make_planned_gather_step(overlap=True)`` pair for pair;
- ``refine_bboxes`` equals the reference's;
- the overlap pad and ``chunk_extents_bbox`` / ``overlap_chunk_pairs``, and
  the kernels' own cull per warp, ``overlap_warp_pairs``: no culled (chunk,
  query) or (warp, query) pair holds a match.

Rows are config-5 bboxes normalized at 31 bits with adversarial rows: on
each of the four opposing query edges, zero-size boxes, whole-world boxes
and stamped invalid rows (xmin = ymin = INT32_MAX, xmax = ymax = -1). Boxes
are packed with the overlap pad, as a line store packs them. Tolerance:
none — counts, lanes and positions compare exactly.
"""

import numpy as np
import pytest
import torch

import geomesa_tpu  # noqa: F401  (x64 on)
import jax.numpy as jnp
from geomesa_tpu.ops.refine import pack_boxes as ref_pack_boxes
from geomesa_tpu.ops.refine import refine_bboxes as ref_refine_bboxes
from geomesa_tpu.parallel.mesh import default_mesh, pad_query_axis, shard_columns
from geomesa_tpu.parallel.query import (
    intervals_to_block_pairs as ref_block_pairs, make_batched_edge_gather_step,
    make_batched_overlap_step, make_planned_gather_step, pad_block_pairs)

from geomesa_tpu_torch.curve.normalize import lat as norm_lat, lon as norm_lon
from geomesa_tpu_torch.ops import kernels
from geomesa_tpu_torch.ops.kernels import (
    JOIN_BLOCK, batched_edge_gather_overlap, batched_edge_gather_overlap_plain, batched_overlap,
    batched_overlap_plain, overlap_chunk_pairs, overlap_masks, overlap_warp_pairs,
    planned_gather_overlap, planned_gather_overlap_plain)
from geomesa_tpu_torch.ops.refine import pack_boxes, pack_times, refine_bboxes
from geomesa_tpu_torch.parallel.query import batched_overlap_step, intervals_to_block_pairs
from geomesa_tpu_torch.parallel.residency import stage_columns
from geomesa_tpu_torch.workload import xz_boxes

TOP = 2**31 - 1
DAY = 86_400_000
COLS = ("xmin", "ymin", "xmax", "ymax", "bins", "offs")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _rows(n: int, seed: int):
    """Normalized config-5 bounds, xz2-ish order (sorted by xmin), time
    columns, and the adversarial rows (see the module docstring); the
    edge rows are made to touch the boxes of :func:`_payload`."""
    rng = np.random.default_rng(seed)
    b = xz_boxes(n, 9 + seed)
    nlon, nlat = norm_lon(31), norm_lat(31)
    cols = [nlon.normalize(b[0]), nlat.normalize(b[1]), nlon.normalize(b[2]),
            nlat.normalize(b[3])]
    order = np.argsort(cols[0], kind="stable")
    cols = [c[order].astype(np.int64) for c in cols]
    spots = rng.choice(n, 4 * 40, replace=False).reshape(4, 40)
    for c in (0, 1):
        cols[c + 2][spots[0]] = cols[c][spots[0]]  # zero size
        cols[c][spots[1]], cols[c + 2][spots[1]] = 0, TOP  # the whole world
        cols[c][spots[2]], cols[c + 2][spots[2]] = TOP, -1  # stamped invalid
    bins = rng.integers(0, 5, n)
    offs = rng.integers(0, DAY, n)
    offs[rng.random(n) < 0.05] = 0
    return [c.astype(np.int32) for c in cols + [bins, offs]], spots[3]


def _payload(cols, edge_rows, q: int, nb: int, nt: int, seed: int):
    """Packed (q, nb, 4) boxes (the overlap pad) and (q, nt, 4) windows:
    city-sized boxes, boxes whose edges sit on edge rows' opposing bounds
    (those rows are moved to touch them), zero-size and whole-world boxes,
    several boxes per query; windows live, several, or unconstrained. Query
    0 is a zero-width box on the whole-world rows' xmax with no window:
    every one of them is its edge candidate, past a small capacity."""
    rng = np.random.default_rng(seed)
    xmin, ymin, xmax, ymax, bins, offs = cols
    n = len(xmin)
    boxes, times = [], []
    for qi in range(q):
        kb = int(rng.integers(1, nb + 1))
        bq = []
        for _ in range(kb):
            kind = int(rng.integers(5))
            i = int(rng.integers(n))
            d = int(rng.integers(2**20, 2**26))
            x, y = int(xmin[i]), int(ymin[i])
            if kind == 0:
                bq.append([max(0, x - d), min(TOP, x + d), max(0, y - d), min(TOP, y + d)])
            elif kind in (1, 2) and len(edge_rows):  # an edge row on this box's edge
                box = [max(0, x - d), min(TOP, x + d), max(0, y - d), min(TOP, y + d)]
                r = int(edge_rows[qi % len(edge_rows)])
                side = int(rng.integers(4))
                w = 1000
                if side == 0:  # row xmin == box xhi
                    xmin[r], xmax[r], ymin[r], ymax[r] = box[1], box[1] + w, box[2], box[2] + w
                elif side == 1:  # row xmax == box xlo
                    xmin[r], xmax[r], ymin[r], ymax[r] = box[0] - w, box[0], box[2], box[2] + w
                elif side == 2:  # row ymin == box yhi
                    xmin[r], xmax[r], ymin[r], ymax[r] = box[0], box[0] + w, box[3], box[3] + w
                else:  # row ymax == box ylo
                    xmin[r], xmax[r], ymin[r], ymax[r] = box[0], box[0] + w, box[2] - w, box[2]
                bq.append(box)
            elif kind == 3:
                bq.append([x, x, y, y])  # zero size, on a row's corner
            else:
                bq.append([0, TOP, 0, TOP])
        kt = int(rng.integers(0, nt + 1))
        if qi == 0:
            bq, kt = [[TOP, TOP, 0, TOP]], 0
        boxes.append(pack_boxes(np.array(bq, np.int32), slots=nb, overlap=True))
        tq = []
        for _ in range(kt):
            i = int(rng.integers(n))
            blo = int(bins[i])
            tq.append([blo, int(offs[i]), blo + int(rng.integers(0, 2)), int(rng.integers(0, DAY))])
            if tq[-1][2] == blo and tq[-1][3] < tq[-1][1]:
                tq[-1][1], tq[-1][3] = tq[-1][3], tq[-1][1]
        times.append(pack_times(np.array(tq, np.int32) if tq else None, slots=nt))
    return np.ascontiguousarray(np.stack(boxes)), np.ascontiguousarray(np.stack(times))


_STEPS: dict = {}


def _ref(name, factory):
    if name not in _STEPS:
        _STEPS[name] = factory()
    return _STEPS[name]


def _sharded(cols):
    mesh = default_mesh()
    sharded, _, _ = shard_columns(mesh, dict(zip(COLS, cols)), multiple=JOIN_BLOCK)
    return mesh, [sharded[c] for c in COLS]


CASES = [(nb, nt) for nb, nt in ((1, 1), (8, 16), (3, 2))]


@pytest.mark.parametrize("nb,nt", CASES)
def test_overlap_plain_equals_reference_steps(nb, nt):
    n, q = 50_000, 12
    cols, edge_rows = _rows(n, seed=nb + nt)
    boxes, times = _payload(cols, edge_rows, q, nb, nt, seed=3 * nb + nt)
    mesh, sh = _sharded(cols)
    (boxes_p, times_p), _ = pad_query_axis(mesh, boxes, times)
    true_n = n - 321
    no_time = _ref("overlap", lambda: make_batched_overlap_step(mesh))
    with_time = _ref("overlap_t", lambda: make_batched_overlap_step(mesh, with_time=True))
    want = np.asarray(no_time(*sh[:4], jnp.int32(true_n), jnp.asarray(boxes_p)))[:q]
    want_t = np.asarray(with_time(*sh, jnp.int32(true_n), jnp.asarray(boxes_p),
                                  jnp.asarray(times_p)))[:q]
    staged, _ = stage_columns(dict(zip(COLS, cols)), torch.device("cpu"))
    tc = [staged[c] for c in COLS]
    for chunk in (1 << 20, 4096):
        got = batched_overlap_plain(tc[:4], 0, true_n, _t(boxes), chunk=chunk)
        got_t = batched_overlap_plain(tc, 0, true_n, _t(boxes), _t(times), chunk=chunk)
        assert got.dtype == got_t.dtype == torch.int32
        assert np.array_equal(got.numpy(), want) and np.array_equal(got_t.numpy(), want_t)
    # the wrapper and the step take the plain version on CPU tensors
    assert torch.equal(batched_overlap(tc[:4], 0, true_n, _t(boxes)), got)
    assert torch.equal(batched_overlap_step(tc, true_n, _t(boxes), _t(times)), got_t)
    assert want.sum() > 0 and want_t.sum() > 0

    truncated = fitted = 0
    for cap in (4, 512):
        step = _ref(f"edge{cap}", lambda: make_batched_edge_gather_step(mesh, cap, overlap=True))
        wc, wp, wh = (np.asarray(a)[:q] for a in step(*sh, jnp.int32(true_n),
                                                      jnp.asarray(boxes_p),
                                                      jnp.asarray(times_p)))
        assert np.array_equal(wc, want_t)  # counts equal the overlap count with time
        for gc, gp, gh in (batched_edge_gather_overlap(tc, 0, true_n, _t(boxes), _t(times), cap),
                           batched_edge_gather_overlap_plain(tc, 0, true_n, _t(boxes),
                                                             _t(times), cap, chunk=4096)):
            assert gc.dtype == gp.dtype == gh.dtype == torch.int32
            assert np.array_equal(gc.numpy(), wc)
            assert np.array_equal(gh[:, 0].numpy(), wh.sum(axis=1))
            for k in range(q):
                h = int(gh[k, 0])
                lanes = gp[k, 0].numpy()
                if h > cap or (wh[k] > cap).any():
                    truncated += 1
                    assert (lanes >= 0).all()
                    continue
                fitted += 1
                union = np.sort(np.concatenate([wp[k, d, :wh[k, d]] for d in range(wp.shape[1])]))
                assert np.array_equal(lanes[:h], union) and (lanes[h:] == -1).all()
    assert fitted and truncated


def _ref_planned(cols, true_n, pair_q, pair_blk, boxes, times):
    """The reference's planned gather in overlap mode: per pair its rows."""
    mesh, sh = _sharded(cols)
    budget = max(8, -(-len(pair_q) // 8) * 8)
    pq, pb = pad_block_pairs(pair_q, pair_blk, budget)
    step = make_planned_gather_step(mesh, JOIN_BLOCK, budget, capacity=len(cols[0]) * 4,
                                    overlap=True)
    buf, hits = step(*sh, jnp.int32(true_n), jnp.asarray(pq), jnp.asarray(pb),
                     jnp.asarray(boxes), jnp.asarray(times))
    buf, hits = np.asarray(buf), np.asarray(hits)
    per_shard = sh[0].shape[0] // buf.shape[0] // JOIN_BLOCK
    off = np.zeros(buf.shape[0], np.int64)
    out = []
    for p in range(len(pair_q)):
        d, h = int(pb[p]) // per_shard, int(hits[p])
        out.append(buf[d, off[d]:off[d] + h])
        off[d] += h
    return out


@pytest.mark.parametrize("nb,nt", CASES)
def test_planned_gather_overlap_plain_equals_reference(nb, nt):
    n, q = 60_000, 9
    cols, edge_rows = _rows(n, seed=20 + nb)
    boxes, times = _payload(cols, edge_rows, q, nb, nt, seed=7 * nb + nt)
    rng = np.random.default_rng(nb)
    intervals = [np.sort(rng.integers(0, n, (int(rng.integers(1, 6)), 2)), axis=1)
                 for _ in range(q)]
    pair_q, pair_blk = intervals_to_block_pairs(intervals, JOIN_BLOCK)
    rq, rb = ref_block_pairs(intervals, JOIN_BLOCK)
    assert np.array_equal(pair_q, rq) and np.array_equal(pair_blk, rb)
    true_n = n - 1234
    want = _ref_planned(cols, true_n, pair_q, pair_blk, boxes, times)
    staged, _ = stage_columns(dict(zip(COLS, cols)), torch.device("cpu"))
    tc = [staged[c] for c in COLS]
    for fn in (planned_gather_overlap, planned_gather_overlap_plain):
        pos, hits = fn(tc, true_n, _t(pair_q.astype(np.int32)), _t(pair_blk.astype(np.int32)),
                       _t(boxes), _t(times))
        assert pos.dtype == torch.int32 and hits.dtype == torch.int64
        parts = np.split(pos.numpy(), np.cumsum(hits.numpy())[:-1])
        assert len(parts) == len(want)
        for got_p, want_p in zip(parts, want):
            assert np.array_equal(got_p, want_p)
    assert sum(len(w) for w in want) > 0


@pytest.mark.parametrize("nb,nt", CASES)
def test_planned_overlap_masks_round_trip(nb, nt):
    """The overlap count pass's masks, modelled on the CPU: each pair's
    match bits as the kernel's threads hold them (8 a thread, rows
    ``planned_overlap_rows``), regrouped by ``overlap_mask_words`` into the
    write pass's uint16 words (16 consecutive rows a word), equal the row
    mask packed directly, and the write pass's reading of them (bit j of
    word w is row 16w + j, in pair order) gives ``planned_gather_overlap_
    plain``'s positions and counts on the reference test's data."""
    n, q = 60_000, 9
    cols, edge_rows = _rows(n, seed=20 + nb)
    boxes, times = _payload(cols, edge_rows, q, nb, nt, seed=7 * nb + nt)
    rng = np.random.default_rng(nb)
    intervals = [np.sort(rng.integers(0, n, (int(rng.integers(1, 6)), 2)), axis=1)
                 for _ in range(q)]
    pair_q, pair_blk = intervals_to_block_pairs(intervals, JOIN_BLOCK)
    true_n = n - 1234
    staged, _ = stage_columns(dict(zip(COLS, cols)), torch.device("cpu"))
    tc = [staged[c] for c in COLS]
    pq, pb = _t(pair_q.astype(np.int32)), _t(pair_blk.astype(np.int32))
    want_p, want_h = kernels.planned_gather_overlap_plain(tc, true_n, pq, pb, _t(boxes),
                                                          _t(times))
    rows_of = kernels.planned_overlap_rows()  # (512, 8)
    block = [c.view(-1, JOIN_BLOCK)[pb.long()] for c in tc]
    m, _ = kernels.overlap_masks(*block, _t(boxes)[pq.long()], _t(times)[pq.long()])
    gpos = pb.long()[:, None] * JOIN_BLOCK + torch.arange(JOIN_BLOCK)
    m &= gpos < true_n  # (P, 4096): each pair's row mask
    bits = (m[:, rows_of].long() << torch.arange(8)).sum(dim=2)  # (P, 512)
    words = kernels.overlap_mask_words(bits)
    assert words.shape == (len(pair_q), JOIN_BLOCK // 16) and words.dtype == torch.int16
    direct = (m.view(len(pair_q), -1, 16).long() << torch.arange(16)).sum(dim=2)
    assert torch.equal(words.long() & 0xFFFF, direct)
    read = (words.long()[..., None] >> torch.arange(16)) & 1  # the write pass's reading
    read = read.view(len(pair_q), JOIN_BLOCK).bool()
    assert torch.equal(read.sum(dim=1), want_h)
    assert torch.equal(gpos[read].to(torch.int32), want_p)
    assert int(want_h.sum()) > 0


def test_refine_bboxes_equals_reference():
    n = 20_000
    cols, edge_rows = _rows(n, seed=31)
    boxes, times = _payload(cols, edge_rows, 4, 8, 16, seed=32)
    rng = np.random.default_rng(33)
    idx = rng.integers(0, n, 6000).astype(np.int32)
    count = 5500
    xmin, ymin, xmax, ymax, bins, offs = cols
    for k in range(4):
        want = np.asarray(ref_refine_bboxes(
            *(jnp.asarray(c) for c in (xmin, xmax, ymin, ymax, bins, offs)), jnp.asarray(idx),
            jnp.int32(count), jnp.asarray(boxes[k]), jnp.asarray(times[k])))
        got = refine_bboxes(*(_t(c) for c in cols), _t(idx).long(), count, _t(boxes[k]),
                            _t(times[k]))
        assert np.array_equal(got.numpy(), want)
        assert want.any()


def test_overlap_pad_and_live_slots():
    """The packers' overlap pad equals the reference's and matches no
    resident row; an inverted box is dead in the port's overlap predicate
    (kernels and plain versions alike), where the reference's expression
    would match a row spanning it: the packers never make one."""
    b = np.array([[5, 10, 5, 10]], np.int32)
    for slots in (1, 8):
        assert np.array_equal(pack_boxes(b, slots=slots, overlap=True),
                              ref_pack_boxes(b, slots=slots, overlap=True))
    assert np.array_equal(pack_boxes(None, overlap=True), ref_pack_boxes(None, overlap=True))
    rows = [_t(np.array(v, np.int32)) for v in
            ([0, 3, TOP, TOP], [0, 3, TOP, TOP], [TOP, 20, -1, TOP], [TOP, 20, -1, TOP])]
    rows = [rows[0][None], rows[1][None], rows[2][None], rows[3][None]]
    pad = _t(pack_boxes(np.array([[TOP, TOP, TOP, TOP]], np.int32), slots=2, overlap=True)[1:])
    m, _ = overlap_masks(*rows, None, None, pad[None], None)
    assert not m.any()
    inverted = _t(np.array([[[10, 5, 10, 5]]], np.int32))
    m, _ = overlap_masks(*rows, None, None, inverted, None)
    assert not m.any()
    # the reference's expression on the same inverted box: the spanning row 0 matches
    x0, y0, x1, y1 = (r.numpy()[0] for r in rows)
    assert ((x0 <= 5) & (x1 >= 10) & (y0 <= 5) & (y1 >= 10))[0]


@pytest.mark.parametrize("with_time", [False, True])
def test_overlap_cull_never_drops_a_match(with_time):
    """``overlap_chunk_pairs`` (over ``chunk_extents_bbox``) keeps every
    (chunk, query) pair that holds a match, and ``overlap_warp_pairs`` (the
    kernels' cull, at their unit: the 256 rows of a chunk one warp holds)
    every (warp, query) pair, stamped and padded rows included, with a
    ``base``/``true_n`` tail; a kept warp's chunk is kept; in sorted order
    both cull most pairs of small boxes."""
    n = 9 * JOIN_BLOCK + 77
    cols, edge_rows = _rows(n, seed=41)
    boxes, times = _payload(cols, edge_rows, 20, 2, 3, seed=42)
    tc = [_t(c) for c in (cols if with_time else cols[:4])]
    tm = _t(times) if with_time else None
    base, true_n = JOIN_BLOCK, JOIN_BLOCK + n - 999
    keep = overlap_chunk_pairs(tc, base, true_n, _t(boxes), tm)
    assert keep.shape == (10, 20)
    wkeep = overlap_warp_pairs(tc, base, true_n, _t(boxes), tm)
    assert wkeep.shape == (10 * 16, 20)
    assert not (wkeep.view(10, 16, 20).any(dim=1) & ~keep).any()
    for qi in range(20):
        m, _ = overlap_masks(*(c[None] for c in tc), *([None] * (6 - len(tc))),
                             _t(boxes[qi:qi + 1]), None if tm is None else tm[qi:qi + 1])
        m = m[0] & ((base + torch.arange(n)) < true_n)
        hit = torch.nonzero(m).flatten()
        hit_chunks = torch.unique(hit // JOIN_BLOCK)
        assert keep[hit_chunks, qi].all()
        hit_warps = hit // JOIN_BLOCK * 16 + hit % JOIN_BLOCK % 2048 // 128
        assert wkeep[hit_warps, qi].all()
    # without the whole-world rows, which widen every chunk they sit in,
    # narrow boxes over rows sorted by xmin keep few pairs
    b = xz_boxes(n, 43)
    clean = [norm_lon(31).normalize(b[0]), norm_lat(31).normalize(b[1]),
             norm_lon(31).normalize(b[2]), norm_lat(31).normalize(b[3])]
    order = np.argsort(clean[0], kind="stable")
    clean = [_t(c[order].astype(np.int32)) for c in clean]
    small = _t(np.ascontiguousarray(np.stack([pack_boxes(
        np.array([[int(x), int(x) + 100, 0, TOP]], np.int32), slots=1, overlap=True)
        for x in clean[0][JOIN_BLOCK // 2::JOIN_BLOCK].tolist()])))
    kept = overlap_chunk_pairs(clean, 0, n, small)
    assert float(kept.float().mean()) < 0.5
    assert float(overlap_warp_pairs(clean, 0, n, small).float().mean()) < 0.5
    assert torch.equal(batched_overlap(clean, 0, n, small) > 0, kept.any(dim=0) &
                       (batched_overlap(clean, 0, n, small) > 0))
    with pytest.raises(ValueError, match="without times"):
        overlap_chunk_pairs(tc[:4], 0, n, small, _t(times[:len(small)]))
    assert kernels.launches["batched_overlap"] == 0  # CPU tensors never launch
