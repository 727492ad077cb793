"""Device steps of the bbox+time path on one GPU.

Ports of :mod:`geomesa_tpu.parallel.query` for a single shard. Three steps
have no function of their own, as each is one call with nothing to hide:

- the batched count step (``make_batched_count_step`` ``:449``):
  ``DataStore.count_many`` calls ``ops.kernels.batched_count`` with
  ``base=0``;
- the exact batched count's fused scan (``make_batched_edge_gather_step``
  ``:342``): ``DataStore.count_many(loose=False)`` calls
  ``ops.kernels.batched_edge_gather`` with ``base=0`` (on a line or
  polygon store ``ops.kernels.batched_edge_gather_overlap``, the
  ``overlap=True`` form);
- the row select of one query (``_make_count_step`` ``:115`` /
  ``_make_gather_step`` ``:140``): ``DeviceBackend.select_positions``
  indexes the candidate slots with ``ops.refine.refine_points``, one pass
  and one boolean index. The reference splits it in two only because XLA
  needs the gather's capacity as a static shape.

The module's steps:

- :func:`repeated_count_step` — R query batches, one full pass each
  (``make_repeated_count_step`` ``:582``): one ``batched_count`` launch per
  batch, bench config 7's full scan.
- :func:`intervals_to_block_pairs` / :func:`pad_block_pairs` /
  :func:`planned_count_step` — the index-pruned resident count
  (``:675``, ``:702``, ``make_planned_count_step`` ``:716``): one
  ``planned_count`` launch per batch over its planned (query, block)
  pairs, bench config 7's pruned scan.
- :func:`intervals_to_block_pairs` / :func:`planned_gather_step` — batched
  row retrieval over the planner's candidate blocks
  (``intervals_to_block_pairs`` ``:675``, ``make_planned_gather_step``
  ``:820``), the ``select_many`` path: the ``planned_gather`` kernel, or
  over a store's bbox columns its overlap form (``overlap=True``).
- :func:`batched_overlap_step` — Q bbox-overlap counts over a line or
  polygon store's per-feature bounds (``make_batched_overlap_step``
  ``:914``, with or without time): one ``batched_overlap`` launch.
- :func:`grouped_agg_step` — the fused GROUP BY of ``aggregate_many``
  (``make_grouped_agg_step`` ``:1498``, point and overlap modes): the
  ``agg_work_list`` kernel, then one ``grouped_agg`` launch over its runs,
  or over a store's bbox columns its overlap form (``overlap=True``).
- :func:`matrix_scan_step` — the subscription matrix's fused scan
  (``make_matrix_scan_step`` ``:497``): one ``batched_count_hits`` launch,
  then the top-k of its lane scoreboard.
- :func:`batched_density_step` — Q density grids over the resident store
  (``make_batched_density_step`` ``:1193``), ``density_many``'s path: one
  ``batched_density`` launch.
- :func:`batched_knn_step` — the k nearest rows of Q points
  (``make_batched_knn_step`` ``:1125``; on one card also
  ``make_ring_knn_step`` ``:1295``), ``knn_many``'s path: one
  ``batched_knn`` launch.
- :func:`join_pairs` / :func:`block_join_step` — the block-sparse ST_Within
  count of the spatial join (``geomesa_tpu/ops/join.py:357``,
  ``make_block_join_step``): one ``polygon_join`` launch over a block
  plan's (polygon, block) pairs.
- :func:`block_bbox_gather_step` — the candidate rows of the exact join
  (``ops/join.py:247`` / ``:300``, ``make_block_bbox_count_step`` and
  ``make_block_bbox_gather_step``): each polygon's int bbox as a query
  through the ``planned_gather`` kernel, which computes the same function.
- :func:`corridor_step` — the corridor engine's band masks over N rows x
  Q corridors x S segments (``make_corridor_step`` ``:1371``): one
  ``corridor_masks`` launch. The gather form over a resident point
  state's candidate positions (``corridor_masks_gather``) is launched by
  the corridor engine itself (``trajectory/corridor.py``).

The ``cached_*`` step factories (``cached_batched_edge_gather_step``
``:441``, ``cached_matrix_scan_step`` ``:567``, ``cached_grouped_agg_step``
``:1716``, ``cached_batched_knn_step`` ``:1179``, ``cached_ring_knn_step``
``:1355``, ``cached_batched_density_step`` ``:1363``, ``cached_corridor_step``
``:1444``) have no counterparts: they memoize a compiled executable per
shape, and eager PyTorch has no compile cache to key.
"""

from __future__ import annotations

import numpy as np
import torch

from geomesa_tpu_torch.ops.kernels import (
    EDGE_CAPACITY, LANES, batched_count, batched_count_hits, batched_density, batched_knn,
    batched_overlap, block_runs, corridor_masks, grouped_agg, grouped_agg_overlap, planned_count,
    planned_gather, planned_gather_overlap, polygon_join)
from geomesa_tpu_torch.parallel.residency import JOIN_BLOCK


def intervals_to_block_pairs(intervals_per_query, block_rows: int):
    """Per-query row intervals → flat (query, block) work list.

    ``intervals_per_query``: list over queries of (k, 2) int64 arrays of
    half-open global row intervals (the planner's candidate spans). Returns
    unpadded (pair_q, pair_blk) int32 arrays, grouped by query in order with
    each query's blocks sorted and deduplicated: blocks are global row-space
    tiles of ``block_rows`` (many small z-ranges in one block collapse to
    one gather). :func:`planned_count_step` takes them padded to a common
    length by :func:`pad_block_pairs`; :func:`planned_gather_step` takes
    them as they are."""
    qs, bs = [], []
    for q, iv in enumerate(intervals_per_query):
        iv = np.asarray(iv, dtype=np.int64).reshape(-1, 2)
        iv = iv[iv[:, 1] > iv[:, 0]]
        if not len(iv):
            continue
        first = iv[:, 0] // block_rows
        lens = (iv[:, 1] - 1) // block_rows - first + 1
        # every interval's blocks first .. first + len - 1, in one array
        blks = np.unique(np.repeat(first - (np.cumsum(lens) - lens), lens)
                         + np.arange(int(lens.sum())))
        qs.append(np.full(len(blks), q, dtype=np.int32))
        bs.append(blks.astype(np.int32))
    if not qs:
        return np.empty(0, np.int32), np.empty(0, np.int32)
    return np.concatenate(qs), np.concatenate(bs)


def pad_block_pairs(pair_q, pair_blk, n_pairs: int):
    """Pad a (query, block) work list to ``n_pairs`` (``:702``): padded
    slots carry query -1, which counts nothing. Raises ``ValueError`` when
    the list is longer: truncating a cover would undercount. Config 7 pads
    each batch's list to one length so that the R batches stack into (R,
    P) arrays, as the reference's step takes them."""
    total = len(pair_q)
    if total > n_pairs:
        raise ValueError(f"{total} block pairs exceed budget {n_pairs}")
    out_q = np.full(n_pairs, -1, dtype=np.int32)
    out_b = np.zeros(n_pairs, dtype=np.int32)
    out_q[:total] = pair_q
    out_b[:total] = pair_blk
    return out_q, out_b


def repeated_count_step(cols, true_n: int, boxes_r, times_r) -> torch.Tensor:
    """R independent query batches over the resident columns, one full pass
    each (``make_repeated_count_step`` ``:582`` with one shard).

    ``cols``: the (N,) int32 ``x, y, bins, offs`` columns; ``boxes_r`` (R,
    Q, B, 4) / ``times_r`` (R, Q, T, 4) int32 payloads on the columns'
    device. Returns (R, Q) int32 counts. Each batch is one
    :func:`~geomesa_tpu_torch.ops.kernels.batched_count` launch, all on the
    current stream with no host synchronisation between them: each launch
    reads the columns once, as each iteration of the reference's
    ``lax.scan`` does, so a pass's device time is ``(t(R) - t(1)) / (R -
    1)``. The batches are not folded into one launch of R x Q queries,
    which would read the columns once for all of them."""
    if boxes_r.dim() != 4 or times_r.dim() != 4 or boxes_r.shape[:2] != times_r.shape[:2]:
        raise ValueError("boxes_r (R, Q, B, 4) and times_r (R, Q, T, 4) must share R and Q")
    return torch.stack([batched_count(*cols, 0, true_n, boxes_r[r], times_r[r])
                        for r in range(boxes_r.shape[0])])


def planned_count_step(cols, true_n: int, pair_q_r, pair_blk_r, boxes_r, times_r,
                       block_rows: int) -> torch.Tensor:
    """The index-pruned resident count (``make_planned_count_step``
    ``:716`` with one shard): R batches, each counting only its planned
    (query, block) pairs.

    ``cols``: the (N,) int32 ``x, y, bins, offs`` columns or, in the overlap
    form (``overlap=True``), ``xmin, ymin, xmax, ymax, bins, offs``, N a
    multiple of ``block_rows`` (else ``ValueError``, as the reference
    asserts); ``pair_q_r``/``pair_blk_r``: (R, P) int arrays, each row a
    batch's pairs from :func:`intervals_to_block_pairs` padded by
    :func:`pad_block_pairs` (query -1 counts nothing): host arrays, checked
    and uploaded here in one copy, or int32 tensors on the columns' device,
    taken as they are (a caller that reuses its pairs uploads them once, as
    the reference's bench does; the kernel counts a pair out of range as
    nothing); ``boxes_r`` (R, Q, B, 4) / ``times_r`` (R, Q, T, 4) int32
    payloads on the columns' device. Returns (R, Q) int32 counts, each the
    rows of its query's pairs below ``true_n`` that pass it: equal to
    :func:`repeated_count_step`'s when the pairs cover every matching row.
    One :func:`~geomesa_tpu_torch.ops.kernels.planned_count` launch per
    batch on the current stream."""
    x = cols[0]
    if x.shape[0] % block_rows:
        raise ValueError(f"per-shard rows {x.shape[0]} not a multiple of block_rows {block_rows}")
    if not isinstance(pair_q_r, torch.Tensor):
        pair_q_r = np.asarray(pair_q_r, dtype=np.int64)
        pair_blk_r = np.asarray(pair_blk_r, dtype=np.int64)
        if pair_q_r.shape != pair_blk_r.shape:
            raise ValueError("pair_q_r and pair_blk_r must be (R, P) arrays of one shape")
        live = pair_q_r >= 0
        if np.any(pair_q_r[live] >= boxes_r.shape[1]):
            raise ValueError(f"pair queries must lie in [0, {boxes_r.shape[1]}) or be -1")
        if np.any((pair_blk_r[live] < 0) | (pair_blk_r[live] >= x.shape[0] // block_rows)):
            raise ValueError(f"pair blocks must lie in [0, {x.shape[0] // block_rows})")
        pair_q_r, pair_blk_r = torch.from_numpy(
            np.stack([pair_q_r, pair_blk_r]).astype(np.int32)).to(x.device)
    if pair_q_r.dim() != 2 or pair_q_r.shape != pair_blk_r.shape:
        raise ValueError("pair_q_r and pair_blk_r must be (R, P) of one shape")
    r = pair_q_r.shape[0]
    if boxes_r.shape[0] != r or times_r.shape[0] != r:
        raise ValueError(f"{r} pair lists for {boxes_r.shape[0]} query batches")
    return torch.stack([planned_count(cols, true_n, pair_q_r[i], pair_blk_r[i], boxes_r[i],
                                      times_r[i], block_rows) for i in range(r)])


def planned_gather_step(cols, true_n: int, pair_q, pair_blk, boxes, times):
    """Batched row retrieval over planned (query, block) pairs, one shard.

    ``cols``: the (N,) int32 ``x, y, bins, offs`` columns, or a bbox
    layout's ``xmin, ymin, xmax, ymax, bins, offs`` (the overlap form,
    ``make_planned_gather_step(..., overlap=True)``: the
    ``planned_gather_overlap`` kernel), N a multiple of ``JOIN_BLOCK``
    (else ``ValueError``); ``pair_q``/``pair_blk``: host int
    arrays from :func:`intervals_to_block_pairs` with ``JOIN_BLOCK``-row
    blocks; ``boxes`` (Q, B, 4) / ``times`` (Q, T, 4) int32 payloads on the
    columns' device. Each pair's block is tested against its one query by
    :func:`~geomesa_tpu_torch.ops.kernels.planned_gather` (the
    ``planned_gather`` kernel on the card, its plain version on the CPU),
    with rows at ``true_n`` or past it masked. The host builds the pairs'
    block-major order here (``ops.kernels.block_runs``), so that the card's
    count pass reads each distinct block once. Returns ``(positions (H,) int32, pair_hits (P,) int64)``: the matching global positions in pair
    order, each pair's in row order, and each pair's match count, the
    reference's buffer order. Pairs grouped by query with sorted blocks give
    each query's positions sorted.

    The reference sizes a static XLA buffer with a count step first
    (``make_planned_count_step`` ``:716``); here the kernel's count pass
    sizes the output, and the plain version's boolean index needs none.
    The count step itself is :func:`planned_count_step`, bench config 7's
    pruned scan.
    """
    x = cols[0]
    n = x.shape[0]
    if n % JOIN_BLOCK:
        raise ValueError(f"residency not block-aligned: {n} % {JOIN_BLOCK}")
    pair_q = np.asarray(pair_q, dtype=np.int64)
    pair_blk = np.asarray(pair_blk, dtype=np.int64)
    if pair_q.shape != pair_blk.shape or pair_q.ndim != 1:
        raise ValueError("pair_q and pair_blk must be 1-D arrays of one length")
    if len(pair_q) and (pair_blk.min() < 0 or pair_blk.max() >= n // JOIN_BLOCK):
        raise ValueError(f"pair blocks must lie in [0, {n // JOIN_BLOCK})")
    if len(pair_q) and (pair_q.min() < 0 or pair_q.max() >= boxes.shape[0]):
        raise ValueError(f"pair queries must lie in [0, {boxes.shape[0]})")
    # one upload: the pair lists and their block-major plan
    p = len(pair_q)
    lists = torch.from_numpy(np.concatenate([pair_q.astype(np.int32), pair_blk.astype(np.int32),
                                             *block_runs(pair_q, pair_blk)])).to(x.device)
    if len(cols) == 6:
        return planned_gather_overlap(cols, true_n, lists[:p], lists[p:2 * p], boxes, times,
                                      plan=lists[2 * p:])
    return planned_gather(*cols, true_n, lists[:p], lists[p:2 * p], boxes, times,
                          plan=lists[2 * p:])


def batched_overlap_step(cols, true_n: int, boxes, times=None) -> torch.Tensor:
    """Q bbox-overlap counts over one shard's bbox columns
    (``make_batched_overlap_step`` ``:914``): ``cols`` (xmin, ymin, xmax,
    ymax) with ``times`` None (``with_time=False``, bench config 5's step)
    or (xmin, ymin, xmax, ymax, bins, offs) with ``times`` (Q, T, 4)
    (``with_time=True``, the loose ``count_many`` of a line or polygon
    store); ``boxes`` (Q, B, 4) packed with ``pack_boxes(...,
    overlap=True)``. Returns (Q,) int32 on the columns' device: one
    ``batched_overlap`` launch with ``base = 0``."""
    return batched_overlap(cols, 0, true_n, boxes, times)


def grouped_agg_step(cols, gid, rowid, vals, true_n: int, boxes, times, n_groups: int,
                     capacity: int = EDGE_CAPACITY, extents=None, overlap: bool = False):
    """Q filtered GROUP BY queries over one shard's resident columns, one
    fused pass: ``make_grouped_agg_step(mesh, n_groups, V, capacity,
    overlap=overlap)`` with one shard (``base = 0``, ``D = 1``), without TTL
    (the port has none).

    ``cols``: the (N,) int32 ``x, y, bins, offs`` columns, or with
    ``overlap`` a line or polygon store's ``xmin, ymin, xmax, ymax, bins,
    offs`` (the spatial test is then int-bbox overlap); ``gid`` (N,) int32
    group ids in ``[0, n_groups)``, ``rowid`` (N,) int32 original row
    indexes (int32 max on padding) and ``vals`` (V, N) float64 (NaN for
    nulls), all in the columns' sorted order; ``n_groups`` the padded group
    count (``1 << ceil(log2 G)``, as ``aggregate_many`` passes it);
    ``extents`` the columns' per-chunk extents (``IndexState.extents``;
    computed per call when None). Returns ``(cnt, first, vcnt, vsum, vmin,
    vmax, positions, hits)`` as
    :func:`~geomesa_tpu_torch.ops.kernels.grouped_agg` does: the folds over
    every matching row but the boundary rows, whose positions take the
    ``capacity`` lanes (``hits > capacity``: truncated, the caller declines
    that query). On the card the work list of kept (chunk, query) pairs in
    query-major runs, then the fold over it
    (:func:`~geomesa_tpu_torch.ops.kernels.grouped_agg_overlap` in overlap
    mode); its plain version on the CPU."""
    if len(cols) != (6 if overlap else 4):
        raise ValueError(f"{'overlap' if overlap else 'point'} mode takes "
                         f"{6 if overlap else 4} columns, got {len(cols)}")
    if overlap:
        return grouped_agg_overlap(cols, gid, rowid, vals, 0, true_n, boxes, times, n_groups,
                                   capacity, extents=extents)
    return grouped_agg(*cols, gid, rowid, vals, 0, true_n, boxes, times, n_groups, capacity,
                       extents=extents)


def matrix_scan_step(x, y, bins, offs, true_n: int, boxes, times, topk: int):
    """Q standing queries over one staged chunk, one fused pass.

    One shard (``base = 0``, ``D = 1``) of the reference step. Returns
    ``(counts (Q,) int32, positions (Q, 1, topk) int32)``: exact counts and,
    per query, the newest-first top-k of the lane scoreboard (at most one
    position per 128-row lane, -1 padded). ``x.shape[0]`` must be a
    multiple of 128, as in the reference.
    """
    n = x.shape[0]
    if n % LANES:
        raise ValueError(f"matrix scan needs rows % {LANES} == 0, got {n}")
    counts, lane_pos = batched_count_hits(x, y, bins, offs, 0, true_n, boxes, times)
    k = min(topk, LANES)
    top = torch.topk(lane_pos, k, dim=1).values
    if k < topk:
        top = torch.nn.functional.pad(top, (0, topk - k), value=-1)
    return counts, top[:, None, :]


def batched_density_step(cols, true_n: int, boxes, times, grid_bounds, width: int = 256,
                         height: int = 256):
    """Q density grids over one shard's resident columns, one pass:
    ``make_batched_density_step(mesh, width, height)`` with one shard
    (``base = 0``), its scatter form.

    ``cols``: the (N,) int32 ``x, y, bins, offs`` columns; ``boxes`` (Q, B,
    4) / ``times`` (Q, T, 4) int32 payloads and ``grid_bounds`` (Q, 4) int32
    [xlo, xhi, ylo, yhi], each query's own, all on the columns' device.
    For each query the rows inside any live box slot and any live time
    window (and below ``true_n``) add 1.0 to their cell of that query's
    grid. Returns (Q, height, width) float32. The reference's MXU one-hot
    form (``use_mxu``, a TPU's) gives the same grids; this card adds with
    atomics: :func:`~geomesa_tpu_torch.ops.kernels.batched_density`."""
    return batched_density(*cols, 0, true_n, boxes, times, grid_bounds, width, height)


KNN_IMPLS = ("map", "scan", "blocked")


def check_knn_impl(impl) -> None:
    """``_check_knn_impl`` (``:1119``): ``None`` or one of the reference's
    three sweep shapes, else ``ValueError``. The shapes return the same
    answer and the card runs one kernel for all of them, so the name is only
    validated: a misspelt one must not pass silently."""
    if impl not in (None, *KNN_IMPLS):
        raise ValueError(f"unknown KNN impl {impl!r} "
                         "(expected 'map', 'scan', or 'blocked')")


def batched_knn_step(cols, true_n: int, qx, qy, k: int, impl: str | None = None):
    """The ``k`` nearest rows of Q query points over one shard's resident
    columns, one pass: ``make_batched_knn_step(mesh, k, impl=impl)`` with
    one shard (``base = 0``), without TTL (the port has none).

    ``cols``: the (N,) int32 ``x, y`` columns (a state's first two);
    ``qx, qy``: (Q,) host query points in degrees, taken as float32 and
    uploaded to the columns' device. Returns ``(dists (Q, k) float32
    degrees ascending, rows (Q, k) int32 sorted-order positions)``, ties to
    the lower row (:func:`~geomesa_tpu_torch.ops.kernels.batched_knn`).

    On one card the reference's ring merge (``make_ring_knn_step``) has no
    hop and equals this gather merge, so ``knn_many(topology="ring")`` takes
    this step too. ``impl`` names the reference's sweep shape (``map``,
    ``scan`` or ``blocked``; None is ``map``) and is checked as loudly as
    the reference checks it (:func:`check_knn_impl`); the card runs one
    kernel for all three, and the plain version is the ``map`` form. There
    is no ``GEOMESA_KNN_IMPL`` knob."""
    check_knn_impl(impl)
    x, y = cols[0], cols[1]
    qx, qy = (torch.from_numpy(np.ascontiguousarray(v, dtype=np.float32)).to(x.device)
              for v in (qx, qy))
    return batched_knn(x, y, 0, true_n, qx, qy, k)


def join_pairs(offsets, blocks, device):
    """A block plan (``ops.join.polygon_block_plan``'s CSR ``offsets`` (K +
    1,) and ``blocks``) → ``(pair_poly, pair_blk)`` (P,) int32 tensors on
    ``device``, one upload: the plan's (polygon, block) pairs ordered by
    block (stable, so each block's polygons keep their order), so that the
    card's CTAs in flight together test the same blocks and share their
    reads in L2. The reference's padded device plan (``blk``, ``nblk``) in
    the role it plays for ``make_block_join_step``."""
    offsets = np.asarray(offsets, dtype=np.int64)
    blocks = np.asarray(blocks, dtype=np.int32)
    poly = np.repeat(np.arange(len(offsets) - 1, dtype=np.int32), np.diff(offsets))
    order = np.argsort(blocks, kind="stable")
    p = len(blocks)
    lists = torch.from_numpy(np.concatenate([poly[order], blocks[order]])).to(device)
    return lists[:p], lists[p:]


def block_join_step(x, y, true_n: int, pairs, verts, bbox, nverts, block: int):
    """The block-sparse ST_Within count, one shard:
    ``make_block_join_step(mesh, block)`` with ``D = 1`` (no psum).

    ``x, y``: (N,) float32 resident columns in degrees, z2-sorted, N a
    multiple of ``block``; ``pairs``: :func:`join_pairs` of the polygons'
    block plan; ``verts`` (K, V, 2), ``bbox`` (K, 4) and ``nverts`` (K,)
    host arrays of one vertex bucket (``ops.join.pack_polygons``),
    uploaded here as the reference uploads its per call. Each polygon
    tests only its planned blocks (rows below ``true_n``). Returns (K,)
    int32 counts: :func:`~geomesa_tpu_torch.ops.kernels.polygon_join`."""
    dev = x.device
    verts, bbox = (torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(dev)
                   for a in (verts, bbox))
    nverts = torch.from_numpy(np.ascontiguousarray(nverts, dtype=np.int32)).to(dev)
    return polygon_join(x, y, true_n, pairs[0], pairs[1], verts, nverts, bbox, block)


# the full-span time window: every (bin, offset) pair lies inside it, in the
# kernel's biased 64-bit keys (INT64_MIN to INT64_MAX) and in row_masks
FULL_WINDOW = np.array([-2**31, -2**31, 2**31 - 1, 2**31 - 1], dtype=np.int32)


def block_bbox_gather_step(cols, true_n: int, pair_q, pair_blk, iboxes):
    """The candidate rows of the exact block join, one shard: per
    (polygon, block) pair, the block's rows inside the polygon's int bbox,
    as global sorted positions (``make_block_bbox_count_step`` ``:247``
    and ``make_block_bbox_gather_step`` ``:300`` with ``D = 1``).

    ``cols``: the (N,) int32 ``x, y, bins, offs`` columns, N a multiple of
    ``JOIN_BLOCK``; ``pair_q``/``pair_blk``: host int arrays of
    ``JOIN_BLOCK``-row pairs grouped by polygon with each one's blocks
    ascending; ``iboxes`` (K, 4) int32 [xlo, xhi, ylo, yhi] in the columns'
    normalized domain. Each polygon is one query of one box and the
    full-span window (:data:`FULL_WINDOW`), so the test is the reference's
    inclusive ``xs >= xlo & xs <= xhi & ys >= ylo & ys <= yhi`` on every
    row below ``true_n``: :func:`planned_gather_step`, the ``planned_gather``
    kernel. Returns ``(positions (H,) int32, pair_hits (P,) int64)`` in
    pair order, each polygon's positions ascending. No capacity to size and
    no overflow to retry: the kernel's count pass sizes the output."""
    dev = cols[0].device
    k = len(iboxes)
    boxes = torch.from_numpy(np.ascontiguousarray(
        np.asarray(iboxes, dtype=np.int32).reshape(k, 1, 4))).to(dev)
    times = torch.from_numpy(np.tile(FULL_WINDOW, (k, 1)).reshape(k, 1, 4)).to(dev)
    return planned_gather_step(cols, true_n, pair_q, pair_blk, boxes, times)


def corridor_step(cx, cy, bins, offs, hdg, segs, tq, brg, buf2_lo, buf2_hi, tol_lo, tol_hi,
                  heading: bool, bidirectional: bool):
    """The fused corridor pass (``make_corridor_step`` ``:1371``): N rows x
    Q corridors x S segments → ``(cand, sure)``, the two f32 bands of
    :mod:`geomesa_tpu_torch.trajectory.corridor`, each (Q, ceil(N / 32))
    int32 words of one bit a row (``kernels.unpack_mask_words`` gives the
    reference's (Q, N) bools).

    ``cx, cy`` (N,) f32, ``bins, offs`` (N,) int32, ``hdg`` (N,) f32,
    ``segs`` (Q, S, 4) f32, ``tq`` (Q, S, 4) int32, ``brg`` (Q, S) f32 and
    the four (Q,) f32 bands, all tensors on one device: on the card one
    ``corridor_masks`` launch, on the CPU its plain version
    (:func:`~geomesa_tpu_torch.ops.kernels.corridor_masks`).

    The reference pads rows, segments and corridors to power-of-two buckets
    (``cached_corridor_step`` ``:1444``, ``pow2_bucket``) only so that XLA
    compiles one executable per bucket. A CUDA kernel takes any size, so
    nothing is padded here that the kernel does not need: the rows and the
    corridors come as they are, and the segments only to the batch's
    longest corridor, since (Q, S, 4) is rectangular. The payload
    sentinels that carry meaning stay: the unsatisfiable time quad ``[1, 0,
    0, -1]`` on a short corridor's padded segments, the unconstrained quad
    ``[0, -1, 2^31 - 1, 2^31 - 1]``, a negative ``buf2`` on a padded
    corridor and a tolerance of 360 or more for "no heading constraint"."""
    return corridor_masks(cx, cy, bins, offs, hdg, segs, tq, brg, buf2_lo, buf2_hi, tol_lo,
                          tol_hi, heading, bidirectional)
