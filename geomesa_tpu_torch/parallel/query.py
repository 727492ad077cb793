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

- :func:`intervals_to_block_pairs` / :func:`planned_gather_step` — batched
  row retrieval over the planner's candidate blocks
  (``intervals_to_block_pairs`` ``:675``, ``make_planned_gather_step``
  ``:820``), the ``select_many`` path: the ``planned_gather`` kernel, or
  over a store's bbox columns its overlap form (``overlap=True``).
- :func:`batched_overlap_step` — Q bbox-overlap counts over a line or
  polygon store's per-feature bounds (``make_batched_overlap_step``
  ``:914``, with or without time): one ``batched_overlap`` launch.
- :func:`grouped_agg_step` — the fused GROUP BY of ``aggregate_many``
  (``make_grouped_agg_step`` ``:1498``, point mode): the ``agg_work_list``
  kernel, then one ``grouped_agg`` launch over its runs.
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

The ``cached_*`` step factories (``cached_batched_edge_gather_step``
``:441``, ``cached_matrix_scan_step`` ``:567``, ``cached_grouped_agg_step``
``:1716``, ``cached_batched_knn_step`` ``:1179``, ``cached_ring_knn_step``
``:1355``, ``cached_batched_density_step`` ``:1363``) have no counterparts: they
memoize a compiled executable per shape, and eager PyTorch has no compile
cache to key.
"""

from __future__ import annotations

import numpy as np
import torch

from geomesa_tpu_torch.ops.kernels import (
    EDGE_CAPACITY, LANES, batched_count_hits, batched_density, batched_knn, batched_overlap,
    block_runs, grouped_agg, planned_gather, planned_gather_overlap, polygon_join)
from geomesa_tpu_torch.parallel.residency import JOIN_BLOCK


def intervals_to_block_pairs(intervals_per_query, block_rows: int):
    """Per-query row intervals → flat (query, block) work list.

    ``intervals_per_query``: list over queries of (k, 2) int64 arrays of
    half-open global row intervals (the planner's candidate spans). Returns
    unpadded (pair_q, pair_blk) int32 arrays, grouped by query in order with
    each query's blocks sorted and deduplicated: blocks are global row-space
    tiles of ``block_rows`` (many small z-ranges in one block collapse to
    one gather). The reference's ``pad_block_pairs`` (``:702``) has no
    counterpart: eager shapes need no compile-time budget."""
    qs, bs = [], []
    for q, iv in enumerate(intervals_per_query):
        iv = np.asarray(iv, dtype=np.int64).reshape(-1, 2)
        spans = [
            np.arange(a // block_rows, (b - 1) // block_rows + 1)
            for a, b in iv if b > a
        ]
        if not spans:
            continue
        blks = np.unique(np.concatenate(spans))
        qs.append(np.full(len(blks), q, dtype=np.int32))
        bs.append(blks.astype(np.int32))
    if not qs:
        return np.empty(0, np.int32), np.empty(0, np.int32)
    return np.concatenate(qs), np.concatenate(bs)


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

    There is no count step: the reference's (``make_planned_count_step``
    ``:716``) sizes a static XLA buffer; here the kernel's count pass sizes
    the output, and the plain version's boolean index needs none.
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
                     capacity: int = EDGE_CAPACITY, extents=None):
    """Q filtered GROUP BY queries over one shard's resident columns, one
    fused pass: ``make_grouped_agg_step(mesh, n_groups, V, capacity)`` in
    point mode with one shard (``base = 0``, ``D = 1``), without TTL
    (the port has none) and without the overlap mode (no XZ layout yet).

    ``cols``: the (N,) int32 ``x, y, bins, offs`` columns; ``gid`` (N,)
    int32 group ids in ``[0, n_groups)``, ``rowid`` (N,) int32 original row
    indexes (int32 max on padding) and ``vals`` (V, N) float64 (NaN for
    nulls), all in the columns' sorted order; ``n_groups`` the padded group
    count (``1 << ceil(log2 G)``, as ``aggregate_many`` passes it);
    ``extents`` the columns' per-chunk extents (``IndexState.extents``;
    computed per call when None). Returns
    ``(cnt, first, vcnt, vsum, vmin, vmax, positions, hits)`` as
    :func:`~geomesa_tpu_torch.ops.kernels.grouped_agg` does: the folds over
    every matching row but the boundary rows, whose positions take the
    ``capacity`` lanes (``hits > capacity``: truncated, the caller declines
    that query). On the card the work list of kept (chunk, query) pairs in
    query-major runs, then the fold over it; its plain version on the
    CPU."""
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
