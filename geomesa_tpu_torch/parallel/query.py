"""Device steps of the bbox+time path on one GPU.

Ports of :mod:`geomesa_tpu.parallel.query` for a single shard. The batched
count step (``make_batched_count_step`` ``:449``) has no function of its own:
``DataStore.count_many`` calls ``ops.kernels.batched_count`` with ``base=0``.

- :func:`select_count` / :func:`select_gather` — the two-pass row select
  (``_make_count_step`` ``:115`` / ``_make_gather_step`` ``:140``): refine
  the planned candidate slots, count the hits, then compact the matching
  sorted positions into ``capacity`` lanes by a prefix sum. The reference
  computes these in XLA outside any Pallas kernel; here they are torch ops.
- :func:`matrix_scan_step` — the subscription matrix's fused scan
  (``make_matrix_scan_step`` ``:497``): one ``batched_count_hits`` launch,
  then the top-k of its lane scoreboard. ``cached_matrix_scan_step``
  (``:567``) has no counterpart: it memoizes a compiled executable per
  capacity bucket, and eager PyTorch has no compile cache to key.
"""

from __future__ import annotations

import torch

from geomesa_tpu_torch.ops.kernels import LANES, batched_count_hits
from geomesa_tpu_torch.ops.refine import refine_points


def select_count(x, y, bins, offs, idx, count: int, boxes, times) -> torch.Tensor:
    """Pass 1: number of candidate slots passing the int-domain refine."""
    return refine_points(x, y, bins, offs, idx, count, boxes, times).sum()


def select_gather(x, y, bins, offs, idx, count: int, boxes, times, capacity: int):
    """Pass 2: refine + stable stream compaction of matching sorted-row
    positions into ``capacity`` lanes. Returns (positions (capacity,) int32,
    -1 past the hits; hits () int64 — may exceed ``capacity``, whose lanes
    then hold the first ``capacity`` matches)."""
    mask = refine_points(x, y, bins, offs, idx, count, boxes, times)
    dest = torch.cumsum(mask.to(torch.int64), dim=0) - 1
    keep = mask & (dest < capacity)
    out = torch.full((capacity,), -1, dtype=torch.int32, device=x.device)
    out[dest[keep]] = idx[keep].to(torch.int32)
    return out, mask.sum()


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
