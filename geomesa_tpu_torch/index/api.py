"""Index API: sort permutations and filter bounds → sorted-row intervals.

Port copy of :mod:`geomesa_tpu.index.api`. An index is (a) a permutation
that sorts the table by its key order and (b) a planner from extracted
filter bounds to ``[start, end)`` intervals in that sorted order — the scan
IR the device gathers candidate rows from.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

DEFAULT_MAX_RANGES = 2000  # range budget per query (ScanRangesTarget default)


@dataclass
class IndexPlan:
    """Scan plan: ``intervals`` is (R, 2) int64 ``[start, end)`` in
    sorted-row positions."""

    intervals: np.ndarray

    @property
    def n_candidates(self) -> int:
        if len(self.intervals) == 0:
            return 0
        return int((self.intervals[:, 1] - self.intervals[:, 0]).sum())

    @staticmethod
    def empty() -> "IndexPlan":
        return IndexPlan(np.empty((0, 2), dtype=np.int64))

    @staticmethod
    def full(n: int) -> "IndexPlan":
        return IndexPlan(np.array([[0, n]], dtype=np.int64))


def intervals_from_key_ranges(
    sorted_keys: np.ndarray, ranges: np.ndarray, offset: int = 0
) -> list[tuple[int, int]]:
    """Map inclusive key ranges to [start, end) positions by binary search."""
    if len(ranges) == 0 or len(sorted_keys) == 0:
        return []
    starts = np.searchsorted(sorted_keys, ranges[:, 0], side="left") + offset
    ends = np.searchsorted(sorted_keys, ranges[:, 1], side="right") + offset
    keep = ends > starts
    return list(zip(starts[keep].tolist(), ends[keep].tolist()))


def merge_intervals(intervals: list[tuple[int, int]]) -> np.ndarray:
    """Sort + coalesce overlapping/adjacent [start, end) intervals."""
    if not intervals:
        return np.empty((0, 2), dtype=np.int64)
    intervals.sort()
    out = [list(intervals[0])]
    for s, e in intervals[1:]:
        if s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return np.asarray(out, dtype=np.int64)


def gather_indices(intervals: np.ndarray, device=None) -> tuple[torch.Tensor, int]:
    """Expand [start, end) intervals into a flat array of row positions:
    (idx int64 tensor on ``device``, the CPU by default; count). The (R, 2)
    intervals are uploaded (16 B each, not 8 B a slot) and expanded there.
    Torch needs no padded shape buckets, so the reference's ``pad_to`` is
    not carried."""
    device = torch.device("cpu") if device is None else device
    if len(intervals) == 0:
        return torch.zeros(0, dtype=torch.int64, device=device), 0
    iv = torch.from_numpy(np.ascontiguousarray(intervals, dtype=np.int64)).to(device)
    lens = iv[:, 1] - iv[:, 0]
    total = int((intervals[:, 1] - intervals[:, 0]).sum())  # the host's copy: no sync
    first = torch.cumsum(lens, 0) - lens  # each interval's first slot
    idx = torch.repeat_interleave(iv[:, 0] - first, lens, output_size=total)
    return idx + torch.arange(total, device=device), total



class BuildClock:
    """Seconds per phase of one index build on ``device``.

    :meth:`lap` closes a phase on the host clock, after synchronizing the
    card so that queued device work is charged to the phase that queued it;
    :meth:`kernel` times one kernel call with CUDA events on the card (the
    host clock on the CPU)."""

    def __init__(self, device: torch.device):
        self.device = device
        self.phases: dict[str, float] = {}
        self._t = time.perf_counter()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def lap(self, name: str) -> None:
        self._sync()
        now = time.perf_counter()
        self.phases[name] = now - self._t
        self._t = now

    def kernel(self, name: str, fn):
        """Run ``fn()`` as phase ``name``; returns its result."""
        self._sync()
        if self.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn()
            end.record()
            end.synchronize()
            self.phases[name] = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            out = fn()
            self.phases[name] = time.perf_counter() - t0
        self._t = time.perf_counter()
        return out
