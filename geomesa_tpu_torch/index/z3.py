"""Z3 index: points + time, sorted by (time bin, z3 key).

Port of :class:`geomesa_tpu.index.z3.Z3Index` (build and plan) and
``time_windows``. Bins are contiguous sorted-row spans; planning splits the
range budget across the bins a query touches and binary-searches each bin's
sorted z keys.

The build runs on the store's device: the host normalizes lon/lat/offset to
int32, stages them (12 B/row), the ``z3_encode`` kernel interleaves them
into int64 keys there, and two stable ``torch.sort`` passes (by z, then by
bin) give the same permutation as the reference's stable host ``lexsort``
by (bin, z) — z3 keys are < 2^63, so they sort as int64. Only the
permutation and the sorted keys come back to the host.

:class:`XZ3Index` is the port of :class:`geomesa_tpu.index.z3.XZ3Index`
(``:208-307``) for extended geometries with a date: each feature's bbox and
time offset get an XZ3 sequence code on the host (``curve/xz.py``), and
:func:`sort_bin_z` orders (bin, code) on the store's device, tie for tie as
the reference's stable host sort.
"""

from __future__ import annotations

import numpy as np
import torch

from geomesa_tpu_torch.curve.binned_time import BinnedTime
from geomesa_tpu_torch.curve.sfc import z3_sfc
from geomesa_tpu_torch.curve.xz import xz3_sfc
from geomesa_tpu_torch.filter.bounds import Extraction
from geomesa_tpu_torch.index.api import (
    DEFAULT_MAX_RANGES,
    BuildClock,
    IndexPlan,
    intervals_from_key_ranges,
    merge_intervals,
)
from geomesa_tpu_torch.ops.kernels import z3_encode
from geomesa_tpu_torch.schema.columnar import FeatureTable
from geomesa_tpu_torch.schema.sft import FeatureType

WORLD = (-180.0, -90.0, 180.0, 90.0)


def refuse_legacy(sft: FeatureType) -> None:
    """The legacy curves (``geomesa.index.layout=legacy``) are not ported:
    keying such a schema with the current curves would give other keys than
    the reference's, so it is refused."""
    if sft.index_layout == "legacy":
        raise NotImplementedError(
            "geomesa.index.layout=legacy needs the legacy curves, which this "
            "port does not carry yet"
        )


def sort_bin_z(bins: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Stable permutation sorting rows by (bin, z), on the tensors' device."""
    _, by_z = torch.sort(z, stable=True)
    _, by_bin = torch.sort(bins[by_z], stable=True)
    return by_z[by_bin]


def time_windows(
    binned: BinnedTime, bin_values: np.ndarray, intervals
) -> list[tuple[int, int, int]]:
    """Expand temporal bounds into per-bin (bin, off_lo, off_hi) windows,
    clipped to the bins present in the data."""
    if len(bin_values) == 0:
        return []
    max_off = int(binned.max_offset)
    if intervals is None:
        return [(int(b), 0, max_off) for b in bin_values]
    out = []
    for lo_ms, hi_ms in intervals:
        lo_ms = max(int(lo_ms), 0)
        # clamp to the last millisecond of the last bin present
        hi_ms = min(
            int(hi_ms),
            int(binned.bin_start_millis(np.array([int(bin_values[-1]) + 1]))[0]) - 1,
        )
        if hi_ms < lo_ms:
            continue
        (blo,), (olo,) = binned.to_bin_and_offset(np.array([lo_ms]))
        (bhi,), (ohi,) = binned.to_bin_and_offset(np.array([hi_ms]))
        sel = (bin_values >= blo) & (bin_values <= bhi)
        for b in bin_values[sel]:
            w_lo = int(olo) if b == blo else 0
            w_hi = int(ohi) if b == bhi else max_off
            out.append((int(b), w_lo, w_hi))
    return out


class Z3Index:
    name = "z3"

    def __init__(self, sft: FeatureType):
        if not self.supports(sft):
            raise ValueError("the z3 index needs a point geometry and a date")
        refuse_legacy(sft)
        self.sft = sft
        self.binned = BinnedTime(sft.z3_interval)
        self.sfc = z3_sfc(sft.z3_interval)
        self.perm: np.ndarray | None = None  # sorted position -> table row
        self.n = 0
        self.bins: np.ndarray | None = None  # sorted (n,) int32
        self.zs: np.ndarray | None = None  # sorted (n,) uint64
        self.bin_values: np.ndarray | None = None  # unique bins present
        self.bin_starts: np.ndarray | None = None  # row span start per bin
        self.build_s: dict[str, float] = {}  # last build's phase seconds

    @staticmethod
    def supports(sft: FeatureType) -> bool:
        return sft.geom_is_points and sft.dtg_field is not None

    def _normalized(self, table: FeatureTable):
        col = table.geom_column()
        bins, offs = self.binned.to_bin_and_offset(table.dtg_millis())
        return bins.astype(np.int32), self.sfc.normalized(col.x, col.y, offs)

    def build(self, table: FeatureTable, device: torch.device) -> np.ndarray:
        """Encode and sort on ``device``; keep the permutation and the sorted
        host keys planning needs. ``build_s`` gets the phase seconds."""
        clock = BuildClock(device)
        bins, cols = self._normalized(table)
        clock.lap("normalize")
        d_cols = [torch.from_numpy(c).to(device) for c in cols]
        d_bins = torch.from_numpy(bins).to(device)
        clock.lap("stage")
        z = clock.kernel("encode", lambda: z3_encode(*d_cols))
        del d_cols
        d_perm = sort_bin_z(d_bins, z)
        d_zs, d_sbins = z[d_perm], d_bins[d_perm]
        d_values, d_counts = torch.unique_consecutive(d_sbins, return_counts=True)
        clock.lap("sort")
        perm = d_perm.cpu().numpy()
        zs = d_zs.cpu().numpy().view(np.uint64)
        sorted_bins, values = d_sbins.cpu().numpy(), d_values.cpu().numpy()
        starts = np.cumsum(d_counts.cpu().numpy()) - d_counts.cpu().numpy()
        clock.lap("copy_back")
        self.build_s = clock.phases
        return self._install(perm, sorted_bins, zs, values, starts)

    def install(self, table: FeatureTable, perm: np.ndarray) -> np.ndarray:
        """Adopt a permutation computed elsewhere (the reference store's),
        without re-sorting; it must order the table by (bin, z). Runs on the
        host: the keys come from ``z3_encode`` on CPU tensors."""
        bins, cols = self._normalized(table)
        z = z3_encode(*(torch.from_numpy(c) for c in cols)).numpy().view(np.uint64)
        perm = np.asarray(perm, dtype=np.int64)
        if len(perm) != len(table):
            raise ValueError(f"perm length {len(perm)} != table rows {len(table)}")
        sb, sz = bins[perm], z[perm]
        if len(perm) > 1 and not np.all(
            (sb[:-1] < sb[1:]) | ((sb[:-1] == sb[1:]) & (sz[:-1] <= sz[1:]))
        ):
            raise ValueError("perm does not sort the table by (bin, z)")
        self.build_s = {}
        return self._install(perm, sb, sz, *np.unique(sb, return_index=True))

    def _install(self, perm, sorted_bins, sorted_zs, bin_values, bin_starts) -> np.ndarray:
        self.perm = perm
        self.bins = sorted_bins
        self.zs = sorted_zs
        self.n = len(perm)
        self.bin_values, self.bin_starts = bin_values, bin_starts
        return perm

    def _bin_span(self, b: int) -> tuple[int, int]:
        i = np.searchsorted(self.bin_values, b)
        if i == len(self.bin_values) or self.bin_values[i] != b:
            return (0, 0)
        start = int(self.bin_starts[i])
        end = int(self.bin_starts[i + 1]) if i + 1 < len(self.bin_starts) else self.n
        return (start, end)

    def plan(self, e: Extraction, max_ranges: int = DEFAULT_MAX_RANGES) -> IndexPlan:
        if e.disjoint or self.n == 0:
            return IndexPlan.empty()
        boxes = e.boxes if e.boxes is not None else [WORLD]
        windows = time_windows(self.binned, self.bin_values, e.intervals)
        if not windows:
            return IndexPlan.empty()
        budget = max(1, max_ranges // max(1, len(windows)))
        out: list[tuple[int, int]] = []
        for b, w_lo, w_hi in windows:
            start, end = self._bin_span(b)
            if end <= start:
                continue
            zranges = self.sfc.ranges(boxes, (float(w_lo), float(w_hi)), budget)
            out.extend(
                intervals_from_key_ranges(self.zs[start:end], zranges, offset=start)
            )
        return IndexPlan(merge_intervals(out))


class XZ3Index:
    """XZ3: bbox of the geometry + time instant, for extended geometries
    with a date. ``merge_build`` (the delta tier's merge) is not carried."""

    name = "xz3"

    def __init__(self, sft: FeatureType):
        if not self.supports(sft):
            raise ValueError("the xz3 index needs an extended (non-point) geometry and a date")
        refuse_legacy(sft)
        self.sft = sft
        self.binned = BinnedTime(sft.z3_interval)
        self.sfc = xz3_sfc(sft.z3_interval, sft.xz_precision)
        self.perm: np.ndarray | None = None  # sorted position -> table row
        self.n = 0
        self.bins: np.ndarray | None = None  # sorted (n,) int32
        self.codes: np.ndarray | None = None  # sorted (n,) uint64
        self.bin_values: np.ndarray | None = None  # unique bins present
        self.bin_starts: np.ndarray | None = None  # row span start per bin
        self.build_s: dict[str, float] = {}  # last build's phase seconds

    @staticmethod
    def supports(sft: FeatureType) -> bool:
        return (sft.geom_field is not None and not sft.geom_is_points
                and sft.dtg_field is not None)

    def _keys(self, table: FeatureTable):
        b = table.geom_column().bounds
        bins, offs = self.binned.to_bin_and_offset(table.dtg_millis())
        o = offs.astype(np.float64)
        return bins.astype(np.int32), self.sfc.index((b[:, 0], b[:, 1], o), (b[:, 2], b[:, 3], o))

    def build(self, table: FeatureTable, device: torch.device) -> np.ndarray:
        """Code on the host, sort (bin, code) on ``device``; keep what
        planning needs. ``build_s`` gets the phase seconds (``encode`` on
        the host clock)."""
        clock = BuildClock(device)
        bins, codes = self._keys(table)
        clock.lap("encode")
        d_codes = torch.from_numpy(codes.view(np.int64)).to(device)
        d_bins = torch.from_numpy(bins).to(device)
        clock.lap("stage")
        d_perm = sort_bin_z(d_bins, d_codes)
        clock.lap("sort")
        perm = d_perm.cpu().numpy()
        clock.lap("copy_back")
        self.build_s = clock.phases
        sb = bins[perm]
        return self._install(perm, sb, codes[perm], *np.unique(sb, return_index=True))

    def install(self, table: FeatureTable, perm: np.ndarray) -> np.ndarray:
        """Adopt a permutation computed elsewhere (the reference store's),
        without re-sorting; it must order the table by (bin, code)."""
        bins, codes = self._keys(table)
        perm = np.asarray(perm, dtype=np.int64)
        if len(perm) != len(table):
            raise ValueError(f"perm length {len(perm)} != table rows {len(table)}")
        sb, sc = bins[perm], codes[perm]
        if len(perm) > 1 and not np.all(
            (sb[:-1] < sb[1:]) | ((sb[:-1] == sb[1:]) & (sc[:-1] <= sc[1:]))
        ):
            raise ValueError("perm does not sort the table by (bin, xz3 code)")
        self.build_s = {}
        return self._install(perm, sb, sc, *np.unique(sb, return_index=True))

    def _install(self, perm, sorted_bins, sorted_codes, bin_values, bin_starts) -> np.ndarray:
        self.perm = perm
        self.bins = sorted_bins
        self.codes = sorted_codes
        self.n = len(perm)
        self.bin_values, self.bin_starts = bin_values, bin_starts
        return perm

    _bin_span = Z3Index._bin_span

    def plan(self, e: Extraction, max_ranges: int = DEFAULT_MAX_RANGES) -> IndexPlan:
        if e.disjoint or self.n == 0:
            return IndexPlan.empty()
        boxes = e.boxes if e.boxes is not None else [WORLD]
        windows = time_windows(self.binned, self.bin_values, e.intervals)
        if not windows:
            return IndexPlan.empty()
        budget = max(1, max_ranges // max(1, len(windows)))
        out: list[tuple[int, int]] = []
        for b, w_lo, w_hi in windows:
            start, end = self._bin_span(b)
            if end <= start:
                continue
            wins = [((x1, y1, float(w_lo)), (x2, y2, float(w_hi))) for x1, y1, x2, y2 in boxes]
            cranges = self.sfc.ranges(wins, budget)
            out.extend(intervals_from_key_ranges(self.codes[start:end], cranges, offset=start))
        return IndexPlan(merge_intervals(out))
