"""Z2 index: points sorted by their z2 key, for spatial-only planning.

Port of :class:`geomesa_tpu.index.z2.Z2Index` (build and plan). The build
runs on the store's device: the host normalizes lon/lat to 31-bit int32,
stages them (8 B/row), the ``z2_encode`` kernel interleaves them into int64
keys there, and one stable ``torch.sort`` orders them. z2 keys are < 2^62,
so the int64 order is the unsigned order, and the stable sort gives the
reference's stable ``np.argsort(kind="stable")`` permutation, ties included.
Only the permutation and the sorted keys come back to the host.

:class:`XZ2Index` is the port of :class:`geomesa_tpu.index.z2.XZ2Index`
(``:73-108``) for extended geometries: each feature's bbox gets its XZ2
sequence code on the host (``curve/xz.py``, as in the reference), the codes
(< 2^63) are staged as int64 and one stable ``torch.sort`` orders them on
the store's device. Many boxes share an enlarged element, so codes tie far
more often than z keys; the stable sort gives the reference's stable host
sort (``native.sort_u64``) tie for tie.
"""

from __future__ import annotations

import numpy as np
import torch

from geomesa_tpu_torch.curve.sfc import Z2SFC
from geomesa_tpu_torch.curve.xz import xz2_sfc
from geomesa_tpu_torch.filter.bounds import Extraction
from geomesa_tpu_torch.index.api import (
    DEFAULT_MAX_RANGES,
    BuildClock,
    IndexPlan,
    intervals_from_key_ranges,
    merge_intervals,
)
from geomesa_tpu_torch.index.z3 import refuse_legacy
from geomesa_tpu_torch.ops.kernels import z2_encode
from geomesa_tpu_torch.schema.columnar import FeatureTable
from geomesa_tpu_torch.schema.sft import FeatureType


class Z2Index:
    name = "z2"

    def __init__(self, sft: FeatureType):
        if not self.supports(sft):
            raise ValueError("the z2 index needs a point geometry")
        refuse_legacy(sft)
        self.sft = sft
        self.sfc = Z2SFC()
        self.perm: np.ndarray | None = None  # sorted position -> table row
        self.n = 0
        self.zs: np.ndarray | None = None  # sorted (n,) uint64
        self.build_s: dict[str, float] = {}  # last build's phase seconds

    @staticmethod
    def supports(sft: FeatureType) -> bool:
        return sft.geom_is_points

    def _normalized(self, table: FeatureTable):
        col = table.geom_column()
        return self.sfc.normalized(col.x, col.y)

    def build(self, table: FeatureTable, device: torch.device) -> np.ndarray:
        """Encode and sort on ``device``; keep the permutation and the sorted
        host keys planning needs. ``build_s`` gets the phase seconds."""
        clock = BuildClock(device)
        cols = self._normalized(table)
        clock.lap("normalize")
        d_cols = [torch.from_numpy(c).to(device) for c in cols]
        clock.lap("stage")
        z = clock.kernel("encode", lambda: z2_encode(*d_cols))
        del d_cols
        zs, d_perm = torch.sort(z, stable=True)
        clock.lap("sort")
        perm = d_perm.cpu().numpy()
        zs = zs.cpu().numpy().view(np.uint64)
        clock.lap("copy_back")
        self.build_s = clock.phases
        return self._install(zs, perm)

    def install(self, table: FeatureTable, perm: np.ndarray) -> np.ndarray:
        """Adopt a permutation computed elsewhere (the reference store's),
        without re-sorting; it must order the table by z. Runs on the host:
        the keys come from ``z2_encode`` on CPU tensors."""
        cols = self._normalized(table)
        z = z2_encode(*(torch.from_numpy(c) for c in cols)).numpy().view(np.uint64)
        perm = np.asarray(perm, dtype=np.int64)
        if len(perm) != len(table):
            raise ValueError(f"perm length {len(perm)} != table rows {len(table)}")
        sz = z[perm]
        if len(perm) > 1 and not np.all(sz[:-1] <= sz[1:]):
            raise ValueError("perm does not sort the table by z")
        self.build_s = {}
        return self._install(sz, perm)

    def _install(self, sorted_zs, perm) -> np.ndarray:
        self.perm = perm
        self.zs = sorted_zs
        self.n = len(perm)
        return perm

    def plan(self, e: Extraction, max_ranges: int = DEFAULT_MAX_RANGES) -> IndexPlan:
        if e.disjoint or self.n == 0:
            return IndexPlan.empty()
        if e.boxes is None:
            return IndexPlan.full(self.n)
        zranges = self.sfc.ranges(e.boxes, max_ranges)
        return IndexPlan(merge_intervals(intervals_from_key_ranges(self.zs, zranges)))


class XZ2Index:
    """XZ2: each extended geometry's bbox as an XZ2 sequence code, for
    spatial-only planning. ``merge_build`` (the delta tier's merge) is not
    carried."""

    name = "xz2"

    def __init__(self, sft: FeatureType):
        if not self.supports(sft):
            raise ValueError("the xz2 index needs an extended (non-point) geometry")
        refuse_legacy(sft)
        self.sft = sft
        self.sfc = xz2_sfc(sft.xz_precision)
        self.perm: np.ndarray | None = None  # sorted position -> table row
        self.n = 0
        self.codes: np.ndarray | None = None  # sorted (n,) uint64
        self.build_s: dict[str, float] = {}  # last build's phase seconds

    @staticmethod
    def supports(sft: FeatureType) -> bool:
        return sft.geom_field is not None and not sft.geom_is_points

    def _codes(self, table: FeatureTable) -> np.ndarray:
        b = table.geom_column().bounds
        return self.sfc.index((b[:, 0], b[:, 1]), (b[:, 2], b[:, 3]))

    def build(self, table: FeatureTable, device: torch.device) -> np.ndarray:
        """Code on the host, sort on ``device``; keep the permutation and
        the sorted host codes planning needs. ``build_s`` gets the phase
        seconds (``encode`` on the host clock)."""
        clock = BuildClock(device)
        codes = self._codes(table)
        clock.lap("encode")
        d_codes = torch.from_numpy(codes.view(np.int64)).to(device)
        clock.lap("stage")
        _, d_perm = torch.sort(d_codes, stable=True)
        clock.lap("sort")
        perm = d_perm.cpu().numpy()
        clock.lap("copy_back")
        self.build_s = clock.phases
        return self._install(codes[perm], perm)

    def install(self, table: FeatureTable, perm: np.ndarray) -> np.ndarray:
        """Adopt a permutation computed elsewhere (the reference store's),
        without re-sorting; it must order the table by code."""
        codes = self._codes(table)
        perm = np.asarray(perm, dtype=np.int64)
        if len(perm) != len(table):
            raise ValueError(f"perm length {len(perm)} != table rows {len(table)}")
        sc = codes[perm]
        if len(perm) > 1 and not np.all(sc[:-1] <= sc[1:]):
            raise ValueError("perm does not sort the table by xz2 code")
        self.build_s = {}
        return self._install(sc, perm)

    def _install(self, sorted_codes, perm) -> np.ndarray:
        self.perm = perm
        self.codes = sorted_codes
        self.n = len(perm)
        return perm

    def plan(self, e: Extraction, max_ranges: int = DEFAULT_MAX_RANGES) -> IndexPlan:
        if e.disjoint or self.n == 0:
            return IndexPlan.empty()
        if e.boxes is None:
            return IndexPlan.full(self.n)
        windows = [((x1, y1), (x2, y2)) for x1, y1, x2, y2 in e.boxes]
        cranges = self.sfc.ranges(windows, max_ranges)
        return IndexPlan(merge_intervals(intervals_from_key_ranges(self.codes, cranges)))
