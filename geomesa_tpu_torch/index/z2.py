"""Z2 index: points sorted by their z2 key, for spatial-only planning.

Port of :class:`geomesa_tpu.index.z2.Z2Index` (build and plan). The build
runs on the store's device: the host normalizes lon/lat to 31-bit int32,
stages them (8 B/row), the ``z2_encode`` kernel interleaves them into int64
keys there, and one stable ``torch.sort`` orders them. z2 keys are < 2^62,
so the int64 order is the unsigned order, and the stable sort gives the
reference's stable ``np.argsort(kind="stable")`` permutation, ties included.
Only the permutation and the sorted keys come back to the host.
"""

from __future__ import annotations

import numpy as np
import torch

from geomesa_tpu_torch.curve.sfc import Z2SFC
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
