"""The Z2 and Z3 space-filling curves: points, and points + binned time.

Port copy of :mod:`geomesa_tpu.curve.sfc` (``Z2SFC``, ``Z3SFC``):
``normalized(...)`` gives the int32 fixed-point coordinates the index
builds hand to the ``z2_encode``/``z3_encode`` kernels; ``index(...)``
encodes on the host with numpy and is kept as the referee the tests hold the
kernels to; ``ranges(...)`` plans key ranges with
:func:`geomesa_tpu_torch.curve.zranges.zranges` (the native BFS), one call
per box.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np

from geomesa_tpu_torch.curve import normalize, zorder
from geomesa_tpu_torch.curve.binned_time import MAX_OFFSET, TimePeriod
from geomesa_tpu_torch.curve.zranges import merge_ranges, zranges


def split_antimeridian(bboxes):
    """Split (xmin, ymin, xmax, ymax) boxes whose lon bounds wrap the
    antimeridian (xmin > xmax) into two; reject inverted latitude bounds."""
    out = []
    for xmin, ymin, xmax, ymax in bboxes:
        if ymin > ymax:
            raise ValueError(f"inverted latitude bounds: [{ymin}, {ymax}]")
        if xmin > xmax:
            out.append((xmin, ymin, 180.0, ymax))
            out.append((-180.0, ymin, xmax, ymax))
        else:
            out.append((xmin, ymin, xmax, ymax))
    return out


def _union(ranges: list[np.ndarray]) -> np.ndarray:
    """The merged union of per-box z ranges: one box's sorted, merged
    output as it is, else :func:`merge_ranges` of them all."""
    if len(ranges) == 1:
        return ranges[0]
    return merge_ranges([(int(a), int(b)) for r in ranges for a, b in r])


@dataclass(frozen=True)
class Z2SFC:
    """2-D Morton curve over (lon, lat); 31 bits/dim."""

    precision: int = 31

    @property
    def lon(self) -> normalize.NormalizedDimension:
        return normalize.lon(self.precision)

    @property
    def lat(self) -> normalize.NormalizedDimension:
        return normalize.lat(self.precision)

    def index(self, x, y) -> np.ndarray:
        """(lon, lat) f64 arrays → uint64 z2 codes (host referee)."""
        return zorder.encode2(self.lon.normalize(x), self.lat.normalize(y))

    def normalized(self, x, y) -> tuple[np.ndarray, np.ndarray]:
        """(lon, lat) → int32 fixed-point coordinates, the kernel's input."""
        return (self.lon.normalize(x).astype(np.int32),
                self.lat.normalize(y).astype(np.int32))

    def ranges(self, bboxes, max_ranges: int = 2000) -> np.ndarray:
        """Cover (xmin, ymin, xmax, ymax) boxes with z2 intervals (uint64 (R, 2))."""
        bboxes = split_antimeridian(bboxes)
        out = []
        budget = max(1, max_ranges // max(1, len(bboxes)))
        for xmin, ymin, xmax, ymax in bboxes:
            lo = (int(self.lon.normalize(xmin)), int(self.lat.normalize(ymin)))
            hi = (int(self.lon.normalize(xmax)), int(self.lat.normalize(ymax)))
            out.append(zranges(lo, hi, self.precision, budget))
        return _union(out)


@dataclass(frozen=True)
class Z3SFC:
    """3-D Morton curve over (lon, lat, offset-in-bin); 21 bits/dim. The time
    bin itself lives outside the curve, as the leading sort key."""

    period: TimePeriod = TimePeriod.WEEK
    precision: int = 21

    @property
    def lon(self) -> normalize.NormalizedDimension:
        return normalize.lon(self.precision)

    @property
    def lat(self) -> normalize.NormalizedDimension:
        return normalize.lat(self.precision)

    @property
    def time(self) -> normalize.NormalizedDimension:
        return normalize.time(self.precision, MAX_OFFSET[self.period])

    def index(self, x, y, t_offset) -> np.ndarray:
        """(lon, lat, offset-in-bin) → uint64 z3 codes (host referee)."""
        return zorder.encode3(
            self.lon.normalize(x), self.lat.normalize(y), self.time.normalize(t_offset)
        )

    def normalized(self, x, y, t_offset) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(lon, lat, offset-in-bin) → int32 fixed-point coordinates, the
        kernel's input."""
        return (self.lon.normalize(x).astype(np.int32),
                self.lat.normalize(y).astype(np.int32),
                self.time.normalize(t_offset).astype(np.int32))

    def ranges(self, bboxes, time_offsets, max_ranges: int = 2000) -> np.ndarray:
        """Cover boxes × one bin's [tmin, tmax] offset window with z3
        intervals (the caller splits the range budget across bins)."""
        bboxes = split_antimeridian(bboxes)
        tmin, tmax = time_offsets
        tlo = int(self.time.normalize(tmin))
        thi = int(self.time.normalize(tmax))
        out = []
        budget = max(1, max_ranges // max(1, len(bboxes)))
        for xmin, ymin, xmax, ymax in bboxes:
            lo = (int(self.lon.normalize(xmin)), int(self.lat.normalize(ymin)), tlo)
            hi = (int(self.lon.normalize(xmax)), int(self.lat.normalize(ymax)), thi)
            out.append(zranges(lo, hi, self.precision, budget))
        return _union(out)


@lru_cache(maxsize=None)
def z3_sfc(period: TimePeriod) -> Z3SFC:
    """Singleton Z3 curve per time period."""
    return Z3SFC(period=period)
