"""XZ-ordering curves for objects with spatial extension (lines/polygons).

Port copy of :mod:`geomesa_tpu.curve.xz` (Boehm/Klump/Kriegel "XZ-Ordering: A
Space-Filling Curve for Objects with Spatial Extension", GeoMesa's
``XZ2SFC``/``XZ3SFC``). An object is indexed by the *enlarged* quad/oct-tree
element that contains its bounding box (an element doubled in width per
dim), encoded as a base-(2^dims) sequence code; query windows are covered by
BFS over the element tree.

Host numpy and Python, as in the reference: ``index`` is vectorized over
whole bbox arrays (a fixed ``g``-iteration loop of masked vector ops), and
range planning is a Python BFS. Codes stay below 2^63 for every precision
the stores use (``g`` = 12: under 2^37 for XZ3), so they sort as int64.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from functools import lru_cache

import numpy as np

from geomesa_tpu_torch.curve.binned_time import MAX_OFFSET, TimePeriod
from geomesa_tpu_torch.curve.zranges import merge_ranges

DEFAULT_G = 12  # reference XZSFC.DefaultPrecision (SimpleFeatureTypes.scala:45)


@dataclass(frozen=True)
class XZSFC:
    """Dims-generic XZ curve over ``[0,1]^dims``-normalized bounding boxes."""

    g: int
    dims: int
    mins: tuple[float, ...]
    maxs: tuple[float, ...]

    @property
    def base(self) -> int:
        return 1 << self.dims  # 4 for XZ2, 8 for XZ3

    def _geom_factor(self, level: int) -> int:
        """(base^(g-level+1) - 1) / (base - 1): code-block size of the subtree
        rooted at an element of depth ``level`` (XZ paper lemma 3; the
        reference's ``sequenceInterval`` / ``sequenceCode`` step factors)."""
        return ((self.base ** (self.g - level + 1)) - 1) // (self.base - 1)

    @property
    def max_code(self) -> int:
        """Exclusive upper bound on sequence codes."""
        return ((self.base ** (self.g + 1)) - 1) // (self.base - 1)

    def _normalize(self, los, his, lenient: bool = True):
        """User-space bbox arrays → [0,1]^dims, clamped (lenient) per dim."""
        out_lo, out_hi = [], []
        for d in range(self.dims):
            lo = np.asarray(los[d], dtype=np.float64)
            hi = np.asarray(his[d], dtype=np.float64)
            if lenient:
                lo = np.clip(lo, self.mins[d], self.maxs[d])
                hi = np.clip(hi, self.mins[d], self.maxs[d])
            size = self.maxs[d] - self.mins[d]
            out_lo.append((lo - self.mins[d]) / size)
            out_hi.append((hi - self.mins[d]) / size)
        return out_lo, out_hi

    def index(self, los, his) -> np.ndarray:
        """Vectorized sequence codes for bbox arrays.

        Args:
          los/his: per-dim arrays of bbox min/max in user space
            (e.g. ``([xmins, ymins], [xmaxs, ymaxs])`` for XZ2).

        Mirrors ``XZ2SFC.index``: sequence length is the paper's l1 (or l1+1
        when the box fits an enlarged element one level down), then the code is
        the base-(2^dims) path of the box's min corner for that many levels.
        """
        nlo, nhi = self._normalize(los, his)
        n = np.broadcast(*nlo).shape or (1,)
        nlo = [np.broadcast_to(a, n).astype(np.float64) for a in nlo]
        nhi = [np.broadcast_to(a, n).astype(np.float64) for a in nhi]

        # sequence length (XZ2SFC.scala:54-77)
        max_dim = nhi[0] - nlo[0]
        for d in range(1, self.dims):
            max_dim = np.maximum(max_dim, nhi[d] - nlo[d])
        max_dim = np.maximum(max_dim, 1e-300)  # avoid log(0); points -> full depth
        l1 = np.floor(np.log(max_dim) / np.log(0.5)).astype(np.int64)
        w2 = np.power(0.5, np.minimum(l1 + 1, 1023).astype(np.float64))
        fits = np.ones(n, dtype=bool)
        for d in range(self.dims):
            fits &= nhi[d] <= (np.floor(nlo[d] / w2) * w2) + 2 * w2
        length = np.where(l1 >= self.g, self.g, np.where(fits, l1 + 1, l1))
        length = np.clip(length, 0, self.g)

        # vectorized sequence-code walk of the min corner
        cs = np.zeros(n, dtype=np.uint64)
        cell_lo = [np.zeros(n, dtype=np.float64) for _ in range(self.dims)]
        cell_hi = [np.ones(n, dtype=np.float64) for _ in range(self.dims)]
        for i in range(self.g):
            active = i < length
            quad = np.zeros(n, dtype=np.uint64)
            centers = []
            for d in range(self.dims):
                c = (cell_lo[d] + cell_hi[d]) * 0.5
                centers.append(c)
                quad |= (nlo[d] >= c).astype(np.uint64) << np.uint64(d)
            step = np.uint64(1) + quad * np.uint64(self._geom_factor(i + 1))
            cs = np.where(active, cs + step, cs)
            for d in range(self.dims):
                hi_half = nlo[d] >= centers[d]
                cell_lo[d] = np.where(active & hi_half, centers[d], cell_lo[d])
                cell_hi[d] = np.where(active & ~hi_half, centers[d], cell_hi[d])
        return cs

    def ranges(self, windows, max_ranges: int = 2000) -> np.ndarray:
        """Cover OR'd query windows with sequence-code intervals.

        ``windows``: list of (los_tuple, his_tuple) in user space. Returns
        inclusive ``(R, 2) uint64`` intervals — a superset cover (an object
        matches only if its *enlarged element* intersects a window, so the
        residual geometry refine is always required, as in the reference).
        """
        nwin = []
        for los, his in windows:
            nlo, nhi = self._normalize(
                [np.float64(v) for v in los], [np.float64(v) for v in his]
            )
            nwin.append((tuple(float(v) for v in nlo), tuple(float(v) for v in nhi)))

        out: list[tuple[int, int]] = []
        # element = (cell mins tuple, level); cell width 0.5^level, extended
        # bounds = mins + 2 * width (XZ2SFC.scala XElement)
        frontier: deque[tuple[tuple[float, ...], int]] = deque()
        for q in range(self.base):
            frontier.append(
                (tuple(0.5 * ((q >> d) & 1) for d in range(self.dims)), 1)
            )

        def classify(mins: tuple[float, ...], level: int) -> int:
            """2 = contained in some window, 1 = overlaps, 0 = disjoint from all."""
            w = 0.5**level
            best = 0
            for wlo, whi in nwin:
                contained = True
                overlaps = True
                for d in range(self.dims):
                    ext = mins[d] + 2 * w  # extended element upper bound
                    if not (wlo[d] <= mins[d] and whi[d] >= ext):
                        contained = False
                    if not (whi[d] >= mins[d] and wlo[d] <= ext):
                        overlaps = False
                        break
                if contained:
                    return 2
                if overlaps:
                    best = 1
            return best

        def seq_code(mins: tuple[float, ...], length: int) -> int:
            cs = 0
            lo = [0.0] * self.dims
            hi = [1.0] * self.dims
            for i in range(length):
                quad = 0
                for d in range(self.dims):
                    c = (lo[d] + hi[d]) * 0.5
                    if mins[d] >= c - 1e-15:
                        quad |= 1 << d
                        lo[d] = c
                    else:
                        hi[d] = c
                cs += 1 + quad * self._geom_factor(i + 1)
            return cs

        while frontier:
            mins, level = frontier.popleft()
            if len(out) >= max_ranges or level >= self.g:
                # budget/depth floor: emit remaining elements with full subtrees
                c = classify(mins, level)
                if c:
                    code = seq_code(mins, level)
                    out.append((code, code + self._geom_factor(level)))
                continue
            c = classify(mins, level)
            if c == 2:
                code = seq_code(mins, level)
                out.append((code, code + self._geom_factor(level)))
            elif c == 1:
                code = seq_code(mins, level)
                out.append((code, code))  # partial: the element's own code only
                w = 0.5 ** (level + 1)
                for q in range(self.base):
                    child = tuple(mins[d] + w * ((q >> d) & 1) for d in range(self.dims))
                    frontier.append((child, level + 1))

        return merge_ranges(out)


@lru_cache(maxsize=None)
def xz2_sfc(g: int = DEFAULT_G) -> XZSFC:
    """XZ2 over (lon, lat) — ``XZ2SFC.scala`` object cache."""
    return XZSFC(g=g, dims=2, mins=(-180.0, -90.0), maxs=(180.0, 90.0))


@lru_cache(maxsize=None)
def xz3_sfc(period: TimePeriod, g: int = DEFAULT_G) -> XZSFC:
    """XZ3 over (lon, lat, binned-time-offset) — ``XZ3SFC.scala``."""
    return XZSFC(
        g=g,
        dims=3,
        mins=(-180.0, -90.0, 0.0),
        maxs=(180.0, 90.0, MAX_OFFSET[period]),
    )
