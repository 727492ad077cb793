"""GeoBlocks: a pre-aggregated Z-grid pyramid and an epoch-validated query
cache for grouped bbox+time aggregations.

Port of :mod:`geomesa_tpu.ops.geoblocks` (the design of *GeoBlocks: A
Query-Cache Accelerated Data Structure for Spatial Aggregation over
Polygons*, PAPERS.md), host numpy as in the reference. Instead of
rescanning the base table per query, :class:`AggPyramid` keeps up to three
grid levels (``LEVEL_KS``) of partials per (time bin, grid cell, group):
COUNT, the first matching row, and per value column count/sum/min/max. An
aggregation is answered as

    interior cells read from the pyramid  +  boundary rows refined from base.

Exactness: an *interior* cell lies strictly inside the query's int-domain
box ``[xlo+1, xhi-1] x [ylo+1, yhi-1]``; monotone coordinate quantization
makes every row in it f64-certain. A *full* time bin lies strictly between
the window's end bins, so its rows are millisecond-certain. Everything else
(the spatial boundary ring and the two end bins) is refined from the base
table against the full f64 filter, as the fused device path's boundary
rows are. The answer is exact, not approximate. Boundary rows are found in
O(boundary) time through a CSR built with the pyramid: one stable argsort
of ``(bin, cell, group)`` keys orders the table by finest-level bucket and
gives every per-(bucket, group) segment reduction; coarser levels are
reshaped reductions of the finest.

:class:`QueryCache` holds exact-repeat answers stamped with the owning
type's data epoch: an entry whose stamp differs from the live epoch is
dead, so a stale answer cannot be served.

The switch differs from the reference's: there the pyramid serves unless
``GEOMESA_TPU_PYRAMID`` turns it off; here it serves only when the switch
turns it on (:func:`enabled`), and the fused device path answers otherwise
(:func:`geomesa_tpu_torch.planning.planner.choose_agg_path`).

What the port leaves out: the finest level's count mirror on the device,
its devmon residency ledger and its buffer-pool registration (no kernel
reads the mirror; ROADMAP.md A.9), the cache's Prometheus lines and the
auditor's entry listing (A.9, A.12), and the static-analysis
``cache_surface`` marker (the reference's ``geomesa_tpu/analysis``, which
the port does not import).
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict

import numpy as np

__all__ = ["AggPyramid", "QueryCache", "enabled", "base_over_cap", "PYRAMID_ENV",
           "PYRAMID_BYTES_ENV", "LEVEL_KS"]

PYRAMID_ENV = "GEOMESA_TPU_PYRAMID"  # "1"/"true"/"on"/"yes" enables; off by default
# host bytes cap per pyramid — covers the WHOLE structure: the level
# ladder AND the O(N) members (CSR order/bucket, group ids, value
# mirrors). The O(N) share is ~N × (12 + 8·V) bytes, so the default
# admits ~10M-row single-value-column shapes; lower it to keep pyramids
# off big types, raise it for deliberate hot-type pre-aggregation.
PYRAMID_BYTES_ENV = "GEOMESA_TPU_PYRAMID_BYTES"
DEFAULT_PYRAMID_BYTES = 512 << 20
# grid levels: 2**k cells per axis in the 31-bit normalized domain
LEVEL_KS = (3, 5, 7)  # 8×8, 32×32, 128×128
COORD_BITS = 31


def enabled() -> bool:
    return os.environ.get(PYRAMID_ENV, "0").strip().lower() in (
        "1", "true", "on", "yes")


def _byte_cap() -> int:
    raw = os.environ.get(PYRAMID_BYTES_ENV, "").strip()
    if not raw:
        return DEFAULT_PYRAMID_BYTES
    try:
        return int(raw)
    except ValueError:
        raise ValueError(
            f"{PYRAMID_BYTES_ENV} must be an integer byte count, got {raw!r}"
        ) from None


def base_bytes(n: int, v: int) -> int:
    """Host bytes of a pyramid's O(N) members over ``n`` rows and ``v``
    value columns: the int32 CSR order and bucket, the int32 group ids and
    the f64 value mirrors."""
    return n * (4 + 4 + 4 + 8 * v)


def base_over_cap(n: int, v: int) -> bool:
    """Whether the O(N) members alone exceed the byte cap, so that no level
    can fit: a caller refuses before it prepares any input."""
    return base_bytes(n, v) > _byte_cap()


def _level_bytes(t: int, k: int, g: int, v: int) -> int:
    """Host bytes of one level's partial arrays: cnt + first + 4 per-value
    stats, all 8-byte, over (T, 4**k cells, G) — the memory-overhead
    formula documented in docs/observability.md."""
    return t * (1 << (2 * k)) * g * 8 * (2 + 4 * v)


class _Level:
    __slots__ = ("k", "shift", "nx", "cnt", "first", "vcnt", "vsum",
                 "vmin", "vmax")

    def __init__(self, k, cnt, first, vcnt, vsum, vmin, vmax):
        self.k = k
        self.shift = COORD_BITS - k
        self.nx = 1 << k
        self.cnt = cnt      # (T, C, G) int64
        self.first = first  # (T, C, G) int64, int64-max = empty
        self.vcnt = vcnt    # (V, T, C, G) int64 (non-NaN counts)
        self.vsum = vsum    # (V, T, C, G) f64
        self.vmin = vmin    # (V, T, C, G) f64, +inf = empty
        self.vmax = vmax    # (V, T, C, G) f64, -inf = empty

    @property
    def nbytes(self) -> int:
        n = self.cnt.nbytes + self.first.nbytes
        for a in (self.vcnt, self.vsum, self.vmin, self.vmax):
            n += a.nbytes
        return n


class AggPyramid:
    """Immutable per-(type, group_by, value_cols) pre-aggregation pyramid
    over one main-tier snapshot. Built once per rebuild epoch; queries
    only read."""

    _I64MAX = np.iinfo(np.int64).max

    def __init__(self, xi, yi, bins, gid, keys, vals, *, epoch=None,
                 byte_cap: int | None = None):
        """``xi``/``yi``: 31-bit normalized int coords per row; ``bins``:
        time bin per row; ``gid``: factorized group id per row (< G);
        ``keys``: group key tuples in gid order; ``vals``: (V, N) f64
        value matrix, NaN = invalid (the :meth:`DataStore._agg_residency`
        convention)."""
        n = len(xi)
        if n >= 2**31:
            raise ValueError("pyramid CSR is int32-indexed")
        g = max(len(keys), 1)
        v = len(vals)
        cap = _byte_cap() if byte_cap is None else byte_cap
        self.keys = list(keys)
        self.epoch = epoch
        self.gid = np.asarray(gid, dtype=np.int32)
        self.host_vals = np.asarray(vals, dtype=np.float64).reshape(v, n)
        self.bins_present = np.unique(np.asarray(bins, dtype=np.int64))
        t = max(len(self.bins_present), 1)
        # the cap covers the WHOLE structure: the O(N) members (int32 CSR
        # order + bucket, int32 group ids, f64 value mirrors) plus the
        # level ladder. Finest level = the largest k whose full ladder
        # (reductions are <= 1/15 of it combined) still fits; no fitting
        # level means no pyramid (callers fall back to the scan path)
        base = base_bytes(n, v)
        ks = [k for k in LEVEL_KS
              if base + _level_bytes(t, k, g, v) * 1.1 <= cap]
        if not ks:
            raise ValueError("pyramid exceeds the byte cap for this shape")
        self._ks = ks
        fk = ks[-1]
        nx = 1 << fk
        c = nx * nx
        ti = np.searchsorted(self.bins_present, np.asarray(bins, np.int64))
        xi = np.asarray(xi, dtype=np.int64)
        yi = np.asarray(yi, dtype=np.int64)
        cell = (yi >> (COORD_BITS - fk)) * nx + (xi >> (COORD_BITS - fk))
        bucket = ti * c + cell
        # ONE stable sort serves everything: segments over (bucket, gid)
        # for the dense partials, and the bucket-major CSR for boundary
        # row lookup (stable ⇒ first row in a segment = min row id)
        key = bucket * g + self.gid
        order = np.argsort(key, kind="stable").astype(np.int32)
        sk = key[order]
        if n:
            seg = np.flatnonzero(np.r_[True, sk[1:] != sk[:-1]])
            uk = sk[seg]
            seg_len = np.diff(np.r_[seg, n])
        else:
            seg = uk = seg_len = np.empty(0, dtype=np.int64)
        size = t * c * g
        cnt = np.zeros(size, dtype=np.int64)
        cnt[uk] = seg_len
        first = np.full(size, self._I64MAX, dtype=np.int64)
        first[uk] = order[seg]
        vcnt = np.zeros((v, size), dtype=np.int64)
        vsum = np.zeros((v, size), dtype=np.float64)
        vmin = np.full((v, size), np.inf)
        vmax = np.full((v, size), -np.inf)
        for j in range(v):
            vs = self.host_vals[j][order]
            valid = ~np.isnan(vs)
            if n:
                vcnt[j][uk] = np.add.reduceat(
                    valid.astype(np.int64), seg)
                vsum[j][uk] = np.add.reduceat(np.where(valid, vs, 0.0), seg)
                vmin[j][uk] = np.minimum.reduceat(
                    np.where(valid, vs, np.inf), seg)
                vmax[j][uk] = np.maximum.reduceat(
                    np.where(valid, vs, -np.inf), seg)
        levels = {fk: _Level(
            fk,
            cnt.reshape(t, c, g),
            first.reshape(t, c, g),
            vcnt.reshape(v, t, c, g),
            vsum.reshape(v, t, c, g),
            vmin.reshape(v, t, c, g),
            vmax.reshape(v, t, c, g),
        )}
        # coarser levels: pure reshaped reductions of the finest (a coarse
        # cell is an aligned 2**d × 2**d block of fine cells)
        for k in reversed(ks[:-1]):
            fine = levels[min(kk for kk in levels)]
            d = fine.k - k
            nb = 1 << d

            def _red(a, op, lead):
                s = a.shape
                b = a.reshape(*s[:lead], t, 1 << k, nb, 1 << k, nb, g)
                return op(op(b, lead + 4), lead + 2).reshape(
                    *s[:lead], t, 1 << (2 * k), g)

            levels[k] = _Level(
                k,
                _red(fine.cnt, np.ndarray.sum, 0),
                _red(fine.first, np.ndarray.min, 0),
                _red(fine.vcnt, np.ndarray.sum, 1),
                _red(fine.vsum, np.ndarray.sum, 1),
                _red(fine.vmin, np.ndarray.min, 1),
                _red(fine.vmax, np.ndarray.max, 1),
            )
        self.levels = [levels[k] for k in ks]  # coarse → fine
        self._csr_order = order
        self._csr_bucket = bucket[order].astype(
            np.int64 if t * c > np.iinfo(np.int32).max else np.int32)
        self._fine_c = c
        self.build_rows = n

    @property
    def nbytes(self) -> int:
        """Host bytes: levels + CSR + group ids + value mirrors (the
        memory-overhead formula in docs/observability.md)."""
        n = sum(lv.nbytes for lv in self.levels)
        n += self._csr_order.nbytes + self._csr_bucket.nbytes
        n += self.gid.nbytes + self.host_vals.nbytes
        return int(n)

    # -- query answering ------------------------------------------------------
    @staticmethod
    def _interior_range(lo: int, hi: int, shift: int) -> tuple[int, int]:
        """Cells fully inside the OPEN interval (lo, hi): every coordinate
        in the cell is > lo and < hi (so rows there are f64-certain for a
        closed f64 box whose int image is [lo, hi])."""
        a, b = lo + 1, hi - 1
        if a > b:
            return 1, 0
        s = 1 << shift
        clo = (a + s - 1) >> shift  # ceil(a / s)
        chi = ((b + 1) >> shift) - 1  # floor((b + 1) / s) - 1
        return clo, chi

    @staticmethod
    def _cells(x0, x1, y0, y1, nx, exclude=None):
        """Flat cell ids of the rectangle [x0..x1] × [y0..y1] (inclusive,
        cell coords), minus the ``exclude`` rectangle when given."""
        if x0 > x1 or y0 > y1:
            return np.empty(0, dtype=np.int64)
        xs = np.arange(x0, x1 + 1, dtype=np.int64)
        ys = np.arange(y0, y1 + 1, dtype=np.int64)
        cx, cy = np.meshgrid(xs, ys)
        cx = cx.ravel()
        cy = cy.ravel()
        if exclude is not None:
            ex0, ex1, ey0, ey1 = exclude
            keep = ~((cx >= ex0) & (cx <= ex1) & (cy >= ey0) & (cy <= ey1))
            cx, cy = cx[keep], cy[keep]
        return cy * nx + cx

    def _time_split(self, window):
        """(full bin indices, partial bin indices) into ``bins_present``.
        The window's two end bins are ALWAYS partial: their rows need the
        exact-millisecond host re-test (offset quantization makes the
        quantized comparison ambiguous at the ends)."""
        bp = self.bins_present
        if window is None:
            return np.arange(len(bp)), np.empty(0, dtype=np.int64)
        blo, _olo, bhi, _ohi = window
        full = np.flatnonzero((bp > blo) & (bp < bhi))
        partial = np.flatnonzero((bp == blo) | (bp == bhi))
        return full, partial

    def answer(self, box, window):
        """Exact aggregate partials for one int-domain box (or None = no
        spatial constraint) and one time window quad (or None).

        Returns ``(cnt, first, vcnt, vsum, vmin, vmax, boundary_rows)``:
        per-group partials folded from the pyramid's interior cover, plus
        the base-table row ids of the boundary region the caller must
        re-test against the full f64 filter and fold in."""
        g = max(len(self.keys), 1)
        v = len(self.host_vals)
        cnt = np.zeros(g, dtype=np.int64)
        first = np.full(g, self._I64MAX, dtype=np.int64)
        vcnt = np.zeros((v, g), dtype=np.int64)
        vsum = np.zeros((v, g), dtype=np.float64)
        vmin = np.full((v, g), np.inf)
        vmax = np.full((v, g), -np.inf)
        full_ti, partial_ti = self._time_split(window)

        def _fold_cells(level, cells):
            if len(cells) == 0 or len(full_ti) == 0:
                return
            sel = np.ix_(full_ti, cells)
            np.add(cnt, level.cnt[sel].sum(axis=(0, 1)), out=cnt)
            np.minimum(first, level.first[sel].min(axis=(0, 1)), out=first)
            if v:
                vsel = np.ix_(np.arange(v), full_ti, cells)
                np.add(vcnt, level.vcnt[vsel].sum(axis=(1, 2)), out=vcnt)
                np.add(vsum, level.vsum[vsel].sum(axis=(1, 2)), out=vsum)
                np.minimum(vmin, level.vmin[vsel].min(axis=(1, 2)), out=vmin)
                np.maximum(vmax, level.vmax[vsel].max(axis=(1, 2)), out=vmax)

        fine = self.levels[-1]
        if box is None:
            # no spatial constraint: the whole grid is interior at the
            # coarsest level; only the partial end bins need base rows
            _fold_cells(self.levels[0],
                        np.arange(self.levels[0].nx ** 2, dtype=np.int64))
            inter_cells = np.arange(fine.nx ** 2, dtype=np.int64)
            boundary_cells = np.empty(0, dtype=np.int64)
        else:
            xlo, xhi, ylo, yhi = (int(box[0]), int(box[1]),
                                  int(box[2]), int(box[3]))
            prev_rect = None  # already-covered rect, in CELL coords of ℓ-1
            for level in self.levels:
                cx0, cx1 = self._interior_range(xlo, xhi, level.shift)
                cy0, cy1 = self._interior_range(ylo, yhi, level.shift)
                exclude = None
                if prev_rect is not None:
                    # the coarser level's cover, refined to this level's
                    # cell coords (aligned: coarse cells are cell blocks)
                    px0, px1, py0, py1, pk = prev_rect
                    d = level.k - pk
                    exclude = (px0 << d, ((px1 + 1) << d) - 1,
                               py0 << d, ((py1 + 1) << d) - 1)
                if cx0 <= cx1 and cy0 <= cy1:
                    _fold_cells(level, self._cells(
                        cx0, cx1, cy0, cy1, level.nx, exclude))
                    prev_rect = (cx0, cx1, cy0, cy1, level.k)
                # a level with an empty interior keeps prev_rect as-is
            # intersecting cells at the finest level
            s = fine.shift
            ix0, ix1 = xlo >> s, xhi >> s
            iy0, iy1 = ylo >> s, yhi >> s
            covered = None
            if prev_rect is not None:
                px0, px1, py0, py1, pk = prev_rect
                d = fine.k - pk
                covered = (px0 << d, ((px1 + 1) << d) - 1,
                           py0 << d, ((py1 + 1) << d) - 1)
            inter_cells = self._cells(ix0, ix1, iy0, iy1, fine.nx)
            boundary_cells = self._cells(
                ix0, ix1, iy0, iy1, fine.nx, exclude=covered)
        # boundary region = full bins × boundary ring  +  partial end
        # bins × every intersecting cell — located via the CSR
        buckets = []
        c = self._fine_c
        if len(full_ti) and len(boundary_cells):
            buckets.append(
                (full_ti[:, None] * c + boundary_cells[None, :]).ravel())
        if len(partial_ti) and len(inter_cells):
            buckets.append(
                (partial_ti[:, None] * c + inter_cells[None, :]).ravel())
        rows = self._boundary_rows(
            np.concatenate(buckets) if buckets
            else np.empty(0, dtype=np.int64))
        return cnt, first, vcnt, vsum, vmin, vmax, rows

    def _boundary_rows(self, buckets: np.ndarray) -> np.ndarray:
        """Base-table row ids living in the given finest-level buckets,
        via the build-time CSR — O(boundary), never a table rescan."""
        if len(buckets) == 0:
            return np.empty(0, dtype=np.int64)
        buckets = np.unique(buckets)
        lo = np.searchsorted(self._csr_bucket, buckets, side="left")
        hi = np.searchsorted(self._csr_bucket, buckets, side="right")
        take = hi > lo
        if not take.any():
            return np.empty(0, dtype=np.int64)
        return np.concatenate([
            self._csr_order[a:b] for a, b in zip(lo[take], hi[take])
        ])


# -- epoch-validated query cache ----------------------------------------------

class QueryCache:
    """Exact-repeat aggregation cache, keyed by (plan signature, literal
    predicate, GROUP BY, value columns) and validated by the owning
    type's data epoch — an entry whose stamp differs from the live epoch
    is dead, so a stale answer is impossible by construction. One leaf
    lock; results are deep-copied on both put and get (callers may
    mutate the arrays they receive)."""

    def __init__(self, max_entries: int = 256):
        self._lock = threading.Lock()  # leaf: entry table + counters
        self._entries: OrderedDict = OrderedDict()
        self.max_entries = max_entries
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    @staticmethod
    def _copy(res: dict) -> dict:
        return {
            "groups": list(res["groups"]),
            "count": res["count"].copy(),
            "cols": {
                c: {k: a.copy() for k, a in stats.items()}
                for c, stats in res["cols"].items()
            },
        }

    def get(self, type_name: str, key, epoch):
        with self._lock:
            full = (type_name, key)
            hit = self._entries.get(full)
            if hit is None or hit[0] != epoch:
                self.misses += 1
                if hit is not None:  # stale epoch: drop eagerly
                    del self._entries[full]
                return None
            self._entries.move_to_end(full)
            self.hits += 1
            return self._copy(hit[1])

    def put(self, type_name: str, key, epoch, result: dict) -> None:
        entry = (epoch, self._copy(result))
        with self._lock:
            self._entries[(type_name, key)] = entry
            self._entries.move_to_end((type_name, key))
            while len(self._entries) > self.max_entries:
                self._entries.popitem(last=False)
                self.evictions += 1

    def invalidate(self, type_name: str | None = None) -> None:
        """Drop every entry of one type (or all). Epoch stamps make stale
        serving impossible within a type's lifetime; a caller that wants
        a cold answer on an unchanged store (a timing of the fused path)
        drops the type's entries here."""
        with self._lock:
            if type_name is None:
                self._entries.clear()
                return
            for k in [k for k in self._entries if k[0] == type_name]:
                del self._entries[k]

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "entries": len(self._entries),
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
            }
