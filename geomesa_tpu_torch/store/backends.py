"""Execution backends: brute-force oracle and the device backend.

Ports of :mod:`geomesa_tpu.store.backends`:

- :class:`OracleBackend` — evaluates the full filter over every row on the
  host (the parity referee).
- :class:`DeviceBackend` — the ``TpuBackend`` role on one torch device:
  ``load`` stages int32 ``x/y/bins/offs`` columns once per point index, each
  in its own sort order (``backends.py:267-388``, points branch; zero
  ``bins``/``offs`` for a schema without a date), or, for the xz3/xz2
  indexes of a line or polygon schema, the per-feature bbox columns
  ``xmin/ymin/xmax/ymax/bins/offs`` (``:389-428``, ``kind == "bboxes"``);
  ``point_state`` / ``bbox_state`` pick the state the batched counts run on
  (z3, then z2; xz3, then xz2), ``payload`` packs a query's int-domain
  bounds (``:478``, with the overlap pad on a bbox state), ``select``
  refines the planned candidates on the device with one boolean mask
  (``:501``; the reference's two passes exist only to size a static XLA
  buffer) and applies the exact host residual, and
  ``select_many_positions`` (``:575``) answers a batch of queries over
  planned (query, block) pairs, in overlap mode on a bbox state.

``select`` always takes the candidate route. The reference's ``sel:planned``
route inside it (``:539-556``) is chosen by the cost model, which the port
does not carry yet. The reference's device fallbacks (the ``dev is None``
host path in ``select``, the load-failure branch) are deliberately absent:
a missing residency or a device error raises.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from geomesa_tpu_torch.curve.binned_time import MAX_BIN, BinnedTime
from geomesa_tpu_torch.curve.normalize import lat as norm_lat, lon as norm_lon
from geomesa_tpu_torch.filter import ast
from geomesa_tpu_torch.filter.bounds import Extraction
from geomesa_tpu_torch.index.api import IndexPlan, gather_indices
from geomesa_tpu_torch.ops.kernels import chunk_extents, chunk_extents_bbox
from geomesa_tpu_torch.ops.refine import pack_boxes, pack_times, refine_bboxes, refine_points
from geomesa_tpu_torch.parallel.query import intervals_to_block_pairs, planned_gather_step
from geomesa_tpu_torch.parallel.residency import JOIN_BLOCK, stage_columns
from geomesa_tpu_torch.schema.columnar import FeatureTable
from geomesa_tpu_torch.schema.sft import FeatureType

REFINE_PRECISION = 31  # device coords are 31-bit fixed point
POINT_INDEXES = ("z3", "z2")  # resident point layouts, in preference order
BBOX_INDEXES = ("xz3", "xz2")  # resident bbox layouts of line/polygon schemas, likewise
# a full scan's order (planner.py:320); a schema has point or bbox indexes, never both
RESIDENT_INDEXES = ("z3", "xz3", "z2", "xz2")
_INVALID_LO, _INVALID_HI = 2**31 - 1, -1  # a bbox no query box overlaps


def preferred_point_index(names) -> str | None:
    """The first of ``POINT_INDEXES`` among ``names`` (index or state keys)."""
    return next((name for name in POINT_INDEXES if name in names), None)


def preferred_index(names) -> str | None:
    """The first of ``RESIDENT_INDEXES`` among ``names``."""
    return next((name for name in RESIDENT_INDEXES if name in names), None)


class OracleBackend:
    """Brute force: evaluate the full filter over every row (referee)."""

    name = "oracle"

    def load(self, sft, table, indices):
        return None

    def select(self, state, index, plan, extraction, residual, table):
        return np.nonzero(residual.mask(table))[0]


@dataclass
class IndexState:
    """One index's resident columns, sorted in index order. Rows past ``n``
    are padding; ``rows_per_shard`` is the padded length (one shard).
    ``extents`` holds each 4096-row chunk's extent
    (:func:`~geomesa_tpu_torch.ops.kernels.chunk_extents`, or on a bbox
    state :func:`~geomesa_tpu_torch.ops.kernels.chunk_extents_bbox`, 32 B a
    chunk), taken once after the columns are staged (``extents_s``,
    synchronized), for the grouped fold's work list. ``agg_cache`` holds
    ``aggregate_many``'s staged group ids, row ids and value columns in the
    same order, so a rebuild, which makes a new state, drops them. ``kind`` is ``"points"`` (``x, y, bins, offs``) or
    ``"bboxes"`` (``xmin, ymin, xmax, ymax, bins, offs``)."""

    cols: dict[str, torch.Tensor]
    rows_per_shard: int
    n: int
    h2d_bytes: int = 0  # bytes staged host -> device by the load
    h2d_s: float = 0.0  # seconds the staging took (synchronized)
    extents: torch.Tensor | None = None
    extents_s: float = 0.0
    agg_cache: dict = field(default_factory=dict)
    kind: str = "points"

    def spatial_cols(self) -> tuple:
        """The ordered column tuple every kernel of the layout takes
        (``backends.py:124``)."""
        c = self.cols
        if self.kind == "bboxes":
            return (c["xmin"], c["ymin"], c["xmax"], c["ymax"], c["bins"], c["offs"])
        return (c["x"], c["y"], c["bins"], c["offs"])


def time_quads(sft: FeatureType, intervals) -> np.ndarray | None:
    """Interval list → (T, 4) [bin_lo, off_lo, bin_hi, off_hi] int32 quads,
    or None when unconstrained. Every interval clamping away yields the
    unsatisfiable quad (a temporally impossible predicate must not become
    a full-window scan)."""
    if intervals is None or not sft.dtg_field:
        return None
    binned = BinnedTime(sft.z3_interval)
    quads = []
    for lo, hi in intervals:
        lo = max(int(lo), 0)
        # last indexable millisecond: one before the start of bin MAX_BIN+1
        hi_cap = int(binned.bin_start_millis(np.array([MAX_BIN + 1]))[0]) - 1
        hi = min(int(hi), hi_cap)
        if hi < lo:
            continue
        (blo,), (olo,) = binned.to_bin_and_offset(np.array([lo]))
        (bhi,), (ohi,) = binned.to_bin_and_offset(np.array([hi]))
        quads.append([int(blo), int(olo), int(bhi), int(ohi)])
    if quads:
        return np.array(quads, dtype=np.int32)
    return np.array([[1, 0, 0, -1]], dtype=np.int32)


def int_boxes(boxes) -> np.ndarray | None:
    """Extracted (x1, y1, x2, y2) degree boxes → (B, 4) [xlo, xhi, ylo, yhi]
    int32 in the device columns' normalized domain; None stays None
    (spatially unconstrained)."""
    if boxes is None:
        return None
    nlon = norm_lon(REFINE_PRECISION)
    nlat = norm_lat(REFINE_PRECISION)
    return np.array(
        [
            [int(nlon.normalize(x1)), int(nlon.normalize(x2)),
             int(nlat.normalize(y1)), int(nlat.normalize(y2))]
            for x1, y1, x2, y2 in boxes
        ],
        dtype=np.int32,
    )


def _time_columns(sft: FeatureType, table: FeatureTable) -> dict:
    """``bins``/``offs`` int32 in table order: zeros for a schema without a
    date (the unconstrained time window matches them)."""
    if sft.dtg_field is not None:
        bins, offs = BinnedTime(sft.z3_interval).to_bin_and_offset(table.dtg_millis())
    else:
        bins = offs = np.zeros(len(table), dtype=np.int32)
    return {"bins": bins.astype(np.int32), "offs": offs.astype(np.int32)}


def device_columns(sft: FeatureType, table: FeatureTable):
    """The normalized int32 ``x/y/bins/offs`` host columns in table order."""
    col = table.geom_column()
    return {
        "x": norm_lon(REFINE_PRECISION).normalize(col.x).astype(np.int32),
        "y": norm_lat(REFINE_PRECISION).normalize(col.y).astype(np.int32),
        **_time_columns(sft, table),
    }


def bbox_columns(sft: FeatureType, table: FeatureTable):
    """The int32 ``xmin/ymin/xmax/ymax/bins/offs`` host columns of a line or
    polygon schema in table order (``backends.py:389-428``): each feature's
    bounds normalized at 31 bits; a null geometry or a bbox with a
    non-finite bound is stamped ``xmin = ymin = INT32_MAX``, ``xmax = ymax =
    -1``, which no query box overlaps."""
    col = table.geom_column()
    b = col.bounds
    invalid = ~col.is_valid() | ~np.isfinite(b).all(axis=1)
    if invalid.any():
        b = np.where(invalid[:, None], 0.0, b)
    nlon, nlat = norm_lon(REFINE_PRECISION), norm_lat(REFINE_PRECISION)
    out = {
        "xmin": nlon.normalize(b[:, 0]).astype(np.int32),
        "ymin": nlat.normalize(b[:, 1]).astype(np.int32),
        "xmax": nlon.normalize(b[:, 2]).astype(np.int32),
        "ymax": nlat.normalize(b[:, 3]).astype(np.int32),
    }
    if invalid.any():
        for k in ("xmin", "ymin"):
            out[k][invalid] = _INVALID_LO
        for k in ("xmax", "ymax"):
            out[k][invalid] = _INVALID_HI
    return {**out, **_time_columns(sft, table)}


def residual_rows(index, positions: np.ndarray, residual, table: FeatureTable) -> np.ndarray:
    """Table row ids of an index's sorted-order ``positions`` that pass the
    exact host ``residual``, in position order: the tail of every device
    row select (``select`` and ``DataStore.select_many``)."""
    rows = index.perm[positions]
    if isinstance(residual, ast.Include):
        return rows
    return rows[ast.residual_mask(residual, table, rows)]


class DeviceBackend:
    """Resident int32 columns on one torch device, one-mask row select."""

    name = "device"

    def __init__(self, device: torch.device):
        self.device = device

    def load(self, sft, table, indices) -> dict[str, IndexState]:
        """One resident state per point or bbox index, in that index's
        order: the columns are normalized once, in table order, and gathered
        per index."""
        state = {}
        table_order = None
        for name in RESIDENT_INDEXES:
            if name not in indices:
                continue
            kind = "bboxes" if name in BBOX_INDEXES else "points"
            if table_order is None:
                table_order = (bbox_columns if kind == "bboxes" else device_columns)(sft, table)
            perm = indices[name].perm
            host = {k: v[perm] for k, v in table_order.items()}
            t0 = time.perf_counter()
            cols, padded = stage_columns(host, self.device)
            self._sync()
            t1 = time.perf_counter()
            # the grouped fold's work list reads them
            if kind == "points":
                extents = chunk_extents(cols["x"], cols["y"], cols["bins"], cols["offs"])
            else:
                extents = chunk_extents_bbox(cols["xmin"], cols["ymin"], cols["xmax"],
                                             cols["ymax"], cols["bins"], cols["offs"])
            self._sync()
            state[name] = IndexState(
                cols=cols, rows_per_shard=padded, n=len(table),
                h2d_bytes=sum(int(c.nbytes) for c in cols.values()),
                h2d_s=t1 - t0, extents=extents, extents_s=time.perf_counter() - t1, kind=kind,
            )
        return state

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @staticmethod
    def point_state(state) -> tuple[IndexState | None, str | None]:
        """The preferred point-index state and its name (z3, then z2): the
        one the batched counts run on (``backends.py:226-238``)."""
        name = preferred_point_index(state or ())
        return (None, None) if name is None else (state[name], name)

    @staticmethod
    def bbox_state(state) -> tuple[IndexState | None, str | None]:
        """The preferred bbox-index state and its name (xz3, then xz2): the
        one a line or polygon store's batched counts run on
        (``backends.py:241-251``)."""
        name = next((n for n in BBOX_INDEXES if n in (state or ())), None)
        return (None, None) if name is None else (state[name], name)

    def payload(self, sft: FeatureType, e: Extraction,
                overlap: bool = False) -> tuple[np.ndarray, np.ndarray]:
        """Packed (MAX_BOXES, 4) boxes and (MAX_TIMES, 4) windows, int32;
        ``overlap`` pads the boxes with the overlap sentinel (a bbox state's
        payloads, ``backends.py:478-498``)."""
        return (np.ascontiguousarray(pack_boxes(int_boxes(e.boxes), overlap=overlap)),
                np.ascontiguousarray(pack_times(time_quads(sft, e.intervals))))

    def select_positions_device(self, dev: IndexState, sft, e: Extraction,
                                intervals: np.ndarray) -> torch.Tensor:
        """Sorted-order positions passing the int-domain refine (point
        containment, or bbox overlap on a bbox state), as an int64 tensor
        on the store's device, ascending: one boolean mask over the
        candidate slots. A superset of the rows that pass the filter the
        extraction came from (normalization is monotone)."""
        idx, count = gather_indices(intervals, self.device)
        overlap = dev.kind == "bboxes"
        boxes, times = (torch.from_numpy(a).to(self.device)
                        for a in self.payload(sft, e, overlap=overlap))
        refine = refine_bboxes if overlap else refine_points
        return idx[refine(*dev.spatial_cols(), idx, count, boxes, times)]

    def select_positions(self, dev: IndexState, sft, e: Extraction,
                         intervals: np.ndarray) -> np.ndarray:
        """:meth:`select_positions_device`, copied to the host."""
        return self.select_positions_device(dev, sft, e, intervals).cpu().numpy()

    def select_many_positions(self, dev: IndexState, index, extractions,
                              intervals_list, timings: dict | None = None) -> list[np.ndarray]:
        """Matching sorted-order positions for many queries on one index
        state (``backends.py:575``): each query's intervals become
        ``JOIN_BLOCK``-row (query, block) pairs, and one
        :func:`planned_gather_step` serves them all (in overlap mode on a
        bbox state). Returns one int32 array
        per query (the reference's position contract), sorted: views into
        the one buffer copied from the device, split without a copy. :func:`planned_gather_step` raises on a residency
        that is not block-aligned. ``timings``, when given, gains host-clock
        ms: ``pairs_ms`` (the pair lists and the payloads' upload) and
        ``gather_ms`` (the step, its device-to-host copies and the split)."""
        t0 = time.perf_counter()
        nq = len(intervals_list)
        pair_q, pair_blk = intervals_to_block_pairs(intervals_list, JOIN_BLOCK)
        payloads = [self.payload(index.sft, e, overlap=dev.kind == "bboxes") for e in extractions]
        boxes = torch.from_numpy(np.stack([p[0] for p in payloads])).to(self.device)
        times = torch.from_numpy(np.stack([p[1] for p in payloads])).to(self.device)
        t1 = time.perf_counter()
        positions, pair_hits = planned_gather_step(
            dev.spatial_cols(), dev.n, pair_q, pair_blk, boxes, times)
        # pairs come grouped by query in order: split the buffer per query
        per_query = np.bincount(pair_q, weights=pair_hits.cpu().numpy(), minlength=nq)
        out = np.split(positions.cpu().numpy(), np.cumsum(per_query.astype(np.int64))[:-1])
        if timings is not None:
            timings["pairs_ms"] = timings.get("pairs_ms", 0.0) + (t1 - t0) * 1e3
            timings["gather_ms"] = (timings.get("gather_ms", 0.0)
                                    + (time.perf_counter() - t1) * 1e3)
        return out

    def select(self, state, index, plan: IndexPlan, extraction, residual, table,
               timings: dict | None = None):
        """Table rows of the plan's candidates that pass the device refine
        and the exact host ``residual``. ``timings``, when given, gains
        host-clock ms: ``select_ms`` (the refine, its uploads and its
        device-to-host copy) and ``residual_ms``."""
        t0 = time.perf_counter()
        rows = positions = np.empty(0, dtype=np.int64)
        if len(plan.intervals):
            positions = self.select_positions(state[index.name], index.sft, extraction,
                                              plan.intervals)
        t1 = time.perf_counter()
        if len(positions):
            rows = residual_rows(index, positions, residual, table)
        if timings is not None:
            timings["select_ms"] = (t1 - t0) * 1e3
            timings["residual_ms"] = (time.perf_counter() - t1) * 1e3
        return rows
