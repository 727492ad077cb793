"""Subscription matrix: Q standing queries as one (rows × queries) device
problem.

Port of :mod:`geomesa_tpu.stream.matrix` on one torch device:

- every standing query decomposes (:func:`~geomesa_tpu_torch.planning.
  planner.standing_query_payload`) into one row of a packed
  ``(capacity, B, 4)`` box matrix and ``(capacity, T, 4)`` time matrix;
- capacity is a power-of-two bucket: subscribe and unsubscribe rewrite rows
  in place, inactive slots hold the unsatisfiable sentinel payload, and the
  bucket doubles when full and halves when a quarter full;
- a scan is one fused count + hits pass
  (:func:`~geomesa_tpu_torch.parallel.query.matrix_scan_step`, the
  ``batched_count_hits`` kernel): exact per-subscription counts and a
  newest-match position sample from a single pass over the chunk.

Deliveries are int-domain matches, a superset at quantization boundaries,
exactly as in the reference. The reference's mesh, cache-surface and
dispatch-budget annotations and its h2d telemetry are left out; the matrix
keeps a plain ``h2d_bytes`` counter.

Locking: ``_lock`` is a leaf. Device uploads and scans run outside it, on an
immutable per-epoch snapshot, so churn during a scan affects the next chunk.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

import numpy as np
import torch

from geomesa_tpu_torch.device import resolve_device
from geomesa_tpu_torch.ops.kernels import LANES
from geomesa_tpu_torch.ops.refine import pack_boxes, pack_times, unsat_rows
from geomesa_tpu_torch.parallel.query import matrix_scan_step
from geomesa_tpu_torch.planning.planner import standing_query_payload

__all__ = ["SubscriptionMatrix", "HitBatch", "MatrixSnapshot",
           "envelope_hit", "envelope_hits", "merge_positions"]

DEFAULT_BOX_SLOTS = 2
DEFAULT_TIME_SLOTS = 2
DEFAULT_TOPK = 64
MIN_CAPACITY = 8


def envelope_hit(boxes: np.ndarray, times: np.ndarray, ix1: int, ix2: int,
                 iy1: int, iy2: int, b: int, o: int) -> bool:
    """Host int-domain test of one extended feature (normalized envelope
    ``[ix1, ix2] × [iy1, iy2]`` at instant ``(b, o)``) against one
    subscription's packed payload: bbox overlap, not point containment."""
    return bool(envelope_hits(
        boxes, times,
        np.asarray([ix1]), np.asarray([ix2]),
        np.asarray([iy1]), np.asarray([iy2]),
        np.asarray([b]), np.asarray([o]),
    )[0])


def envelope_hits(boxes: np.ndarray, times: np.ndarray,
                  ix1: np.ndarray, ix2: np.ndarray,
                  iy1: np.ndarray, iy2: np.ndarray,
                  b: np.ndarray, o: np.ndarray) -> np.ndarray:
    """Vectorized :func:`envelope_hit`: W wide rows against one payload.
    Empty box slots (lo > hi: the sentinel and the ``pack_boxes`` pad) are
    skipped, since an envelope could overlap their corner; time uses the
    kernel's (bin, offset) window compares."""
    in_box = np.zeros(len(ix1), bool)
    for xlo, xhi, ylo, yhi in boxes:
        if xlo > xhi or ylo > yhi:
            continue
        in_box |= (ix1 <= xhi) & (ix2 >= xlo) & (iy1 <= yhi) & (iy2 >= ylo)
    if not in_box.any():
        return in_box
    in_time = np.zeros(len(ix1), bool)
    for blo, olo, bhi, ohi in times:
        after = (b > blo) | ((b == blo) & (o >= olo))
        before = (b < bhi) | ((b == bhi) & (o <= ohi))
        in_time |= after & before
    return in_box & in_time


@dataclass(frozen=True)
class HitBatch:
    """One subscription's delivery for one scanned chunk."""

    sid: int
    predicate: object  # the subscribed predicate (CQL text / Query / None)
    count: int  # matches in this chunk
    total: int  # cumulative matches delivered to this subscription
    positions: np.ndarray  # newest-match global stream positions (<= topk), int64
    tags: list | None  # caller row tags for ``positions``, if kept
    chunk: int  # chunk sequence number
    base: int  # global stream position of this chunk's row 0
    rows: int  # true rows in this chunk


class _Sub:
    __slots__ = ("sid", "predicate", "callback", "boxes", "times")

    def __init__(self, sid, predicate, callback, boxes, times):
        self.sid = sid
        self.predicate = predicate
        self.callback = callback
        self.boxes = boxes
        self.times = times


@dataclass(frozen=True)
class MatrixSnapshot:
    """Immutable view of the matrix at one epoch. ``sids[slot]`` maps a
    matrix row to its subscription id (None = masked); the device matrices
    are uploaded once per epoch."""

    epoch: int
    capacity: int
    sids: tuple
    subs: dict
    boxes_dev: torch.Tensor
    times_dev: torch.Tensor


class SubscriptionMatrix:
    """Registry of standing queries held as device query matrices.

    ``sft`` drives predicate decomposition (:meth:`subscribe`); pass None
    when only pre-packed payloads are registered (:meth:`subscribe_packed`).
    ``device`` is where the matrices and scans live: CUDA by default, which
    raises without a card (``device="cpu"`` runs the plain path)."""

    def __init__(self, sft=None, device=None, box_slots: int = DEFAULT_BOX_SLOTS,
                 time_slots: int = DEFAULT_TIME_SLOTS, topk: int = DEFAULT_TOPK,
                 min_capacity: int = MIN_CAPACITY):
        if min_capacity < 1 or (min_capacity & (min_capacity - 1)):
            raise ValueError("min_capacity must be a power of two")
        if topk < 1:
            raise ValueError("topk must be >= 1")
        self.sft = sft
        self.device = resolve_device(device)
        self.box_slots = box_slots
        self.time_slots = time_slots
        self.topk = topk
        self.min_capacity = min_capacity
        self._unsat_boxes, self._unsat_times = unsat_rows(box_slots, time_slots)
        self._lock = threading.Lock()  # leaf — see module docstring
        self._subs: dict[int, _Sub] = {}
        self._slots: list[int | None] = [None] * min_capacity
        self._boxes = np.tile(self._unsat_boxes[None], (min_capacity, 1, 1))
        self._times = np.tile(self._unsat_times[None], (min_capacity, 1, 1))
        self._epoch = 0
        self._dev: tuple | None = None  # (epoch, boxes_dev, times_dev)
        self._next_sid = 1
        self.h2d_bytes = 0  # bytes this matrix staged onto its device

    # -- registry -------------------------------------------------------------
    def subscribe(self, predicate, callback) -> int:
        """Register a standing query (CQL, filter node or Query); returns its
        subscription id."""
        if self.sft is None:
            raise ValueError("matrix built without an sft: use subscribe_packed")
        boxes, times = standing_query_payload(
            self.sft, predicate, self.box_slots, self.time_slots
        )
        return self._add(predicate, callback, boxes, times)

    def subscribe_packed(self, boxes, times, callback, predicate=None) -> int:
        """Register a pre-packed int-domain payload: ``boxes (<= box_slots,
        4)``, ``times (<= time_slots, 4)`` int32."""
        b = np.asarray(boxes, np.int32).reshape(-1, 4)
        t = np.asarray(times, np.int32).reshape(-1, 4)
        return self._add(
            predicate, callback,
            pack_boxes(b, slots=self.box_slots),
            pack_times(t, slots=self.time_slots),
        )

    def _add(self, predicate, callback, boxes, times) -> int:
        with self._lock:
            sid = self._next_sid
            self._next_sid += 1
            try:
                slot = self._slots.index(None)
            except ValueError:
                slot = len(self._slots)
                self._grow_locked()
            self._subs[sid] = _Sub(sid, predicate, callback, boxes, times)
            self._slots[slot] = sid
            self._boxes[slot] = boxes
            self._times[slot] = times
            self._epoch += 1
            self._dev = None
        return sid

    def unsubscribe(self, sid: int) -> bool:
        """Mask a subscription's slot with the unsatisfiable payload; the
        bucket halves (live rows compacted) once a quarter full."""
        with self._lock:
            if self._subs.pop(sid, None) is None:
                return False
            slot = self._slots.index(sid)
            self._slots[slot] = None
            self._boxes[slot] = self._unsat_boxes
            self._times[slot] = self._unsat_times
            cap = len(self._slots)
            if cap > self.min_capacity and len(self._subs) <= cap // 4:
                self._shrink_locked(cap // 2)
            self._epoch += 1
            self._dev = None
        return True

    def _grow_locked(self) -> None:
        cap = len(self._slots)
        boxes = np.tile(self._unsat_boxes[None], (cap * 2, 1, 1))
        times = np.tile(self._unsat_times[None], (cap * 2, 1, 1))
        boxes[:cap] = self._boxes
        times[:cap] = self._times
        self._boxes, self._times = boxes, times
        self._slots.extend([None] * cap)

    def _shrink_locked(self, new_cap: int) -> None:
        new_cap = max(new_cap, self.min_capacity)
        boxes = np.tile(self._unsat_boxes[None], (new_cap, 1, 1))
        times = np.tile(self._unsat_times[None], (new_cap, 1, 1))
        slots: list[int | None] = [None] * new_cap
        live = [sid for sid in self._slots if sid is not None]
        for i, sid in enumerate(live):
            slots[i] = sid
            boxes[i] = self._subs[sid].boxes
            times[i] = self._subs[sid].times
        self._boxes, self._times, self._slots = boxes, times, slots

    def capacity(self) -> int:
        with self._lock:
            return len(self._slots)

    def active_count(self) -> int:
        with self._lock:
            return len(self._subs)

    def validate_sentinels(self) -> list[str]:
        """Every masked slot must hold the unsatisfiable sentinel payload, and
        the sentinel's box rows must all be empty. Returns violations."""
        out: list[str] = []
        with self._lock:
            for slot, sid in enumerate(self._slots):
                if sid is not None:
                    continue
                if not (np.array_equal(self._boxes[slot], self._unsat_boxes)
                        and np.array_equal(self._times[slot], self._unsat_times)):
                    out.append(f"slot {slot}: masked but payload differs "
                               "from the unsat sentinel")
                    continue
                b = self._boxes[slot]
                if not (b[:, 0] > b[:, 1]).all():
                    out.append(f"slot {slot}: sentinel box rows satisfiable")
        return out

    # -- scan side ------------------------------------------------------------
    def snapshot(self) -> MatrixSnapshot:
        """The scan-side view: slot → sid map plus the device matrices,
        uploaded outside the lock and once per epoch."""
        with self._lock:
            epoch = self._epoch
            cap = len(self._slots)
            sids = tuple(self._slots)
            subs = {sid: self._subs[sid] for sid in sids if sid is not None}
            dev = self._dev if (self._dev and self._dev[0] == epoch) else None
            host = None if dev else (self._boxes.copy(), self._times.copy())
        if dev is None:
            host_b, host_t = host
            dev = (epoch, torch.from_numpy(host_b).to(self.device),
                   torch.from_numpy(host_t).to(self.device))
            with self._lock:
                self.h2d_bytes += host_b.nbytes + host_t.nbytes
                if self._epoch == epoch:
                    self._dev = dev
        return MatrixSnapshot(
            epoch=epoch, capacity=cap, sids=sids, subs=subs,
            boxes_dev=dev[1], times_dev=dev[2],
        )

    def scan_chunk(self, snapshot: MatrixSnapshot, x, y, bins, offs, true_n: int):
        """One fused pass of staged device columns against the snapshot's
        matrices, on the current stream → ``(counts (cap,) int64, positions
        (cap, 1, topk) int32)`` on the host, after one device→host copy."""
        counts, pos = matrix_scan_step(
            x, y, bins, offs, true_n, snapshot.boxes_dev, snapshot.times_dev, self.topk
        )
        cap = snapshot.capacity
        both = torch.cat([counts[:, None], pos.reshape(cap, self.topk)], dim=1).cpu().numpy()
        return both[:, 0].astype(np.int64), both[:, 1:].reshape(cap, 1, self.topk)

    def scan_host(self, x, y, bins, offs):
        """Single-shot scan of host int32 columns (tests, small batches):
        pads to the lane multiple, stages, runs the fused pass; returns
        ``(snapshot, counts, positions)`` with per-slot newest-first matched
        positions. The streaming path is ``DeviceStreamScanner``."""
        n = len(x)
        padded = ((max(n, 1) + LANES - 1) // LANES) * LANES
        cols = []
        for a in (x, y, bins, offs):
            a = np.asarray(a, np.int32)
            if padded != n:
                a = np.concatenate([a, np.zeros(padded - n, np.int32)])
            cols.append(torch.from_numpy(a).to(self.device))
        with self._lock:
            self.h2d_bytes += 16 * padded
        snap = self.snapshot()
        counts, pos = self.scan_chunk(snap, *cols, n)
        merged = [merge_positions(pos[s], self.topk) for s in range(snap.capacity)]
        return snap, counts, merged


def merge_positions(pos_shards: np.ndarray, topk: int) -> np.ndarray:
    """Merge one slot's per-shard position lanes ``(D, topk)`` into the
    newest-first sample (drop -1 pads, descending, <= topk)."""
    p = pos_shards.reshape(-1)
    p = p[p >= 0]
    if len(p) > 1:
        p = np.sort(p)[::-1]
    return p[:topk]
