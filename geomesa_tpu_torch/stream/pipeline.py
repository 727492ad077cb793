"""Device stream scanner: double-buffered streaming scan of a subscription
matrix.

Port of ``DeviceStreamScanner`` (``geomesa_tpu/stream/pipeline.py:92``) on
one torch device. Two feeding modes share the pipeline:

- :meth:`DeviceStreamScanner.submit_chunk`: pre-built column chunks through
  a bounded queue; the producer blocks while ``max_pending_chunks`` are in
  flight (backpressure by blocking);
- :meth:`DeviceStreamScanner.submit_rows`: row fragments, cut into full
  chunks as they fill; a partial chunk is flushed after
  ``flush_interval_s`` of quiet, padded to the fixed chunk shape. It never
  blocks; watch :meth:`~DeviceStreamScanner.lag`.

The scan thread stages chunk c+1 behind the fused scan of chunk c. On a
CUDA matrix the double buffer is a pool of ``max_pending_chunks + 1``
pinned host buffers, each with a device twin: a chunk's columns are copied
into a free pinned buffer, then to the card on a dedicated copy stream
(``non_blocking=True``), and an event is recorded after the copy. The scan
stream waits on that event before the kernel reads the columns. A buffer is
reused only after the scan that read it returned (the scan ends in a
device→host copy) and after its own copy's event has completed.
``transfer_wait_s`` is the time spent in the pending chunk's
``event.synchronize()`` after a scan returns: transfer that the scan did not
hide. On a CPU matrix the columns are used in place.

A chunk whose staging, scan or delivery raises is dropped and counted
(``scan_errors``; its rows count as scanned so :meth:`drain` terminates) and
the thread keeps serving: a dead scan thread would silently end every
standing query. If the thread dies all the same, it closes the scanner on
its way out, so blocked producers and :meth:`~DeviceStreamScanner.drain`
return instead of waiting forever. A raising callback is counted
(``callback_errors``). The
reference's stream-lens, usage, audit, flight-recorder, span and telemetry
hooks are not ported.

Locking: the scanner's condition lock and the matrix lock are leaves;
staging, the scan and the callbacks run outside them.
"""

from __future__ import annotations

import threading
import time
import traceback
from collections import deque

import numpy as np
import torch

from geomesa_tpu_torch.ops.kernels import LANES
from geomesa_tpu_torch.stream.matrix import (
    HitBatch,
    SubscriptionMatrix,
    envelope_hits,
    merge_positions,
)

__all__ = ["DeviceStreamScanner"]


class _Chunk:
    __slots__ = ("seq", "base", "rows", "cols", "tags", "env")

    def __init__(self, seq, base, rows, cols, tags, env=None):
        self.seq = seq
        self.base = base
        self.rows = rows  # true rows (cols are padded to the fixed shape)
        self.cols = cols  # (x, y, bins, offs) np int32, len == chunk_rows
        self.tags = tags  # per-true-row tags or None
        # wide (extended-geometry) rows: [(local_idx, ix1, ix2, iy1, iy2)];
        # their x/y hold the -1 sentinel (no packed box matches a negative
        # coordinate) and they are refined on the host at delivery
        self.env = env


class _Slot:
    """One staging buffer of the double buffer: pinned host columns, their
    device twin and the event recorded after the host→device copy."""

    __slots__ = ("host", "dev", "event")

    def __init__(self, rows: int, device: torch.device):
        self.host = torch.empty((4, rows), dtype=torch.int32, pin_memory=True)
        self.dev = torch.empty((4, rows), dtype=torch.int32, device=device)
        self.event = torch.cuda.Event()


class _Staged:
    __slots__ = ("cols", "chunk", "slot")

    def __init__(self, cols, chunk, slot):
        self.cols = cols  # 4 device tensors of chunk_rows int32
        self.chunk = chunk
        self.slot = slot  # None on a CPU matrix


class DeviceStreamScanner:
    """Double-buffered streaming scan of a :class:`SubscriptionMatrix` on the
    matrix's device."""

    def __init__(self, matrix: SubscriptionMatrix, chunk_rows: int = 65536,
                 max_pending_chunks: int = 2, flush_interval_s: float = 0.05,
                 keep_tags: bool = True):
        self.matrix = matrix
        # fixed chunk shape, lane-aligned: full and partial (padded) chunks
        # scan at one shape
        self.chunk_rows = ((max(chunk_rows, LANES) + LANES - 1) // LANES) * LANES
        if matrix.topk > self.chunk_rows:
            raise ValueError("topk exceeds the rows of one chunk")
        self.max_pending_chunks = max(1, max_pending_chunks)
        self.flush_interval_s = flush_interval_s
        self.keep_tags = keep_tags
        self._device = matrix.device
        self._lock = threading.Lock()  # leaf: buffers, queue, stats
        self._cv = threading.Condition(self._lock)
        self._frags: list[tuple] = []  # (x, y, bins, offs, tags, env)
        self._buffered = 0
        self._chunks: deque[_Chunk] = deque()
        self._seq = 0
        self._rows_in = 0  # rows accepted (global stream positions)
        self._rows_scanned = 0
        self._totals: dict[int, int] = {}  # sid → delivered total (scan thread)
        self._stats = {
            "chunks": 0, "rows": 0, "h2d_bytes": 0, "transfer_wait_s": 0.0,
            "scan_s": 0.0, "deliveries": 0, "callback_errors": 0,
            "scan_errors": 0,
        }
        self.last_error: str | None = None  # traceback of the last counted error
        # scan-thread private: the staging pool and the copy stream
        self._free: deque[_Slot] = deque()
        self._copy_stream = None
        self._stop = threading.Event()
        self._closed = False
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="geomesa-stream-scan",
        )
        self._thread.start()

    # -- feeding --------------------------------------------------------------
    def submit_rows(self, x, y, bins, offs, tags=None, envelopes=None) -> None:
        """Append rows (int32 columns) to the stream; never blocks.

        ``envelopes``: optional per-row ``None | (ix1, ix2, iy1, iy2)``
        normalized envelopes of extended geometries. Such rows get the -1
        x/y sentinel and are refined on the host at delivery (bbox overlap
        against each subscription's payload)."""
        n = len(x)
        if n == 0:
            return
        if len(y) != n or len(bins) != n or len(offs) != n:
            raise ValueError("column length mismatch")
        if tags is not None and len(tags) != n:
            raise ValueError("tags length mismatch")
        x = np.asarray(x, np.int32)
        y = np.asarray(y, np.int32)
        env = None
        if envelopes is not None:
            if len(envelopes) != n:
                raise ValueError("envelopes length mismatch")
            wide = [i for i, e in enumerate(envelopes) if e is not None]
            if wide:
                x = x.copy()
                y = y.copy()
                x[wide] = -1
                y[wide] = -1
                env = list(envelopes)
        frag = (
            x, y, np.asarray(bins, np.int32), np.asarray(offs, np.int32),
            list(tags) if (tags is not None and self.keep_tags) else None,
            env,
        )
        with self._cv:
            if self._closed:
                return
            self._frags.append(frag)
            self._buffered += n
            self._rows_in += n
            while self._buffered >= self.chunk_rows:
                self._cut_locked(self.chunk_rows)
            self._cv.notify_all()

    def submit_chunk(self, x, y, bins, offs, tags=None, block: bool = True) -> bool:
        """Submit one pre-built chunk through the bounded queue. With
        ``block=True`` the caller waits while ``max_pending_chunks`` chunks
        are queued. Returns False if the scanner is closed."""
        with self._cv:
            if self._closed:
                return False
            if self._buffered:
                # row-mode fragments flush first so stream positions stay in
                # submission order
                self._cut_locked(min(self._buffered, self.chunk_rows))
            while (block and len(self._chunks) >= self.max_pending_chunks
                   and not self._closed):
                self._cv.wait(0.05)  # releases the lock: the backpressure wait
            if self._closed:
                return False
            self._append_chunk_locked(x, y, bins, offs, tags)
            self._cv.notify_all()
        return True

    def _pad(self, a: np.ndarray) -> np.ndarray:
        if len(a) > self.chunk_rows:
            raise ValueError(f"chunk of {len(a)} rows exceeds chunk_rows={self.chunk_rows}")
        if len(a) < self.chunk_rows:
            a = np.concatenate([a, np.zeros(self.chunk_rows - len(a), np.int32)])
        return a

    def _append_chunk_locked(self, x, y, bins, offs, tags) -> None:
        n = len(x)
        cols = tuple(self._pad(np.asarray(a, np.int32)) for a in (x, y, bins, offs))
        self._chunks.append(_Chunk(
            self._seq, self._rows_in, n, cols,
            list(tags) if (tags is not None and self.keep_tags) else None,
        ))
        self._seq += 1
        self._rows_in += n

    def _cut_locked(self, take: int) -> None:
        """Concatenate the buffered fragments and emit the first ``take``
        rows as one chunk (padded to the fixed shape); the rest stays
        buffered. Caller holds the lock."""
        tags, envs = [], []
        # build per-row tag/env lists only when some fragment carries them
        have_tags = any(f[4] is not None for f in self._frags)
        have_env = any(f[5] is not None for f in self._frags)
        for fx, _fy, _fb, _fo, ft, fe in self._frags:
            if have_tags:
                tags.extend(ft if ft is not None else [None] * len(fx))
            if have_env:
                envs.extend(fe if fe is not None else [None] * len(fx))
        x, y, b, o = (np.concatenate([f[i] for f in self._frags]) for i in range(4))
        rest = len(x) - take
        self._frags = (
            [(x[take:], y[take:], b[take:], o[take:],
              tags[take:] if have_tags else None,
              envs[take:] if have_env else None)] if rest else []
        )
        self._buffered = rest
        base = self._rows_in - rest - take
        cols = tuple(self._pad(a[:take]) for a in (x, y, b, o))
        env = (
            [(i, *e) for i, e in enumerate(envs[:take]) if e is not None]
            if have_env else None
        )
        self._chunks.append(_Chunk(
            self._seq, base, take, cols,
            tags[:take] if have_tags else None, env or None,
        ))
        self._seq += 1

    # -- pipeline -------------------------------------------------------------
    def _next_chunk(self):
        """Block until a chunk is available, a quiet partial buffer is due
        for flush, or shutdown. Returns None to exit."""
        deadline = None
        with self._cv:
            while True:
                # stop first: close() promises "after the in-flight chunk",
                # so queued-but-unstarted chunks are dropped
                if self._stop.is_set():
                    return None
                if self._chunks:
                    chunk = self._chunks.popleft()
                    self._cv.notify_all()  # wake bounded submitters
                    return chunk
                if self._buffered:
                    now = time.monotonic()
                    if deadline is None:
                        deadline = now + self.flush_interval_s
                    if now >= deadline:
                        self._cut_locked(self._buffered)
                        continue
                    self._cv.wait(deadline - now)  # the flush-deadline sleep
                else:
                    deadline = None
                    self._cv.wait(self.flush_interval_s)  # idle wait

    def _stage(self, chunk: _Chunk) -> _Staged:
        """Start moving one chunk's columns onto the matrix's device."""
        nbytes = sum(int(a.nbytes) for a in chunk.cols)
        if self._device.type != "cuda":
            staged = _Staged(tuple(torch.from_numpy(a) for a in chunk.cols), chunk, None)
        else:
            if self._copy_stream is None:
                self._copy_stream = torch.cuda.Stream(device=self._device)
                for _ in range(self.max_pending_chunks + 1):
                    self._free.append(_Slot(self.chunk_rows, self._device))
            if not self._free:
                raise RuntimeError("no free staging buffer")
            slot = self._free.popleft()
            try:
                slot.event.synchronize()  # this buffer's previous copy is done
                for i, a in enumerate(chunk.cols):
                    slot.host[i].copy_(torch.from_numpy(a))
                with torch.cuda.stream(self._copy_stream):
                    slot.dev.copy_(slot.host, non_blocking=True)
                    slot.event.record(self._copy_stream)
            except BaseException:
                self._free.append(slot)
                raise
            staged = _Staged(tuple(slot.dev[i] for i in range(4)), chunk, slot)
        with self._lock:
            self._stats["h2d_bytes"] += nbytes
        return staged

    def _release(self, staged: _Staged) -> None:
        if staged.slot is not None:
            self._free.append(staged.slot)

    def _drop_failed(self, chunk: _Chunk) -> None:
        """Count a chunk whose staging, scan or delivery raised, mark its rows
        scanned so drain terminates, and keep the scan thread alive."""
        with self._cv:
            self.last_error = traceback.format_exc()
            self._stats["scan_errors"] += 1
            self._rows_scanned += chunk.rows
            self._cv.notify_all()

    def _run(self) -> None:
        try:
            if self._device.type == "cuda":
                torch.cuda.set_device(self._device)
            self._scan_loop()
        except Exception:  # noqa: BLE001 — recorded; the scanner closes below
            with self._cv:
                self.last_error = traceback.format_exc()
        finally:
            if self._copy_stream is not None:
                self._copy_stream.synchronize()  # no copy outlives its buffers
            # a scan thread that ends, for close() or for an error, leaves the
            # scanner closed: blocked producers and drain() return instead of
            # waiting for a scan that will never come
            with self._cv:
                self._closed = True
                self._stop.set()
                self._chunks.clear()
                self._frags = []
                self._buffered = 0
                self._cv.notify_all()

    def _scan_loop(self) -> None:
        pending = None  # the staged chunk for the NEXT scan
        while True:
            if pending is None:
                chunk = self._next_chunk()
                if chunk is None:
                    break
                try:
                    pending = self._stage(chunk)
                except Exception:  # noqa: BLE001 — the scan thread must live
                    self._drop_failed(chunk)
                    continue
            staged, pending = pending, None
            # stage the following chunk behind this chunk's scan (none once
            # close() asked to stop after the in-flight chunk)
            nxt = None
            with self._cv:
                if self._chunks and not self._stop.is_set():
                    nxt = self._chunks.popleft()
                    self._cv.notify_all()
            if nxt is not None:
                try:
                    pending = self._stage(nxt)
                except Exception:  # noqa: BLE001
                    self._drop_failed(nxt)
            chunk = staged.chunk
            try:
                t0 = time.perf_counter()
                snap = self.matrix.snapshot()
                if staged.slot is not None:
                    torch.cuda.current_stream(self._device).wait_event(staged.slot.event)
                counts, pos = self.matrix.scan_chunk(snap, *staged.cols, chunk.rows)
                scan_s = time.perf_counter() - t0
                wait_s = 0.0
                if pending is not None and pending.slot is not None:
                    t1 = time.perf_counter()
                    pending.slot.event.synchronize()
                    wait_s = time.perf_counter() - t1
                self._deliver(snap, counts, pos, chunk)
            except Exception:  # noqa: BLE001 — the scan thread must live
                self._drop_failed(chunk)
                continue
            finally:
                self._release(staged)
            with self._cv:
                self._rows_scanned += chunk.rows
                st = self._stats
                st["chunks"] += 1
                st["rows"] += chunk.rows
                st["transfer_wait_s"] += wait_s
                st["scan_s"] += scan_s
                self._cv.notify_all()

    def _deliver(self, snap, counts, pos, chunk: _Chunk) -> None:
        """Per-subscription delivery for one chunk: the count, the running
        total, the newest-match positions (global, int64) and their tags.
        Wide rows are refined here against each subscription's payload and
        folded into the same delivery."""
        topk = self.matrix.topk
        wide: dict[int, np.ndarray] = {}  # sid → matched wide local indexes
        if chunk.env:
            env = np.asarray(chunk.env, dtype=np.int64)
            idx = env[:, 0]
            wb = chunk.cols[2][idx].astype(np.int64)
            wo = chunk.cols[3][idx].astype(np.int64)
            for sid, sub in snap.subs.items():
                m = envelope_hits(sub.boxes, sub.times,
                                  env[:, 1], env[:, 2], env[:, 3], env[:, 4], wb, wo)
                if m.any():
                    wide[sid] = idx[m]
        delivered = 0
        for slot, sid in enumerate(snap.sids):
            if sid is None:
                continue
            c = int(counts[slot])
            ex = wide.get(sid)
            if ex is not None:
                c += len(ex)
            if c == 0:
                continue
            sub = snap.subs[sid]
            # int64 before adding the base: stream positions outgrow int32
            local = merge_positions(pos[slot], topk).astype(np.int64)
            if ex is not None:
                local = np.sort(np.concatenate([local, ex]))[::-1][:topk]
            tags = None
            if chunk.tags is not None:
                tags = [chunk.tags[int(p)] for p in local]
            total = self._totals.get(sid, 0) + c
            self._totals[sid] = total
            batch = HitBatch(
                sid=sid, predicate=sub.predicate, count=c, total=total,
                positions=np.int64(chunk.base) + local, tags=tags,
                chunk=chunk.seq, base=chunk.base, rows=chunk.rows,
            )
            try:
                sub.callback(batch)
                delivered += 1
            except Exception:  # noqa: BLE001 — one bad consumer
                with self._lock:
                    self.last_error = traceback.format_exc()
                    self._stats["callback_errors"] += 1
        if delivered:
            with self._lock:
                self._stats["deliveries"] += delivered

    # -- introspection / lifecycle -------------------------------------------
    def lag(self) -> int:
        """Rows accepted but not yet scanned (the backpressure signal)."""
        with self._lock:
            return self._rows_in - self._rows_scanned

    def stats(self) -> dict:
        with self._lock:
            return dict(self._stats)

    def drain(self, timeout_s: float = 30.0) -> bool:
        """Flush the partial buffer and block until every accepted row has
        been scanned and delivered, or ``timeout_s`` passes (False)."""
        deadline = time.monotonic() + timeout_s
        with self._cv:
            if self._buffered:
                self._cut_locked(self._buffered)
                self._cv.notify_all()
            while self._rows_scanned < self._rows_in:
                if self._stop.is_set():
                    return False
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._cv.wait(min(left, 0.1))
        return True

    def close(self) -> None:
        """Idempotent shutdown: stop after the in-flight chunk, join the scan
        thread, refuse further submissions. :meth:`drain` first to flush."""
        with self._cv:
            already = self._closed
            self._closed = True
            self._stop.set()
            self._cv.notify_all()
        if not already:
            self._thread.join(timeout=10.0)
