"""Per-entity track layout and batched track statistics.

Port of :mod:`geomesa_tpu.trajectory.state`. One planned columnar scan
builds a segmented track layout:

- rows sorted by ``(track, time)`` (a lexsort whose third key is the
  descending row index, so among rows of equal track and time the lowest
  original row sorts last and is the entity's label row, the rule of
  :func:`geomesa_tpu_torch.process.tracks.track_label`), entity boundaries
  as CSR offsets;
- device columns (x/y f32, per-step seconds f32, the offsets int64) staged
  on the store's device at first use and kept with the state, which the
  manager cache keys on the store's ``(rebuild epoch, delta version)`` data
  epoch: a write makes the next :func:`get_track_state` build anew;
- :func:`track_stats` answers length, duration, average speed, heading
  change, dwell and the last-position label of every entity in one pass of
  the ``track_stats`` kernel (:func:`track_stats_step`), with
  :func:`track_stats_host` as the independent f64 referee.

Step semantics, shared by the kernel, its plain version and the host
referee: a step's bearing is defined only when its length is positive;
heading change sums ``|floor_mod(b_i - b_{i-1} + 180, 360) - 180|`` over
consecutive defined-bearing step pairs within an entity; dwell sums step
durations whose step length is at most ``dwell_eps_deg``.

Deliberate differences from the reference:

- no ``BufferPool`` residency or ledger registration (so no
  ``_pool_key``, and ``release`` simply drops the device columns): the
  buffer pool is ROADMAP.md A.9;
- record-level visibility (``auths``) raises ``NotImplementedError``
  (ROADMAP.md A.8.6), as the corridor engine's does;
- no padding to power-of-two row and entity buckets (``pow2_bucket``): the
  reference pads only so that XLA compiles one executable per bucket, and
  a CUDA kernel takes any size, so the columns are the rows as they are
  and the sums the entities as they are (the reference's pad rows fall in
  a discard segment and add nothing);
- the step is a hand-written kernel over the CSR offsets, not XLA's
  segment sums over ``sid``/``first`` columns: the kernel finds each row's
  entity from the offsets (:func:`geomesa_tpu_torch.ops.kernels.track_stats`).
"""

from __future__ import annotations

import threading
import time
import weakref

import numpy as np
import torch

from geomesa_tpu_torch.ops.kernels import track_stats as track_stats_kernel
from geomesa_tpu_torch.planning.planner import Query
from geomesa_tpu_torch.schema.columnar import representative_xy

__all__ = [
    "TrackState", "build_track_state", "get_track_state", "invalidate", "track_stats",
    "track_stats_host", "track_stats_step",
]

DEFAULT_DWELL_EPS_DEG = 1e-4


def _refuse_auths(auths, surface: str) -> None:
    if auths is not None:
        raise NotImplementedError(f"{surface}: record-level visibility (auths) is not ported "
                                  "yet (ROADMAP.md A.8.6)")


class TrackState:
    """One (type, track field, filter) snapshot in segmented track layout.

    Host truth: ``order`` (row permutation of the scanned table), ``t_ms``
    int64 times, ``x``/``y`` f64 coordinates, ``entities`` (E,) object keys
    and ``offsets`` (E+1,) int64 CSR: entity ``e`` owns sorted rows
    ``offsets[e]:offsets[e+1]``. Device columns stage at first use and stay
    until :meth:`release`."""

    def __init__(self, type_name: str, track_field: str, epoch, entities, offsets, table, order,
                 t_ms, x, y, filter_text: str = ""):
        self.type_name = type_name
        self.track_field = track_field
        self.epoch = epoch
        self.filter_text = filter_text
        self.entities = entities
        self.offsets = offsets
        self.table = table  # the scanned table, in sorted order
        self.order = order
        self.t_ms = t_ms
        self.x = x
        self.y = y
        self._lock = threading.Lock()  # leaf: the device columns only
        self._dev = None  # (x32, y32, dt32, offsets) on one device
        self.stage_s = 0.0  # host seconds of the last staging (synchronized)

    @property
    def n(self) -> int:
        return len(self.order)

    @property
    def n_entities(self) -> int:
        return len(self.entities)

    @property
    def nbytes(self) -> int:
        """Device bytes of the staged columns (0 while unstaged)."""
        cols = self._dev
        return 0 if cols is None else int(sum(c.nbytes for c in cols))

    def device_columns(self, device) -> tuple:
        """The device columns, staged on ``device`` at first use: ``(x32,
        y32, dt32, offsets)``: the sorted rows' f32 coordinates, each row's
        f32 seconds since the previous row of its entity (0 on an entity's
        first row) and the (E+1,) int64 offsets."""
        device = torch.device(device)
        with self._lock:
            cols = self._dev
            if cols is not None and cols[0].device == device:
                return cols
        t0 = time.perf_counter()
        n = self.n
        dt = np.zeros(n, dtype=np.float64)
        if n:
            dt[1:] = (self.t_ms[1:] - self.t_ms[:-1]) / 1000.0
            dt[self.offsets[:-1][self.offsets[:-1] < n]] = 0.0
        host = (self.x.astype(np.float32), self.y.astype(np.float32), dt.astype(np.float32),
                np.asarray(self.offsets, dtype=np.int64))
        cols = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in host)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        with self._lock:
            if self._dev is None or self._dev[0].device != device:
                self._dev = cols
                self.stage_s = time.perf_counter() - t0
            return self._dev

    def release(self) -> None:
        """Drop the device columns (manager invalidation); the next use
        stages them anew."""
        with self._lock:
            self._dev = None

    def validate(self) -> list[str]:
        """Structural CSR invariants: offsets start at 0, end at the row
        count, never decrease; every entity's times are nondecreasing.
        Returns violation strings (empty = clean)."""
        out: list[str] = []
        off = np.asarray(self.offsets, dtype=np.int64)
        if len(off) != self.n_entities + 1:
            out.append(f"offsets length {len(off)} != entities+1 {self.n_entities + 1}")
            return out
        if len(off) and off[0] != 0:
            out.append(f"offsets[0] = {off[0]} != 0")
        if len(off) and off[-1] != self.n:
            out.append(f"offsets[-1] = {off[-1]} != rows {self.n}")
        if np.any(np.diff(off) < 0):
            out.append("offsets decrease")
            return out
        if self.n:
            d = np.diff(self.t_ms)
            boundary = np.zeros(self.n - 1, dtype=bool)
            inner = off[1:-1]
            boundary[inner[(inner > 0) & (inner < self.n)] - 1] = True
            bad = np.nonzero((d < 0) & ~boundary)[0]
            if len(bad):
                out.append(f"time not monotone within entity at sorted rows {bad[:4].tolist()}")
        return out


def _data_epoch(ds, type_name: str):
    """The store's (rebuild epoch, delta version) pair, or None when the
    store exposes none (such a caller is never served from the cache)."""
    try:
        return ds._state(type_name).data_epoch()
    except (AttributeError, KeyError):
        return None


def build_track_state(ds, type_name: str, track_field: str, filter=None, auths=None,
                      timings: dict | None = None) -> TrackState:
    """One planned columnar scan → segmented track layout.

    The data epoch is read before the scan: a racing write can only make
    the state look stale, never fresh. ``timings``, when given, gains
    host-clock seconds: ``scan_s`` (the query), ``sort_s`` (factorize,
    lexsort and offsets) and ``take_s`` (the sorted table and columns)."""
    _refuse_auths(auths, "build_track_state")
    epoch = _data_epoch(ds, type_name)
    t0 = time.perf_counter()
    t = ds.query(type_name, Query(filter=filter)).table
    t1 = time.perf_counter()
    if track_field not in t.columns:
        raise KeyError(f"{type_name!r} has no attribute {track_field!r}")
    tms = t.dtg_millis()
    if len(t):
        groups = t.columns[track_field].values.astype(object)
        ents, codes = np.unique(groups, return_inverse=True)
        codes = codes.reshape(-1)
        # tertiary key: descending row index, so among equal (track, time)
        # rows the lowest original row sorts last: the entity's label row
        order = np.lexsort((-np.arange(len(t)), tms, codes))
        sorted_codes = codes[order]
        starts = np.nonzero(np.r_[True, sorted_codes[1:] != sorted_codes[:-1]])[0]
        offsets = np.concatenate([starts, [len(t)]]).astype(np.int64)
        xs, ys = representative_xy(t)
    else:
        ents = np.empty(0, dtype=object)
        order = np.empty(0, dtype=np.int64)
        offsets = np.zeros(1, dtype=np.int64)
        xs = ys = np.empty(0, dtype=np.float64)
    t2 = time.perf_counter()
    state = TrackState(
        type_name, track_field, epoch, ents, offsets, t.take(order) if len(t) else t, order,
        tms[order], np.asarray(xs, dtype=np.float64)[order],
        np.asarray(ys, dtype=np.float64)[order],
        filter_text="" if filter is None else str(filter))
    if timings is not None:
        timings.update(scan_s=t1 - t0, sort_s=t2 - t1, take_s=time.perf_counter() - t2)
    return state


# -- manager cache (data-epoch fingerprinted) -----------------------------------

_lock = threading.Lock()  # leaf: the manager cache table
_states: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def get_track_state(ds, type_name: str, track_field: str, filter=None,
                    auths=None) -> TrackState:
    """The cached track state for (store, type, field, filter), rebuilt
    when the store's data epoch moved (one tuple compare)."""
    _refuse_auths(auths, "get_track_state")
    key = (type_name, track_field, "" if filter is None else str(filter))
    epoch = _data_epoch(ds, type_name)
    with _lock:
        table = _states.get(ds)
        st = table.get(key) if table else None
    if st is not None and epoch is not None and st.epoch == epoch:
        return st
    fresh = build_track_state(ds, type_name, track_field, filter=filter)
    with _lock:
        table = _states.get(ds)
        if table is None:
            table = _states[ds] = {}
        prev = table.get(key)
        table[key] = fresh
    if prev is not None:
        prev.release()
    return fresh


def invalidate(ds, type_name: str | None = None) -> None:
    """Drop cached states (of one type, or all of the store's)."""
    with _lock:
        table = _states.get(ds)
        if not table:
            return
        keys = [k for k in table if type_name is None or k[0] == type_name]
        dropped = [table.pop(k) for k in keys]
    for st in dropped:
        st.release()


# -- the per-entity aggregation -----------------------------------------------

def track_stats_step(x, y, dt, offsets, dwell_eps: float):
    """The per-entity step (``cached_track_stats_step`` ``:364``) over the
    device columns of :meth:`TrackState.device_columns`: ``(length_deg,
    duration_s, heading_change_deg, dwell_s)``, each (E,) f32. One launch
    of the ``track_stats`` kernel on the card, its plain version on the
    CPU (:func:`~geomesa_tpu_torch.ops.kernels.track_stats`)."""
    return track_stats_kernel(x, y, dt, offsets, dwell_eps)


def track_stats(ds, type_name: str, track_field: str, filter=None,
                dwell_eps_deg: float = DEFAULT_DWELL_EPS_DEG, state: TrackState | None = None,
                auths=None) -> dict:
    """Every entity's length, duration, average speed, heading change,
    dwell and last-position label, in one kernel pass over the cached track
    state (on the store's device). Returns a column dict."""
    _refuse_auths(auths, "track_stats")
    st = state or get_track_state(ds, type_name, track_field, filter=filter)
    x32, y32, dt32, offsets = st.device_columns(ds.device)
    sums = track_stats_step(x32, y32, dt32, offsets, float(dwell_eps_deg))
    length, duration, hc, dwell = (s.cpu().numpy().astype(np.float64) for s in sums)
    return _assemble(st, length, duration, hc, dwell)


def track_stats_host(state: TrackState, dwell_eps_deg: float = DEFAULT_DWELL_EPS_DEG) -> dict:
    """Independent f64 numpy referee with the same step semantics: the
    parity oracle of :func:`track_stats`."""
    st = state
    n, e = st.n, st.n_entities
    length = np.zeros(e)
    duration = np.zeros(e)
    hc = np.zeros(e)
    dwell = np.zeros(e)
    if n:
        first = np.zeros(n, dtype=bool)
        first[st.offsets[:-1]] = True
        dx = np.diff(st.x, prepend=st.x[:1])
        dy = np.diff(st.y, prepend=st.y[:1])
        dist = np.where(first, 0.0, np.hypot(dx, dy))
        dt = np.zeros(n)
        dt[1:] = (st.t_ms[1:] - st.t_ms[:-1]) / 1000.0
        dt[first] = 0.0
        sid = np.repeat(np.arange(e), np.diff(st.offsets).astype(np.int64))
        length = np.bincount(sid, weights=dist, minlength=e)
        duration = np.bincount(sid, weights=dt, minlength=e)
        with np.errstate(invalid="ignore"):
            brg = np.degrees(np.arctan2(dx, dy))
        moved = ~first & (dist > 0)
        pmoved = np.r_[False, moved[:-1]]
        turn = np.abs(np.mod(brg - np.r_[brg[:1], brg[:-1]] + 180.0, 360.0) - 180.0)
        turn = np.where(moved & pmoved, turn, 0.0)
        hc = np.bincount(sid, weights=turn, minlength=e)
        dwell = np.bincount(sid, weights=np.where(dist <= dwell_eps_deg, dt, 0.0), minlength=e)
    return _assemble(st, length, duration, hc, dwell)


def _assemble(st: TrackState, length, duration, hc, dwell) -> dict:
    last = np.maximum(st.offsets[1:] - 1, 0).astype(np.int64)
    firsts = st.offsets[:-1].astype(np.int64)
    with np.errstate(divide="ignore", invalid="ignore"):
        speed = np.where(duration > 0, length / np.maximum(duration, 1e-12), 0.0)
    e = st.n_entities
    return {
        "track": np.asarray(st.entities, dtype=object),
        "rows": np.diff(st.offsets).astype(np.int64),
        "length_deg": length,
        "duration_s": duration,
        "avg_speed_deg_s": speed,
        "heading_change_deg": hc,
        "dwell_s": dwell,
        "first_ms": st.t_ms[firsts] if e else np.empty(0, np.int64),
        "last_ms": st.t_ms[last] if e else np.empty(0, np.int64),
        "last_x": st.x[last] if e else np.empty(0),
        "last_y": st.y[last] if e else np.empty(0),
        "last_fid": st.table.fids[last] if e else np.empty(0, dtype=object),
    }
