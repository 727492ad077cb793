"""Corridor engine: tube select and route search as one device problem.

Port of :mod:`geomesa_tpu.trajectory.corridor`. Q corridor queries are one
(rows x corridors) problem:

- candidate pruning goes through the planner: the union of every
  corridor's per-segment buffered bbox (and time window) runs as one
  planned query (:func:`prune_filter`, ``DataStore.query``);
- the corridors' segments pack into query matrices (:func:`_pack`) that the
  fused ``corridor_masks`` kernel evaluates over the candidates
  (:func:`geomesa_tpu_torch.parallel.query.corridor_step`): the clamped f32
  point-to-segment distance, the exact int (bin, offset) time window and
  the heading test;
- the kernel answers in two f32 bands (``cand`` a widened superset,
  ``sure`` a narrowed certain-in); only the rows between them are re-checked
  in f64 (:func:`corridor_masks_f64`), so the results are exactly the f64
  semantics of the host paths (``process.processes.tube_select``,
  ``process.tracks.route_search``), which the tests and ``chip_smoke.py``
  hold them to.

What the port changes: the route between the device and the host refine is
a fixed rule, the device (``DEFAULT_ROUTE``); the reference's cost-model
observation and audit shadow (``_observe_route``, ``_maybe_audit``) wait
for the observability plane (ROADMAP.md A.9); record-level visibility
(``auths``) raises ``NotImplementedError`` (A.8.6). The reference pads rows,
segments and corridors to power-of-two buckets for XLA; the port pads the
segments to the batch's longest corridor only (``corridor_step``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from geomesa_tpu_torch.curve.binned_time import BinnedTime
from geomesa_tpu_torch.filter import ast
from geomesa_tpu_torch.filter.cql import parse
from geomesa_tpu_torch.parallel.query import corridor_step
from geomesa_tpu_torch.planning.planner import Query
from geomesa_tpu_torch.schema.columnar import representative_xy
from geomesa_tpu_torch.store.backends import time_quads

__all__ = ["CorridorSpec", "corridor_masks_f64", "route_search_device", "tube_select_device",
           "tube_select_many"]

# f32 distance band half-width (deg): the widened and narrowed thresholds
# cover the worst f32 error of the point-to-segment computation at lon/lat
# magnitudes (|coord| <= 360: projection and cancellation error <~ 1e-4);
# only speed rides the width, since every band row is re-checked in f64
DIST_SLACK_DEG = 2e-3
HEADING_SLACK_DEG = 0.05  # f32 error of the mod-360 wrap is <~ 1e-4 deg
ROUTES = ("device", "host")
# The route when the caller names none. The reference asks the adaptive cost
# model (traj:corridor-dev / traj:corridor-host), whose untrained seed picks
# the device; the port has no cost model yet (ROADMAP.md A.8.3), so the
# seed's winner is a fixed rule here, as process.join.join_counts_auto keeps
# its seed rule. The card contradicts the seed: chip_smoke.py's phase 11 on
# an H100 times the host route faster at bench config 10 (PERF.md), since
# the device route's time goes to the candidate query's host residual (an OR
# of every segment's box) and its take, not to the kernel.
DEFAULT_ROUTE = "device"
_UNCONSTRAINED = np.array([0, -1, 2**31 - 1, 2**31 - 1], dtype=np.int32)
_UNSATISFIABLE = np.array([1, 0, 0, -1], dtype=np.int32)


@dataclass(frozen=True)
class CorridorSpec:
    """One corridor query: ordered waypoints, optional per-waypoint times.

    ``pts``: P >= 2 (lon, lat) waypoints. ``ts``: P epoch-ms (tube select),
    or None (route search: no time constraint). ``heading_tolerance_deg``
    None: no heading constraint."""

    pts: tuple
    ts: tuple | None
    buffer_deg: float
    time_buffer_ms: int = 0
    heading_tolerance_deg: float | None = None
    bidirectional: bool = False

    @staticmethod
    def tube(track, buffer_deg: float, time_buffer_ms: int) -> "CorridorSpec":
        """From a tube-select track ``[(lon, lat, epoch_ms), ...]``."""
        if len(track) < 2:
            raise ValueError("tube requires at least 2 waypoints")
        return CorridorSpec(pts=tuple((float(x), float(y)) for x, y, _ in track),
                            ts=tuple(int(t) for _, _, t in track),
                            buffer_deg=float(buffer_deg), time_buffer_ms=int(time_buffer_ms))

    @staticmethod
    def route(route, buffer_deg: float, heading_tolerance_deg=None,
              bidirectional: bool = False) -> "CorridorSpec":
        """From a route-search waypoint list ``[(lon, lat), ...]``."""
        if len(route) < 2:
            raise ValueError("route requires at least 2 waypoints")
        return CorridorSpec(
            pts=tuple((float(x), float(y)) for x, y in route), ts=None,
            buffer_deg=float(buffer_deg),
            heading_tolerance_deg=(None if heading_tolerance_deg is None
                                   else float(heading_tolerance_deg)),
            bidirectional=bool(bidirectional))

    def segments(self):
        """(x1, y1, x2, y2 (S,) f64, t_lo, t_hi (S,) int64 or None)."""
        p = np.asarray(self.pts, dtype=np.float64)
        x1, y1, x2, y2 = p[:-1, 0], p[:-1, 1], p[1:, 0], p[1:, 1]
        if self.ts is None:
            return x1, y1, x2, y2, None, None
        t = np.asarray(self.ts, dtype=np.int64)
        lo = np.minimum(t[:-1], t[1:]) - self.time_buffer_ms
        hi = np.maximum(t[:-1], t[1:]) + self.time_buffer_ms
        return x1, y1, x2, y2, lo, hi

    def bearings(self) -> np.ndarray:
        """Per-segment bearing (degrees clockwise from north)."""
        x1, y1, x2, y2, _, _ = self.segments()
        return np.degrees(np.arctan2(x2 - x1, y2 - y1)) % 360.0


def prune_filter(sft, specs, base=None) -> ast.Filter:
    """The candidate filter: the OR over every corridor's per-segment
    buffered bbox (AND its time window when timed), one planned query for
    the whole batch; the query's residual re-applies it, so the candidates
    are a superset of every corridor's rows. ``base``: a further filter
    (CQL or AST), ANDed."""
    parts = []
    for spec in specs:
        x1, y1, x2, y2, lo, hi = spec.segments()
        b = spec.buffer_deg
        for i in range(len(x1)):
            box = ast.BBox(sft.geom_field, min(x1[i], x2[i]) - b, min(y1[i], y2[i]) - b,
                           max(x1[i], x2[i]) + b, max(y1[i], y2[i]) + b)
            if lo is not None:
                if sft.dtg_field is None:
                    raise ValueError("timed corridor over a schema with no dtg field")
                box = ast.And([box, ast.During(sft.dtg_field, int(lo[i]) - 1, int(hi[i]) + 1)])
            parts.append(box)
    f = parts[0] if len(parts) == 1 else ast.Or(parts)
    if base is not None:
        f = ast.And([f, parse(base) if isinstance(base, str) else base])
    return f


def corridor_masks_f64(xs, ys, tms, hdg, specs) -> np.ndarray:
    """Exact f64 corridor membership, (Q, N) bool over the given rows: a
    row matches a corridor when some segment has point-to-segment distance
    at most the buffer and, where timed, the row's time inside the
    segment's buffered span and, where heading-constrained, a finite
    heading within tolerance of the segment's bearing. The one definition
    that the device route's band refine and the host route share."""
    n = len(xs)
    out = np.zeros((len(specs), n), dtype=bool)
    if n == 0:
        return out
    cx, cy = xs[:, None], ys[:, None]
    for qi, spec in enumerate(specs):
        x1, y1, x2, y2, lo, hi = spec.segments()
        dx, dy = (x2 - x1)[None, :], (y2 - y1)[None, :]
        len2 = dx * dx + dy * dy
        with np.errstate(divide="ignore", invalid="ignore"):
            tp = np.where(len2 > 0, ((cx - x1[None, :]) * dx + (cy - y1[None, :]) * dy) / len2,
                          0.0)
        tp = np.clip(tp, 0.0, 1.0)
        d2 = (cx - (x1[None, :] + tp * dx)) ** 2 + (cy - (y1[None, :] + tp * dy)) ** 2
        ok = d2 <= spec.buffer_deg ** 2
        if lo is not None:
            ct = tms[:, None]
            ok &= (ct >= lo[None, :]) & (ct <= hi[None, :])
        if spec.heading_tolerance_deg is not None:
            if hdg is None:
                raise ValueError("heading-constrained corridor without a heading column")
            h = hdg[:, None]
            with np.errstate(invalid="ignore"):
                diff = np.abs((h - spec.bearings()[None, :] + 180.0) % 360.0 - 180.0)
            if spec.bidirectional:
                diff = np.minimum(diff, 180.0 - diff)
            ok &= np.isfinite(h) & (diff <= spec.heading_tolerance_deg)
        out[qi] = ok.any(axis=1)
    return out


def _pack(specs, sft):
    """A corridor batch → the kernel's payloads: ``(segs (Q, S, 4) f32, tq
    (Q, S, 4) int32, brg (Q, S) f32, buf2_lo, buf2_hi, tol_lo, tol_hi (Q,)
    f32)``, S the batch's most segments. A shorter corridor's padded
    segments hold the unsatisfiable time quad; an untimed segment the
    unconstrained one; a corridor without a heading constraint the >= 360
    tolerance that the kernel accepts outright (a finite stand-in would drop
    NaN-heading rows, since NaN compares False)."""
    q = len(specs)
    s_cap = max(len(sp.pts) - 1 for sp in specs)
    segs = np.zeros((q, s_cap, 4), dtype=np.float32)
    tq = np.tile(_UNSATISFIABLE, (q, s_cap, 1))
    brg = np.zeros((q, s_cap), dtype=np.float32)
    bands = np.zeros((4, q), dtype=np.float32)  # buf2_lo, buf2_hi, tol_lo, tol_hi
    for qi, spec in enumerate(specs):
        x1, y1, x2, y2, lo, hi = spec.segments()
        s = len(x1)
        segs[qi, :s] = np.stack([x1, y1, x2, y2], axis=1)
        if lo is None:
            tq[qi, :s] = _UNCONSTRAINED
        else:
            for si in range(s):
                quads = time_quads(sft, [(int(lo[si]), int(hi[si]))])
                tq[qi, si] = quads[0] if quads is not None else _UNCONSTRAINED
        brg[qi, :s] = spec.bearings().astype(np.float32)
        b = spec.buffer_deg
        bands[0, qi] = max(b - DIST_SLACK_DEG, 0.0) ** 2
        bands[1, qi] = (b + DIST_SLACK_DEG) ** 2
        tol = spec.heading_tolerance_deg
        if tol is None:
            bands[2, qi] = bands[3, qi] = 999.0
        else:
            bands[2, qi] = max(tol - HEADING_SLACK_DEG, 0.0)
            bands[3, qi] = tol + HEADING_SLACK_DEG
    return segs, tq, brg, *bands


def tube_select_many(ds, type_name: str, specs, filter=None, heading_field: str | None = None,
                     route: str | None = None, auths=None):
    """Q corridor queries in one pass → one result table per corridor.

    One planned candidate query (:func:`prune_filter`), then the fused
    device kernel and the f64 band refine (``route="device"``, the default)
    or the f64 refine on the host (``"host"``) over the shared candidates.
    The results are exactly :func:`corridor_masks_f64`'s either way.
    ``auths`` (record-level visibility) is not ported and raises
    ``NotImplementedError``."""
    if auths is not None:
        raise NotImplementedError("tube_select_many: record-level visibility (auths) is not "
                                  "ported yet (ROADMAP.md A.8.6)")
    if route is not None and route not in ROUTES:
        raise ValueError(f"unknown corridor route {route!r}: one of {ROUTES}")
    specs = list(specs)
    if not specs:
        return []
    sft = ds.get_schema(type_name)
    if heading_field is None and any(s.heading_tolerance_deg is not None for s in specs):
        raise ValueError("heading-constrained specs need heading_field")
    t = ds.query(type_name, Query(filter=prune_filter(sft, specs, filter))).table
    n = len(t)
    if n == 0:
        return [t for _ in specs]
    xs, ys = representative_xy(t)
    tms = t.dtg_millis() if sft.dtg_field else np.zeros(n, dtype=np.int64)
    hdg = None
    if heading_field is not None:
        col = t.columns[heading_field]
        with np.errstate(invalid="ignore"):
            hdg = col.values.astype(np.float64) % 360.0  # NaN stays NaN: never aligned
        if col.valid is not None:
            hdg = np.where(col.valid, hdg, np.nan)
    if (route or DEFAULT_ROUTE) == "device":
        masks = _device_masks(sft, specs, xs, ys, tms, hdg, ds.device)
    else:
        masks = corridor_masks_f64(xs, ys, tms, hdg, specs)
    return [t.take(np.nonzero(masks[qi])[0]) for qi in range(len(specs))]


def _device_masks(sft, specs, xs, ys, tms, hdg, device) -> np.ndarray:
    """The device route: one kernel launch, or two when a batch mixes uni-
    and bidirectional heading constraints (each launch runs one variant of
    the kernel, as each of the reference's compiled steps does)."""
    constrained = [s.heading_tolerance_deg is not None for s in specs]
    bi = [c and s.bidirectional for c, s in zip(constrained, specs)]
    if hdg is None or not any(bi) or all(b for b, c in zip(bi, constrained) if c):
        return _corridor_kernel(sft, specs, xs, ys, tms, hdg, device)
    m = np.zeros((len(specs), len(xs)), dtype=bool)
    for side in (False, True):
        idx = [i for i, b in enumerate(bi) if b == side]
        m[idx] = _corridor_kernel(sft, [specs[i] for i in idx], xs, ys, tms, hdg, device)
    return m


def _corridor_kernel(sft, specs, xs, ys, tms, hdg, device) -> np.ndarray:
    """One ``corridor_masks`` launch over a batch of one directionality:
    the rows and the packed corridors uploaded, the two band masks read
    back, and the rows of ``cand & ~sure`` re-checked in f64."""
    n = len(xs)
    if sft.dtg_field:
        bins, offs = BinnedTime(sft.z3_interval).to_bin_and_offset(tms)
    else:
        bins = offs = np.zeros(n, dtype=np.int64)
    heading = hdg is not None and any(s.heading_tolerance_deg is not None for s in specs)
    bidirectional = heading and any(s.bidirectional for s in specs
                                    if s.heading_tolerance_deg is not None)
    dev = torch.device(device)

    def up(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(dev)

    rows = (up(xs, np.float32), up(ys, np.float32), up(bins, np.int32), up(offs, np.int32),
            up(hdg if hdg is not None else np.zeros(n), np.float32))
    segs, tq, brg, *bands = _pack(specs, sft)
    payload = (up(segs, np.float32), up(tq, np.int32), up(brg, np.float32),
               *(up(b, np.float32) for b in bands))
    cand, sure = corridor_step(*rows, *payload, heading, bidirectional)
    cand, sure = cand.cpu().numpy(), sure.cpu().numpy()
    out = sure.copy()
    band = cand & ~sure
    for qi in np.nonzero(band.any(axis=1))[0]:
        r = np.nonzero(band[qi])[0]
        exact = corridor_masks_f64(xs[r], ys[r], tms[r], None if hdg is None else hdg[r],
                                   [specs[qi]])
        out[qi, r] |= exact[0]
    return out


def tube_select_device(ds, type_name: str, track, buffer_deg: float, time_buffer_ms: int,
                       filter=None, auths=None):
    """One tube select on the corridor engine (the product path; the host
    :func:`geomesa_tpu_torch.process.processes.tube_select` is its
    referee)."""
    spec = CorridorSpec.tube(track, buffer_deg, time_buffer_ms)
    return tube_select_many(ds, type_name, [spec], filter=filter, auths=auths)[0]


def route_search_device(ds, type_name: str, route, buffer_deg: float,
                        heading_field: str | None = None, heading_tolerance_deg: float = 45.0,
                        bidirectional: bool = False, filter=None, auths=None):
    """One route search on the corridor engine (the product path; the host
    :func:`geomesa_tpu_torch.process.tracks.route_search` is its
    referee)."""
    spec = CorridorSpec.route(route, buffer_deg,
                              heading_tolerance_deg=(heading_tolerance_deg
                                                     if heading_field is not None else None),
                              bidirectional=bidirectional)
    return tube_select_many(ds, type_name, [spec], filter=filter, heading_field=heading_field,
                            auths=auths)[0]
