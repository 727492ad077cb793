"""Corridor engine: tube select and route search as one device problem.

Port of :mod:`geomesa_tpu.trajectory.corridor`. Q corridor queries are one
(rows x corridors) problem:

- candidate pruning goes through the planner: the union of every
  corridor's per-segment buffered bbox (and time window) runs as one
  planned query (:func:`prune_filter`, ``DataStore.query``);
- the corridors' segments pack into query matrices (:func:`_pack`) that the
  fused ``corridor_masks`` kernel evaluates over the candidates: the
  clamped f32 point-to-segment distance, the exact int (bin, offset) time
  window and the heading test. On a store whose plan reads a resident point
  state the kernel's gather form reads the device select's positions there
  (:func:`geomesa_tpu_torch.ops.kernels.corridor_masks_gather`), and the
  candidate query's residual and take are skipped: the corridor test
  implies the prune filter. Elsewhere its row form reads the candidate
  query's rows (:func:`geomesa_tpu_torch.parallel.query.corridor_step`);
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
segments to the batch's longest corridor only (``corridor_step``). The
reference's device route always takes the candidate query's rows to the
host and uploads them again; the port's reads resident candidates in
place where it can (same results: the f64 semantics above).
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from geomesa_tpu_torch.curve.binned_time import BinnedTime
from geomesa_tpu_torch.filter import ast
from geomesa_tpu_torch.filter.cql import parse
from geomesa_tpu_torch.ops.kernels import corridor_masks_gather
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
# its seed rule. On a point store the card bears the seed out since the
# device route reads the candidates where they are resident (chip_smoke.py's
# phase 11 on an H100, PERF.md); on a line or polygon store the device route
# still pays the candidate query's host residual (an OR of every segment's
# box) and its take, as the host route does.
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
                     route: str | None = None, auths=None, timings: dict | None = None):
    """Q corridor queries in one pass → one result table per corridor.

    One planned candidate query (:func:`prune_filter`), then the fused
    device kernel and the f64 band refine (``route="device"``, the default)
    or the f64 refine on the host (``"host"``) over the shared candidates.
    The device route reads the candidates where the plan finds them: on a
    store whose plan scans a resident point state (z3 or z2 of a
    ``DeviceBackend``) the kernel's gather form tests the device select's
    positions on the card, with no residual of the candidate query and no
    take of its rows (the corridor test implies the prune filter, so only
    ``filter`` is applied exactly, to the matched rows); on any other store
    (lines and polygons, the Oracle backend) the row form tests the rows of
    the candidate query's table. The results are exactly
    :func:`corridor_masks_f64`'s either way. ``timings``, when given, gains
    ``route`` ("device:resident", "device:table" or "host"), the candidates
    and band rows, the rows given to an exact residual, and the host-clock
    ms of ``plan_ms``, ``select_ms``, ``residual_ms``, ``kernel_ms`` (the
    uploads, launches and the masks' copy back), ``refine_ms`` (the f64
    band refine) and ``take_ms``. ``auths`` (record-level visibility) is
    not ported and raises ``NotImplementedError``."""
    if auths is not None:
        raise NotImplementedError("tube_select_many: record-level visibility (auths) is not "
                                  "ported yet (ROADMAP.md A.8.6)")
    if route is not None and route not in ROUTES:
        raise ValueError(f"unknown corridor route {route!r}: one of {ROUTES}")
    specs = list(specs)
    if not specs:
        return []
    sft = ds.get_schema(type_name)
    if heading_field is None and _constrained(specs):
        raise ValueError("heading-constrained specs need heading_field")
    base = parse(filter) if isinstance(filter, str) else filter
    prune = Query(filter=prune_filter(sft, specs, base))
    tm = timings if timings is not None else {}
    tm.update({"kernel_ms": 0.0, "refine_ms": 0.0, "band_rows": 0})
    device = (route or DEFAULT_ROUTE) == "device"
    res = ds.resident_candidates(type_name, prune) if device else None
    if res is not None:
        return _resident_route(sft, specs, res, base, heading_field, ds.device, tm)
    r = ds.query(type_name, prune)
    t, n = r.table, len(r.table)
    tm.update({"route": "device:table" if device else "host", "candidates": n,
               "residual_rows": n, **(r.timings or {})})
    if n == 0:
        return [t for _ in specs]
    xs, ys = representative_xy(t)
    tms = t.dtg_millis() if sft.dtg_field else np.zeros(n, dtype=np.int64)
    hdg = _headings(t.columns[heading_field]) if _constrained(specs) else None
    if device:
        matches = _device_matches(sft, specs, _TableRows(xs, ys, tms, sft, ds.device), hdg,
                                  ds.device, tm)
    else:
        s = time.perf_counter()
        masks = corridor_masks_f64(xs, ys, tms, hdg, specs)
        matches = [np.nonzero(m)[0] for m in masks]
        tm["refine_ms"] = (time.perf_counter() - s) * 1e3
    s = time.perf_counter()
    out = [t.take(idx) for idx in matches]
    tm["take_ms"] = tm.get("take_ms", 0.0) + (time.perf_counter() - s) * 1e3
    return out


def _constrained(specs) -> bool:
    return any(s.heading_tolerance_deg is not None for s in specs)


def _headings(col, rows=None) -> np.ndarray:
    """A heading column's values (at ``rows``) as f64 degrees mod 360, NaN
    where null or not finite (never aligned)."""
    vals = col.values if rows is None else col.values[rows]
    with np.errstate(invalid="ignore"):
        hdg = vals.astype(np.float64) % 360.0  # NaN stays NaN: never aligned
    if col.valid is not None:
        hdg = np.where(col.valid if rows is None else col.valid[rows], hdg, np.nan)
    return hdg


def _resident_route(sft, specs, res, base, heading_field, device, tm) -> list:
    """The device route over resident candidates: the gather form over the
    device select's positions, the band rows refined in f64 from the
    table's exact columns, ``base`` (the caller's filter) applied exactly to
    the matched rows only, each corridor's rows sorted and taken."""
    table, pos = res.table, res.positions
    c = int(pos.shape[0])
    tm.update({"route": "device:resident", "candidates": c, "residual_rows": 0,
               "residual_ms": 0.0, **res.timings})
    if c == 0:
        empty = table.take(np.zeros(0, dtype=np.int64))
        return [empty for _ in specs]
    rows = _ResidentRows(res, sft)
    hdg = None
    if _constrained(specs):
        hdg = _headings(table.columns[heading_field], rows.table_rows())
    matches = [rows.table_rows(idx) for idx in _device_matches(sft, specs, rows, hdg, device, tm)]
    if base is not None and not isinstance(base, ast.Include):
        s = time.perf_counter()
        matched = np.unique(np.concatenate(matches))
        kept = matched[ast.residual_mask(base, table, matched)]
        matches = [m[np.isin(m, kept)] for m in matches]
        tm.update({"residual_rows": len(matched), "residual_ms": (time.perf_counter() - s) * 1e3})
    s = time.perf_counter()
    out = [table.take(np.sort(m)) for m in matches]
    tm["take_ms"] = (time.perf_counter() - s) * 1e3
    return out


class _TableRows:
    """The row form's candidates: the rows of the candidate query's table,
    uploaded once as f32 coordinates and int32 (bin, offset)."""

    def __init__(self, xs, ys, tms, sft, device):
        self.xs, self.ys, self.tms, self.sft, self.device = xs, ys, tms, sft, device
        self.n = len(xs)
        self._up = None

    def masks(self, hdg, payload, heading: bool, bidirectional: bool):
        if self._up is None:
            if self.sft.dtg_field:
                bins, offs = BinnedTime(self.sft.z3_interval).to_bin_and_offset(self.tms)
            else:
                bins = offs = np.zeros(self.n, dtype=np.int64)
            self._up = [_upload(a, d, self.device) for a, d in
                        ((self.xs, np.float32), (self.ys, np.float32), (bins, np.int32),
                         (offs, np.int32))]
        if hdg is None:
            hdg = torch.zeros(self.n, dtype=torch.float32, device=self.device)
        return corridor_step(*self._up, hdg, *payload, heading, bidirectional)

    def exact(self, idx):
        return self.xs[idx], self.ys[idx], self.tms[idx]


class _ResidentRows:
    """The gather form's candidates: a point state's resident columns read
    through the device select's positions; the exact columns of a
    candidate come from the table row its position maps to."""

    def __init__(self, res, sft):
        self.res, self.sft = res, sft
        self._pos = None

    def table_rows(self, idx=None) -> np.ndarray:
        """The table rows of the candidates ``idx`` (all by default): their
        positions, copied to the host once, through the index's ``perm``."""
        if self._pos is None:
            self._pos = self.res.positions.cpu().numpy()
        return self.res.perm[self._pos if idx is None else self._pos[idx]]

    def masks(self, hdg, payload, heading: bool, bidirectional: bool):
        return corridor_masks_gather(*self.res.state.spatial_cols(), self.res.positions, hdg,
                                     *payload, heading, bidirectional)

    def exact(self, idx):
        r = self.table_rows(idx)
        t = self.res.table
        xs, ys = representative_xy(t)
        tms = t.dtg_millis()[r] if self.sft.dtg_field else np.zeros(len(r), dtype=np.int64)
        return xs[r], ys[r], tms


def _upload(a, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(device)


def _device_matches(sft, specs, rows, hdg, device, tm) -> list:
    """The device route's matches, each corridor's candidate indices
    ascending: one kernel launch, or two when a batch mixes uni- and
    bidirectional heading constraints (each launch runs one variant of the
    kernel, as each of the reference's compiled steps does)."""
    constrained = [s.heading_tolerance_deg is not None for s in specs]
    bi = [c and s.bidirectional for c, s in zip(constrained, specs)]
    if hdg is None or not any(bi) or all(b for b, c in zip(bi, constrained) if c):
        return _corridor_kernel(sft, specs, rows, hdg, device, tm)
    out = [None] * len(specs)
    for side in (False, True):
        idx = [i for i, b in enumerate(bi) if b == side]
        for i, m in zip(idx, _corridor_kernel(sft, [specs[i] for i in idx], rows, hdg, device,
                                              tm)):
            out[i] = m
    return out


def _set_bits(words: np.ndarray) -> list:
    """Each corridor's set bits of (Q, W) uint32 mask words as row indices,
    ascending (bit j of word w is the row 32 w + j): the words read 64 bits
    at a time, only the non-zero ones unpacked."""
    q, w = words.shape
    flat = np.ascontiguousarray(words).reshape(-1)
    if flat.size % 2:
        flat = np.append(flat, np.uint32(0))
    u = flat.view(np.uint64)
    nz = np.flatnonzero(u)
    k = np.flatnonzero(np.unpackbits(u[nz].view(np.uint8), bitorder="little").view(bool))
    g = nz[k >> 6] * 64 + (k & 63)  # corridor * 32 W + row
    span = 32 * w
    return [part - i * span
            for i, part in enumerate(np.split(g, np.searchsorted(g, np.arange(1, q) * span)))]


def _corridor_kernel(sft, specs, rows, hdg, device, tm) -> list:
    """One ``corridor_masks`` launch (the row or the gather form, as
    ``rows`` is) over a batch of one directionality: the packed corridors
    (and the headings) uploaded, the two bands' words read back, and each
    corridor's rows of ``cand & ~sure`` re-checked in f64 and merged into
    its ``sure`` rows. Returns each corridor's matched candidate indices,
    ascending."""
    heading = hdg is not None and _constrained(specs)
    bidirectional = heading and any(s.bidirectional for s in specs
                                    if s.heading_tolerance_deg is not None)
    s0 = time.perf_counter()
    payload = [_upload(a, a.dtype, device) for a in _pack(specs, sft)]
    hdg_t = _upload(hdg, np.float32, device) if heading else None
    cand, sure = rows.masks(hdg_t, payload, heading, bidirectional)
    cand = cand.cpu().numpy().view(np.uint32)
    sure = sure.cpu().numpy().view(np.uint32)
    s1 = time.perf_counter()
    out = _set_bits(sure)
    for qi, band in enumerate(_set_bits(cand & ~sure)):
        if not len(band):
            continue
        xs, ys, tms = rows.exact(band)
        keep = band[corridor_masks_f64(xs, ys, tms, None if hdg is None else hdg[band],
                                       [specs[qi]])[0]]
        out[qi] = np.insert(out[qi], np.searchsorted(out[qi], keep), keep)
        tm["band_rows"] += len(band)
    tm["kernel_ms"] += (s1 - s0) * 1e3
    tm["refine_ms"] += (time.perf_counter() - s1) * 1e3
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
