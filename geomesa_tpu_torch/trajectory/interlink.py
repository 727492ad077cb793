"""Spatial interlinking: every (left, right) pair of two stores' features
under an envelope predicate.

Port of :mod:`geomesa_tpu.trajectory.interlink`. The predicates, on f64
feature envelopes:

- ``intersects`` — the envelopes overlap (touching counts); for points,
  point in box or point equality;
- ``dwithin`` — envelope-to-envelope distance at most ``distance``
  (degrees);
- either lifted to 3D with ``time_buffer_ms``: also ``|t_left - t_right| <=
  time_buffer_ms``.

Candidate pairing: the right envelopes get XZ sequence codes
(:class:`geomesa_tpu_torch.curve.xz.XZSFC`, 2D, or dims=3 with the time
axis lifted into the cube), and each left envelope's buffered window is
covered by ``XZSFC.ranges`` and ``searchsorted`` over the sorted codes: a
superset, which the f64 refine cuts to the exact pair set of the nested
loop referee (:func:`interlink_referee`). For a right store of points with
z2 residency on the card, the candidates may come from the blocked device
join instead (``route="block"``: ``process.join.join_rows_device``, the
``planned_gather`` kernel).

What the port changes: the pairing is a fixed rule (``DEFAULT_PAIRING``,
see its note): the block route where the right store can take it and the
call has no ``rfilter`` and no ``time_buffer_ms``, else the XZ pairing; a
``"block"`` route (forced or by default) on a right store without point z2
residency on a device backend falls back to ``"xz"``, a test made before
anything is launched, and the module logs which route ran.
``link_members`` (the federated view's members) waits for the merged view
(ROADMAP.md A.12), the cost-model observation and the audit shadow for A.9,
and ``auths`` raises ``NotImplementedError`` (A.8.6).
"""

from __future__ import annotations

import logging

import numpy as np

from geomesa_tpu_torch.curve.xz import XZSFC, xz2_sfc
from geomesa_tpu_torch.geometry.types import Polygon
from geomesa_tpu_torch.planning.planner import Query
from geomesa_tpu_torch.process.join import join_rows_device
from geomesa_tpu_torch.store.backends import DeviceBackend

__all__ = ["envelopes", "interlink", "interlink_referee"]

log = logging.getLogger(__name__)

PREDICATES = ("intersects", "dwithin")
# The pairing when the caller names none and the query can take either. It
# stands in for the reference's cost-model choice (``_choose_pairing``,
# geomesa_tpu/trajectory/interlink.py:188) until the port has a cost model
# (ROADMAP.md A.8.3), and departs from that model's untrained seed, which
# picks the XZ pairing (seed 1.0 ms against the block route's 2.0). The
# reference's model learns from observed times; on an H100 it would pick
# the block route: chip_smoke.py's phase 11 (NVIDIA H100 80GB HBM3, 700 W
# power limit) timed it at 447.75 ms against
# the XZ pairing's 2069.17 in one run and 540.12 against 2685.82 in another
# on bench config 10's point stores (PERF.md section 5), the XZ pairing's
# time being its Python range planning. The two routes' answers are equal.
DEFAULT_PAIRING = "block"
XZ_G = 12  # curve precision (the reference default)
MAX_RANGES_PER_LEFT = 64  # range budget per left window (coarse = superset)


def envelopes(table):
    """Per-row f64 envelopes ``(xmin, ymin, xmax, ymax, valid)``: points
    degenerate, extended geometries their bounds, null or NaN rows
    invalid."""
    col = table.geom_column()
    n = len(table)
    if col.x is not None:
        x = np.asarray(col.x, dtype=np.float64)
        y = np.asarray(col.y, dtype=np.float64)
        b = np.stack([x, y, x, y], axis=1)
    elif col.bounds is not None:
        b = np.asarray(col.bounds, dtype=np.float64)
    else:
        return (np.zeros(n),) * 4 + (np.zeros(n, dtype=bool),)
    valid = np.isfinite(b).all(axis=1)
    if col.valid is not None:
        valid &= col.valid
    b = np.where(valid[:, None], b, 0.0)
    return b[:, 0], b[:, 1], b[:, 2], b[:, 3], valid


def _rect_dist2(lx1, ly1, lx2, ly2, rx1, ry1, rx2, ry2):
    """Squared envelope-to-envelope distance (0 when they overlap)."""
    dx = np.maximum(np.maximum(rx1 - lx2, lx1 - rx2), 0.0)
    dy = np.maximum(np.maximum(ry1 - ly2, ly1 - ry2), 0.0)
    return dx * dx + dy * dy


def interlink_referee(ltable, rtable, pred: str = "intersects", distance: float = 0.0,
                      time_buffer_ms: int | None = None) -> list:
    """Nested-loop f64 referee: every (left fid, right fid) pair under the
    predicate, sorted, with no pruning, planner or device."""
    lx1, ly1, lx2, ly2, lv = envelopes(ltable)
    rx1, ry1, rx2, ry2, rv = envelopes(rtable)
    d = float(distance) if pred == "dwithin" else 0.0
    lt = ltable.dtg_millis() if time_buffer_ms is not None else None
    rt = rtable.dtg_millis() if time_buffer_ms is not None else None
    out = []
    for i in range(len(ltable)):
        if not lv[i]:
            continue
        ok = rv & (_rect_dist2(lx1[i], ly1[i], lx2[i], ly2[i], rx1, ry1, rx2, ry2) <= d * d)
        if time_buffer_ms is not None:
            ok &= np.abs(rt - lt[i]) <= int(time_buffer_ms)
        for j in np.nonzero(ok)[0]:
            out.append((str(ltable.fids[i]), str(rtable.fids[j])))
    out.sort()
    return out


def _xz_candidates(ltable, rtable, distance: float, time_buffer_ms: int | None, lenv, renv):
    """XZ-range candidate pairing: the right envelopes' sorted XZ codes and,
    per valid left row, the cover of its buffered window. 2D
    (:func:`~geomesa_tpu_torch.curve.xz.xz2_sfc`) without a time buffer,
    else dims=3 with the time axis lifted into the cube over both tables'
    times. Yields ``(left_row, candidate_right_rows)``."""
    lx1, ly1, lx2, ly2, lv = lenv
    rx1, ry1, rx2, ry2, rv = renv
    rrows = np.nonzero(rv)[0]
    if len(rrows) == 0:
        return
    if time_buffer_ms is None:
        sfc = xz2_sfc(XZ_G)
        codes = sfc.index((rx1[rrows], ry1[rrows]), (rx2[rrows], ry2[rrows]))
        t_lo = t_hi = None
    else:
        lt = ltable.dtg_millis()
        rt = rtable.dtg_millis()
        buf = int(time_buffer_ms)
        tmin = float(min(lt.min() if len(lt) else 0, rt[rrows].min()) - buf - 1)
        tmax = float(max(lt.max() if len(lt) else 1, rt[rrows].max()) + buf + 1)
        sfc = XZSFC(g=XZ_G, dims=3, mins=(-180.0, -90.0, tmin), maxs=(180.0, 90.0, tmax))
        t = rt[rrows].astype(np.float64)
        codes = sfc.index((rx1[rrows], ry1[rrows], t), (rx2[rrows], ry2[rrows], t))
        t_lo, t_hi = lt.astype(np.float64) - buf, lt.astype(np.float64) + buf
    order = np.argsort(codes, kind="stable")
    sorted_codes = codes[order]
    sorted_rows = rrows[order]
    for i in np.nonzero(lv)[0]:
        lo = (lx1[i] - distance, ly1[i] - distance)
        hi = (lx2[i] + distance, ly2[i] + distance)
        if t_lo is not None:
            lo = lo + (t_lo[i],)
            hi = hi + (t_hi[i],)
        ranges = sfc.ranges([(lo, hi)], max_ranges=MAX_RANGES_PER_LEFT)
        if len(ranges) == 0:
            continue
        starts = np.searchsorted(sorted_codes, ranges[:, 0], side="left")
        ends = np.searchsorted(sorted_codes, ranges[:, 1], side="right")
        if np.any(ends > starts):
            yield i, np.unique(np.concatenate([sorted_rows[s:e] for s, e in zip(starts, ends)]))


def _block_servable(rds, rtype: str) -> bool:
    """Whether the right store can take the block route: a device backend
    holding a z2 residency of points (the layout test, made before any
    launch)."""
    if not isinstance(rds.backend, DeviceBackend):
        return False
    st = rds._state(rtype)
    return (st.sft.geom_is_points and st.table is not None and len(st.table) > 0
            and (st.backend_state or {}).get("z2") is not None)


def _block_candidates(ltable, rds, rtype: str, distance: float):
    """The blocked device join's pairing: each left buffered envelope as a
    box polygon against the right store's z2-resident points
    (``join_rows_device``: an int-domain superset gather on the card and
    the f64 ``intersects`` of the join), then the refine below decides the
    pairs. Returns ``(right table, [(left_row, right_rows)])``."""
    lx1, ly1, lx2, ly2, lv = envelopes(ltable)
    boxes, rows_for = [], []
    for i in np.nonzero(lv)[0]:
        x1, y1 = lx1[i] - distance, ly1[i] - distance
        x2, y2 = lx2[i] + distance, ly2[i] + distance
        boxes.append(Polygon(np.array([[x1, y1], [x2, y1], [x2, y2], [x1, y2], [x1, y1]])))
        rows_for.append(i)
    rtable = rds._state(rtype).table
    if not boxes:
        return rtable, []
    snap, pairs = join_rows_device(rds, rtype, boxes, pred="intersects")
    return snap, [(rows_for[bi], np.asarray(r, dtype=np.int64)) for bi, r in pairs if len(r)]


def interlink(lds, ltype: str, rds, rtype: str, pred: str = "intersects", distance: float = 0.0,
              time_buffer_ms: int | None = None, lfilter=None, rfilter=None,
              route: str | None = None, auths=None) -> list:
    """Predicate links between two stores → sorted ``[(left_fid,
    right_fid), ...]``, the exact pair set of :func:`interlink_referee` over
    the same tables.

    ``pred``: ``intersects`` or ``dwithin``; ``time_buffer_ms`` lifts it to
    3D (XZ3 pairing). ``route`` forces the pairing, ``"xz"`` or ``"block"``;
    by default the block route where the right store holds point z2
    residency on a device and the call has neither ``rfilter`` nor
    ``time_buffer_ms``, else the XZ pairing (:data:`DEFAULT_PAIRING`). A
    forced ``"block"`` cannot apply ``rfilter`` or the time lift and raises
    ``ValueError`` with either."""
    if auths is not None:
        raise NotImplementedError("interlink: record-level visibility (auths) is not ported yet "
                                  "(ROADMAP.md A.8.6)")
    if pred not in PREDICATES:
        raise ValueError(f"unsupported predicate {pred!r} (supported: {PREDICATES})")
    d = float(distance) if pred == "dwithin" else 0.0
    if d < 0:
        raise ValueError("distance must be >= 0")
    if route not in (None, "xz", "block"):
        raise ValueError(f"unknown interlink route {route!r}: 'xz' or 'block'")
    ltable = lds.query(ltype, Query(filter=lfilter)).table
    chosen = route
    if chosen is None:
        chosen = ("xz" if time_buffer_ms is not None or rfilter is not None
                  else DEFAULT_PAIRING)
    elif chosen == "block" and (time_buffer_ms is not None or rfilter is not None):
        raise ValueError("route='block' cannot serve rfilter/time_buffer_ms: use route='xz' "
                         "(or let the router decide)")
    if chosen == "block" and not _block_servable(rds, rtype):
        log.info("interlink %s -> %s: no point z2 residency on a device; xz pairing", ltype,
                 rtype)
        chosen = "xz"
    if chosen == "block":
        rtable, cands = _block_candidates(ltable, rds, rtype, d)
        log.info("interlink %s -> %s: block route", ltype, rtype)
        return _refine(ltable, rtable, cands, pred, d, time_buffer_ms)
    rtable = rds.query(rtype, Query(filter=rfilter)).table
    lenv, renv = envelopes(ltable), envelopes(rtable)
    cands = list(_xz_candidates(ltable, rtable, d, time_buffer_ms, lenv, renv))
    log.info("interlink %s -> %s: xz route", ltype, rtype)
    return _refine(ltable, rtable, cands, pred, d, time_buffer_ms, lenv=lenv, renv=renv)


def _refine(ltable, rtable, cands, pred: str, d: float, time_buffer_ms: int | None, lenv=None,
            renv=None) -> list:
    """The exact f64 refine of candidate pairs, sharing the envelope math
    with :func:`interlink_referee` (:func:`_rect_dist2`)."""
    lx1, ly1, lx2, ly2, _lv = lenv if lenv is not None else envelopes(ltable)
    rx1, ry1, rx2, ry2, rv = renv if renv is not None else envelopes(rtable)
    lt = ltable.dtg_millis() if time_buffer_ms is not None else None
    rt = rtable.dtg_millis() if time_buffer_ms is not None else None
    out = []
    for i, rrows in cands:
        ok = rv[rrows] & (_rect_dist2(lx1[i], ly1[i], lx2[i], ly2[i], rx1[rrows], ry1[rrows],
                                      rx2[rrows], ry2[rrows]) <= d * d)
        if time_buffer_ms is not None:
            ok &= np.abs(rt[rrows] - lt[i]) <= int(time_buffer_ms)
        for j in rrows[ok]:
            out.append((str(ltable.fids[i]), str(rtable.fids[j])))
    out.sort()
    return out
