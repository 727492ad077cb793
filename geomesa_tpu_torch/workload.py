"""GDELT-shaped synthetic events and city-box queries (bench config 2's
data), bench config 3's KNN points, bench config 4's join polygons, bench
config 5's trajectory bboxes, bench config 9's group keys and values, bench
config 8's streamed chunks, bench config 7's resident store and its query
planning, and bench config 10's tracks, corridors and link points.

Port copies of ``bench.py``'s ``synth_gdelt``, ``make_queries``, config 3's
KNN points, config 4's polygons, config 5's bboxes, ``_pack_query_boxes``,
config 9's group ids and values, config 8's ``host_chunk``, config 7's
``_bin_spans`` and ``_plan_query_intervals`` and config 10's generators
(tests hold them equal), plus :func:`resident_store` (config 7's store
with its keys built on the card), plus :func:`box_linestrings` (line strings whose bboxes are
given boxes, for a line store), :func:`bbox_cql` and
:func:`bbox_time_cql`, which write one query as the CQL a user would send, and :func:`edge_columns` /
:func:`edge_payload`, the rows and payloads that hold the count kernels'
staged predicate to their plain versions at its edges.
"""

from __future__ import annotations

import datetime
import time

import numpy as np
import torch

from geomesa_tpu_torch.curve import normalize
from geomesa_tpu_torch.curve.binned_time import MAX_OFFSET, BinnedTime, TimePeriod
from geomesa_tpu_torch.curve.sfc import z3_sfc
from geomesa_tpu_torch.geometry.types import Polygon
from geomesa_tpu_torch.index.z3 import sort_bin_z
from geomesa_tpu_torch.ops.kernels import z3_encode
from geomesa_tpu_torch.ops.refine import pack_boxes, pack_times
from geomesa_tpu_torch.store.backends import int_boxes

T0 = 1_498_867_200_000  # 2017-07-01, GDELT-era
SPAN_DAYS = 30
SPEC = "dtg:Date,*geom:Point:srid=4326;geomesa.z3.interval='day'"

CITIES = np.array(
    [[-74, 40.7], [0.1, 51.5], [2.3, 48.8], [116.4, 39.9], [37.6, 55.7],
     [-99.1, 19.4], [28.0, -26.2], [77.2, 28.6], [139.7, 35.7], [31.2, 30.0]]
)


def synth_gdelt(n: int, seed: int = 42):
    """GDELT-shaped events: population-center clusters + uniform background.
    Returns (lon f64, lat f64, epoch-ms int64)."""
    rng = np.random.default_rng(seed)
    k = n // 2
    which = rng.integers(0, len(CITIES), k)
    lon = np.empty(n)
    lat = np.empty(n)
    lon[:k] = CITIES[which, 0] + rng.normal(0, 3.0, k)
    lat[:k] = CITIES[which, 1] + rng.normal(0, 2.0, k)
    lon[k:] = rng.uniform(-180, 180, n - k)
    lat[k:] = rng.uniform(-60, 75, n - k)
    np.clip(lon, -180, 180, out=lon)
    np.clip(lat, -90, 90, out=lat)
    t = T0 + rng.integers(0, SPAN_DAYS * 86_400_000, n)
    return lon, lat, t


def make_queries(q: int, seed: int = 7):
    """q city-centered boxes with 2-7 day windows: ([(x1, y1, x2, y2)],
    [(lo_ms, hi_ms)])."""
    rng = np.random.default_rng(seed)
    boxes_f64 = []
    windows_ms = []
    for _ in range(q):
        cx, cy = CITIES[rng.integers(0, len(CITIES))]
        w = float(rng.uniform(2, 20))
        h = float(rng.uniform(2, 15))
        x1 = max(-180.0, cx - w / 2)
        x2 = min(180.0, cx + w / 2)
        y1 = max(-90.0, cy - h / 2)
        y2 = min(90.0, cy + h / 2)
        lo = T0 + int(rng.integers(0, (SPAN_DAYS - 7) * 86_400_000))
        hi = lo + int(rng.integers(2, 7)) * 86_400_000
        boxes_f64.append((x1, y1, x2, y2))
        windows_ms.append((lo, hi))
    return boxes_f64, windows_ms


def knn_points(n: int, seed: int = 3) -> np.ndarray:
    """Bench config 3's KNN query points (``bench.py:560-565``): each a
    ``CITIES`` row plus ``normal(0, 1, 2)`` degrees, from one generator.
    Returns (n, 2) float64 (lon, lat)."""
    rng = np.random.default_rng(seed)
    return np.stack([CITIES[rng.integers(0, len(CITIES))] + rng.normal(0, 1, 2)
                     for _ in range(n)]).reshape(n, 2)


def join_polygons(k: int, seed: int = 5):
    """Bench config 4's polygons (``bench.py:660-669``): from one generator,
    per polygon a ``CITIES`` row plus ``normal(0, 4, 2)`` degrees as its
    center, width and height ``uniform(0.2, 1.5, 2)``, 8 to 95 vertices at
    sorted random angles and radii ``uniform(0.3, 1.0)``. Returns k
    :class:`~geomesa_tpu_torch.geometry.types.Polygon` (closed shells)."""
    rng = np.random.default_rng(seed)
    polys = []
    for _ in range(k):
        cx, cy = CITIES[rng.integers(0, len(CITIES))] + rng.normal(0, 4, 2)
        w, h = rng.uniform(0.2, 1.5, 2)
        nv = int(rng.integers(8, 96))
        ang = np.sort(rng.uniform(0, 2 * np.pi, nv))
        rad = rng.uniform(0.3, 1.0, nv)
        ring = np.stack([cx + w * rad * np.cos(ang), cy + h * rad * np.sin(ang)], 1)
        polys.append(Polygon(ring))
    return polys


# bench config 5's store as a line-string schema: config 2's day bins
XZ_SPEC = "dtg:Date,*geom:LineString:srid=4326;geomesa.z3.interval='day'"
# the same with bench config 9's group key and value column (the value nullable)
XZ_AGG_SPEC = ("cat:Integer,val:Double,dtg:Date,*geom:LineString:srid=4326;"
               "geomesa.z3.interval='day'")


def xz_boxes(m: int, seed: int = 9):
    """Bench config 5's trajectory bboxes (``bench.py:797-808``): short GPS
    tracks clustered around ``CITIES``, from one generator. Returns (xmin,
    ymin, xmax, ymax) f64 arrays of length ``m``."""
    rng = np.random.default_rng(seed)
    which = rng.integers(0, len(CITIES), m)
    cx = CITIES[which, 0] + rng.normal(0, 3.0, m)
    cy = CITIES[which, 1] + rng.normal(0, 2.0, m)
    w = rng.exponential(0.05, m)
    h = rng.exponential(0.05, m)
    return (np.clip(cx - w, -180, 180), np.clip(cy - h, -90, 90),
            np.clip(cx + w, -180, 180), np.clip(cy + h, -90, 90))


def box_linestrings(xmin, ymin, xmax, ymax, seed: int = 11):
    """A line string on each box: 2 to 5 vertices, the first at (xmin,
    ymin), the last at (xmax, ymax), the rest inside the box, so that each
    feature's bbox is its box exactly. Returns ``(coords (M, 2) f64,
    offsets (n + 1,) int64)``, the input of
    :func:`~geomesa_tpu_torch.schema.columnar.linestring_column`."""
    rng = np.random.default_rng(seed)
    n = len(xmin)
    k = rng.integers(2, 6, n)
    offsets = np.concatenate([[0], np.cumsum(k)]).astype(np.int64)
    feat = np.repeat(np.arange(n), k)
    u = rng.random((int(offsets[-1]), 2))
    lo = np.stack([xmin, ymin], 1)[feat]
    hi = np.stack([xmax, ymax], 1)[feat]
    coords = np.clip(lo + u * (hi - lo), lo, hi)
    coords[offsets[:-1]] = np.stack([xmin, ymin], 1)
    coords[offsets[1:] - 1] = np.stack([xmax, ymax], 1)
    return coords, offsets


def star_ring(rng, nv: int, cx: float, cy: float, w: float, h: float, levels: int = 0):
    """A closed star-shaped ring of ``nv`` float32 vertices (the last repeats
    the first), drawn as :func:`join_polygons` draws a shell: sorted random
    angles, radii ``uniform(0.3, 1.0)``; with ``levels`` its y snapped to
    that many values, so that many edges are horizontal. Returns (nv, 2)."""
    ang = np.sort(rng.uniform(0, 2 * np.pi, nv - 1))
    rad = rng.uniform(0.3, 1.0, nv - 1)
    ys = cy + h * rad * np.sin(ang)
    if levels:
        ys = cy + h * np.round((ys - cy) / h * levels) / levels
    ring = np.stack([cx + w * rad * np.cos(ang), ys], 1)
    return np.concatenate([ring, ring[:1]]).astype(np.float32)


def iso_millis(ms: int) -> str:
    """Epoch millis → ``YYYY-MM-DDTHH:MM:SS.mmmZ``."""
    dt = datetime.datetime(1970, 1, 1) + datetime.timedelta(milliseconds=int(ms))
    return dt.strftime("%Y-%m-%dT%H:%M:%S.") + f"{dt.microsecond // 1000:03d}Z"


def bbox_cql(box, geom: str = "geom") -> str:
    """``BBOX(geom, x1, y1, x2, y2)`` for one box: a spatial-only query."""
    x1, y1, x2, y2 = (float(v) for v in box)
    return f"BBOX({geom}, {x1!r}, {y1!r}, {x2!r}, {y2!r})"


def bbox_time_cql(box, window, geom: str = "geom", dtg: str = "dtg") -> str:
    """``BBOX(geom, x1, y1, x2, y2) AND dtg DURING lo/hi`` for one query."""
    lo, hi = window
    return f"{bbox_cql(box, geom)} AND {dtg} DURING {iso_millis(lo)}/{iso_millis(hi)}"


# bench config 9's store (bench.py:1588): GDELT-shaped points with a group
# key and a value; the default z3 interval (week)
AGG_SPEC = "cat:Integer,val:Double,dtg:Date,*geom:Point"


def grouped_columns(n: int, n_groups: int = 1024, seed: int = 17):
    """Bench config 9's group ids and values (``bench.py:1610-1619``): from
    one generator, ``gid`` (n,) int32 uniform in ``[0, n_groups)``, then
    ``vals`` (n,) f64 normal(50, 20)."""
    rng = np.random.default_rng(seed)
    gid = rng.integers(0, n_groups, n).astype(np.int32)
    return gid, rng.normal(50.0, 20.0, n)


STREAM_MAX_OFF = 86_400_000 - 1  # PERIOD=DAY offsets; one chunk = one time bin


def stream_chunk(c: int, n: int):
    """Bench config 8's host chunk ``c`` of ``n`` rows (``bench.py:1313``):
    uniform int-domain x/y, random offsets, every row in time bin ``c``.
    Returns (x, y, bins, offs) int32."""
    rng = np.random.default_rng(1000 + c)
    x = rng.integers(0, 2**31 - 1, n, dtype=np.int32)
    y = rng.integers(0, 2**31 - 1, n, dtype=np.int32)
    offs = rng.integers(0, STREAM_MAX_OFF, n, dtype=np.int32)
    bins = np.full(n, c, dtype=np.int32)
    return x, y, bins, offs


def pack_query_boxes(boxes_f64, overlap: bool = False) -> np.ndarray:
    """f64 boxes → (Q, 1, 4) normalized int32 payloads, one slot per query
    (``bench.py:273``; ``overlap`` for the bbox-overlap kernels)."""
    return np.stack([pack_boxes(int_boxes([b]), slots=1, overlap=overlap) for b in boxes_f64])


# -- bench config 7: the resident store and its index-pruned planning ----------

RESIDENT_BLOCK = 1024  # bench config 7's BLOCK: rows a planned pair covers
RESIDENT_PERIOD = TimePeriod.DAY  # bench.py PERIOD


def pack_query_times(windows_ms, period: TimePeriod = RESIDENT_PERIOD) -> np.ndarray:
    """(lo_ms, hi_ms) windows → (Q, 1, 4) int32 time payloads, one slot per
    query (the times of ``bench.py:293`` ``_pack_queries``)."""
    binned = BinnedTime(period)
    out = []
    for lo, hi in windows_ms:
        (blo,), (olo,) = binned.to_bin_and_offset(np.array([lo]))
        (bhi,), (ohi,) = binned.to_bin_and_offset(np.array([hi]))
        out.append(pack_times(np.array([[blo, olo, bhi, ohi]], dtype=np.int32), slots=1))
    return np.stack(out)


def resident_store(lon, lat, t_ms, device, block_rows: int = RESIDENT_BLOCK,
                   period: TimePeriod = RESIDENT_PERIOD) -> dict:
    """Bench config 7's store (``bench.py:233`` ``_sharded_store`` with one
    shard): the points as four int32 columns (x, y at 31 bits, the time
    bin and offset) sorted by (bin, z3), zero-padded to a multiple of
    ``block_rows``, resident on ``device``. The keys are built there, the
    port's index-build idiom: the host normalizes, ``z3_encode`` interleaves
    the 21-bit coordinates, two stable sorts order (bin, z) as the
    reference's host lexsort does, and only the sorted z and bins (for
    planning) come back. Returns ``{"cols", "true_n", "z_sorted" (uint64),
    "bins_sorted" (int32), "host" (the four int32 columns in input order, for
    a referee), "binned", "sfc", "seconds"}``; ``seconds`` splits the build
    (normalize, stage, encode, sort, copy_back)."""
    dev = torch.device(device)
    clock = {}
    t0 = time.perf_counter()

    def lap(name):
        nonlocal t0
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        clock[name] = time.perf_counter() - t0
        t0 = time.perf_counter()

    binned, sfc = BinnedTime(period), z3_sfc(period)
    bins, offs = binned.to_bin_and_offset(t_ms)
    host = (normalize.lon(31).normalize(lon).astype(np.int32),
            normalize.lat(31).normalize(lat).astype(np.int32),
            bins.astype(np.int32), offs.astype(np.int32))
    zin = sfc.normalized(lon, lat, offs)
    lap("normalize")
    d_zin = [torch.from_numpy(c).to(dev) for c in zin]
    d_bins = torch.from_numpy(host[2]).to(dev)
    lap("stage")
    z = z3_encode(*d_zin)
    del d_zin
    lap("encode")
    perm = sort_bin_z(d_bins, z)
    n = len(lon)
    padded = -(-n // block_rows) * block_rows
    cols = []
    for c in host:
        out = torch.zeros(padded, dtype=torch.int32, device=dev)
        out[:n] = torch.from_numpy(c).to(dev)[perm]
        cols.append(out)
    z_sorted = z[perm]
    del z
    lap("sort")
    z_np = z_sorted.cpu().numpy().view(np.uint64)
    bins_np = cols[2][:n].cpu().numpy()
    lap("copy_back")
    return {"cols": tuple(cols), "true_n": n, "z_sorted": z_np, "bins_sorted": bins_np,
            "host": host, "binned": binned, "sfc": sfc, "seconds": clock}


def bin_spans(bins_sorted):
    """Per-bin [start, end) spans of the (bin, z)-sorted store, computed
    once per store (``bench.py:305`` ``_bin_spans``): ``({bin: start},
    {bin: end})``."""
    ub = np.unique(bins_sorted)
    lo = {int(b): int(np.searchsorted(bins_sorted, b, "left")) for b in ub}
    hi = {int(b): int(np.searchsorted(bins_sorted, b, "right")) for b in ub}
    return lo, hi


def plan_query_intervals(boxes_f64, windows_ms, binned, sfc, z_sorted, spans):
    """Per-query global row intervals covering every row the int-domain
    scan predicate can match (``bench.py:315`` ``_plan_query_intervals``):
    per time bin, the z3 ranges of the box widened by one 21-bit cell a side
    (so the coarse planning grid never excludes a row the 31-bit predicate
    passes; raw-offset windows map monotonically onto the 21-bit time codes
    and need no widening), mapped onto the (bin, z)-sorted store by
    ``searchsorted``. ``sfc`` is the port's ``Z3SFC`` (its ranges from the
    native ``zranges``); returns a list of (k, 2) int64 arrays."""
    max_off = MAX_OFFSET[binned.period]
    lo_by_bin, hi_by_bin = spans
    dx = 360.0 / (1 << 21)
    dy = 180.0 / (1 << 21)
    out = []
    for (x1, y1, x2, y2), (lo, hi) in zip(boxes_f64, windows_ms):
        (blo,), (olo,) = binned.to_bin_and_offset(np.array([lo]))
        (bhi,), (ohi,) = binned.to_bin_and_offset(np.array([hi]))
        box = (max(-180.0, x1 - dx), max(-90.0, y1 - dy),
               min(180.0, x2 + dx), min(90.0, y2 + dy))
        ivs = []
        for b in range(int(blo), int(bhi) + 1):
            s0 = lo_by_bin.get(b)
            if s0 is None:
                continue
            s1 = hi_by_bin[b]
            o0 = int(olo) if b == int(blo) else 0
            o1 = int(ohi) if b == int(bhi) else max_off
            rng = sfc.ranges([box], (o0, o1), max_ranges=2000)
            zb = z_sorted[s0:s1]
            a = s0 + np.searchsorted(zb, rng[:, 0], "left")
            e = s0 + np.searchsorted(zb, rng[:, 1], "right")
            keep = e > a
            ivs.append(np.stack([a[keep], e[keep]], axis=1))
        out.append(np.concatenate(ivs) if ivs else np.empty((0, 2), np.int64))
    return out


# -- bench config 10: drifting tracks, corridors and link points ---------------

TRACK_SPEC = "track:String,dtg:Date,*geom:Point"  # bench.py:1856
LINK_SPEC = "dtg:Date,*geom:Point"  # bench.py:1920


def trajectory_workload(n: int, n_corridors: int = 16, seed: int = 15):
    """Bench config 10's store and corridors (``bench.py:1840-1890``), from
    one generator in the bench's order: ``n_tracks = max(n // 256, 32)``
    tracks drifting around ``CITIES``, each point of a random track, then
    ``n_corridors`` tube corridors of 2-3 waypoints near a city, buffers
    0.3-1.2 degrees and time buffers of 1-47 hours. Returns ``(lon, lat,
    t_ms, track_ids (object "t<k>"), n_tracks, corridors)``, each corridor
    ``(track [(lon, lat, ms), ...], buffer_deg, time_buffer_ms)``."""
    rng = np.random.default_rng(seed)
    n_tracks = max(n // 256, 32)
    which = rng.integers(0, len(CITIES), n_tracks)
    tx = CITIES[which, 0] + rng.normal(0, 3.0, n_tracks)
    ty = CITIES[which, 1] + rng.normal(0, 2.0, n_tracks)
    owner = rng.integers(0, n_tracks, n)
    lon = np.clip(tx[owner] + rng.normal(0, 1.0, n), -179.9, 179.9)
    lat = np.clip(ty[owner] + rng.normal(0, 0.8, n), -89.9, 89.9)
    t_ms = T0 + rng.integers(0, SPAN_DAYS * 86_400_000, n)
    track_ids = np.char.add("t", owner.astype(str)).astype(object)
    corridors = []
    for _ in range(n_corridors):
        npts = int(rng.integers(2, 4))
        city = CITIES[rng.integers(0, len(CITIES))]
        xs = np.sort(city[0] + rng.uniform(-6, 6, npts))
        ys = city[1] + rng.uniform(-4, 4, npts)
        ts = T0 + np.sort(rng.integers(0, SPAN_DAYS * 86_400_000, npts))
        corridors.append(([(float(x), float(y), int(t)) for x, y, t in zip(xs, ys, ts)],
                          float(rng.uniform(0.3, 1.2)), int(rng.integers(1, 48)) * 3_600_000))
    return lon, lat, t_ms, track_ids, n_tracks, corridors


def link_points(n: int, seed: int):
    """One interlink store's points (``bench.py:1920`` ``_pts``): from one
    generator, times within a day of ``T0``, lon uniform in [-20, 20], lat
    in [-10, 10]. Returns (t_ms int64, lon, lat)."""
    s = np.random.default_rng(seed)
    t = T0 + s.integers(0, 86_400_000, n)
    return t, s.uniform(-20, 20, n), s.uniform(-10, 10, n)


# -- edge cases of the count kernels' staged predicate -------------------------

I32_MIN, I32_MAX = -(2**31), 2**31 - 1
_I32_EDGES = np.array([I32_MIN, I32_MAX, 0, -1, 1, I32_MIN + 1, I32_MAX - 1], np.int64)


def edge_columns(n: int, seed: int):
    """(x, y, bins, offs) int32 rows over the whole int32 range, with its
    extremes spliced in at the front, offsets of both signs, bins in
    [-2, 3], and about a tenth of the rows at ``bins = offs = 0`` (a
    date-less store's rows)."""
    rng = np.random.default_rng(seed)
    x, y, offs = (rng.integers(I32_MIN, I32_MAX, n, endpoint=True) for _ in range(3))
    bins = rng.integers(-2, 4, n)
    k = min(n, len(_I32_EDGES))
    x[:k], y[:k], offs[:k] = _I32_EDGES[:k], _I32_EDGES[::-1][:k], _I32_EDGES[:k]
    zero = rng.random(n) < 0.1
    bins[zero] = 0
    offs[zero] = 0
    return tuple(a.astype(np.int32) for a in (x, y, bins, offs))


def _live_box(rng, x, y, i: int) -> list[int]:
    xi, yi = int(x[i]), int(y[i])
    kind = int(rng.integers(5))
    if kind == 0:  # degenerate: xlo == xhi, ylo == yhi, on a row
        return [xi, xi, yi, yi]
    if kind == 1:  # around a row
        d = int(rng.integers(1, 2**29))
        return [max(I32_MIN, xi - d), min(I32_MAX, xi + d),
                max(I32_MIN, yi - d), min(I32_MAX, yi + d)]
    if kind == 2:  # everything
        return [I32_MIN, I32_MAX, I32_MIN, I32_MAX]
    edge = I32_MIN if kind == 3 else I32_MAX  # one extreme column of x
    return [edge, edge, I32_MIN, I32_MAX]


def _dead_box(rng, x, y, i: int) -> list[int]:
    kind = int(rng.integers(4))
    if kind == 0:
        return [1, 0, 1, 0]  # ops/refine.py's padding sentinel
    if kind == 1:  # x bounds inverted, y everything
        lo, hi = sorted(int(v) for v in rng.choice(x, 2))
        return [hi, lo, I32_MIN, I32_MAX] if lo < hi else [1, 0, I32_MIN, I32_MAX]
    if kind == 2:  # inverted across the whole range: xhi - xlo is 1 modulo 2^32
        return [I32_MAX, I32_MIN, I32_MIN, I32_MAX]
    return [I32_MIN, I32_MAX, I32_MAX, I32_MIN]


def _live_window(rng, bins, offs, i: int) -> list[int]:
    bi, oi = int(bins[i]), int(offs[i])
    kind = int(rng.integers(5))
    if kind == 0:  # one row's instant
        return [bi, oi, bi, oi]
    if kind == 1:  # pack_times' unconstrained window
        return [0, -1, I32_MAX, I32_MAX]
    if kind == 2:  # negative offsets of one bin
        return [bi, I32_MIN, bi, -1]
    if kind == 3:  # across bins, offsets of either sign
        lo, hi = (int(v) for v in rng.integers(I32_MIN, I32_MAX, 2, endpoint=True))
        return [bi - 1, lo, bi + 1, hi]
    return [I32_MIN, I32_MIN, I32_MAX, I32_MAX]  # everything


def _dead_window(rng, bins, offs, i: int) -> list[int]:
    bi, oi = int(bins[i]), int(offs[i])
    kind = int(rng.integers(4))
    if kind == 0:
        return [1, 0, 0, -1]  # ops/refine.py's padding sentinel
    if kind == 1:  # one bin, offsets inverted by one
        return [bi, oi, bi, oi - 1] if oi > I32_MIN else [bi, I32_MIN + 1, bi, I32_MIN]
    if kind == 2:  # bins inverted
        return [bi + 1, I32_MIN, bi, I32_MAX]
    return [0, 0, 0, -1]  # live to a key without the offset bias


_EDGE_KINDS = {True: ("one", "dead", "nobox", "notime"),
               False: ("one", "multi", "dead", "nobox", "notime")}


def edge_payload(cols, q: int, nb: int, nt: int, seed: int, single: bool):
    """(q, nb, 4) boxes and (q, nt, 4) times around the rows of ``cols``, in
    shapes the packers of ``ops/refine.py`` never make: live slots at random
    positions behind dead ones (dead in ways other than the padding
    sentinel), degenerate and whole-range boxes and boxes on the int32
    extremes, windows with negative offsets and the unconstrained window,
    and queries with no live box, no live window or neither. With
    ``single`` every query with a live box and a live window has exactly one
    of each (the kernels' single-slot row loop); otherwise some queries
    have several, mixed in one tile with single-slot ones."""
    rng = np.random.default_rng(seed)
    x, y, bins, offs = cols
    boxes = np.empty((q, nb, 4), np.int64)
    times = np.empty((q, nt, 4), np.int64)
    kinds = _EDGE_KINDS[single]
    for qi in range(q):
        kind = kinds[qi % len(kinds)]
        kb = kt = 1
        if kind == "multi":
            kb, kt = int(rng.integers(1, nb + 1)), int(rng.integers(1, nt + 1))
        live_b = set(rng.choice(nb, 0 if kind in ("dead", "nobox") else kb, replace=False).tolist())
        live_t = set(rng.choice(nt, 0 if kind in ("dead", "notime") else kt, replace=False).tolist())
        i = int(rng.integers(len(x)))  # the row the query's slots are built around
        for k in range(nb):
            boxes[qi, k] = (_live_box if k in live_b else _dead_box)(rng, x, y, i)
        for k in range(nt):
            times[qi, k] = (_live_window if k in live_t else _dead_window)(rng, bins, offs, i)
    return boxes.astype(np.int32), times.astype(np.int32)


# -- edge-heavy rows and payloads for the exact count's edge gather ------------


def grid_columns(n: int, seed: int, values: int = 300):
    """(x, y, bins, offs) int32 rows drawn from ``values`` distinct
    coordinates per axis, bins in [0, 4) and ``values`` distinct offsets of
    either sign: many rows share every box edge and window endpoint that
    :func:`grid_payload` puts on those values."""
    rng = np.random.default_rng(seed)
    xs, ys = (np.sort(rng.choice(2**31 - 1, values, replace=False)) for _ in range(2))
    os_ = np.sort(rng.choice(2**32, values, replace=False) - 2**31)
    pick = lambda grid: grid[rng.integers(values, size=n)]  # noqa: E731
    return tuple(a.astype(np.int32)
                 for a in (pick(xs), pick(ys), rng.integers(0, 4, n), pick(os_)))


def grid_payload(cols, q: int, nb: int, nt: int, seed: int):
    """(q, nb, 4) boxes and (q, nt, 4) times whose bounds are values of the
    rows ``cols`` (from :func:`grid_columns`), packed as ``ops/refine.py``
    packs them: 1..nb boxes and 1..nt windows per query, mostly narrow, some
    wide enough that a query's edge candidates overflow any small
    capacity."""
    rng = np.random.default_rng(seed)
    x, y, bins, offs = cols
    xs, ys, bs, os_ = (np.unique(c) for c in (x, y, bins, offs))

    def span(grid):
        lo = int(rng.integers(len(grid)))
        hi = min(len(grid) - 1, lo + int(len(grid) * rng.random() ** 3))
        return int(grid[lo]), int(grid[hi])

    boxes, times = [], []
    for _ in range(q):
        kb, kt = int(rng.integers(1, nb + 1)), int(rng.integers(1, nt + 1))
        boxes.append(pack_boxes(np.array([[*span(xs), *span(ys)] for _ in range(kb)],
                                         np.int32), slots=nb))
        tq = []
        for _ in range(kt):
            blo = int(rng.choice(bs))
            bhi = blo + int(rng.integers(0, 2))
            olo, ohi = (int(v) for v in rng.choice(os_, 2))
            if bhi == blo and olo > ohi:
                olo, ohi = ohi, olo
            tq.append([blo, olo, bhi, ohi])
        times.append(pack_times(np.array(tq, np.int32), slots=nt))
    return np.ascontiguousarray(np.stack(boxes)), np.ascontiguousarray(np.stack(times))
