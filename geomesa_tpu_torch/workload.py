"""GDELT-shaped synthetic events and city-box queries (bench config 2's
data), and bench config 8's streamed chunks.

Port copies of ``bench.py``'s ``synth_gdelt``, ``make_queries``,
``_pack_query_boxes`` and config 8's ``host_chunk`` (tests hold them
equal), plus :func:`bbox_cql` and :func:`bbox_time_cql`, which write one
query as the CQL a user would send.
"""

from __future__ import annotations

import datetime

import numpy as np

from geomesa_tpu_torch.ops.refine import pack_boxes
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


def pack_query_boxes(boxes_f64) -> np.ndarray:
    """f64 boxes → (Q, 1, 4) normalized int32 payloads, one slot per query
    (``bench.py:273``)."""
    return np.stack([pack_boxes(int_boxes([b]), slots=1) for b in boxes_f64])
