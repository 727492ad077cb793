"""WKT read/write for the geometry model (the JTS WKTReader/Writer role).

Port copy of :mod:`geomesa_tpu.geometry.wkt` over
:mod:`geomesa_tpu_torch.geometry.types`: :func:`from_wkt` parses the six
geometry types, :func:`to_wkt` writes them with 10 significant digits per
coordinate (so a round trip may move a coordinate; the port's stores carry
coordinates as arrays, never through WKT)."""

from __future__ import annotations

import re

import numpy as np

from geomesa_tpu_torch.geometry.types import (
    Geometry,
    LineString,
    MultiLineString,
    MultiPoint,
    MultiPolygon,
    Point,
    Polygon,
)

_NUM = r"[-+]?\d*\.?\d+(?:[eE][-+]?\d+)?"


def _parse_coord_seq(body: str) -> np.ndarray:
    pts = []
    for pair in body.split(","):
        xy = pair.split()
        if len(xy) < 2:
            raise ValueError(f"bad coordinate: {pair!r}")
        pts.append((float(xy[0]), float(xy[1])))
    return np.asarray(pts, dtype=np.float64)


def _split_rings(body: str) -> list[str]:
    """Split '(...), (...)' at top level."""
    rings, depth, start = [], 0, None
    for i, ch in enumerate(body):
        if ch == "(":
            if depth == 0:
                start = i + 1
            depth += 1
        elif ch == ")":
            depth -= 1
            if depth == 0:
                rings.append(body[start:i])
    if depth != 0:
        raise ValueError(f"unbalanced parens in WKT body: {body!r}")
    return rings


def from_wkt(wkt: str) -> Geometry:
    s = wkt.strip()
    m = re.match(r"^([A-Za-z]+)\s*\((.*)\)\s*$", s, re.S)
    if not m:
        raise ValueError(f"invalid WKT: {wkt!r}")
    typ = m.group(1).upper()
    body = m.group(2).strip()
    if typ == "POINT":
        c = _parse_coord_seq(body)
        return Point(float(c[0, 0]), float(c[0, 1]))
    if typ == "LINESTRING":
        return LineString(_parse_coord_seq(body))
    if typ == "POLYGON":
        rings = [_parse_coord_seq(r) for r in _split_rings(body)]
        return Polygon(rings[0], tuple(rings[1:]))
    if typ == "MULTIPOINT":
        if "(" in body:
            pts = [_parse_coord_seq(r) for r in _split_rings(body)]
            coords = np.vstack(pts)
        else:
            coords = _parse_coord_seq(body)
        return MultiPoint(tuple(Point(float(x), float(y)) for x, y in coords))
    if typ == "MULTILINESTRING":
        return MultiLineString(
            tuple(LineString(_parse_coord_seq(r)) for r in _split_rings(body))
        )
    if typ == "MULTIPOLYGON":
        polys = []
        # each polygon is ((ring), (ring)...)
        depth, start = 0, None
        for i, ch in enumerate(body):
            if ch == "(":
                if depth == 0:
                    start = i + 1
                depth += 1
            elif ch == ")":
                depth -= 1
                if depth == 0:
                    inner = body[start:i]
                    rings = [_parse_coord_seq(r) for r in _split_rings(inner)]
                    polys.append(Polygon(rings[0], tuple(rings[1:])))
        return MultiPolygon(tuple(polys))
    raise ValueError(f"unsupported WKT type: {typ}")


def _fmt(v: float) -> str:
    return f"{v:.10g}"


def _ring_str(c: np.ndarray) -> str:
    return "(" + ", ".join(f"{_fmt(x)} {_fmt(y)}" for x, y in c) + ")"


def to_wkt(g: Geometry) -> str:
    if isinstance(g, Point):
        return f"POINT ({_fmt(g.x)} {_fmt(g.y)})"
    if isinstance(g, LineString):
        return "LINESTRING " + _ring_str(g.coords)
    if isinstance(g, Polygon):
        return "POLYGON (" + ", ".join(_ring_str(r) for r in g.rings) + ")"
    if isinstance(g, MultiPoint):
        return "MULTIPOINT (" + ", ".join(
            f"({_fmt(p.x)} {_fmt(p.y)})" for p in g.parts
        ) + ")"
    if isinstance(g, MultiLineString):
        return "MULTILINESTRING (" + ", ".join(_ring_str(l.coords) for l in g.parts) + ")"
    if isinstance(g, MultiPolygon):
        return (
            "MULTIPOLYGON ("
            + ", ".join("(" + ", ".join(_ring_str(r) for r in p.rings) + ")" for p in g.parts)
            + ")"
        )
    raise ValueError(f"cannot serialize: {g!r}")
