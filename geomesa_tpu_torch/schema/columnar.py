"""Struct-of-arrays feature table: the host-side columnar store.

Port copy of :mod:`geomesa_tpu.schema.columnar` (its geometry values are
:mod:`geomesa_tpu_torch.geometry.types`'s). A point column stores its f64
``x``/``y`` arrays and nothing else — no object array of geometries, no
bbox array (a point's bbox is the point). An extended geometry column
(lines, polygons and their ``Multi`` forms) stores each feature's f64 bbox
in ``bounds`` (N, 4) ``[xmin, ymin, xmax, ymax]`` (NaN for a null) beside
its geometries: an object array, or, for a line-string column built from
coordinate arrays (:func:`linestring_column`), one ``(M, 2)`` coordinate
array with per-feature offsets, whose objects are made only when asked
for (:meth:`GeometryColumn.geometries`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Iterable

import numpy as np

from geomesa_tpu_torch.geometry.types import LineString, Point
from geomesa_tpu_torch.schema.sft import AttributeType, FeatureType

_NUMERIC_DTYPES = {
    AttributeType.INT: np.int32,
    AttributeType.LONG: np.int64,
    AttributeType.FLOAT: np.float32,
    AttributeType.DOUBLE: np.float64,
    AttributeType.BOOLEAN: np.bool_,
}


@dataclass
class Column:
    """One attribute's storage; ``valid`` is None when all values are set."""

    type: AttributeType
    values: np.ndarray  # typed array; object array for strings
    valid: np.ndarray | None = None

    def __len__(self) -> int:
        return len(self.values)

    def take(self, idx: np.ndarray) -> "Column":
        return Column(
            self.type,
            self.values[idx],
            None if self.valid is None else self.valid[idx],
        )

    def is_valid(self) -> np.ndarray:
        if self.valid is None:
            return np.ones(len(self), dtype=bool)
        return self.valid


@dataclass
class GeometryColumn(Column):
    """Geometry storage. Points: f64 ``x``/``y`` (``values`` and ``bounds``
    unused). Extended geometries: ``bounds`` (N, 4) f64 and either
    ``values``, an object array of geometries, or ``coords`` (M, 2) f64 with
    ``offsets`` (N + 1,) int64, feature i's line-string vertices being
    ``coords[offsets[i]:offsets[i + 1]]``."""

    x: np.ndarray | None = None
    y: np.ndarray | None = None
    bounds: np.ndarray | None = None  # (N, 4) f64: xmin, ymin, xmax, ymax
    coords: np.ndarray | None = None
    offsets: np.ndarray | None = None

    def __len__(self) -> int:
        if self.x is not None:
            return len(self.x)
        return len(self.bounds)

    def take(self, idx: np.ndarray) -> "GeometryColumn":
        valid = None if self.valid is None else self.valid[idx]
        if self.x is not None:
            return GeometryColumn(self.type, None, valid, x=self.x[idx], y=self.y[idx])
        if self.coords is not None:
            starts, ends = self.offsets[:-1][idx], self.offsets[1:][idx]
            lens = ends - starts
            offsets = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
            flat = np.repeat(starts - offsets[:-1], lens) + np.arange(int(offsets[-1]))
            return GeometryColumn(self.type, None, valid, bounds=self.bounds[idx],
                                  coords=self.coords[flat], offsets=offsets)
        return GeometryColumn(self.type, self.values[idx], valid, bounds=self.bounds[idx])

    def geometries(self) -> np.ndarray:
        """The object array of the column's geometries (None for a null);
        made once from the coordinate arrays where it is not stored."""
        if self.values is not None:
            return self.values
        n = len(self)
        vals = np.empty(n, dtype=object)
        ok = self.is_valid()
        if self.x is not None:
            for i in np.flatnonzero(ok):
                vals[i] = Point(float(self.x[i]), float(self.y[i]))
        else:
            for i in np.flatnonzero(ok):
                vals[i] = LineString(self.coords[self.offsets[i]:self.offsets[i + 1]])
        self.values = vals
        return vals


def point_column(x: np.ndarray, y: np.ndarray, valid=None) -> GeometryColumn:
    """Point column straight from coordinate arrays (bulk ingest)."""
    return GeometryColumn(
        AttributeType.POINT,
        None,
        valid,
        x=np.asarray(x, dtype=np.float64),
        y=np.asarray(y, dtype=np.float64),
    )


def linestring_column(coords: np.ndarray, offsets: np.ndarray) -> GeometryColumn:
    """Line-string column straight from coordinate arrays (bulk ingest):
    ``coords`` (M, 2) f64 vertices, feature i's ``coords[offsets[i]:offsets[i
    + 1]]``, at least two each. Bounds are each feature's vertex min and max,
    as ``LineString.bbox`` gives them."""
    coords = np.ascontiguousarray(coords, dtype=np.float64)
    offsets = np.asarray(offsets, dtype=np.int64)
    if coords.ndim != 2 or coords.shape[1] != 2:
        raise ValueError(f"coordinates must be (M, 2): got {coords.shape}")
    if offsets[0] != 0 or offsets[-1] != len(coords) or np.any(np.diff(offsets) < 2):
        raise ValueError("offsets must run from 0 to len(coords), two vertices a feature or more")
    starts = offsets[:-1]
    bounds = np.stack([np.minimum.reduceat(coords[:, 0], starts),
                       np.minimum.reduceat(coords[:, 1], starts),
                       np.maximum.reduceat(coords[:, 0], starts),
                       np.maximum.reduceat(coords[:, 1], starts)], axis=1)
    return GeometryColumn(AttributeType.LINESTRING, None, None, bounds=bounds, coords=coords,
                          offsets=offsets)


def _geometry_column(typ: AttributeType, geoms: Iterable[Any]) -> GeometryColumn:
    """Geometry column of ``typ`` from geometry values, WKT strings (parsed,
    the GeoTools convention) or, for points, (lon, lat) pairs; None is a
    null (``columnar.py:123-158``)."""
    geoms = list(geoms)
    if any(isinstance(g, str) for g in geoms):
        from geomesa_tpu_torch.geometry.wkt import from_wkt

        geoms = [from_wkt(g) if isinstance(g, str) else g for g in geoms]
    n = len(geoms)
    valid = np.ones(n, dtype=bool)
    if typ == AttributeType.POINT:
        x = np.full(n, np.nan)
        y = np.full(n, np.nan)
        for i, g in enumerate(geoms):
            if g is None:
                valid[i] = False
            elif hasattr(g, "x") and hasattr(g, "y"):
                x[i], y[i] = g.x, g.y
            else:
                x[i], y[i] = g  # (lon, lat) pair
        return point_column(x, y, None if valid.all() else valid)
    vals = np.empty(n, dtype=object)
    bounds = np.full((n, 4), np.nan, dtype=np.float64)
    for i, g in enumerate(geoms):
        vals[i] = g
        if g is None:
            valid[i] = False
        else:
            bounds[i] = g.bbox
    return GeometryColumn(typ, vals, None if valid.all() else valid, bounds=bounds)


def _scalar_column(typ: AttributeType, values: Iterable[Any]) -> Column:
    values = list(values)
    n = len(values)
    valid = np.ones(n, dtype=bool)
    if typ in _NUMERIC_DTYPES or typ == AttributeType.DATE:
        arr = np.zeros(n, dtype=_NUMERIC_DTYPES.get(typ, np.int64))
        for i, v in enumerate(values):
            if v is None:
                valid[i] = False
            else:
                arr[i] = _to_millis(v) if typ == AttributeType.DATE else v
        return Column(typ, arr, None if valid.all() else valid)
    arr = np.empty(n, dtype=object)
    for i, v in enumerate(values):
        arr[i] = v
        if v is None:
            valid[i] = False
    return Column(typ, arr, None if valid.all() else valid)


def _to_millis(v) -> int:
    if isinstance(v, (int, np.integer)):
        return int(v)
    if isinstance(v, np.datetime64):
        return int(v.astype("datetime64[ms]").astype(np.int64))
    if isinstance(v, str):
        return int(np.datetime64(v.rstrip("Z"), "ms").astype(np.int64))
    import datetime

    if isinstance(v, datetime.datetime):
        if v.tzinfo is None:
            v = v.replace(tzinfo=datetime.timezone.utc)
        return int(v.timestamp() * 1000)
    raise TypeError(f"cannot convert to epoch millis: {v!r}")


@dataclass
class FeatureTable:
    """An ordered batch of features as columns; the unit of ingest/scan/result."""

    sft: FeatureType
    fids: np.ndarray  # str array (object or fixed-width unicode)
    columns: dict[str, Column]

    def __post_init__(self):
        n = len(self.fids)
        for name, col in self.columns.items():
            if len(col) != n:
                raise ValueError(
                    f"column {name!r} length {len(col)} != feature count {n}"
                )

    def __len__(self) -> int:
        return len(self.fids)

    @staticmethod
    def from_records(
        sft: FeatureType, records: list[dict], fids: list[str] | None = None
    ) -> "FeatureTable":
        cols: dict[str, Column] = {}
        for a in sft.attributes:
            vals = [r.get(a.name) for r in records]
            if a.type.is_geometry:
                cols[a.name] = _geometry_column(a.type, vals)
            else:
                cols[a.name] = _scalar_column(a.type, vals)
        if fids is None:
            fids = [str(i) for i in range(len(records))]
        return FeatureTable(sft, np.asarray(fids, dtype=object), cols)

    @staticmethod
    def from_columns(
        sft: FeatureType, fids, columns: dict[str, Column]
    ) -> "FeatureTable":
        """Bulk constructor: ``fids`` may stay a fixed-width unicode array
        (no per-row Python objects at bulk-ingest scale)."""
        fids = np.asarray(fids)
        if fids.dtype.kind not in "OU":
            raise TypeError("fids must be strings")
        return FeatureTable(sft, fids, columns)

    def take(self, idx) -> "FeatureTable":
        idx = np.asarray(idx)
        return FeatureTable(
            self.sft,
            self.fids[idx],
            {k: c.take(idx) for k, c in self.columns.items()},
        )

    def geom_column(self) -> GeometryColumn:
        if self.sft.geom_field is None:
            raise ValueError(f"schema {self.sft.name} has no geometry")
        return self.columns[self.sft.geom_field]  # type: ignore[return-value]

    def dtg_millis(self) -> np.ndarray:
        if self.sft.dtg_field is None:
            raise ValueError(f"schema {self.sft.name} has no date attribute")
        return self.columns[self.sft.dtg_field].values

    @staticmethod
    def concat(tables: list["FeatureTable"]) -> "FeatureTable":
        if not tables:
            raise ValueError("nothing to concat")
        sft = tables[0].sft
        fids = np.concatenate([t.fids for t in tables])
        cols: dict[str, Column] = {}
        for name in tables[0].columns:
            parts = [t.columns[name] for t in tables]
            valid = None
            if any(p.valid is not None for p in parts):
                valid = np.concatenate([p.is_valid() for p in parts])
            if isinstance(parts[0], GeometryColumn):
                cols[name] = _concat_geometry(parts, valid)
            else:
                cols[name] = Column(
                    parts[0].type, np.concatenate([p.values for p in parts]), valid
                )
        return FeatureTable(sft, fids, cols)


def _concat_geometry(parts: list[GeometryColumn], valid) -> GeometryColumn:
    """One geometry column of ``parts`` in order (``columnar.py:338``):
    points by their coordinates, extended geometries by their bounds and
    their coordinate arrays where every part keeps them, else their
    geometry objects."""
    typ = parts[0].type
    if parts[0].x is not None:
        return point_column(np.concatenate([p.x for p in parts]),
                            np.concatenate([p.y for p in parts]), valid)
    bounds = np.concatenate([p.bounds for p in parts])
    if all(p.coords is not None for p in parts):
        shifts = np.cumsum([0] + [len(p.coords) for p in parts[:-1]])
        offsets = np.concatenate([parts[0].offsets[:1]]
                                 + [p.offsets[1:] + s for p, s in zip(parts, shifts)])
        return GeometryColumn(typ, None, valid, bounds=bounds,
                              coords=np.concatenate([p.coords for p in parts]), offsets=offsets)
    return GeometryColumn(typ, np.concatenate([p.geometries() for p in parts]), valid,
                          bounds=bounds)


def representative_xy(table: FeatureTable) -> tuple[np.ndarray, np.ndarray]:
    """Representative point coordinates of each feature (``columnar.py:351``):
    a point's own, or its bbox centroid for an extended geometry (the
    track processes and the corridor engine refine on these)."""
    col = table.geom_column()
    if col.x is not None:
        return col.x, col.y
    b = col.bounds
    return (b[:, 0] + b[:, 2]) * 0.5, (b[:, 1] + b[:, 3]) * 0.5
