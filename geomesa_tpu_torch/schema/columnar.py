"""Struct-of-arrays feature table: the host-side columnar store.

Port copy of :mod:`geomesa_tpu.schema.columnar` (its ``Point`` value is
:mod:`geomesa_tpu_torch.geometry.types`'s), trimmed to point schemas: a point column
stores its f64 ``x``/``y`` arrays and nothing else — no object array of
geometries, no bbox array (a point's bbox is the point).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Iterable

import numpy as np

from geomesa_tpu_torch.geometry.types import Point  # noqa: F401  (record-style ingest)
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
    """Point storage: f64 ``x``/``y`` coordinate arrays (``values`` unused)."""

    x: np.ndarray | None = None
    y: np.ndarray | None = None

    def __len__(self) -> int:
        return len(self.x)

    def take(self, idx: np.ndarray) -> "GeometryColumn":
        return GeometryColumn(
            self.type,
            None,
            None if self.valid is None else self.valid[idx],
            x=self.x[idx],
            y=self.y[idx],
        )


def point_column(x: np.ndarray, y: np.ndarray, valid=None) -> GeometryColumn:
    """Point column straight from coordinate arrays (bulk ingest)."""
    return GeometryColumn(
        AttributeType.POINT,
        None,
        valid,
        x=np.asarray(x, dtype=np.float64),
        y=np.asarray(y, dtype=np.float64),
    )


def _point_values(geoms: Iterable[Any]) -> GeometryColumn:
    geoms = list(geoms)
    n = len(geoms)
    x = np.full(n, np.nan)
    y = np.full(n, np.nan)
    valid = np.ones(n, dtype=bool)
    for i, g in enumerate(geoms):
        if g is None:
            valid[i] = False
        elif hasattr(g, "x") and hasattr(g, "y"):
            x[i], y[i] = g.x, g.y
        else:
            x[i], y[i] = g  # (lon, lat) pair
    return point_column(x, y, None if valid.all() else valid)


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
                cols[a.name] = _point_values(vals)
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
                cols[name] = point_column(
                    np.concatenate([p.x for p in parts]),
                    np.concatenate([p.y for p in parts]),
                    valid,
                )
            else:
                cols[name] = Column(
                    parts[0].type, np.concatenate([p.values for p in parts]), valid
                )
        return FeatureTable(sft, fids, cols)
