"""Planar geometry value model, trimmed for the port.

Port copy of :mod:`geomesa_tpu.geometry.types`: coordinates are ``(N, 2)``
float64 arrays, rings are closed on construction, and every geometry knows
its bbox. Left out: the WKT-based ``__eq__``/``__hash__`` (WKT I/O lives in
:mod:`geomesa_tpu_torch.geometry.wkt`); a :class:`Point` compares by value,
every other geometry by identity.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable

import numpy as np

__all__ = [
    "Geometry",
    "Point",
    "LineString",
    "Polygon",
    "MultiPoint",
    "MultiLineString",
    "MultiPolygon",
    "bbox_union",
    "box",
]


def _coords(arr) -> np.ndarray:
    a = np.asarray(arr, dtype=np.float64)
    if a.ndim != 2 or a.shape[1] != 2:
        raise ValueError(f"coordinates must be (N, 2): got {a.shape}")
    return a


class Geometry:
    """Base geometry; subclasses set ``geom_type`` and implement ``bbox``."""

    geom_type: str = "Geometry"

    @property
    def bbox(self) -> tuple[float, float, float, float]:  # (xmin, ymin, xmax, ymax)
        raise NotImplementedError

    @property
    def is_point(self) -> bool:
        return isinstance(self, Point)


@dataclass(frozen=True)
class Point(Geometry):
    x: float
    y: float
    geom_type = "Point"

    @property
    def bbox(self):
        return (self.x, self.y, self.x, self.y)


@dataclass(frozen=True, eq=False)
class LineString(Geometry):
    coords: np.ndarray  # (N, 2) f64
    geom_type = "LineString"

    def __post_init__(self):
        object.__setattr__(self, "coords", _coords(self.coords))

    @property
    def bbox(self):
        c = self.coords
        return (c[:, 0].min(), c[:, 1].min(), c[:, 0].max(), c[:, 1].max())


@dataclass(frozen=True, eq=False)
class Polygon(Geometry):
    """Shell + holes; rings need not be explicitly closed (we close them)."""

    shell: np.ndarray  # (N, 2) f64
    holes: tuple[np.ndarray, ...] = ()
    geom_type = "Polygon"

    def __post_init__(self):
        object.__setattr__(self, "shell", _close_ring(_coords(self.shell)))
        object.__setattr__(
            self, "holes", tuple(_close_ring(_coords(h)) for h in self.holes)
        )

    @property
    def bbox(self):
        c = self.shell
        return (c[:, 0].min(), c[:, 1].min(), c[:, 0].max(), c[:, 1].max())

    @property
    def rings(self) -> tuple[np.ndarray, ...]:
        return (self.shell, *self.holes)


def _close_ring(c: np.ndarray) -> np.ndarray:
    if len(c) < 3:
        raise ValueError("ring needs at least 3 coordinates")
    if not np.array_equal(c[0], c[-1]):
        c = np.vstack([c, c[:1]])
    return c


@dataclass(frozen=True, eq=False)
class _Multi(Geometry):
    parts: tuple[Geometry, ...]

    def __post_init__(self):
        object.__setattr__(self, "parts", tuple(self.parts))

    @property
    def bbox(self):
        return bbox_union(p.bbox for p in self.parts)


class MultiPoint(_Multi):
    geom_type = "MultiPoint"


class MultiLineString(_Multi):
    geom_type = "MultiLineString"


class MultiPolygon(_Multi):
    geom_type = "MultiPolygon"


def bbox_union(boxes: Iterable[tuple[float, float, float, float]]):
    boxes = list(boxes)
    if not boxes:
        raise ValueError("empty geometry collection")
    a = np.asarray(boxes, dtype=np.float64)
    return (a[:, 0].min(), a[:, 1].min(), a[:, 2].max(), a[:, 3].max())


def box(xmin: float, ymin: float, xmax: float, ymax: float) -> Polygon:
    """Axis-aligned rectangle polygon (the CQL BBOX literal)."""
    return Polygon(
        np.array(
            [[xmin, ymin], [xmax, ymin], [xmax, ymax], [xmin, ymax], [xmin, ymin]],
            dtype=np.float64,
        )
    )
