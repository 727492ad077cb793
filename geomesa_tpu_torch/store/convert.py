"""Carry a reference store's main tier across into the port's store.

:func:`load_reference_state` takes the main tier of a ``geomesa_tpu``
DataStore as plain numpy arrays — extracted by the caller, so this module
never imports the reference — and installs it in the port's store in the
same row order, without re-sorting, staging the same device columns.
"""

from __future__ import annotations

import numpy as np

from geomesa_tpu_torch.geometry.types import (
    LineString, MultiLineString, MultiPoint, MultiPolygon, Point, Polygon)
from geomesa_tpu_torch.schema.columnar import (
    Column, FeatureTable, _geometry_column, point_column)
from geomesa_tpu_torch.schema.sft import AttributeType


def geometry_from_coords(kind: str, coords):
    """A geometry from its type name and coordinate arrays: ``Point`` (x,
    y); ``LineString`` (N, 2); ``Polygon`` a list of rings, the shell
    first; ``MultiPoint`` (N, 2); ``MultiLineString`` a list of (N, 2);
    ``MultiPolygon`` a list of ring lists. None stays None (a null)."""
    if kind is None:
        return None
    if kind == "Point":
        return Point(float(coords[0]), float(coords[1]))
    if kind == "LineString":
        return LineString(coords)
    if kind == "Polygon":
        return Polygon(coords[0], tuple(coords[1:]))
    if kind == "MultiPoint":
        return MultiPoint(tuple(Point(float(x), float(y)) for x, y in coords))
    if kind == "MultiLineString":
        return MultiLineString(tuple(LineString(c) for c in coords))
    if kind == "MultiPolygon":
        return MultiPolygon(tuple(Polygon(r[0], tuple(r[1:])) for r in coords))
    raise ValueError(f"unknown geometry type {kind!r}")


def load_reference_state(store, type_name: str, spec: str, columns: dict,
                         fids, perm) -> None:
    """Create ``type_name`` from ``spec`` and install a main tier.

    ``columns``: attribute name → numpy array in the reference table's row
    order; a point geometry maps to a ``(lon, lat)`` pair of f64 arrays, an
    extended geometry to a list of ``(type name, coordinates)`` per feature
    (:func:`geometry_from_coords`; ``(None, None)`` for a null), the date to
    int64 epoch millis. Coordinates cross as arrays, never as WKT, whose 10
    significant digits would move bounds. ``fids``: feature ids in that
    order. ``perm``: the reference indexes' sorted position → row
    permutations by index name (``{"z3": ..., "z2": ...}`` or ``{"xz3":
    ..., "xz2": ...}``), each installed into that index; a bare array is the
    z3 permutation. An index of the schema without one is built by the
    store.
    """
    sft = store.create_schema(type_name, spec)
    cols = {}
    for a in sft.attributes:
        v = columns[a.name]
        if a.type == AttributeType.POINT:
            lon, lat = v
            cols[a.name] = point_column(lon, lat)
        elif a.type.is_geometry:
            cols[a.name] = _geometry_column(a.type, [geometry_from_coords(k, c) for k, c in v])
        else:
            cols[a.name] = Column(a.type, np.asarray(v))
    table = FeatureTable.from_columns(sft, fids, cols)
    store._validate(sft, table)
    perms = perm if isinstance(perm, dict) else {"z3": perm}
    store._rebuild(store._state(type_name), table,
                   perms={name: np.asarray(p) for name, p in perms.items()})
