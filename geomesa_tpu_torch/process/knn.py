"""K-nearest-neighbor search: per point by expanding windows, or batched.

Port of :mod:`geomesa_tpu.process.knn` (``KNearestNeighborSearchProcess``):

- :func:`knn` is the per-point iterative-deepening window search through
  :meth:`DataStore.query` (query a window around the point; with fewer than
  k candidates, or a k-th distance outside the window's inscribed circle,
  double the window and retry). It serves the ``oracle`` backend, an empty
  store and a line or polygon store, whose windows go through the XZ
  indexes and whose features rank by the exact f64
  :func:`~geomesa_tpu_torch.geometry.predicates.distance` (``knn.py:250``).
- :func:`knn_many` answers every point in one ``batched_knn_step`` over the
  store's preferred point state; a store with none (a line or polygon
  store) answers per point with :func:`knn`. It has no TTL and no hot-tier
  merge: the port has neither age-off nor a delta tier.
"""

from __future__ import annotations

import numpy as np

from geomesa_tpu_torch.filter import ast
from geomesa_tpu_torch.geometry import predicates as P
from geomesa_tpu_torch.parallel.query import batched_knn_step, check_knn_impl
from geomesa_tpu_torch.planning.planner import Query
from geomesa_tpu_torch.schema.columnar import Point
from geomesa_tpu_torch.store.backends import DeviceBackend


def knn(ds, type_name: str, point: Point, k: int = 10, filter=None,
        initial_radius_deg: float = 0.5, max_radius_deg: float = 45.0):
    """Returns ``(table, distances_deg)`` of the k nearest features to
    ``point`` (``knn.py:20``), f64 distances ascending, ties in row order.

    ``filter``: an optional extra CQL/AST predicate AND'ed with the window.
    On a line or polygon store a feature's distance is the exact f64
    distance from the point to its geometry."""
    base = None
    if filter is not None:
        from geomesa_tpu_torch.filter.cql import parse

        base = parse(filter) if isinstance(filter, str) else filter
    geom_field = ds.get_schema(type_name).geom_field
    radius = initial_radius_deg
    while True:
        window = ast.BBox(geom_field, point.x - radius, max(point.y - radius, -90.0),
                          point.x + radius, min(point.y + radius, 90.0))
        f = window if base is None else ast.And([window, base])
        r = ds.query(type_name, Query(filter=f))
        # enough candidates, and the k-th distance is inside the window's
        # inscribed circle (otherwise a nearer point could hide outside)
        if r.count >= k:
            d = _distances(r, point)
            kth = np.partition(d, k - 1)[k - 1]
            if kth <= radius or radius >= max_radius_deg:
                break
        elif radius >= max_radius_deg:
            d = _distances(r, point)
            break
        radius = min(radius * 2.0, max_radius_deg)
    order = np.argsort(d, kind="stable")[: min(k, r.count)]
    return r.table.take(order), d[order]


def knn_many(ds, type_name: str, points, k: int = 10, topology: str = "gather",
             impl: str | None = None):
    """Batched KNN: all query points in one device pass (``knn.py:72``).

    On the device backend, one ``batched_knn_step`` over the preferred
    point state (f32 distances over the decoded int32 coordinates, ties to
    the lower sorted-order row) gives each point's ``min(k, rows)`` nearest
    positions; they map to table rows through the index's permutation.
    Other backends, an empty store and a store with no point state (a line
    or polygon store, ``knn.py:116-121``) answer per point with
    :func:`knn`.

    ``topology``: ``"gather"`` or ``"ring"``, the reference's heap-merge
    collective. On one card the ring has no hop and equals the gather
    merge, so both take the same step. ``impl``: the reference's per-shard
    sweep shape (``map``, ``scan`` or ``blocked``), checked and otherwise
    unused (see ``batched_knn_step``).

    Returns a list of ``(table, distances_deg)`` pairs, one per point, each
    holding that point's k nearest features in distance order."""
    if topology not in ("gather", "ring"):
        raise ValueError(f"topology must be gather|ring: {topology!r}")
    check_knn_impl(impl)  # loud even when the per-point path serves
    st = ds._state(type_name)
    main = st.table
    main_n = 0 if main is None else len(main)
    dev = name = None
    if isinstance(ds.backend, DeviceBackend):
        dev, name = DeviceBackend.point_state(st.backend_state)
    if dev is None or main_n == 0:
        return [knn(ds, type_name, p, k) for p in points]
    kk = min(k, main_n)
    qx = np.array([p.x for p in points], dtype=np.float32)
    qy = np.array([p.y for p in points], dtype=np.float32)
    dists, pos = batched_knn_step(dev.spatial_cols(), dev.n, qx, qy, kk, impl=impl)
    dists, pos = dists.cpu().numpy(), pos.cpu().numpy()
    perm = st.indices[name].perm
    out = []
    for qi in range(len(points)):
        cand_t = main.take(perm[pos[qi].astype(np.int64)])
        cand_d = dists[qi].astype(np.float64)
        live = np.isfinite(cand_d)
        if not live.all():
            cand_t = cand_t.take(np.nonzero(live)[0])
            cand_d = cand_d[live]
        order = np.argsort(cand_d, kind="stable")[: min(k, len(cand_d))]
        out.append((cand_t.take(order), cand_d[order]))
    return out


def _f32_dists(x: np.ndarray, y: np.ndarray, point: Point) -> np.ndarray:
    """f32 euclidean distances (``knn.py:242``): the device step's ranking
    metric over f32 coordinates."""
    return np.sqrt((x - np.float32(point.x)) ** 2 + (y - np.float32(point.y)) ** 2)


def _distances(r, point: Point) -> np.ndarray:
    """f64 distances of a result's features to ``point`` (``knn.py:250``):
    points by their coordinates, other geometries by
    :func:`~geomesa_tpu_torch.geometry.predicates.distance`, a null one
    ``inf``."""
    col = r.table.geom_column()
    if col.x is not None:
        return np.sqrt((col.x - point.x) ** 2 + (col.y - point.y) ** 2)
    return np.array([P.distance(point, g) if g is not None else np.inf
                     for g in col.geometries()])
