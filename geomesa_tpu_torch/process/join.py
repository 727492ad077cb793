"""Spatial join: points × polygons (the ``JoinProcess`` / batched ST_Within role).

Port of :mod:`geomesa_tpu.process.join`, over the port's one-card store:

- :func:`join_rows_device` — exact: per geometry, the z2 blocks its bbox
  ranges touch, an int-bbox gather of their rows on the card (the
  ``planned_gather`` kernel) and the f64 predicate on the candidates.
- :func:`join_within_device` — bulk: every point against every polygon by
  the f32 crossing number (the ``polygon_join`` kernel), counts only;
  ~1e-5 degree edge tolerance.
- :func:`measured_pair_density` and :func:`join_counts_auto`, which picks
  one of the two by the density.

Left out, each queued in ROADMAP.md: ``join_scan`` and ``join_within``
(they need the ``SpatialOp`` predicate in the port's filter language, A.5);
``_observe_join`` and the cost model's learned route (A.9, A.8.3). The port
has no delta tier and no TTL age-off (A.8.2): a schema that asks for
age-off raises ``NotImplementedError`` here.
"""

from __future__ import annotations

import numpy as np
import torch

from geomesa_tpu_torch.geometry import predicates as P
from geomesa_tpu_torch.ops.join import (
    pack_polygons, planned_candidate_rows, points_in_polygons_count, polygon_block_plan)
from geomesa_tpu_torch.ops.kernels import JOIN_BLOCK
from geomesa_tpu_torch.parallel.query import block_bbox_gather_step
from geomesa_tpu_torch.store.backends import DeviceBackend, int_boxes

# pair density below which join_counts_auto takes the block route: the
# untrained cost model's seed rule (geomesa_tpu/planning/costmodel.py:259)
BLOCK_ROUTE_DENSITY = 0.25


def _refuse_age_off(sft) -> None:
    if sft.user_data.get("geomesa.age.off") is not None:
        raise NotImplementedError(
            "device join: TTL age-off (geomesa.age.off) is not ported yet (ROADMAP.md A.8.2)")


def _z2_residency(ds, type_name: str):
    """(main table, z2 index, its resident state) of a device store, or
    None when it has no z2 residency to plan against."""
    if not isinstance(ds.backend, DeviceBackend):
        return None
    st = ds._state(type_name)
    dev = (st.backend_state or {}).get("z2")
    z2 = (st.indices or {}).get("z2")
    if dev is None or z2 is None or st.table is None or len(st.table) == 0:
        return None
    return st.table, z2, dev


def _matches(xs, ys, g, pred: str) -> np.ndarray:
    if pred == "within":
        return P.points_within_geom(xs, ys, g)
    return P.points_intersect_geom(xs, ys, g)


def join_rows_device(ds, type_name: str, geoms, pred: str = "within",
                     chunk_budget: int = 1 << 28):
    """Exact spatial join returning row sets per right geometry.

    The z2-sorted resident layout is cut into ``JOIN_BLOCK``-row blocks;
    per geometry only the blocks its bbox z-ranges touch are tested (host
    planning, :func:`~geomesa_tpu_torch.ops.join.polygon_block_plan` over
    the z2 index's host keys), an int-domain bbox gather compacts the
    candidate rows on the card (a superset: normalize is monotone;
    :func:`~geomesa_tpu_torch.parallel.query.block_bbox_gather_step`), and
    the exact f64 predicate (``within`` or ``intersects``) runs host-side on
    the candidates.

    Returns ``(table, [(i, rows), ...])``: the main table the row indices
    refer to and, per geometry ``i`` in order, its matching row indices
    (int64, in z2 order, as the reference gives them; a ``None`` geometry
    matches nothing). Raises ``ValueError`` when the store cannot take the
    device path (no device backend, or no z2 residency: a line or polygon
    store has none) and ``NotImplementedError`` for a schema with TTL
    age-off.

    ``chunk_budget``: at most this many candidate rows (pairs x
    ``JOIN_BLOCK``) per gather launch; more pairs run in several launches
    (it bounds the card's scratch: 512 B of mask and up to 16 KB of
    positions a pair).
    """
    if pred not in ("within", "intersects"):
        raise ValueError(f"device join: unsupported predicate {pred!r}")
    res = _z2_residency(ds, type_name)
    if res is None:
        raise ValueError("device join: no z2 device residency")
    main, z2, dev = res
    _refuse_age_off(ds._state(type_name).sft)
    if dev.rows_per_shard % JOIN_BLOCK:
        raise ValueError("device join: layout not block-aligned")
    live = [i for i, g in enumerate(geoms) if g is not None]
    bbox_deg = np.array([geoms[i].bbox for i in live], dtype=np.float64).reshape(-1, 4)
    offsets, blocks = polygon_block_plan(z2.zs, bbox_deg, JOIN_BLOCK, dev.rows_per_shard)
    pair_q = np.repeat(np.arange(len(live), dtype=np.int32), np.diff(offsets))
    iboxes = int_boxes(bbox_deg.tolist()) if live else np.zeros((0, 4), dtype=np.int32)
    step = max(1, chunk_budget // JOIN_BLOCK)
    positions, hits = [], []
    for s in range(0, len(blocks), step):
        pos, h = block_bbox_gather_step(dev.spatial_cols(), dev.n, pair_q[s:s + step],
                                        blocks[s:s + step], iboxes)
        positions.append(pos.cpu().numpy())
        hits.append(h.cpu().numpy())
    per_geom = np.zeros(len(live), dtype=np.int64)
    if hits:
        np.add.at(per_geom, pair_q, np.concatenate(hits))
        cand_all = np.concatenate(positions).astype(np.int64)
    else:
        cand_all = np.empty(0, dtype=np.int64)
    ends = np.cumsum(per_geom)
    col = main.geom_column()
    perm = z2.perm
    rows_of = {}
    for j, i in enumerate(live):
        cand = cand_all[ends[j] - per_geom[j]:ends[j]]
        rows = perm[cand]  # sorted-order positions → table rows
        rows_of[i] = rows[_matches(col.x[rows], col.y[rows], geoms[i], pred)]
    empty = np.empty(0, dtype=np.int64)
    return main, [(i, rows_of.get(i, empty)) for i in range(len(geoms))]


def join_within_device(ds, type_name: str, polygons, max_vertices: int = 64):
    """Bulk join counts: (K,) int32 points strictly inside each polygon.

    Runs the f32 crossing number over the main tier's points on the store's
    device (:func:`~geomesa_tpu_torch.ops.join.points_in_polygons_count`,
    the ``polygon_join`` kernel with every block a candidate). The points
    are staged as f32 degrees for the call, padded to whole blocks. A
    non-empty line or polygon store raises ``ValueError``, as the
    reference's does."""
    ds.compact(type_name)  # the bulk path scans the main tier only
    st = ds._state(type_name)
    if st.table is None or len(st.table) == 0:
        return np.zeros(len(polygons), dtype=np.int32)
    col = st.table.geom_column()
    if col.x is None:
        raise ValueError("device join requires a point geometry store")
    verts, bbox, nverts = pack_polygons(polygons, max_vertices)
    n = len(col.x)
    padded = -(-n // JOIN_BLOCK) * JOIN_BLOCK
    cols = []
    for v in (col.x, col.y):
        host = np.zeros(padded, dtype=np.float32)
        host[:n] = v
        cols.append(torch.from_numpy(host).to(ds.device))
    return points_in_polygons_count(cols[0], cols[1], verts, bbox, nverts, n).cpu().numpy()


def measured_pair_density(ds, type_name: str, geoms) -> float | None:
    """The measured candidate-pair density of a join: candidate rows a z2
    range plan admits (searchsorted over the host z2 keys, no block
    expansion, no device work) over ``points x geometries``, clamped to
    [0, 1]. None when the store has no z2 residency to plan against (the
    block route cannot run at all)."""
    res = _z2_residency(ds, type_name)
    if res is None:
        return None
    main, z2, _ = res
    k = sum(1 for g in geoms if g is not None)
    if k == 0:
        return 0.0
    bbox_deg = np.array([g.bbox for g in geoms if g is not None], dtype=np.float64)
    cand = planned_candidate_rows(z2.zs, bbox_deg)
    return min(float(int(cand.sum())) / float(len(main) * k), 1.0)


def join_counts_auto(ds, type_name: str, polygons, max_vertices: int = 64):
    """Per-polygon points-inside counts by the route the measured pair
    density picks: ``"block"`` (:func:`join_rows_device`, the index-pruned
    gather and the exact f64 refine) or ``"dense"``
    (:func:`join_within_device`, the f32 pass over every point, within its
    ~1e-5 degree edge tolerance). Returns ``(counts (K,) int64, route)``.

    The port has no cost model yet (ROADMAP.md A.8.3), so the route is the
    untrained model's seed rule (``costmodel.choose_join_path``,
    ``geomesa_tpu/planning/costmodel.py:252-264``): ``"block"`` when the
    density is below :data:`BLOCK_ROUTE_DENSITY`, else ``"dense"``; no
    measurement trains it. A store the block route cannot take (no z2
    residency: the density is None) takes ``"dense"``, so a non-empty line
    or polygon store raises :func:`join_within_device`'s ``ValueError``, as
    the reference's does."""
    density = measured_pair_density(ds, type_name, polygons)
    route = "block" if density is not None and density < BLOCK_ROUTE_DENSITY else "dense"
    if route == "block":
        _snap, pairs = join_rows_device(ds, type_name, polygons)
        counts = np.zeros(len(polygons), dtype=np.int64)
        for i, rows in pairs:
            counts[i] = len(rows)
        return counts, route
    return (
        np.asarray(join_within_device(ds, type_name, polygons, max_vertices), dtype=np.int64),
        route,
    )
