"""Point-in-polygon counts and the block plan of the spatial join (ST_Within).

Port of :mod:`geomesa_tpu.ops.join`. Host numpy copies (tests hold them
equal): :func:`pack_polygons`, :func:`pack_polygons_bucketed` (``_BUCKETS``),
:func:`planned_candidate_rows` and :func:`polygon_block_plan`, the last
planning over the port's native z2 ranges for one shard and giving a flat
CSR plan (per-polygon offsets into one list of block ids) where the
reference gives a padded (D, K, MB) array per shard. The device forms:

- :func:`points_in_polygons_count` (``:77``): every block a candidate of
  every polygon, through the ``polygon_join`` kernel;
- :func:`points_in_polygons_mask` (``:94``): the (K, N) masks, plain torch,
  for small K where the matrix fits, as in the reference.

Both run the reference's f32 crossing number (``_membership`` ``:56``:
bbox test, straddle, ``x1 + (y - y1) * (x2 - x1) / dy`` with each step
rounded alone). Points within ~1e-5 degrees of an edge can classify
differently than the f64 host predicate; the exact path
(:func:`geomesa_tpu_torch.process.join.join_rows_device`) uses the int
bbox only as a superset and decides in f64.

The block steps (``make_block_join_step`` ``:357``, the bbox count and
gather ``:247``/``:300``) live in :mod:`geomesa_tpu_torch.parallel.query`.
"""

from __future__ import annotations

import numpy as np
import torch

from geomesa_tpu_torch.curve.sfc import Z2SFC
from geomesa_tpu_torch.geometry.types import MultiPolygon, Polygon
from geomesa_tpu_torch.ops.kernels import JOIN_BLOCK, crossing_parity, polygon_join


def _shell_polygon(p) -> Polygon:
    """A polygon's shell carrier: a MultiPolygon's largest part (the exact
    path takes the rest), else the polygon itself; anything else raises."""
    if isinstance(p, MultiPolygon):
        p = max(p.parts, key=lambda q: len(q.shell))
    if not isinstance(p, Polygon):
        raise ValueError(f"expected polygon, got {p.geom_type}")
    return p


def pack_polygons(polygons, max_vertices: int = 64):
    """Polygon list → (verts (K, V, 2) f32, bbox (K, 4) f32, nverts (K,) int32).

    Shells only (holes are rare in join workloads; holed polygons should take
    the exact host path). Rings are closed; padding repeats the last vertex
    (zero-length edges never change crossing parity).
    """
    k = len(polygons)
    verts = np.zeros((k, max_vertices, 2), dtype=np.float32)
    bbox = np.zeros((k, 4), dtype=np.float32)
    nverts = np.zeros(k, dtype=np.int32)
    for i, p in enumerate(polygons):
        p = _shell_polygon(p)
        ring = p.shell
        if len(ring) > max_vertices:
            raise ValueError(
                f"polygon {i} has {len(ring)} vertices > max {max_vertices}"
            )
        verts[i, : len(ring)] = ring
        verts[i, len(ring) :] = ring[-1]
        nverts[i] = len(ring)
        bbox[i] = p.bbox
    return verts, bbox, nverts


_BUCKETS = (16, 32, 64, 128, 256, 512)


def pack_polygons_bucketed(polygons, buckets=_BUCKETS):
    """Group polygons by vertex-count bucket (pow2 padding tiers).

    Returns a list of (ids (Kb,) int64, verts (Kb, V, 2) f32, bbox (Kb, 4)
    f32, nverts (Kb,) int32), one entry per non-empty bucket in ascending
    order of V.
    """
    groups: dict[int, list[int]] = {}
    shells = []
    for i, p in enumerate(polygons):
        p = _shell_polygon(p)
        shells.append(p)
        nv = len(p.shell)
        for b in buckets:
            if nv <= b:
                groups.setdefault(b, []).append(i)
                break
        else:
            raise ValueError(
                f"polygon {i} has {nv} vertices > max bucket {buckets[-1]}"
            )
    out = []
    for b in sorted(groups):
        ids = np.asarray(groups[b], dtype=np.int64)
        verts, bbox, nverts = pack_polygons(
            [shells[i] for i in ids], max_vertices=b
        )
        out.append((ids, verts, bbox, nverts))
    return out


def planned_candidate_rows(sorted_z2: np.ndarray, bbox_deg,
                           max_ranges: int = 16, sfc=None) -> np.ndarray:
    """Per-polygon candidate row counts a z2 range plan admits:
    searchsorted over the host sorted keys, no block expansion and no
    device work, so a route decision can measure pair density without
    paying the full :func:`polygon_block_plan` it may then skip. Counts
    are pre-block-rounding (a lower bound on what the block join tests)."""
    sfc = sfc or Z2SFC()
    out = np.zeros(len(bbox_deg), dtype=np.int64)
    for p, (xmin, ymin, xmax, ymax) in enumerate(bbox_deg):
        zr = sfc.ranges(
            [(float(xmin), float(ymin), float(xmax), float(ymax))],
            max_ranges=max_ranges,
        )
        if len(zr) == 0:
            continue
        starts = np.searchsorted(sorted_z2, zr[:, 0], side="left")
        ends = np.searchsorted(sorted_z2, zr[:, 1], side="right")
        out[p] = int(np.maximum(ends - starts, 0).sum())
    return out


def polygon_block_plan(sorted_z2: np.ndarray, bbox_deg: np.ndarray, block: int,
                       n_rows: int, max_ranges: int = 16, sfc=None):
    """Host planning for the block-sparse join, one shard: per-polygon z2
    ranges → the sorted, distinct global blocks they touch.

    The store is z2-sorted (``sorted_z2``, its keys) and cut into blocks of
    ``block`` rows; ``n_rows`` is the padded resident length, a multiple of
    ``block``. A polygon's candidates are every block its bbox z-ranges
    (at most ``max_ranges``) touch. Each bbox is widened by one f32 ulp
    first (bboxes arrive f32-rounded from :func:`pack_polygons`), so points
    whose f64 coordinates sit just past a rounded-down edge but round
    inside in f32 are never pruned out of the cover.

    Returns ``(offsets (K + 1,) int64, blocks (B,) int32)``: polygon p's
    blocks are ``blocks[offsets[p]:offsets[p + 1]]``, ascending. The
    reference's ``(blk (D, K, MB), nblk (D, K))`` with ``D = 1`` holds the
    same sets, padded.
    """
    if n_rows % block:
        raise ValueError(f"n_rows {n_rows} % block {block} != 0")
    sfc = sfc or Z2SFC()
    k = len(bbox_deg)
    per: list[np.ndarray] = []
    for p in range(k):
        xmin, ymin, xmax, ymax = bbox_deg[p]
        xmin = float(np.nextafter(np.float32(xmin), np.float32(-np.inf)))
        ymin = float(np.nextafter(np.float32(ymin), np.float32(-np.inf)))
        xmax = float(np.nextafter(np.float32(xmax), np.float32(np.inf)))
        ymax = float(np.nextafter(np.float32(ymax), np.float32(np.inf)))
        zr = sfc.ranges([(xmin, ymin, xmax, ymax)], max_ranges=max_ranges)
        if len(zr) == 0:
            per.append(np.empty(0, dtype=np.int64))
            continue
        starts = np.searchsorted(sorted_z2, zr[:, 0], side="left")
        ends = np.searchsorted(sorted_z2, zr[:, 1], side="right")
        keep = ends > starts
        b_lo = starts[keep] // block
        b_hi = (ends[keep] - 1) // block + 1
        # expand spans → unique global block ids (vectorized repeat-arange)
        lens = b_hi - b_lo
        tot = int(lens.sum())
        if tot == 0:
            per.append(np.empty(0, dtype=np.int64))
            continue
        per.append(np.unique(
            np.repeat(b_lo, lens) + (np.arange(tot) - np.repeat(np.cumsum(lens) - lens, lens))
        ))
    offsets = np.zeros(k + 1, dtype=np.int64)
    offsets[1:] = np.cumsum([len(b) for b in per])
    blocks = np.concatenate(per).astype(np.int32) if k else np.empty(0, np.int32)
    return offsets, blocks


def _as_f32(t, device) -> torch.Tensor:
    if isinstance(t, torch.Tensor):
        return t.to(device=device, dtype=torch.float32).contiguous()
    return torch.from_numpy(np.ascontiguousarray(t, dtype=np.float32)).to(device)


def points_in_polygons_count(x, y, verts, bbox, nverts=None, true_n=None) -> torch.Tensor:
    """Counts of points strictly inside each polygon (f32 crossing number).

    ``x, y``: (N,) float32 point coordinates in degrees, a tensor on the
    device that runs it; ``verts`` (K, V, 2) float32 closed rings (padded)
    and ``bbox`` (K, 4) float32 [xmin, ymin, xmax, ymax], arrays or tensors;
    ``nverts`` (K,) their real vertex counts (None: all V); ``true_n``: rows
    at it or past it are padding (None: N). Returns (K,) int32 counts: the
    ``polygon_join`` kernel with every ``JOIN_BLOCK``-row block a candidate
    of every polygon (the columns are padded to a multiple of it, a copy
    unless N is one already)."""
    dev = x.device
    n = x.shape[0] if true_n is None else int(true_n)
    pad = -x.shape[0] % JOIN_BLOCK
    if pad:
        x = torch.cat([x, x.new_zeros(pad)])
        y = torch.cat([y, y.new_zeros(pad)])
    verts, bbox = _as_f32(verts, dev), _as_f32(bbox, dev)
    if nverts is None:
        nv = torch.full((verts.shape[0],), verts.shape[1], dtype=torch.int32, device=dev)
    else:
        nv = torch.as_tensor(nverts, dtype=torch.int32, device=dev).contiguous()
    return polygon_join(x.contiguous(), y.contiguous(), n, None, None, verts, nv, bbox,
                        JOIN_BLOCK)


def membership(x, y, ring, bb) -> torch.Tensor:
    """(N,) bool: f32 points inside one closed ring and its bbox
    (``_membership``, ``:56``): the shared body of the count and the mask."""
    in_bb = (x >= bb[0]) & (x <= bb[2]) & (y >= bb[1]) & (y <= bb[3])
    return crossing_parity(x, y, ring) & in_bb


def points_in_polygons_mask(x, y, verts, bbox) -> torch.Tensor:
    """(K, N) bool membership masks, for small K where the full matrix fits;
    plain torch on the points' device (``:94``)."""
    dev = x.device
    verts, bbox = _as_f32(verts, dev), _as_f32(bbox, dev)
    if verts.shape[0] == 0:
        return torch.zeros((0, x.shape[0]), dtype=torch.bool, device=dev)
    return torch.stack([membership(x, y, verts[p], bbox[p]) for p in range(verts.shape[0])])
