"""DataStore: schema, writes, queries and batched counts on one device.

Port of :class:`geomesa_tpu.store.datastore.DataStore` for point schemas
and for line and polygon schemas (LineString, Polygon and their Multi
forms), each with or without a date: ``create_schema`` → ``write`` →
``compact`` → ``query`` / ``select_many`` / ``count_many``. Every write
builds the indexes the schema has (z3 and z2 keys encoded and sorted on the
store's device; xz3 and xz2 codes made on the host and sorted on the
device) and stages each index's columns: int32 points, or each feature's
int32 bbox for a line or polygon schema, whose batched paths take the
overlap forms of the kernels. Differences from the reference, all
deliberate:

- ``write`` folds the rows straight into the sorted main tier and rebuilds
  (index sort + device residency); there is no delta hot tier yet, so
  ``compact`` has nothing to merge. Answers are the same as the
  reference's after its own ``compact``.
- No device fallbacks: no circuit breaker, no failover ``except`` in
  ``count_many``, no load-failure branch that leaves the store on the host.
  A device error propagates to the caller.
- ``select_many`` leaves out what the port does not carry yet: query
  interceptors, TTL age-off, the audit trail, the delta tier and
  ``reduce_result``; a query with a hint goes through ``query``.
- ``query`` answers one hint, ``density`` (``reduce_result``'s density
  branch: points snap to their cell, lines and polygons rasterize their
  footprint); any other hint but the ``tenant`` metadata raises
  ``NotImplementedError``.
- ``aggregate_many`` has the reference's query cache, GeoBlocks pyramid
  and fused path; the route is a fixed rule until the port has a cost
  model (``planning.choose_agg_path``): the fused path, and the pyramid
  only where ``GEOMESA_TPU_PYRAMID=1`` asks for it. See its docstring for
  what it leaves out.
- ``density_many`` has no circuit breaker, failover or audit, as above.
- On a line or polygon store, ``aggregate_many`` folds over the bbox
  state with the overlap form of the grouped fold, and ``density_many``
  and the ``density`` hint take the exact per-query path (the host
  rasterization), as the reference's do; ``process.knn`` answers there
  through ``query()`` windows and the exact f64 distance, and the device
  joins of ``process.join`` raise the reference's ``ValueError`` (no z2
  residency; the bulk join needs points).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field, replace
from typing import Any

import numpy as np
import torch

from geomesa_tpu_torch.curve.binned_time import BinnedTime
from geomesa_tpu_torch.curve.normalize import lat as norm_lat, lon as norm_lon
from geomesa_tpu_torch.device import resolve_device
from geomesa_tpu_torch.filter import ast
from geomesa_tpu_torch.filter.bounds import extract
from geomesa_tpu_torch.ops import geoblocks
from geomesa_tpu_torch.ops.kernels import (
    EDGE_CAPACITY, batched_count, batched_edge_gather, batched_edge_gather_overlap)
from geomesa_tpu_torch.ops.refine import MAX_BOXES, MAX_TIMES
from geomesa_tpu_torch.parallel.query import (
    batched_density_step, batched_overlap_step, grouped_agg_step)
from geomesa_tpu_torch.planning.planner import (
    Query, QueryPlanner, build_indices, choose_agg_path)
from geomesa_tpu_torch.schema.columnar import FeatureTable, GeometryColumn
from geomesa_tpu_torch.schema.sft import FeatureType, parse_spec
from geomesa_tpu_torch.store.backends import (
    REFINE_PRECISION, DeviceBackend, OracleBackend, int_boxes, residual_rows, time_quads)
from geomesa_tpu_torch.store.reduce import density_grid

# hints that are execution metadata, never semantics (datastore.py:51): the
# batched paths do not decline on them
_METADATA_HINTS = frozenset({"tenant"})
_ANSWERED_HINTS = frozenset({"density"})  # the semantic hints query() answers


def _semantic_hints(q) -> bool:
    """True when the query carries hints that can alter results or the
    execution contract (``datastore.py:57``): every hint but the metadata."""
    return any(k not in _METADATA_HINTS for k in q.hints)


def _pure_bbox_time(f: ast.Filter, sft: FeatureType) -> bool:
    """True when the filter is a conjunction of BBOX/temporal primaries on
    the schema's default geometry/date fields — fully expressible as an
    int-domain payload, so the batched loose count covers it."""
    if isinstance(f, ast.Include):
        return True
    if isinstance(f, ast.BBox):
        return f.prop == sft.geom_field
    if isinstance(f, (ast.During, ast.TempOp)):
        return f.prop == sft.dtg_field
    if isinstance(f, ast.And):
        return all(_pure_bbox_time(c, sft) for c in f.children)
    return False


def _factorize(vals: np.ndarray):
    """``np.unique(vals, return_inverse=True)`` as (sorted unique values,
    int64 inverse). An integer column whose values span at most four times
    its length takes a bincount instead of a sort, with the same output."""
    if isinstance(vals, np.ndarray) and vals.dtype.kind in "iu" and len(vals):
        lo, hi = int(vals.min()), int(vals.max())
        if hi - lo < 4 * len(vals):
            shifted = vals.astype(np.int64) - lo
            present = np.bincount(shifted, minlength=hi - lo + 1) > 0
            uniq = (np.flatnonzero(present) + lo).astype(vals.dtype)
            return uniq, (np.cumsum(present) - 1)[shifted]
    uniq, inv = np.unique(vals, return_inverse=True)
    return uniq, inv.astype(np.int64).reshape(-1)


def _first_rows(codes: np.ndarray, k: int, chunk: int = 1 << 16) -> np.ndarray:
    """The first row holding each of the ``k`` dense codes (every one
    occurs), as ``np.unique(..., return_index=True)`` gives it: the rows
    are scanned a chunk at a time until every code has been seen."""
    first = np.full(k, -1, dtype=np.int64)
    missing = k
    for s in range(0, len(codes), chunk):
        u, idx = np.unique(codes[s:s + chunk], return_index=True)
        new = first[u] < 0
        first[u[new]] = s + idx[new]
        missing -= int(new.sum())
        if missing == 0:
            break
    return first


@dataclass
class QueryResult:
    """Matching features (``table``), their row ids in the main tier, the
    plan that found them and, from :meth:`DataStore.query`, the host-clock
    ms of its steps: ``plan_ms``, ``select_ms`` (device refine and copies),
    ``residual_ms`` and ``take_ms`` (sort and gather of the rows; the
    Oracle backend's query gives ``take_ms`` alone). ``density`` is the
    (height, width) float64 grid of a query with the ``density`` hint."""

    table: FeatureTable
    row_ids: np.ndarray
    plan_info: Any = None
    timings: dict | None = None
    density: np.ndarray | None = None

    @property
    def count(self) -> int:
        return len(self.table)


@dataclass
class ResidentCandidates:
    """A planned query's candidates where they are resident
    (:meth:`DataStore.resident_candidates`): ``positions`` (C,) int32
    sorted-order positions on the store's device, ascending, that pass the
    device's int-domain refine (a superset of the filter's rows, with no
    exact residual applied); ``state`` the point state they index; ``perm``
    the index's sorted position → table row map; ``table`` the main tier;
    ``plan_info`` the plan; ``timings`` host-clock ms of ``plan_ms`` and
    ``select_ms`` (the refine and its uploads)."""

    table: FeatureTable
    perm: np.ndarray
    state: Any
    positions: torch.Tensor
    plan_info: Any
    timings: dict


@dataclass
class _TypeState:
    sft: FeatureType
    table: FeatureTable | None = None  # main tier, in write order
    indices: dict | None = None
    backend_state: Any = None
    rebuild_s: dict | None = None  # last rebuild's phase seconds
    epoch: int = 0  # rebuild epoch: every write and compact advances it
    # (group_by, value_cols) -> (AggPyramid or None for a remembered
    # failure, the rebuild epoch it was built at)
    pyramids: dict = field(default_factory=dict)

    def data_epoch(self) -> tuple:
        """The (rebuild epoch, delta version) pair every mutation advances
        (``datastore.py:298``): a cache keyed on it is stale once it moves.
        The delta version stays 0 until the port has a delta tier (ROADMAP.md
        A.8.2): every write lands in the main tier and advances the rebuild
        epoch."""
        return (self.epoch, 0)


class DataStore:
    """An in-process spatio-temporal store over one execution backend.

    ``backend="device"`` (default) keeps the resident columns on ``device``
    (``None`` → ``cuda``, raising when there is none); ``"oracle"`` is the
    host brute-force referee. Sorting for index builds runs on ``device``.
    """

    def __init__(self, backend: str = "device", device=None):
        self.device = resolve_device(device)
        if backend == "device":
            self.backend = DeviceBackend(self.device)
        elif backend == "oracle":
            self.backend = OracleBackend()
        else:
            raise ValueError(f"unknown backend {backend!r}: 'device' or 'oracle'")
        self._types: dict[str, _TypeState] = {}
        # queries count_many answered through query(), the exact per-query path
        self.exact_fallbacks = 0
        # host-clock ms of the last select_many: plan_ms (every query's
        # plan), pairs_ms and gather_ms (summed over its index groups, see
        # DeviceBackend.select_many_positions) and tail_ms (residual, sort
        # and take of every query's rows)
        self.last_select_many: dict = {}
        # the last aggregate_many's queries by tier (see its docstring)
        self.last_aggregate_many: dict = {}
        # exact-repeat aggregate_many answers, stamped with the data epoch
        self.agg_cache = geoblocks.QueryCache()

    # -- schema ---------------------------------------------------------------
    def create_schema(self, sft: FeatureType | str, spec: str | None = None) -> FeatureType:
        if isinstance(sft, str):
            if spec is None:
                raise ValueError("create_schema('name', 'spec string') requires a spec")
            sft = parse_spec(sft, spec)
        build_indices(sft)  # refuses what the port cannot index
        if sft.name in self._types:
            raise ValueError(f"schema already exists: {sft.name}")
        self._types[sft.name] = _TypeState(sft=sft)
        return sft

    def get_schema(self, name: str) -> FeatureType:
        return self._state(name).sft

    def _state(self, name: str) -> _TypeState:
        if name not in self._types:
            raise KeyError(f"no such schema: {name!r}")
        return self._types[name]

    # -- writes ---------------------------------------------------------------
    def write(self, type_name: str, data, fids=None) -> int:
        """Append features (a FeatureTable, or record dicts with ``fids``)
        and rebuild the main tier. Rows with a null geometry, or a null date
        where the schema has one, are rejected before anything changes."""
        st = self._state(type_name)
        if isinstance(data, list):
            if fids is None:
                base = 0 if st.table is None else len(st.table)
                fids = [f"{type_name}.{base + i}" for i in range(len(data))]
            data = FeatureTable.from_records(st.sft, data, fids)
        self._validate(st.sft, data)
        table = data if st.table is None else FeatureTable.concat([st.table, data])
        self._rebuild(st, table)
        return len(data)

    def compact(self, type_name: str) -> None:
        """Merge pending writes into the sorted main tier. Every write already
        lands there (no hot tier in this port), so this merges nothing; it
        advances the data epoch, as the reference's compaction does."""
        self._state(type_name).epoch += 1

    def _rebuild(self, st: _TypeState, table: FeatureTable, perms=None) -> None:
        """Build every index of the schema (or install ``perms[name]``, a
        permutation computed elsewhere) and load the backend."""
        t0 = time.perf_counter()
        indices = build_indices(st.sft)
        for name, index in indices.items():
            if perms is not None and name in perms:
                index.install(table, perms[name])
            else:
                index.build(table, self.device)
        t1 = time.perf_counter()
        state = self.backend.load(st.sft, table, indices)
        st.table, st.indices, st.backend_state = table, indices, state
        st.epoch += 1
        st.rebuild_s = {
            "index_build": t1 - t0,
            "load": time.perf_counter() - t1,
            "indices": {name: dict(index.build_s) for name, index in indices.items()},
        }

    def last_rebuild(self, type_name: str) -> dict:
        """Seconds the last rebuild of ``type_name`` spent building the
        indexes (``index_build``) and loading the backend (``load``:
        normalize + stage), and, under ``indices``, each index build's
        phases: ``normalize`` and ``stage`` (host → device) of the curve
        inputs, ``encode`` (the kernel; CUDA events on the card), ``sort``
        and ``copy_back`` (permutation and sorted keys to the host)."""
        return dict(self._state(type_name).rebuild_s or {})

    @staticmethod
    def _validate(sft: FeatureType, table: FeatureTable) -> None:
        checks = [(sft.geom_field, "geometry")]
        if sft.dtg_field is not None:
            checks.append((sft.dtg_field, "date"))
        for field, what in checks:
            col = table.columns[field]
            if not col.is_valid().all():
                bad = int((~col.is_valid()).sum())
                raise ValueError(
                    f"{bad} feature(s) with null {what} {field!r}: "
                    "indexed attributes must be non-null"
                )

    # -- queries --------------------------------------------------------------
    def query(self, type_name: str, q: "Query | str | ast.Filter | None" = None) -> QueryResult:
        """Exact row set: plan → device superset (or oracle) → host residual.
        With the ``density`` hint the result also carries its exact f64
        heatmap (``reduce.py:208-249``: points snap to their cell, lines and
        polygons rasterize their footprint); another hint but the ``tenant``
        metadata raises ``NotImplementedError``."""
        st = self._state(type_name)
        if not isinstance(q, Query):
            q = Query(filter=q)
        unported = sorted(k for k in q.hints
                          if k not in _METADATA_HINTS and k not in _ANSWERED_HINTS)
        if unported:
            raise NotImplementedError(f"query hints {unported} are not supported by this port "
                                      f"(it answers {sorted(_ANSWERED_HINTS)})")
        main = st.table
        if main is None:
            table = FeatureTable.from_records(st.sft, [])
            return QueryResult(table, np.empty(0, dtype=np.int64),
                               density=self._density_hint(q, table))
        f = q.resolved_filter()
        info = None
        timings: dict = {}
        if isinstance(self.backend, OracleBackend):
            rows = self.backend.select(None, None, None, None, f, main)
        else:
            plan, f, info = QueryPlanner(st.sft, st.indices).plan(q)
            timings["plan_ms"] = info.plan_ms
            rows = self.backend.select(
                st.backend_state, st.indices[info.scan_index], plan, info.extraction, f, main,
                timings=timings,
            )
        t0 = time.perf_counter()
        rows = np.sort(rows)
        table = main.take(rows)
        timings["take_ms"] = (time.perf_counter() - t0) * 1e3
        return QueryResult(table, rows, info, timings, self._density_hint(q, table))

    def resident_candidates(self, type_name: str, q: "Query | str | ast.Filter"):
        """``q``'s candidates as sorted-order positions on the card, for a
        consumer that tests them there (the corridor engine's gather form):
        the plan and the device refine of :meth:`query`, without its exact
        host residual and its take. A :class:`ResidentCandidates`, or None
        where the plan reads no resident point state: an Oracle backend, an
        empty store, or a line or polygon store's bbox state."""
        st = self._state(type_name)
        if not isinstance(self.backend, DeviceBackend) or st.table is None:
            return None
        if not isinstance(q, Query):
            q = Query(filter=q)
        plan, _, info = QueryPlanner(st.sft, st.indices).plan(q)
        state = (st.backend_state or {}).get(info.scan_index)
        if state is None or state.kind != "points":
            return None
        t0 = time.perf_counter()
        pos = self.backend.select_positions_device(state, st.sft, info.extraction,
                                                   plan.intervals)
        return ResidentCandidates(
            st.table, st.indices[info.scan_index].perm, state, pos.to(torch.int32), info,
            {"plan_ms": info.plan_ms, "select_ms": (time.perf_counter() - t0) * 1e3})

    @staticmethod
    def _density_hint(q: Query, table: FeatureTable):
        """The ``density`` hint's grid over the result, or None without it."""
        if "density" not in q.hints:
            return None
        return density_grid(table, q.hints["density"] or {})

    def _batch_payloads(self, st: _TypeState, qs, viewport=None) -> list:
        """The queries a batched pass can take (``datastore.py:1707``):
        pure bbox+time conjunctions on the default geometry/date fields,
        without a semantic hint. Returns ``[(query index, payload | None,
        exactable)]``: the payload is None for a provably disjoint filter;
        ``exactable`` is False when packing widened the payload (more boxes
        than ``MAX_BOXES`` or more windows than ``MAX_TIMES`` collapse to an
        envelope), so the int count is a superset beyond the edge buckets
        and cannot be corrected to exact. ``viewport`` (x1, y1, x2, y2):
        every query's boxes are clipped to it, so that rows outside it do not
        match (the density viewport); a query it clips to nothing has no
        payload."""
        pending = []
        for i, q in enumerate(qs):
            f = q.resolved_filter()
            if not _pure_bbox_time(f, st.sft) or _semantic_hints(q):
                continue
            e = extract(f, st.sft.geom_field, st.sft.dtg_field)
            if viewport is not None and not e.disjoint:
                vx1, vy1, vx2, vy2 = viewport
                boxes = e.boxes if e.boxes is not None else [(-180.0, -90.0, 180.0, 90.0)]
                clipped = []
                for x1, y1, x2, y2 in boxes:
                    nx1, ny1 = max(x1, vx1), max(y1, vy1)
                    nx2, ny2 = min(x2, vx2), min(y2, vy2)
                    if nx1 <= nx2 and ny1 <= ny2:
                        clipped.append((nx1, ny1, nx2, ny2))
                if not clipped:
                    pending.append((i, None, True))
                    continue
                e = replace(e, boxes=clipped)
            payload = None if e.disjoint else self.backend.payload(
                st.sft, e, overlap=not st.sft.geom_is_points)
            n_boxes = len(e.boxes) if e.boxes is not None else 1
            n_times = len(e.intervals) if e.intervals is not None else 1
            pending.append((i, payload, n_boxes <= MAX_BOXES and n_times <= MAX_TIMES))
        return pending

    def count_many(self, type_name: str, queries, loose: bool = True) -> list[int]:
        """Counts for many queries, the pure bbox+time ones in ONE device pass
        over the preferred point index's resident columns, or on a line or
        polygon store the preferred bbox index's (``datastore.py:1942-2090``);
        a provably disjoint filter counts 0.

        ``loose=True``: the int-domain count of the ``batched_count`` kernel
        (the loose-bbox semantics), or of ``batched_overlap`` with time on a
        bbox store (a feature counts when its bbox overlaps a query box).
        ``loose=False``: one ``batched_edge_gather`` launch (its overlap
        form on a bbox store) gives the same count plus each query's edge
        candidates, the only rows where the int count and the f64 filter can
        differ (in an edge bucket of a box, a bbox sharing an opposing edge
        bucket, or at a window's quantized endpoint); the host re-tests them
        against the full filter and subtracts the failures.

        Every other query goes through :meth:`query` and counts in
        ``exact_fallbacks``: a filter that is not pure bbox+time, a widened
        payload (``loose=False``), and a query whose edge candidates
        overflowed their lanes (``hits > EDGE_CAPACITY``). With one shard the
        port flags that overflow per query where the reference flags it per
        shard, so it may fall back where the reference did not; the counts
        are the same either way."""
        st = self._state(type_name)
        qs = [q if isinstance(q, Query) else Query(filter=q) for q in queries]
        out: list = [None] * len(qs)
        if st.table is None:
            return [0] * len(qs)
        pending = self._batch_payloads(st, qs) if isinstance(self.backend, DeviceBackend) else []
        live = []
        for i, payload, exactable in pending:
            if payload is None:
                out[i] = 0
            elif loose or exactable:
                live.append((i, payload))
        if live:
            dev, name = DeviceBackend.point_state(st.backend_state)
            overlap = dev is None  # a line or polygon store (_batch_gate :1676-1705)
            if overlap:
                dev, name = DeviceBackend.bbox_state(st.backend_state)
            boxes = torch.from_numpy(np.stack([p[0] for _, p in live])).to(self.device)
            times = torch.from_numpy(np.stack([p[1] for _, p in live])).to(self.device)
            # make_batched_count_step / make_batched_overlap_step(with_time=True)
            # / make_batched_edge_gather_step(overlap=) (parallel/query.py:449,
            # :914, :342) on one shard: base 0, the kernel on cuda, its plain
            # version only on the CPU
            if loose:
                if overlap:
                    counts = batched_overlap_step(dev.spatial_cols(), dev.n, boxes, times)
                else:
                    counts = batched_count(*dev.spatial_cols(), 0, dev.n, boxes, times)
                counts = counts.cpu().numpy()
                for k, (i, _) in enumerate(live):
                    out[i] = int(counts[k])
            else:
                if overlap:
                    counts, pos, hits = batched_edge_gather_overlap(
                        dev.spatial_cols(), 0, dev.n, boxes, times, EDGE_CAPACITY)
                else:
                    counts, pos, hits = batched_edge_gather(
                        *dev.spatial_cols(), 0, dev.n, boxes, times, EDGE_CAPACITY)
                counts, pos, hits = counts.cpu().numpy(), pos.cpu().numpy(), hits.cpu().numpy()
                perm = st.indices[name].perm
                for k, (i, _) in enumerate(live):
                    h = int(hits[k, 0])
                    if h > pos.shape[2]:
                        continue  # truncated lanes: the exact per-query path
                    out[i] = int(counts[k])
                    if h:  # subtract the candidates the f64 filter rejects
                        rows = perm[pos[k, 0, :h].astype(np.int64)]
                        f = qs[i].resolved_filter()
                        out[i] -= int((~ast.residual_mask(f, st.table, rows)).sum())
        for i, q in enumerate(qs):
            if out[i] is None:
                self.exact_fallbacks += 1
                out[i] = self.query(type_name, q).count
        return out

    def select_many(self, type_name: str, queries) -> list[QueryResult]:
        """Row sets of many queries, equal to ``[self.query(type_name, q) for
        q in queries]`` (``datastore.py:1762-1941``): every query is planned
        as :meth:`query` plans it, the queries are grouped by the index
        whose order their intervals address, and each group's candidate
        blocks go through one ``select_many_positions``; each query's rows
        then take the exact host residual and are sorted. A disjoint plan
        has no blocks and answers empty; the Oracle backend and an empty
        store answer per query."""
        st = self._state(type_name)
        qs = [q if isinstance(q, Query) else Query(filter=q) for q in queries]
        main = st.table
        if main is None or isinstance(self.backend, OracleBackend):
            return [self.query(type_name, q) for q in qs]
        results: list = [None] * len(qs)
        for i, q in enumerate(qs):
            if _semantic_hints(q):  # the hint's reduce is query()'s
                results[i] = self.query(type_name, q)
        t0 = time.perf_counter()
        planner = QueryPlanner(st.sft, st.indices)
        planned = [None if results[i] is not None else planner.plan(q)
                   for i, q in enumerate(qs)]  # (plan, residual, info)
        split = {"plan_ms": (time.perf_counter() - t0) * 1e3, "tail_ms": 0.0}
        groups: dict[str, list[int]] = {}
        for i, p in enumerate(planned):
            if p is not None:
                groups.setdefault(p[2].scan_index, []).append(i)
        for name, idxs in groups.items():
            index = st.indices[name]
            pos_lists = self.backend.select_many_positions(
                st.backend_state[name], index,
                [planned[i][2].extraction for i in idxs],
                [planned[i][0].intervals for i in idxs], timings=split)
            t0 = time.perf_counter()
            for i, positions in zip(idxs, pos_lists):
                _, f, info = planned[i]
                rows = np.sort(residual_rows(index, positions, f, main))
                results[i] = QueryResult(main.take(rows), rows, info)
            split["tail_ms"] += (time.perf_counter() - t0) * 1e3
        self.last_select_many = split
        return results

    def density_many(self, type_name: str, queries, bbox, width: int = 256, height: int = 256,
                     loose: bool = True) -> list[np.ndarray]:
        """Density grids of many queries over one shared viewport ``bbox``
        (x1, y1, x2, y2) at ``width`` x ``height``, one (height, width)
        float64 grid per query (``datastore.py:2921``).

        ``loose=True``: the queries a batched pass can take (pure bbox+time
        conjunctions without a semantic hint, :meth:`_batch_payloads`) go
        through one ``batched_density_step`` over the preferred point
        state, their boxes clipped to the viewport and the viewport
        normalized as their grid bounds (``:2992-2998``): the int-domain
        (loose-bbox) semantics, so a row in an edge bucket may count where
        the exact path's f64 test drops it. A query the viewport clips to
        nothing, or a provably disjoint one, is an empty grid. Every other
        query, and every query with ``loose=False``, takes the exact path:
        :meth:`query` with the ``density`` hint, the viewport merged over
        the caller's density options (``weight_by`` survives). A line or
        polygon store takes the exact path for every query, as the
        reference's does (``datastore.py:2955-2970``: its batched step
        snaps points only). No circuit breaker, failover or audit: a device
        error propagates."""
        st = self._state(type_name)
        qs = [q if isinstance(q, Query) else Query(filter=q) for q in queries]
        width, height = int(width), int(height)
        opts = {"bbox": tuple(bbox), "width": width, "height": height}

        def exact(q: Query) -> np.ndarray:
            caller = q.hints.get("density")
            merged = {**(caller if isinstance(caller, dict) else {}), **opts}
            return self.query(type_name, replace(q, hints={**q.hints, "density": merged})).density

        main = st.table
        if (not loose or main is None or len(main) == 0 or not st.sft.geom_is_points
                or not isinstance(self.backend, DeviceBackend)):
            return [exact(q) for q in qs]
        out: list = [None] * len(qs)
        live = []
        for i, payload, _ in self._batch_payloads(st, qs, viewport=opts["bbox"]):
            if payload is None:
                out[i] = np.zeros((height, width))
            else:
                live.append((i, payload))
        if live:
            dev, _ = DeviceBackend.point_state(st.backend_state)
            gb = int_boxes([opts["bbox"]])  # (1, 4) [xlo, xhi, ylo, yhi], as a payload's box
            boxes = torch.from_numpy(np.stack([p[0] for _, p in live])).to(self.device)
            times = torch.from_numpy(np.stack([p[1] for _, p in live])).to(self.device)
            gbs = torch.from_numpy(np.repeat(gb, len(live), axis=0)).to(self.device)
            grids = batched_density_step(dev.spatial_cols(), dev.n, boxes, times, gbs, width,
                                         height).cpu().numpy()
            for k, (i, _) in enumerate(live):
                out[i] = grids[k].astype(np.float64)
        return [exact(q) if g is None else g for q, g in zip(qs, out)]

    # -- grouped aggregation (GROUP BY in one device pass) -------------------

    _AGG_MAX_GROUPS = 65536  # beyond this the host fold is the better engine

    def aggregate_many(self, type_name: str, queries, group_by=None, value_cols=()) -> list:
        """Batched grouped aggregation: per query, COUNT(*) plus per value
        column count/sum/min/max for every GROUP BY key
        (``datastore.py:2500``, ``_aggregate_many_impl`` :2528).

        Three tiers answer, in the reference's order (``:2612-2794``):

        1. the query cache (:class:`~geomesa_tpu_torch.ops.geoblocks.QueryCache`,
           ``self.agg_cache``): an exact repeat (the same filter text, GROUP
           BY and value columns) on an unchanged store, stamped with the
           type's ``data_epoch()``; every write and compact makes it stale.
           A filter :func:`~geomesa_tpu_torch.filter.ast.to_cql` cannot
           render, or a query with a hint, is not cached;
        2. the GeoBlocks pyramid (:meth:`_pyramid`, built on the host once
           per rebuild epoch for each (GROUP BY, value columns)), when
           :func:`~geomesa_tpu_torch.planning.planner.choose_agg_path`
           routes there (``GEOMESA_TPU_PYRAMID=1``; off by default), for a
           point store and a filter that is one bbox and one time window on
           the default fields: interior partials from the pyramid, boundary
           rows re-tested against the full f64 filter;
        3. the fused device pass over the rest: the ``grouped_agg`` kernel
           folds every matching row but the boundary rows (in an edge bucket
           of a box or at a quantized window endpoint, the only rows where
           the int-domain predicate and the f64 filter can differ); the host
           re-tests those against the full filter and ADDS the ones that
           pass. Sums ride f64, folded with atomics in no fixed order on the
           card. A line or polygon store folds over its bbox state (xz3,
           then xz2) with the overlap form (``datastore.py:2666-2675``): a
           feature matches when its int bbox overlaps a query box, exact for
           the envelope semantics of BBOX away from the boundary rows, which
           are a bbox sharing an opposing edge bucket with a box or a row at
           a window's endpoint.

        Pyramid and fused answers go into the cache. Returns one entry per
        query: ``None`` when the query cannot ride the device path, for the
        reference's own reasons (a filter beyond a bbox+time conjunction on
        the default fields, a widened payload, a column that is missing,
        truncated boundary lanes (``hits > capacity``), NaN or geometry
        GROUP BY keys, non-numeric value columns, more than
        ``_AGG_MAX_GROUPS`` groups, an empty store or the Oracle backend),
        else ``{"groups": [key tuples], "count": (G,) int64, "cols": {col:
        {"count": (G,) int64, "sum"/"min"/"max": (G,) f64 (NaN = empty)}}}``
        with groups ordered by their first matching row and only groups with
        a matching row (``group_by=None``: one group, ``()``). A provably
        disjoint filter gives the empty result. ``last_aggregate_many``
        holds the call's queries by tier (``cache``, ``pyramid``, ``fused``,
        ``declined``) and the boundary rows each pyramid answer re-tested
        (``pyramid_boundary_rows``).

        Left out, as the port carries none of them yet: query interceptors,
        the audit hook, the cost model's observations (the route is a fixed
        rule, A.8.3), the pyramid's count mirror on the device with its
        devmon ledger and buffer pool (A.9), TTL age-off and the delta tier.
        A device error propagates."""
        st = self._state(type_name)
        qs = [q if isinstance(q, Query) else Query(filter=q) for q in queries]
        out: list = [None] * len(qs)
        group_by = list(group_by) if group_by else None
        value_cols = list(value_cols)
        tally = {"cache": 0, "pyramid": 0, "fused": 0, "declined": 0,
                 "pyramid_boundary_rows": []}
        self.last_aggregate_many = tally
        epoch = st.data_epoch()
        main = st.table
        if main is None or len(main) == 0 or not isinstance(self.backend, DeviceBackend):
            tally["declined"] = len(qs)
            return out
        if any(c not in main.columns for c in (group_by or []) + value_cols):
            tally["declined"] = len(qs)
            return out

        # -- the query cache and the GeoBlocks pyramid (datastore.py:2612-2663) --------
        keys_of = {}
        for i, q in enumerate(qs):
            key = self._agg_cache_key(q, group_by, value_cols)
            if key is None:
                continue
            keys_of[i] = key
            hit = self.agg_cache.get(type_name, key, epoch)
            if hit is not None:
                out[i] = hit
                tally["cache"] += 1
        if choose_agg_path() == "pyramid":
            pyr = None
            for i, q in enumerate(qs):
                if out[i] is not None:
                    continue
                e = self._pyramid_extraction(st, q)
                if e is None:
                    continue
                if e.disjoint:
                    out[i] = self._assemble_agg_empty(value_cols)
                    continue
                if pyr is None:
                    pyr = self._pyramid(st, main, group_by, value_cols, epoch[0])
                    if pyr is None:
                        break  # the shape cannot ride: the fused path
                out[i] = self._pyramid_answer(q, st, main, pyr, e, value_cols, group_by)
                tally["pyramid"] += 1
                if i in keys_of:
                    self.agg_cache.put(type_name, keys_of[i], epoch, out[i])
        todo = [i for i in range(len(qs)) if out[i] is None]
        if not todo:
            return out

        # -- the fused device pass over the rest ------------------------------------------
        dev, name = DeviceBackend.point_state(st.backend_state)
        overlap = dev is None  # a line or polygon store: its bbox state (datastore.py:2666)
        if overlap:
            dev, name = DeviceBackend.bbox_state(st.backend_state)
        if dev is None:
            tally["declined"] = len(todo)
            return out
        perm = st.indices[name].perm
        try:
            (dev_gid, gid_orig, keys), dev_rowid, dev_vals, host_vals = self._agg_residency(
                dev, main, perm, group_by, value_cols)
        except (TypeError, ValueError):
            tally["declined"] = len(todo)
            return out
        pending = [(todo[j], p, ok) for j, p, ok in
                   self._batch_payloads(st, [qs[i] for i in todo])]
        live = [(i, p) for i, p, ok in pending if p is not None and ok]
        for i, p, _ in pending:
            if p is None:  # provably disjoint: zero rows, no groups
                out[i] = self._assemble_agg_empty(value_cols)
        if live:
            n_groups = len(keys)
            g_pad = 1 << max(0, (n_groups - 1).bit_length())
            cap = EDGE_CAPACITY  # boundary lanes a query, as the reference's (:2713)
            boxes = torch.from_numpy(np.stack([p[0] for _, p in live])).to(self.device)
            times = torch.from_numpy(np.stack([p[1] for _, p in live])).to(self.device)
            res = grouped_agg_step(dev.spatial_cols(), dev_gid, dev_rowid, dev_vals, dev.n,
                                   boxes, times, g_pad, cap, extents=dev.extents,
                                   overlap=overlap)
            cnt, first, vcnt, vsum, vmin, vmax, epos, ehits = (t.cpu().numpy() for t in res)
            for k, (i, _) in enumerate(live):
                h = int(ehits[k, 0])
                if h > cap:
                    continue  # truncated boundary lanes: the caller's host fold
                cand = epos[k, 0, :h].astype(np.int64)
                out[i] = self._assemble_agg(
                    qs[i], main, keys, value_cols,
                    cnt[k, :n_groups].astype(np.int64), first[k, :n_groups].astype(np.int64),
                    vcnt[k, :, :n_groups].astype(np.int64), vsum[k, :, :n_groups].copy(),
                    vmin[k, :, :n_groups].copy(), vmax[k, :, :n_groups].copy(),
                    perm[cand], gid_orig, host_vals, group_by)
                tally["fused"] += 1
                if i in keys_of:
                    self.agg_cache.put(type_name, keys_of[i], epoch, out[i])
        tally["declined"] = sum(out[i] is None for i in todo)
        return out

    # -- GeoBlocks (ops/geoblocks.py) -----------------------------------------------

    @staticmethod
    def _agg_cache_key(q: Query, group_by, value_cols):
        """The exact-repeat cache key (``datastore.py:2317``): the filter's
        CQL text (``INCLUDE`` for none, a string as given, an AST through
        :func:`~geomesa_tpu_torch.filter.ast.to_cql`) with the GROUP BY and
        value columns. None (uncacheable) for a query with a hint or a
        filter ``to_cql`` cannot render (``_plan_cache_key``, :1532)."""
        if _semantic_hints(q):
            return None
        f = q.filter
        if f is None:
            text = "INCLUDE"
        elif isinstance(f, str):
            text = f
        else:
            try:
                text = ast.to_cql(f)
            except ValueError:
                return None
        return (text, tuple(group_by or ()), tuple(value_cols or ()))

    @staticmethod
    def _pyramid_extraction(st: _TypeState, q: Query):
        """The query's Extraction when it can ride the pyramid
        (``datastore.py:2330``): a bbox+time conjunction on the default
        fields with at most one box and one interval (the interior and
        boundary split is per rectangle), no hint. None: the fused path."""
        f = q.resolved_filter()
        if not _pure_bbox_time(f, st.sft) or _semantic_hints(q):
            return None
        e = extract(f, st.sft.geom_field, st.sft.dtg_field)
        if e.boxes is not None and len(e.boxes) != 1:
            return None
        if e.intervals is not None and len(e.intervals) != 1:
            return None
        return e

    def _pyramid(self, st: _TypeState, main: FeatureTable, group_by, value_cols,
                 main_epoch: int):
        """The (group_by, value_cols) pyramid of the current main tier
        (``datastore.py:2354``), built on the host once per rebuild epoch
        (one stable sort), with ``build_ms`` set on it. None when the shape
        cannot ride: a line or polygon store, geometry or non-numeric value
        columns, NaN or geometry keys, more than ``_AGG_MAX_GROUPS`` groups,
        or the byte cap (``GEOMESA_TPU_PYRAMID_BYTES``; the rows' O(N) share
        is checked before any input is prepared); the failure is remembered
        for the epoch. The reference's device mirror of the finest level's
        counts (``_pyramid_mirror`` :2430), which no kernel reads, is left
        out (ROADMAP.md A.9)."""
        pkey = (tuple(group_by or ()), tuple(value_cols))
        cached = st.pyramids.get(pkey)
        if cached is not None and cached[1] == main_epoch:
            return cached[0]  # may be None: the remembered failure
        t0 = time.perf_counter()
        try:
            if geoblocks.base_over_cap(len(main), len(value_cols)):
                raise ValueError("pyramid exceeds the byte cap for this shape")
            col = main.geom_column() if st.sft.geom_field else None
            if col is None or col.x is None:
                raise ValueError("pyramid needs point geometries")
            gid, keys = self._agg_group_ids(main, group_by)
            if len(keys) > self._AGG_MAX_GROUPS:
                raise ValueError("group cardinality beyond the pyramid")
            xi = norm_lon(REFINE_PRECISION).normalize(col.x).astype(np.int64)
            yi = norm_lat(REFINE_PRECISION).normalize(col.y).astype(np.int64)
            if st.sft.dtg_field:
                bins, _ = BinnedTime(st.sft.z3_interval).to_bin_and_offset(main.dtg_millis())
            else:
                bins = np.zeros(len(main), dtype=np.int64)
            vals = []
            for c in value_cols:
                cv = main.columns[c]
                v = np.asarray(cv.values, dtype=np.float64).copy()
                if cv.valid is not None:
                    v[~cv.valid] = np.nan
                vals.append(v)
            vmat = np.stack(vals) if vals else np.zeros((0, len(main)), dtype=np.float64)
            pyr = geoblocks.AggPyramid(xi, yi, bins, gid, keys, vmat, epoch=main_epoch)
        except (TypeError, ValueError):
            pyr = None
        if pyr is not None:
            pyr.build_ms = (time.perf_counter() - t0) * 1e3
        st.pyramids[pkey] = (pyr, main_epoch)
        return pyr

    def _pyramid_answer(self, q: Query, st: _TypeState, main: FeatureTable, pyr, e,
                        value_cols, group_by):
        """One exact grouped aggregate from the pyramid (``datastore.py:2467``):
        its interior partials, and the boundary rows re-tested against the
        full f64 filter and added (:meth:`_assemble_agg`)."""
        box = None
        if e.boxes is not None:
            (x1, y1, x2, y2), = e.boxes
            box = (int(norm_lon(REFINE_PRECISION).normalize(x1)),
                   int(norm_lon(REFINE_PRECISION).normalize(x2)),
                   int(norm_lat(REFINE_PRECISION).normalize(y1)),
                   int(norm_lat(REFINE_PRECISION).normalize(y2)))
        window = None
        quads = time_quads(st.sft, e.intervals)
        if quads is not None:
            blo, olo, bhi, ohi = (int(v) for v in quads[0])
            if (blo, olo) > (bhi, ohi):  # clamped to unsatisfiable
                self.last_aggregate_many["pyramid_boundary_rows"].append(0)
                return self._assemble_agg_empty(value_cols)
            window = (blo, olo, bhi, ohi)
        cnt, first, vcnt, vsum, vmin, vmax, brows = pyr.answer(box, window)
        self.last_aggregate_many["pyramid_boundary_rows"].append(len(brows))
        return self._assemble_agg(q, main, pyr.keys, value_cols, cnt, first, vcnt, vsum,
                                  vmin, vmax, np.sort(brows), pyr.gid, pyr.host_vals, group_by)

    def _agg_group_ids(self, main: FeatureTable, group_by):
        """Factorize the GROUP BY key columns over ``main`` (``datastore.py
        :2115-2190``) → (int32 group id per row, group keys as tuples in
        first-occurrence row order); the reference's output, with its two
        sorts over the rows replaced where :func:`_factorize` and
        :func:`_first_rows` can. NaN keys raise ``ValueError`` (the
        host fold keeps every NaN its own group, ``np.unique`` would merge
        them); geometry keys raise ``TypeError``; a key space beyond 2^62
        raises ``ValueError``."""
        n = len(main)
        if not group_by:
            return np.zeros(n, dtype=np.int32), [()]
        ids: list[np.ndarray] = []
        vocabs: list[list] = []
        for g in group_by:
            col = main.columns[g]
            if isinstance(col, GeometryColumn):
                raise TypeError("geometry GROUP BY keys take the host fold")
            vals = col.values
            if isinstance(vals, np.ndarray) and vals.dtype.kind == "f" and np.isnan(vals).any():
                raise ValueError("NaN GROUP BY keys take the host fold")
            try:
                uniq, inv = _factorize(vals)
                vocabs.append(list(uniq))
                ids.append(inv)
            except TypeError:
                # object column with None or mixed values: dict factorize
                seen: dict = {}
                inv = np.empty(n, dtype=np.int64)
                vocab: list = []
                for i, v in enumerate(vals):
                    j = seen.get(v)
                    if j is None:
                        j = seen[v] = len(vocab)
                        vocab.append(v)
                    inv[i] = j
                vocabs.append(vocab)
                ids.append(inv)
        code = ids[0]
        for k in range(1, len(ids)):
            base = len(vocabs[k]) + 1
            if int(code.max(initial=0)) > (2**62) // base:
                raise ValueError("group key space overflows the device path")
            code = code * base + ids[k]
        uniq_codes, inv = _factorize(code)
        order = np.argsort(_first_rows(inv, len(uniq_codes)), kind="stable")
        rank = np.empty(len(order), dtype=np.int64)
        rank[order] = np.arange(len(order))
        gid = rank[inv].astype(np.int32)
        keys = []
        for ci in uniq_codes[order]:
            c = int(ci)
            parts = []
            for k in range(len(ids) - 1, 0, -1):
                base = len(vocabs[k]) + 1
                parts.append(vocabs[k][c % base])
                c //= base
            parts.append(vocabs[0][c])
            keys.append(tuple(reversed(parts)))
        return gid, keys

    def _agg_residency(self, dev, main: FeatureTable, perm, group_by, value_cols):
        """Stage (or fetch from ``dev.agg_cache``) the group-id column, the
        row-id column and the (V, N) float64 value matrix on the store's
        device, in ``dev``'s sorted order and padding (``datastore.py
        :2192``): ``gid`` int32 (0 on padding), ``rowid`` the permutation as
        int32 (int32 max on padding), each value column float64 with NaN for
        nulls (0 on padding). Returns ``((gid, gid in table order, keys),
        rowid, vals, [host values (n,) in table order per value column])``:
        a call copies nothing on the host, where the reference stacks the
        host columns anew (400 MB a call at 50M rows). Raises
        ``ValueError`` for more than ``_AGG_MAX_GROUPS`` groups and for NaN
        keys, ``TypeError`` (or ``ValueError``) for a column the f64 fold
        cannot carry: the caller declines every query."""
        padded, n = dev.rows_per_shard, len(main)

        def stage(host: np.ndarray, pad_value) -> torch.Tensor:
            out = np.full(padded, pad_value, dtype=host.dtype)
            out[:n] = host
            return torch.from_numpy(out).to(self.device)

        gkey = ("gid", tuple(group_by or ()))
        cached = dev.agg_cache.get(gkey)
        if cached is None:
            gid_orig, keys = self._agg_group_ids(main, group_by)
            if len(keys) > self._AGG_MAX_GROUPS:
                raise ValueError("group cardinality beyond the device path")
            cached = dev.agg_cache[gkey] = (stage(gid_orig[perm], 0), gid_orig, keys)
        rowid = dev.agg_cache.get(("rowid",))
        if rowid is None:
            rowid = dev.agg_cache[("rowid",)] = stage(
                np.asarray(perm, dtype=np.int32), np.iinfo(np.int32).max)
        per_dev, per_host = [], []
        for c in value_cols:
            got = dev.agg_cache.get(("val", c))
            if got is None:
                col = main.columns[c]
                if isinstance(col, GeometryColumn):
                    raise TypeError(f"value column {c!r} is a geometry")
                v = np.asarray(col.values, dtype=np.float64).copy()
                if col.valid is not None:
                    v[~col.valid] = np.nan
                got = dev.agg_cache[("val", c)] = (stage(v[perm], 0.0), v)
            per_dev.append(got[0])
            per_host.append(got[1])
        if per_dev:
            dv = torch.stack(per_dev)
        else:
            dv = torch.zeros((0, padded), dtype=torch.float64, device=self.device)
        return cached, rowid, dv, per_host

    @staticmethod
    def _assemble_agg_empty(value_cols):
        """A query with no matching row: no groups (``datastore.py:2796``)."""
        z64 = np.zeros(0, dtype=np.int64)
        zf = np.zeros(0, dtype=np.float64)
        return {"groups": [], "count": z64,
                "cols": {c: {"count": z64, "sum": zf, "min": zf, "max": zf}
                         for c in value_cols}}

    @staticmethod
    def _assemble_agg(q, main, keys, value_cols, cnt, first, vcnt, vsum, vmin, vmax,
                      cand_rows, gid_orig, host_vals, group_by):
        """Fold the boundary rows that pass the full f64 filter into the
        device partials (added, never subtracted, so min and max stay
        sound), then order the groups by their first matching row and keep
        those with a row (``datastore.py:2808``, without the delta tier and
        TTL). It serves the fused path and the pyramid."""
        f = q.resolved_filter()
        if len(cand_rows):
            rows = cand_rows[ast.residual_mask(f, main, cand_rows)]
            # unbuffered ufunc.at folds in row order, as the reference's loop
            g = gid_orig[rows].astype(np.int64)
            np.add.at(cnt, g, 1)
            np.minimum.at(first, g, rows)
            for v in range(len(value_cols)):
                x = host_vals[v][rows]
                ok = ~np.isnan(x)
                np.add.at(vcnt[v], g[ok], 1)
                np.add.at(vsum[v], g[ok], x[ok])
                np.minimum.at(vmin[v], g[ok], x[ok])
                np.maximum.at(vmax[v], g[ok], x[ok])
        if group_by:
            alive = np.nonzero(cnt > 0)[0]
            alive = alive[np.argsort(first[alive], kind="stable")]
        else:
            alive = np.arange(len(cnt))
        cols = {}
        for v, c in enumerate(value_cols):
            mn = vmin[v][alive].astype(np.float64)
            mx = vmax[v][alive].astype(np.float64)
            empty = vcnt[v][alive] == 0
            mn[empty] = np.nan
            mx[empty] = np.nan
            cols[c] = {"count": vcnt[v][alive], "sum": vsum[v][alive].astype(np.float64),
                       "min": mn, "max": mx}
        return {"groups": [keys[int(i)] for i in alive], "count": cnt[alive], "cols": cols}
