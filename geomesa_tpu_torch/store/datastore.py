"""DataStore: schema, writes, queries and batched counts on one device.

Port of the point path of :class:`geomesa_tpu.store.datastore.DataStore`,
for point schemas with or without a date: ``create_schema`` → ``write`` →
``compact`` → ``query`` / ``select_many`` / ``count_many``. Every write
builds the z3 and z2 indexes the schema has (keys encoded and sorted on the
store's device) and stages each index's columns. Differences from the reference, all
deliberate:

- ``write`` folds the rows straight into the sorted main tier and rebuilds
  (index sort + device residency); there is no delta hot tier yet, so
  ``compact`` has nothing to merge. Answers are the same as the
  reference's after its own ``compact``.
- No device fallbacks: no circuit breaker, no failover ``except`` in
  ``count_many``, no load-failure branch that leaves the store on the host.
  A device error propagates to the caller.
- ``select_many`` leaves out what the port does not carry yet: query
  interceptors, TTL age-off, the audit trail, query hints, the delta tier
  and ``reduce_result``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from geomesa_tpu_torch.device import resolve_device
from geomesa_tpu_torch.filter import ast
from geomesa_tpu_torch.filter.bounds import extract
from geomesa_tpu_torch.ops.kernels import EDGE_CAPACITY, batched_count, batched_edge_gather
from geomesa_tpu_torch.ops.refine import MAX_BOXES, MAX_TIMES
from geomesa_tpu_torch.planning.planner import Query, QueryPlanner, build_indices
from geomesa_tpu_torch.schema.columnar import FeatureTable
from geomesa_tpu_torch.schema.sft import FeatureType, parse_spec
from geomesa_tpu_torch.store.backends import DeviceBackend, OracleBackend, residual_rows


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


@dataclass
class QueryResult:
    """Matching features (``table``), their row ids in the main tier, and
    the plan that found them."""

    table: FeatureTable
    row_ids: np.ndarray
    plan_info: Any = None

    @property
    def count(self) -> int:
        return len(self.table)


@dataclass
class _TypeState:
    sft: FeatureType
    table: FeatureTable | None = None  # main tier, in write order
    indices: dict | None = None
    backend_state: Any = None
    rebuild_s: dict | None = None  # last rebuild's phase seconds


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

    # -- schema ---------------------------------------------------------------
    def create_schema(self, sft: FeatureType | str, spec: str | None = None) -> FeatureType:
        if isinstance(sft, str):
            if spec is None:
                raise ValueError("create_schema('name', 'spec string') requires a spec")
            sft = parse_spec(sft, spec)
        if not sft.geom_is_points:
            raise NotImplementedError(
                "this port serves point schemas only (the z3 and z2 indexes)"
            )
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
        lands there (no hot tier in this port), so this only checks the name."""
        self._state(type_name)

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
        """Exact row set: plan → device superset (or oracle) → host residual."""
        st = self._state(type_name)
        if not isinstance(q, Query):
            q = Query(filter=q)
        main = st.table
        if main is None:
            return QueryResult(FeatureTable.from_records(st.sft, []),
                               np.empty(0, dtype=np.int64))
        f = q.resolved_filter()
        info = None
        if isinstance(self.backend, OracleBackend):
            rows = self.backend.select(None, None, None, None, f, main)
        else:
            plan, f, info = QueryPlanner(st.sft, st.indices).plan(q)
            rows = self.backend.select(
                st.backend_state, st.indices[info.scan_index], plan, info.extraction, f, main
            )
        rows = np.sort(rows)
        return QueryResult(main.take(rows), rows, info)

    def _batch_payloads(self, st: _TypeState, qs) -> list:
        """The queries a batched count can take (``datastore.py:1707``):
        pure bbox+time conjunctions on the default geometry/date fields.
        Returns ``[(query index, payload | None, exactable)]``: the payload
        is None for a provably disjoint filter; ``exactable`` is False when
        packing widened the payload (more boxes than ``MAX_BOXES`` or more
        windows than ``MAX_TIMES`` collapse to an envelope), so the int
        count is a superset beyond the edge buckets and cannot be corrected
        to exact."""
        pending = []
        for i, q in enumerate(qs):
            f = q.resolved_filter()
            if not _pure_bbox_time(f, st.sft):
                continue
            e = extract(f, st.sft.geom_field, st.sft.dtg_field)
            payload = None if e.disjoint else self.backend.payload(st.sft, e)
            n_boxes = len(e.boxes) if e.boxes is not None else 1
            n_times = len(e.intervals) if e.intervals is not None else 1
            pending.append((i, payload, n_boxes <= MAX_BOXES and n_times <= MAX_TIMES))
        return pending

    def count_many(self, type_name: str, queries, loose: bool = True) -> list[int]:
        """Counts for many queries, the pure bbox+time ones in ONE device pass
        over the preferred point index's resident columns; a provably
        disjoint filter counts 0.

        ``loose=True``: the int-domain count of the ``batched_count`` kernel
        (the loose-bbox semantics). ``loose=False``: one ``batched_edge_gather``
        launch gives the same count plus each query's edge candidates, the
        only rows where the int count and the f64 filter can differ (in an
        edge bucket of a box or at a window's quantized endpoint); the host
        re-tests them against the full filter and subtracts the failures.

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
            boxes = torch.from_numpy(np.stack([p[0] for _, p in live])).to(self.device)
            times = torch.from_numpy(np.stack([p[1] for _, p in live])).to(self.device)
            # make_batched_count_step / make_batched_edge_gather_step
            # (parallel/query.py:449, :342) on one shard: base 0, the kernel
            # on cuda, its plain version only on the CPU
            if loose:
                counts = batched_count(*dev.spatial_cols(), 0, dev.n, boxes, times).cpu().numpy()
                for k, (i, _) in enumerate(live):
                    out[i] = int(counts[k])
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
        planner = QueryPlanner(st.sft, st.indices)
        planned = [planner.plan(q) for q in qs]  # (plan, residual, info)
        groups: dict[str, list[int]] = {}
        for i, (_, _, info) in enumerate(planned):
            groups.setdefault(info.scan_index, []).append(i)
        results: list = [None] * len(qs)
        for name, idxs in groups.items():
            index = st.indices[name]
            pos_lists = self.backend.select_many_positions(
                st.backend_state[name], index,
                [planned[i][2].extraction for i in idxs],
                [planned[i][0].intervals for i in idxs])
            for i, positions in zip(idxs, pos_lists):
                _, f, info = planned[i]
                rows = np.sort(residual_rows(index, positions, f, main))
                results[i] = QueryResult(main.take(rows), rows, info)
        return results
