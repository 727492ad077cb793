"""Query planner: extract bounds → choose a strategy → plan scan intervals.

Port of :class:`geomesa_tpu.planning.planner.QueryPlanner` reduced to the
decision :meth:`StrategyDecider._heuristic` makes (``planner.py:317-321``)
over the indexes the port carries, z3 and z2 for points, xz3 and xz2 for
extended geometries: a temporally bounded filter scans the z3 (else xz3)
index's intervals, a spatially bounded one the z2 (else xz2) index's,
anything else is a full scan of the store in its preferred index order (z3,
xz3, z2, xz2). The cost model, stats and union plans of the reference stay
out. The residual
is always the full filter, so every plan is sound; the strategy only sizes
the candidate set.

:func:`standing_query_payload` decomposes a standing query into one row of
the subscription matrix (``planner.py:572`` of the reference);
:func:`choose_agg_path` routes the eligible grouped aggregations to the
fused device path or the GeoBlocks pyramid by a fixed rule.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any

from geomesa_tpu_torch.filter import ast
from geomesa_tpu_torch.filter.bounds import Extraction, extract
from geomesa_tpu_torch.filter.cql import parse as parse_cql
from geomesa_tpu_torch.index.api import DEFAULT_MAX_RANGES, IndexPlan
from geomesa_tpu_torch.index.z2 import XZ2Index, Z2Index
from geomesa_tpu_torch.index.z3 import XZ3Index, Z3Index, refuse_legacy
from geomesa_tpu_torch.ops import geoblocks
from geomesa_tpu_torch.ops.refine import pack_boxes, pack_times, unsat_rows
from geomesa_tpu_torch.schema.sft import FeatureType
from geomesa_tpu_torch.store.backends import (
    RESIDENT_INDEXES,
    int_boxes,
    preferred_index,
    time_quads,
)

FULL_SCAN = "full-scan"


@dataclass
class Query:
    """A query against one feature type: a CQL string, an AST node, or None
    (everything), and its ``hints`` (``planner.py:50``). The port answers
    the ``density`` hint (``{"bbox": (x1, y1, x2, y2), "width": w,
    "height": h, "weight_by": column}``, each optional) and takes
    ``tenant`` as metadata; ``DataStore.query`` refuses any other hint."""

    filter: Any = None
    hints: dict = field(default_factory=dict)

    def resolved_filter(self) -> ast.Filter:
        if self.filter is None:
            return ast.Include()
        if isinstance(self.filter, str):
            return parse_cql(self.filter)
        return self.filter


@dataclass
class QueryPlanInfo:
    """What was planned: the strategy, the bounds and the candidate volume.
    ``scan_index`` is the index whose sort order the plan's intervals
    address (the preferred one for a full scan)."""

    index_name: str  # "z3", "z2", "xz3", "xz2" or FULL_SCAN
    scan_index: str
    extraction: Extraction
    n_intervals: int
    n_candidates: int
    plan_ms: float


INDEX_TYPES = (Z3Index, XZ3Index, Z2Index, XZ2Index)  # in RESIDENT_INDEXES' order


def choose_agg_path() -> str:
    """Route the eligible grouped aggregations of an ``aggregate_many``
    call: the fused device path (``"scan"``) or the GeoBlocks pyramid
    (``"pyramid"``).

    It stands in for the reference's cost model (``planner.py:630``) until
    the port has one (ROADMAP.md A.8.3), and departs from that model's
    seeded default, the pyramid. The reference's model routes by the
    observed p50 of both paths; on an H100 it would take the fused path:
    ``chip_smoke.py``'s phase 6b (NVIDIA H100 80GB HBM3, 700 W power limit)
    timed it at 0.4403 ms a query against the pyramid's 65.2381 on bench
    config 9's queries over 10M rows, whose 2-7 day windows leave nearly
    every matching row a boundary row the pyramid re-tests on the host.
    ``GEOMESA_TPU_PYRAMID=1`` (:func:`~geomesa_tpu_torch.ops.geoblocks.enabled`)
    routes to the pyramid; unset or ``0``, the fused path answers."""
    return "pyramid" if geoblocks.enabled() else "scan"


def build_indices(sft: FeatureType) -> dict:
    """The index set for a schema (the reference's ``build_indices``,
    ``planner.py:653``, over the indexes this port carries, without ``id``):
    z3 + z2 for points with a date, z2 for points without one, xz3 + xz2
    for extended geometries with a date, xz2 without one, narrowed by the
    ``geomesa.indices`` setting. A setting that names none of them, the
    legacy layout and a schema no ported index supports raise
    ``NotImplementedError``."""
    refuse_legacy(sft)
    configured = sft.configured_indices
    out = {}
    for cls in INDEX_TYPES:
        if configured is not None and cls.name not in configured:
            continue
        if cls.supports(sft):
            out[cls.name] = cls(sft)
    if not out:
        raise NotImplementedError(
            f"schema {sft.name!r} needs indexes this port does not carry yet "
            f"(it has {', '.join(RESIDENT_INDEXES)}): "
            f"geomesa.indices={configured}"
        )
    return out


class QueryPlanner:
    def __init__(self, sft: FeatureType, indices: dict):
        self.sft = sft
        self.indices = indices

    def choose(self, e: Extraction) -> str:
        """``_heuristic`` (``planner.py:317-321``): temporal → z3, else xz3;
        spatial → z2, else xz2; otherwise a full scan."""
        for bounded, names in ((e.temporally_bounded, ("z3", "xz3")),
                               (e.spatially_bounded, ("z2", "xz2"))):
            for name in names:
                if bounded and name in self.indices:
                    return name
        return FULL_SCAN

    def plan(
        self, q: Query, max_ranges: int = DEFAULT_MAX_RANGES
    ) -> tuple[IndexPlan, ast.Filter, QueryPlanInfo]:
        t0 = time.perf_counter()
        f = q.resolved_filter()
        e = extract(f, self.sft.geom_field, self.sft.dtg_field)
        name = self.choose(e)
        scan = preferred_index(self.indices) if name == FULL_SCAN else name
        index = self.indices[scan]
        if e.disjoint:
            plan = IndexPlan.empty()
        elif name == FULL_SCAN:
            plan = IndexPlan.full(index.n)
        else:
            plan = index.plan(e, max_ranges)
        info = QueryPlanInfo(
            index_name=name,
            scan_index=scan,
            extraction=e,
            n_intervals=len(plan.intervals),
            n_candidates=plan.n_candidates,
            plan_ms=(time.perf_counter() - t0) * 1e3,
        )
        return plan, f, info


def _standing_dimension(f, geom: str | None, dtg: str | None) -> str:
    """Dimension tag (``space``/``time``/``both``/``all``/``none``) for a
    filter the subscription matrix evaluates exactly in the int domain.

    The matrix runs no residual filter after the device scan, so any clause
    that bounds extraction would widen or drop (attribute predicates, NOT,
    ORs that mix dimensions: the matrix evaluates ``(any box) AND (any
    window)``) raises instead of over-delivering."""
    if isinstance(f, ast.Include):
        return "all"
    if isinstance(f, ast.Exclude):
        return "none"
    if isinstance(f, ast.BBox) and f.prop == geom:
        return "space"
    if isinstance(f, (ast.During, ast.TempOp)) and f.prop == dtg:
        return "time"
    if isinstance(f, ast.Between) and f.prop == dtg:
        return "time"
    if (isinstance(f, ast.Compare) and f.prop == dtg
            and f.op in ("=", "<", "<=", ">", ">=")):
        return "time"
    if isinstance(f, ast.And):
        tags = [_standing_dimension(c, geom, dtg) for c in f.children]
        if "none" in tags:
            return "none"
        tags = [t for t in tags if t != "all"]
        if not tags:
            return "all"
        if all(t == "space" for t in tags):
            return "space"
        if all(t == "time" for t in tags):
            return "time"
        return "both"
    if isinstance(f, ast.Or):
        tags = [_standing_dimension(c, geom, dtg) for c in f.children]
        if "all" in tags:
            return "all"
        tags = [t for t in tags if t != "none"]
        if not tags:
            return "none"
        if all(t == "space" for t in tags):
            return "space"
        if all(t == "time" for t in tags):
            return "time"
        raise ValueError(
            "standing queries cannot OR spatial with temporal clauses — "
            "the matrix evaluates (any box) AND (any window), a strict "
            f"superset of such a predicate: {f!r}"
        )
    raise ValueError(
        "standing queries evaluate bbox + time-window predicates only; no "
        f"residual filter runs after the device scan: unsupported clause {f!r}"
    )


def standing_query_payload(sft: FeatureType, predicate,
                           box_slots: int = 2, time_slots: int = 2):
    """Decompose a standing (bbox + time-window) query into one
    subscription-matrix row: ``(boxes (box_slots, 4) int32, times
    (time_slots, 4) int32)``, the packed int-domain encoding the count
    kernels take. ``predicate`` is CQL text, a filter node or a
    :class:`Query`. A provably disjoint predicate packs to the
    unsatisfiable sentinel; a clause the matrix cannot evaluate exactly
    raises ``ValueError``."""
    q = predicate if isinstance(predicate, Query) else Query(filter=predicate)
    f = q.resolved_filter()
    _standing_dimension(f, sft.geom_field, sft.dtg_field)
    e = extract(f, sft.geom_field, sft.dtg_field)
    if e.disjoint:
        return unsat_rows(box_slots, time_slots)
    return (
        pack_boxes(int_boxes(e.boxes), slots=box_slots),
        pack_times(time_quads(sft, e.intervals), slots=time_slots),
    )
