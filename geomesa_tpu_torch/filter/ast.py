"""Filter AST: the predicate language on the bbox+time path.

Port copy of the subset of :mod:`geomesa_tpu.filter.ast` that bbox+time
queries use: ``INCLUDE``/``EXCLUDE``, ``AND``/``OR``/``NOT``, ``BBOX`` on a
geometry column (a point, or an extended geometry's bounds),
``DURING``/``BEFORE``/``AFTER``/``TEQUALS`` on a date, and attribute
comparisons (``= <> < <= > >=``, ``BETWEEN``, ``IN``).
Evaluation is vectorized host numpy in f64/int64: every node maps a
:class:`~geomesa_tpu_torch.schema.columnar.FeatureTable` to a boolean mask.
These masks are the exact semantics the device's int-domain superset test is
refined back to.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Sequence

import numpy as np

from geomesa_tpu_torch.schema.columnar import FeatureTable, GeometryColumn, _to_millis
from geomesa_tpu_torch.schema.sft import AttributeType


class Filter:
    """Base node; ``mask(table)`` is the vectorized truth function."""

    def mask(self, table: FeatureTable) -> np.ndarray:
        raise NotImplementedError


@dataclass(frozen=True)
class Include(Filter):
    def mask(self, table):
        return np.ones(len(table), dtype=bool)


@dataclass(frozen=True)
class Exclude(Filter):
    def mask(self, table):
        return np.zeros(len(table), dtype=bool)


def _flatten(cls, children):
    out = []
    for c in children:
        if isinstance(c, cls):
            out.extend(c.children)
        else:
            out.append(c)
    return out


@dataclass(frozen=True)
class And(Filter):
    children: Sequence[Filter]

    def __post_init__(self):
        object.__setattr__(self, "children", tuple(_flatten(And, self.children)))

    def mask(self, table):
        m = np.ones(len(table), dtype=bool)
        for c in self.children:
            m &= c.mask(table)
        return m


@dataclass(frozen=True)
class Or(Filter):
    children: Sequence[Filter]

    def __post_init__(self):
        object.__setattr__(self, "children", tuple(_flatten(Or, self.children)))

    def mask(self, table):
        m = np.zeros(len(table), dtype=bool)
        for c in self.children:
            m |= c.mask(table)
        return m


@dataclass(frozen=True)
class Not(Filter):
    child: Filter

    def mask(self, table):
        return ~self.child.mask(table)


@dataclass(frozen=True)
class BBox(Filter):
    """``BBOX(geom, xmin, ymin, xmax, ymax)`` — the geometry's bbox
    intersects the closed box (xmin > xmax wraps the antimeridian); for a
    point, the point lies in it."""

    prop: str
    xmin: float
    ymin: float
    xmax: float
    ymax: float

    @property
    def bounds(self):
        return (self.xmin, self.ymin, self.xmax, self.ymax)

    def mask(self, table):
        """The reference's test on the column's bounds (``ast.py:121-129``);
        a point column's bounds are (x, y, x, y), read from ``x``/``y``."""
        col: GeometryColumn = table.columns[self.prop]  # type: ignore[assignment]
        if col.x is not None:
            bxmin = bxmax = col.x
            bymin = bymax = col.y
        else:
            bxmin, bymin, bxmax, bymax = col.bounds.T
        if self.xmin > self.xmax:  # antimeridian wrap: lon > xmin OR lon < xmax
            mx = (bxmax >= self.xmin) | (bxmin <= self.xmax)
        else:
            mx = (bxmax >= self.xmin) & (bxmin <= self.xmax)
        return mx & (bymax >= self.ymin) & (bymin <= self.ymax) & col.is_valid()


@dataclass(frozen=True)
class During(Filter):
    """``prop DURING t1/t2`` — exclusive endpoints (CQL temporal semantics)."""

    prop: str
    lo_millis: int
    hi_millis: int

    def mask(self, table):
        col = table.columns[self.prop]
        v = col.values
        return (v > self.lo_millis) & (v < self.hi_millis) & col.is_valid()


@dataclass(frozen=True)
class TempOp(Filter):
    """BEFORE (<), AFTER (>), TEQUALS (==)."""

    op: str
    prop: str
    millis: int

    def mask(self, table):
        col = table.columns[self.prop]
        v = col.values
        if self.op == "before":
            m = v < self.millis
        elif self.op == "after":
            m = v > self.millis
        elif self.op == "tequals":
            m = v == self.millis
        else:
            raise ValueError(f"unknown temporal op: {self.op}")
        return m & col.is_valid()


_CMP = {
    "=": lambda v, x: v == x,
    "<>": lambda v, x: v != x,
    "<": lambda v, x: v < x,
    "<=": lambda v, x: v <= x,
    ">": lambda v, x: v > x,
    ">=": lambda v, x: v >= x,
}


@dataclass(frozen=True)
class Compare(Filter):
    op: str  # =, <>, <, <=, >, >=
    prop: str
    literal: Any

    def mask(self, table):
        col = table.columns[self.prop]
        v = col.values
        lit = self.literal
        if col.type == AttributeType.DATE and not isinstance(lit, (int, np.integer)):
            lit = _to_millis(lit)
        valid = col.is_valid()
        if v.dtype == object:
            f = _CMP[self.op]
            out = np.zeros(len(v), dtype=bool)
            for i in range(len(v)):
                if valid[i]:
                    try:
                        out[i] = bool(f(v[i], lit))
                    except TypeError:
                        out[i] = False
            return out
        return _CMP[self.op](v, lit) & valid


@dataclass(frozen=True)
class Between(Filter):
    """``prop BETWEEN lo AND hi`` — inclusive both ends."""

    prop: str
    lo: Any
    hi: Any

    def mask(self, table):
        col = table.columns[self.prop]
        lo, hi = self.lo, self.hi
        if col.type == AttributeType.DATE:
            lo = lo if isinstance(lo, (int, np.integer)) else _to_millis(lo)
            hi = hi if isinstance(hi, (int, np.integer)) else _to_millis(hi)
        v = col.values
        if v.dtype == object:
            return Compare(">=", self.prop, lo).mask(table) & Compare(
                "<=", self.prop, hi
            ).mask(table)
        return (v >= lo) & (v <= hi) & col.is_valid()


@dataclass(frozen=True)
class In(Filter):
    prop: str
    literals: tuple

    def __post_init__(self):
        object.__setattr__(self, "literals", tuple(self.literals))

    def mask(self, table):
        out = np.zeros(len(table.columns[self.prop]), dtype=bool)
        for lit in self.literals:
            out |= Compare("=", self.prop, lit).mask(table)
        return out


_PROP_LEAVES = (BBox, During, TempOp, Compare, Between, In)


def _cql_literal(v) -> str:
    if isinstance(v, str):
        return "'" + v.replace("'", "''") + "'"
    if isinstance(v, bool):
        return "TRUE" if v else "FALSE"
    return str(v)


def _cql_millis(ms: int) -> str:
    import datetime

    return (datetime.datetime.fromtimestamp(ms / 1000, datetime.timezone.utc)
            .strftime("%Y-%m-%dT%H:%M:%S.%f")[:-3] + "Z")


def to_cql(f: Filter) -> str:
    """Render an AST back to CQL text, as the reference's ``to_cql``
    (``ast.py:557``) renders the node types this port has; any other node
    raises ``ValueError`` (the aggregation cache then takes the query as
    uncacheable, as the reference's ``_plan_cache_key`` does)."""
    if isinstance(f, Include):
        return "INCLUDE"
    if isinstance(f, Exclude):
        return "EXCLUDE"
    if isinstance(f, And):
        return " AND ".join(f"({to_cql(c)})" for c in f.children)
    if isinstance(f, Or):
        return " OR ".join(f"({to_cql(c)})" for c in f.children)
    if isinstance(f, Not):
        return f"NOT ({to_cql(f.child)})"
    if isinstance(f, BBox):
        return f"BBOX({f.prop}, {f.xmin}, {f.ymin}, {f.xmax}, {f.ymax})"
    if isinstance(f, During):
        return f"{f.prop} DURING {_cql_millis(f.lo_millis)}/{_cql_millis(f.hi_millis)}"
    if isinstance(f, TempOp):
        return f"{f.prop} {f.op.upper()} {_cql_millis(f.millis)}"
    if isinstance(f, Compare):
        return f"{f.prop} {f.op} {_cql_literal(f.literal)}"
    if isinstance(f, Between):
        return f"{f.prop} BETWEEN {_cql_literal(f.lo)} AND {_cql_literal(f.hi)}"
    if isinstance(f, In):
        return f"{f.prop} IN ({', '.join(_cql_literal(v) for v in f.literals)})"
    raise ValueError(f"cannot render {type(f).__name__} to CQL")


def column_refs(f: Filter) -> set:
    """The attribute columns ``f.mask()`` reads."""
    props: set = set()

    def walk(n):
        if isinstance(n, (And, Or)):
            for c in n.children:
                walk(c)
        elif isinstance(n, Not):
            walk(n.child)
        elif isinstance(n, _PROP_LEAVES):
            props.add(n.prop)
        elif not isinstance(n, (Include, Exclude)):
            raise NotImplementedError(f"filter node {type(n).__name__} is not ported")

    walk(f)
    return props


def residual_mask(f: Filter, table: FeatureTable, rows: np.ndarray) -> np.ndarray:
    """``f.mask(table.take(rows))`` gathering only the columns ``f`` reads."""
    rows = np.asarray(rows)
    if isinstance(f, Include):
        return np.ones(len(rows), dtype=bool)
    cols = {p: table.columns[p].take(rows) for p in column_refs(f)}
    sub = FeatureTable(table.sft, np.empty(len(rows), dtype=object), cols)
    return np.asarray(f.mask(sub), dtype=bool)
