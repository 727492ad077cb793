"""The port's CQL subset against the reference: parse + extract give the
same boxes, intervals and disjoint flag; masks and residual masks agree
row for row; predicates outside the subset raise instead of answering.

Tolerance: none — bounds are compared as exact floats/ints and masks as
booleans.
"""

import numpy as np
import pytest

import geomesa_tpu  # noqa: F401  (x64 on)
from geomesa_tpu.filter import ast as ref_ast
from geomesa_tpu.filter.bounds import extract as ref_extract
from geomesa_tpu.filter.cql import parse as ref_parse
from geomesa_tpu.schema import columnar as ref_columnar
from geomesa_tpu.schema.sft import parse_spec as ref_parse_spec

from geomesa_tpu_torch.filter import ast
from geomesa_tpu_torch.filter.bounds import extract
from geomesa_tpu_torch.filter.cql import CQLError, parse
from geomesa_tpu_torch.schema import columnar
from geomesa_tpu_torch.schema.sft import parse_spec

SPEC = "name:String,count:Integer,score:Double,dtg:Date,*geom:Point:srid=4326"
T0 = 1_498_867_200_000
A = "2017-07-02T00:00:00.000Z/2017-07-05T00:00:00.000Z"
B = "2017-07-08T06:30:00.000Z/2017-07-09T00:00:00.000Z"

CQLS = [
    "INCLUDE",
    "EXCLUDE",
    "BBOX(geom, -10, -10, 10, 10)",
    "BBOX(geom, 170, -5, -170, 5)",
    "BBOX(geom, -200, -100, 200, 100)",
    f"BBOX(geom, -10, -10, 10, 10) AND dtg DURING {A}",
    f"dtg DURING {A} OR dtg DURING {B}",
    "(BBOX(geom, 0, 0, 20, 20) OR BBOX(geom, 40, 40, 60, 60)) AND dtg AFTER 2017-07-03T00:00:00Z",
    "NOT BBOX(geom, -10, -10, 10, 10)",
    f"NOT (dtg DURING {A}) AND BBOX(geom, -90, -45, 90, 45)",
    "BBOX(geom, -30, -30, 30, 30) AND name = 'n1'",
    "count > 5 AND BBOX(geom, 0, -60, 120, 60)",
    "score BETWEEN 0.2 AND 0.7",
    "dtg BEFORE 2017-07-10T00:00:00Z",
    "dtg BETWEEN '2017-07-02T00:00:00Z' AND '2017-07-04T00:00:00Z'",
    "dtg TEQUALS 2017-07-05T12:00:00.000Z",
    "dtg >= 2017-07-02T00:00:00Z AND dtg < 2017-07-03T00:00:00Z",
    "BBOX(geom, 0, 0, 10, 10) AND BBOX(geom, 20, 20, 30, 30)",
    f"dtg DURING {A} AND dtg DURING {B}",
    "name IN ('n0', 'n2') OR BBOX(geom, 0, 0, 5, 5)",
    "count <> 3 AND score <= 0.5",
    f"BBOX(geom, 170, -20, -160, 20) AND (dtg DURING {A} OR dtg DURING {B})",
]


@pytest.fixture(scope="module")
def tables():
    rng = np.random.default_rng(21)
    n = 3000
    lon = rng.uniform(-180, 180, n)
    lat = rng.uniform(-90, 90, n)
    t = T0 + rng.integers(0, 14 * 86_400_000, n)
    t[:5] = [T0 + 86_400_000, T0 + 4 * 86_400_000, 1_499_256_000_000, T0 + 2 * 86_400_000, 0]
    names = np.array([f"n{i % 4}" for i in range(n)], dtype=object)
    counts = rng.integers(0, 10, n).astype(np.int32)
    scores = rng.uniform(0, 1, n)
    fids = [f"f{i}" for i in range(n)]

    def build(spec_parser, mod):
        sft = spec_parser("t", SPEC)
        cols = {
            "name": mod.Column(sft.attr("name").type, names.copy()),
            "count": mod.Column(sft.attr("count").type, counts.copy()),
            "score": mod.Column(sft.attr("score").type, scores.copy()),
            "dtg": mod.Column(sft.attr("dtg").type, t.copy()),
            "geom": mod.point_column(lon.copy(), lat.copy()),
        }
        return mod.FeatureTable.from_columns(sft, fids, cols)

    return build(ref_parse_spec, ref_columnar), build(parse_spec, columnar)


@pytest.mark.parametrize("cql", CQLS)
def test_extract_and_masks_match_reference(cql, tables):
    ref_table, table = tables
    rf, f = ref_parse(cql), parse(cql)
    re_, e = ref_extract(rf, "geom", "dtg"), extract(f, "geom", "dtg")
    assert e.boxes == re_.boxes
    assert e.intervals == re_.intervals
    assert e.disjoint == re_.disjoint
    want = rf.mask(ref_table)
    assert np.array_equal(f.mask(table), want)
    rows = np.random.default_rng(len(cql)).choice(len(table), 700, replace=False)
    assert np.array_equal(
        ast.residual_mask(f, table, rows), ref_ast.residual_mask(rf, ref_table, rows)
    )


NULL_CQLS = [
    "name = 'n1'",
    "name <> 'n1'",
    "NOT (name = 'n2')",
    "name IN ('n0', 'n3')",
    "NOT (name IN ('n0', 'n3'))",
    "count > 4",
    "NOT (count > 4)",
    "count BETWEEN 2 AND 6",
    "NOT (count BETWEEN 2 AND 6)",
    "count <> 3",
    "score <= 0.5",
    "NOT (score < 0.25)",
    "score BETWEEN 0.2 AND 0.7",
    f"dtg DURING {A}",
    f"NOT (dtg DURING {A})",
    "count > 2 AND score < 0.6 OR name = 'n0'",
]


@pytest.fixture(scope="module", params=[False, True], ids=["dates", "null_dates"])
def null_tables(request):
    """4,000 rows whose String, Integer and Double columns hold ~20% nulls
    (and, in one form, the date too), made in both packages by
    ``from_records`` from the same records."""
    rng = np.random.default_rng(33)
    recs = []
    for i in range(4000):
        rec = {"name": f"n{i % 4}", "count": int(rng.integers(0, 10)),
               "score": float(rng.uniform(0, 1)), "dtg": int(T0 + rng.integers(0, 14 * 86_400_000))}
        for k in ("name", "count", "score") + (("dtg",) if request.param else ()):
            if rng.random() < 0.2:
                rec[k] = None
        recs.append((rec, float(rng.uniform(-180, 180)), float(rng.uniform(-90, 90))))
    from geomesa_tpu.geometry.types import Point as RefPoint
    from geomesa_tpu_torch.geometry.types import Point

    fids = [f"f{i}" for i in range(len(recs))]
    ref = ref_columnar.FeatureTable.from_records(
        ref_parse_spec("t", SPEC), [{**r, "geom": RefPoint(x, y)} for r, x, y in recs], fids)
    port = columnar.FeatureTable.from_records(
        parse_spec("t", SPEC), [{**r, "geom": Point(x, y)} for r, x, y in recs], fids)
    return ref, port


@pytest.mark.parametrize("cql", NULL_CQLS)
def test_masks_over_null_columns_match_reference(cql, null_tables):
    """A null value matches no compare, ``BETWEEN``, ``IN`` or ``DURING``,
    and ``NOT`` over them is what the reference makes of it: masks and
    residual masks equal the reference's row for row."""
    ref_table, table = null_tables
    rf, f = ref_parse(cql), parse(cql)
    for c in ("name", "count", "score"):
        assert (~table.columns[c].is_valid()).sum() > 500
    want = rf.mask(ref_table)
    assert np.array_equal(f.mask(table), want)
    rows = np.random.default_rng(len(cql)).choice(len(table), 900, replace=False)
    assert np.array_equal(
        ast.residual_mask(f, table, rows), ref_ast.residual_mask(rf, ref_table, rows))


@pytest.mark.parametrize(
    "cql",
    [
        "INTERSECTS(geom, POINT (0 0))",
        "DWITHIN(geom, POINT (0 0), 10, kilometers)",
        "name LIKE 'n%'",
        "name IS NULL",
        "IN ('f1', 'f2')",
    ],
)
def test_unported_predicates_raise(cql):
    ref_parse(cql)  # the reference understands it ...
    with pytest.raises(CQLError, match="not supported"):
        parse(cql)  # ... the port refuses rather than answer wrongly
