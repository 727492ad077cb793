"""The port's native z-range BFS (``csrc/zranges.cpp`` through
``curve.zranges.zranges``) against its plain Python BFS, the reference's
native BFS (``geomesa_tpu.native.zranges_native``) and the reference's
Python BFS, on 2-D and 3-D boxes at the budgets the planner passes; the
output-buffer retry; a failed build; and the planner's intervals against
the reference's indexes on config-2-shaped points.

Tolerance: none — every range and interval compares exactly.
"""

import ctypes
import importlib
import subprocess
from pathlib import Path

import numpy as np
import pytest

import geomesa_tpu  # noqa: F401  (x64 on)
from geomesa_tpu import native as ref_native
from geomesa_tpu.filter.bounds import extract as ref_extract
from geomesa_tpu.filter.cql import parse as ref_parse
from geomesa_tpu.index.z2 import Z2Index as RefZ2Index
from geomesa_tpu.index.z3 import Z3Index as RefZ3Index
from geomesa_tpu.schema import columnar as ref_columnar
from geomesa_tpu.schema.sft import parse_spec as ref_parse_spec

from geomesa_tpu_torch.curve import zranges as zr
from geomesa_tpu_torch.planning.planner import Query, QueryPlanner
from geomesa_tpu_torch.schema import columnar
from geomesa_tpu_torch.store.datastore import DataStore
from geomesa_tpu_torch.workload import bbox_time_cql, make_queries, synth_gdelt

# the module, not the function geomesa_tpu.curve re-exports under its name
ref_zranges_mod = importlib.import_module("geomesa_tpu.curve.zranges")

# Z3Index.plan splits DEFAULT_MAX_RANGES = 2000 over 1..8 day windows
# (index/z3.py:176), Z2SFC/Z3SFC.ranges over the boxes
BUDGETS = sorted({2000 // k for k in range(1, 9)} | {2000, 666, 285})
PRECISION = {2: 31, 3: 21}


@pytest.fixture(scope="module", autouse=True)
def _reference_native(tmp_path_factory):
    """The reference's native BFS, built for this module from the
    reference's own source with its own flags into a directory of this
    module's, and handed to the reference's loader. The reference builds
    ``libzranges.so`` beside its source at first use; under several test
    workers a process that loads it while another's ``g++`` is still
    writing it keeps ``None`` (no native BFS) for the rest of its run, and
    every comparison with ``zranges_native`` then fails."""
    lib = tmp_path_factory.mktemp("ref_zranges") / "libzranges.so"
    subprocess.run([zr._cxx(), "-O2", "-shared", "-fPIC", "-o", str(lib),
                    str(Path(ref_native.__file__).parent / "zranges.cpp")],
                   check=True, capture_output=True, timeout=300)
    missing = object()
    saved = ref_native._libs.get("zranges", missing)
    ref_native._libs["zranges"] = ctypes.CDLL(str(lib))
    yield
    if saved is missing:
        ref_native._libs.pop("zranges", None)
    else:
        ref_native._libs["zranges"] = saved


def _boxes(dims: int, seed: int, k: int = 6):
    """Random boxes of every size, a point box, a one-cell-wide slab and
    the whole domain less one cell."""
    p = PRECISION[dims]
    rng = np.random.default_rng(seed)
    out = []
    for i in range(k):
        lo = rng.integers(0, 2**p, dims)
        span = rng.integers(0, 2 ** (p - 1 - 3 * (i % 4)), dims)
        out.append((tuple(int(v) for v in lo),
                    tuple(int(v) for v in np.minimum(lo + span, 2**p - 1))))
    pt = tuple(int(v) for v in rng.integers(0, 2**p, dims))
    out.append((pt, pt))
    out.append(((0,) * dims, (5,) + (2**p - 1,) * (dims - 1)))
    out.append(((1,) * dims, (2**p - 1,) * dims))
    return out


def _ref_python(lows, highs, precision, budget, monkeypatch):
    """The reference's pure-Python BFS: its native path switched off."""
    with monkeypatch.context() as m:
        m.setattr(ref_native, "zranges_native", lambda *a, **k: None)
        return ref_zranges_mod.zranges(lows, highs, precision, budget)


@pytest.mark.parametrize("dims", [2, 3])
@pytest.mark.parametrize("budget", BUDGETS)
def test_native_equals_plain_and_reference(dims, budget, monkeypatch):
    p = PRECISION[dims]
    for lows, highs in _boxes(dims, seed=dims * 1000 + budget):
        got = zr.zranges(lows, highs, p, budget)
        assert got.dtype == np.uint64 and got.ndim == 2 and got.shape[1] == 2
        for want in (zr.zranges_plain(lows, highs, p, budget),
                     ref_native.zranges_native(lows, highs, p, budget),
                     _ref_python(lows, highs, p, budget, monkeypatch)):
            assert want.dtype == np.uint64 and np.array_equal(got, want)


@pytest.mark.parametrize("dims", [2, 3])
def test_edge_boxes(dims, monkeypatch):
    p = PRECISION[dims]
    full = (2**p - 1,) * dims
    cases = [
        ((7,) * dims, (3,) + (9,) * (dims - 1)),  # inverted: empty
        ((0,) * dims, full),  # the whole domain: one range
        ((0,) * dims, (0,) * dims),
    ]
    for lows, highs in cases:
        for budget, recurse in ((2000, 32), (0, 32), (1, 32), (50, 3)):
            got = zr.zranges(lows, highs, p, budget, recurse)
            want = zr.zranges_plain(lows, highs, p, budget, recurse)
            assert np.array_equal(got, want)
            assert np.array_equal(got, ref_native.zranges_native(lows, highs, p, budget, recurse))
    assert zr.zranges(*cases[0], p).shape == (0, 2)
    assert zr.zranges(*cases[1], p).tolist() == [[0, 2 ** (dims * p) - 1]]
    with pytest.raises(ValueError):
        zr.zranges((0, 0), (1, 1, 1), p)
    with pytest.raises(ValueError):
        zr.zranges((0,) * dims, (2**p,) * dims, p)  # beyond the precision
    with pytest.raises(ValueError):
        zr.zranges((0, 0, 0, 0), (1, 1, 1, 1), 10)


def test_output_buffer_retry(monkeypatch):
    lows, highs = (1000, 2000, 3000), (900_000, 700_000, 1_500_000)
    want = zr.zranges_plain(lows, highs, 21, 2000)
    assert len(want) > 8
    monkeypatch.setattr(zr, "_capacities", lambda budget: (2, 4 * budget + 64))
    assert np.array_equal(zr.zranges(lows, highs, 21, 2000), want)  # retried once
    monkeypatch.setattr(zr, "_capacities", lambda budget: (2, 4))
    with pytest.raises(RuntimeError, match="too few"):
        zr.zranges(lows, highs, 21, 2000)


def test_failed_build_raises(tmp_path):
    with pytest.raises(RuntimeError, match="g.. failed"):
        zr.build_library(zr.SRC, tmp_path, cxx="/bin/false")
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    with pytest.raises(RuntimeError, match="broken.cpp"):
        zr.build_library(bad, tmp_path)
    lib = zr.build_library(zr.SRC, tmp_path)
    assert lib.exists() and lib.parent == tmp_path and zr.SRC.stem in lib.name


N = 20_000
SPEC = "dtg:Date,*geom:Point:srid=4326;geomesa.z3.interval='day'"


@pytest.fixture(scope="module")
def planned():
    lon, lat, t = synth_gdelt(N, seed=42)
    boxes, windows = make_queries(24, seed=7)
    cqls = [bbox_time_cql(b, w) for b, w in zip(boxes, windows)] + [
        "BBOX(geom, -80, 35, -70, 45)",  # spatial only: z2
        "BBOX(geom, 170, -40, -170, 40) AND dtg DURING "
        "2017-07-02T00:00:00.000Z/2017-07-09T00:00:00.000Z",  # antimeridian, 8 days
    ]
    fids = [f"f{i}" for i in range(N)]
    port = DataStore(device="cpu")
    sft = port.create_schema("gdelt", SPEC)
    port.write("gdelt", columnar.FeatureTable.from_columns(sft, fids, {
        "dtg": columnar.Column(sft.attr("dtg").type, t.copy()),
        "geom": columnar.point_column(lon.copy(), lat.copy())}))
    rsft = ref_parse_spec("gdelt", SPEC)
    rtable = ref_columnar.FeatureTable.from_columns(rsft, fids, {
        "dtg": ref_columnar.Column(rsft.attr("dtg").type, t.copy()),
        "geom": ref_columnar.point_column(lon.copy(), lat.copy())})
    ref = {"z3": RefZ3Index(rsft), "z2": RefZ2Index(rsft)}
    for index in ref.values():
        index.build(rtable)
    return port, ref, cqls


def test_planner_intervals_equal_reference(planned):
    port, ref, cqls = planned
    st = port._state("gdelt")
    planner = QueryPlanner(st.sft, st.indices)
    chosen = set()
    for c in cqls:
        plan, _, info = planner.plan(Query(c))
        chosen.add(info.index_name)
        want = ref[info.index_name].plan(ref_extract(ref_parse(c), "geom", "dtg")).intervals
        assert plan.intervals.dtype == want.dtype and np.array_equal(plan.intervals, want), c
    assert chosen == {"z3", "z2"}


def test_query_and_select_many_report_their_host_split(planned):
    """``query()`` gives each result the host-clock ms of its plan, device
    select, residual and take; ``select_many`` keeps the last call's plan,
    block pairs, planned gather and tail. The answers stay the same."""
    port, _, cqls = planned
    one = [port.query("gdelt", c) for c in cqls]
    for r in one:
        assert set(r.timings) == {"plan_ms", "select_ms", "residual_ms", "take_ms"}
        assert all(v >= 0 for v in r.timings.values())
        assert r.timings["plan_ms"] == r.plan_info.plan_ms
    many = port.select_many("gdelt", cqls)
    assert set(port.last_select_many) == {"plan_ms", "pairs_ms", "gather_ms", "tail_ms"}
    assert all(v >= 0 for v in port.last_select_many.values())
    for a, b in zip(one, many):
        assert np.array_equal(a.row_ids, b.row_ids)
