"""Density heatmaps: the port's ``ops.density``, ``ops.step``, the batched
density step (its plain version on the CPU), ``DataStore.density_many``,
the ``density`` query hint and ``process.processes.density``, each against
geomesa_tpu's function on the same seeded inputs:

- ``density_grid`` == ``geomesa_tpu.ops.density.density_grid`` and
  ``query_step`` == ``geomesa_tpu.ops.step.query_step``, on random slots,
  masks and grid bounds, square and not, inverted and degenerate bounds;
- ``batched_density_step`` == ``make_batched_density_step(make_mesh(1), w,
  h)`` on GDELT-shaped rows in z3 order under city boxes, grid rows under
  ``grid_payload`` and the count kernels' edge rows under
  ``edge_payload``, with and without a ``true_n`` tail, each query's own box
  as its grid bounds (as bench config 3 runs it), a degenerate bound
  (``xlo == xhi``, products far past the grid: XLA's conversion saturates)
  and one shared viewport;
- ``DataStore.density_many``, loose and ``loose=False``, with a viewport
  that clips some queries to nothing, a filter the batched pass cannot take
  and a query with its own density hint, against the reference
  ``DataStore`` on one shard (``TpuBackend(mesh=make_mesh(1))``);
- ``query(hints={"density": ...}).density`` with ``weight_by`` and without,
  and ``processes.density``, against the reference; a hint the port does
  not carry raises;
- on the card (``cuda`` marker): the ``batched_density`` kernel against its
  plain version.

Tolerance: grids are equal exactly (f32 adds of 1.0 and f64 histograms).
"""

import numpy as np
import pytest
import torch

import geomesa_tpu  # noqa: F401  (x64 on)
import jax.numpy as jnp
from geomesa_tpu.ops.density import density_grid as ref_density_grid
from geomesa_tpu.ops.step import query_step as ref_query_step
from geomesa_tpu.parallel.mesh import make_mesh
from geomesa_tpu.parallel.query import make_batched_density_step
from geomesa_tpu.planning.planner import Query as RefQuery
from geomesa_tpu.process import processes as ref_processes
from geomesa_tpu.schema import columnar as ref_columnar
from geomesa_tpu.store.backends import TpuBackend
from geomesa_tpu.store.datastore import DataStore as RefDataStore

from geomesa_tpu_torch.ops import kernels
from geomesa_tpu_torch.ops.density import DEFAULT_GRID, density_grid
from geomesa_tpu_torch.ops.kernels import batched_density, batched_density_plain
from geomesa_tpu_torch.ops.step import query_step
from geomesa_tpu_torch.parallel.query import batched_density_step
from geomesa_tpu_torch.planning.planner import Query
from geomesa_tpu_torch.process import processes
from geomesa_tpu_torch.schema import columnar
from geomesa_tpu_torch.store.datastore import DataStore
from geomesa_tpu_torch.workload import (
    bbox_time_cql, edge_columns, edge_payload, grid_columns, grid_payload, make_queries,
    synth_gdelt)

from test_torch_kernels import CULL_N, _city_payload, _store_columns


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _bounds(rng, kind):
    """(4,) int32 grid bounds [xlo, xhi, ylo, yhi]."""
    if kind == "degenerate":
        v = int(rng.integers(0, 2**31 - 1))
        return np.array([v, v, v // 3, v // 3 + 5], np.int32)
    if kind == "inverted":
        return np.array([2**30, 2**29, 2**29, 2**30], np.int32)
    lo = np.sort(rng.integers(0, 2**31 - 1, (2, 2)), axis=1)
    return np.array([lo[0, 0], lo[0, 1], lo[1, 0], lo[1, 1]], np.int32)


@pytest.mark.parametrize("kind", ["box", "degenerate", "inverted"])
@pytest.mark.parametrize("width,height", [(256, 256), (37, 100), (1, 3)])
def test_density_grid_equals_reference(kind, width, height):
    rng = np.random.default_rng(width * 7 + height)
    n, c = 5000, 3000
    x = rng.integers(0, 2**31 - 1, n).astype(np.int32)
    y = rng.integers(0, 2**31 - 1, n).astype(np.int32)
    gb = _bounds(rng, kind)
    # a third of the points on the bounds' corners and edges
    x[: n // 3] = rng.choice([gb[0], gb[1], (int(gb[0]) + int(gb[1])) // 2], n // 3)
    y[: n // 3] = rng.choice([gb[2], gb[3]], n // 3)
    idx = rng.integers(0, n, c).astype(np.int32)
    mask = rng.random(c) < 0.7
    got = density_grid(_t(x), _t(y), _t(idx), _t(mask), _t(gb), width, height)
    want = np.asarray(ref_density_grid(jnp.asarray(x), jnp.asarray(y), jnp.asarray(idx),
                                       jnp.asarray(mask), jnp.asarray(gb), width=width,
                                       height=height))
    assert got.dtype == torch.float32 and got.shape == (height, width)
    assert np.array_equal(got.numpy(), want)
    assert DEFAULT_GRID == (256, 256)


@pytest.mark.parametrize("nb,nt", [(1, 1), (8, 16)])
def test_query_step_equals_reference(nb, nt):
    rng = np.random.default_rng(nb + nt)
    cols = edge_columns(6000, seed=nb)
    boxes, times = edge_payload(cols, 1, nb, nt, seed=nt, single=nb == 1)
    idx = rng.integers(0, 6000, 4096).astype(np.int32)
    count = 3000
    gb = np.array([0, 2**31 - 1, -(2**31), 2**31 - 1], np.int32)
    n, grid, mask = query_step(*(_t(c) for c in cols), _t(idx), count, _t(boxes[0]),
                               _t(times[0]), _t(gb), 64, 48)
    rn, rgrid, rmask = ref_query_step(*(jnp.asarray(c) for c in cols), jnp.asarray(idx),
                                      jnp.int32(count), jnp.asarray(boxes[0]),
                                      jnp.asarray(times[0]), jnp.asarray(gb), 64, 48)
    assert np.array_equal(mask.numpy(), np.asarray(rmask))
    assert int(n) == int(rn) and n.dtype == torch.int32
    assert np.array_equal(grid.numpy(), np.asarray(rgrid))


_REF_STEPS: dict = {}


def _ref_density(cols, true_n, boxes, times, gb, width, height):
    key = (width, height)
    if key not in _REF_STEPS:
        _REF_STEPS[key] = make_batched_density_step(make_mesh(1), width=width, height=height)
    return np.asarray(_REF_STEPS[key](*(jnp.asarray(c) for c in cols), jnp.int32(true_n),
                                      jnp.asarray(boxes), jnp.asarray(times), jnp.asarray(gb)))


def _step_inputs(maker, seed):
    """(host columns, boxes, times, true_n) for one row maker."""
    if maker in ("gdelt-z3", "tail"):
        cols, ds, sft = _store_columns(seed)
        boxes, times = _city_payload(ds, sft, seed)
    elif maker == "grid":
        cols = grid_columns(CULL_N, seed=seed)
        boxes, times = grid_payload(cols, 7, 8, 16, seed=seed + 1)
    else:
        cols = edge_columns(CULL_N, seed=seed)
        boxes, times = edge_payload(cols, 7, 8, 16, seed=seed + 1, single=False)
    return cols, boxes, times, CULL_N - 3500 if maker == "tail" else CULL_N


@pytest.mark.parametrize("bounds", ["own-box", "viewport", "degenerate"])
@pytest.mark.parametrize("maker", ["gdelt-z3", "tail", "grid", "edge"])
def test_batched_density_step_equals_reference(maker, bounds):
    cols, boxes, times, true_n = _step_inputs(maker, 5)
    q = boxes.shape[0]
    if bounds == "own-box":  # bench config 3: each query's first box slot
        gb = np.ascontiguousarray(boxes[:, 0, :])
    elif bounds == "viewport":
        gb = np.tile(np.array([2**29, 3 * 2**29, 2**28, 2**30], np.int32), (q, 1))
    else:
        gb = np.tile(np.array([2**30, 2**30, 0, 2**31 - 1], np.int32), (q, 1))
    for width, height in ((256, 256), (37, 100)):
        got = batched_density_step(tuple(_t(c) for c in cols), true_n, _t(boxes), _t(times),
                                   _t(gb), width, height)
        want = _ref_density(cols, true_n, boxes, times, gb, width, height)
        assert got.shape == (q, height, width) and got.dtype == torch.float32
        assert np.array_equal(got.numpy(), want)
    counts = kernels.batched_count_plain(*(_t(c) for c in cols), 0, true_n, _t(boxes),
                                         _t(times))
    if bounds != "viewport":  # every match lands in some cell: the mass is the count
        assert np.array_equal(got.sum(dim=(1, 2)).numpy(), counts.numpy().astype(np.float32))


def test_batched_density_wrapper_rejects_bad_inputs():
    cols = [torch.zeros(10, dtype=torch.int32) for _ in range(4)]
    boxes = torch.zeros((2, 1, 4), dtype=torch.int32)
    times = torch.zeros((2, 1, 4), dtype=torch.int32)
    gb = torch.zeros((2, 4), dtype=torch.int32)
    with pytest.raises(TypeError):
        batched_density(*cols, 0, 10, boxes, times, gb.long(), 8, 8)
    with pytest.raises(ValueError):
        batched_density(*cols, 0, 10, boxes, times, gb[:1], 8, 8)
    with pytest.raises(ValueError):
        batched_density(*cols, 0, 10, boxes, times, gb, 0, 8)


# -- the store ------------------------------------------------------------------

N = 20_000
SPEC = "val:Double,dtg:Date,*geom:Point:srid=4326;geomesa.z3.interval='day'"
A = "2017-07-02T00:00:00.000Z/2017-07-09T00:00:00.000Z"
VIEWPORT = (-20.0, 20.0, 60.0, 70.0)  # Europe to Delhi: New York, Tokyo, Beijing clip away


@pytest.fixture(scope="module")
def stores():
    """Port and one-shard reference stores over the same GDELT-shaped rows."""
    lon, lat, t = synth_gdelt(N, seed=42)
    vals = np.random.default_rng(9).normal(50.0, 20.0, N)
    fids = [f"g.{i}" for i in range(N)]
    out = []
    for s, mod in ((DataStore(device="cpu"), columnar),
                   (RefDataStore(backend=TpuBackend(mesh=make_mesh(1))), ref_columnar)):
        sft = s.create_schema("g", SPEC)
        s.write("g", mod.FeatureTable.from_columns(sft, fids, {
            "val": mod.Column(sft.attr("val").type, vals.copy()),
            "dtg": mod.Column(sft.attr("dtg").type, t.copy()),
            "geom": mod.point_column(lon.copy(), lat.copy())}))
        s.compact("g")
        out.append(s)
    return tuple(out)


def _density_queries():
    boxes, windows = make_queries(16, seed=7)
    cqls = [bbox_time_cql(b, w) for b, w in zip(boxes, windows)]
    return cqls + [
        f"(BBOX(geom, -5, 45, 5, 55) OR BBOX(geom, 30, 50, 40, 60)) AND dtg DURING {A}",
        "BBOX(geom, 0, 0, 10, 10) AND BBOX(geom, 20, 20, 30, 30)",  # disjoint
        "INCLUDE",
        f"dtg DURING {A}",
        f"BBOX(geom, -80, 30, -70, 45) AND dtg DURING {A}",  # outside the viewport
    ]


@pytest.mark.parametrize("loose", [True, False])
def test_density_many_equals_reference(stores, loose):
    port, ref = stores
    cqls = _density_queries()
    got = port.density_many("g", cqls, VIEWPORT, width=64, height=40, loose=loose)
    want = ref.density_many("g", cqls, VIEWPORT, width=64, height=40, loose=loose)
    assert len(got) == len(want) == len(cqls)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == np.float64 and g.shape == (40, 64)
        assert np.array_equal(g, w), cqls[i]
    clipped = [i for i, g in enumerate(got) if not g.any()]
    assert len(clipped) >= 3 and len(cqls) - 1 in clipped  # some queries clip to nothing
    if not loose:  # the exact path: an f64 histogram of each query's rows
        r = port.query("g", cqls[0])
        col = r.table.geom_column()
        hist, _, _ = np.histogram2d(col.y, col.x, bins=[40, 64],
                                    range=[[VIEWPORT[1], VIEWPORT[3]], [VIEWPORT[0], VIEWPORT[2]]])
        assert np.array_equal(got[0], hist)


def test_density_many_takes_hinted_queries_exactly(stores):
    """A query with its own density options is not batchable: its grid is
    the exact path's, in the shared viewport, with its ``weight_by``."""
    port, ref = stores
    cql = _density_queries()[0]
    q = Query(cql, hints={"density": {"weight_by": "val", "width": 5}})
    got = port.density_many("g", [q, cql], VIEWPORT, width=32, height=32)
    want = ref.density_many("g", [RefQuery(cql, hints={"density": {"weight_by": "val",
                                                                   "width": 5}}), cql],
                            VIEWPORT, width=32, height=32)
    assert got[0].shape == (32, 32)
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    assert not np.array_equal(got[0], got[1])  # weighted


@pytest.mark.parametrize("opts", [
    None, {"bbox": (-10.0, 40.0, 10.0, 60.0), "width": 20, "height": 10},
    {"bbox": (-10.0, 40.0, 10.0, 60.0), "weight_by": "val"}])
def test_density_hint_equals_reference(stores, opts):
    port, ref = stores
    cql = f"BBOX(geom, -20, 35, 20, 65) AND dtg DURING {A}"
    got = port.query("g", Query(cql, hints={"density": opts}))
    want = ref.query("g", RefQuery(cql, hints={"density": opts}))
    assert np.array_equal(got.density, want.density)
    assert sorted(got.table.fids.tolist()) == sorted(want.table.fids.tolist())
    assert port.query("g", cql).density is None


def test_density_process_equals_reference(stores):
    port, ref = stores
    for kw in ({}, {"bbox": (100.0, 20.0, 150.0, 50.0), "width": 16, "height": 8},
               {"weight_by": "val", "width": 12, "height": 12}):
        got = processes.density(port, "g", f"dtg DURING {A}", **kw)
        want = ref_processes.density(ref, "g", f"dtg DURING {A}", **kw)
        assert np.array_equal(got, want)


def test_unported_hints_raise_and_select_many_answers_hints(stores):
    port, _ = stores
    with pytest.raises(NotImplementedError, match="sample"):
        port.query("g", Query("INCLUDE", hints={"sample": 0.5}))
    cql = f"BBOX(geom, -20, 35, 20, 65) AND dtg DURING {A}"
    hinted = Query(cql, hints={"density": {"width": 8, "height": 8}})
    tenant = Query(cql, hints={"tenant": "t1"})
    many = port.select_many("g", [hinted, cql, tenant])
    one = port.query("g", hinted)
    assert np.array_equal(many[0].density, one.density) and many[1].density is None
    assert np.array_equal(many[0].row_ids, many[1].row_ids)
    assert np.array_equal(many[2].row_ids, many[1].row_ids)
    assert port.count_many("g", [tenant, cql]) == [many[1].count] * 2


# -- on the card ----------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("maker", ["gdelt-z3", "tail", "grid", "edge"])
def test_batched_density_kernel_matches_plain_on_card(maker):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernel has no CPU mode")
    dev = torch.device("cuda")
    cols, boxes, times, true_n = _step_inputs(maker, 6)
    dcols = [_t(c).to(dev) for c in cols]
    for gb in (np.ascontiguousarray(boxes[:, 0, :]),
               np.tile(np.array([2**30, 2**30, 0, 2**31 - 1], np.int32), (boxes.shape[0], 1))):
        args = (*dcols, 0, true_n, _t(boxes).to(dev), _t(times).to(dev), _t(gb).to(dev))
        for width, height in ((256, 256), (37, 100)):
            got = batched_density(*args, width, height)
            want = batched_density_plain(*args, width, height)
            torch.cuda.synchronize()
            assert torch.equal(got, want)
