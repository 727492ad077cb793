"""Batched KNN: the port's ``batched_knn_step`` (its plain version on the
CPU), ``process.knn.knn_many`` and ``knn``, each against geomesa_tpu on
the same seeded inputs:

- the step against ``make_batched_knn_step(make_mesh(1), k, impl=...)`` for
  ``map``, ``scan`` and ``blocked``, and against ``make_ring_knn_step``, at
  k in {1, 10, 64}, on GDELT-shaped rows in z3 order with bench config 3's
  points, with and without a ``true_n`` tail;
- ties broken by row: grid rows (a few hundred values per axis) under
  points placed on them, against a numpy f32 brute force ordered by (d2,
  row), bit for bit; fewer valid rows than k (the inf slots);
- ``knn_many`` (gather and ring) and ``knn`` on the device store, and
  ``knn`` on the oracle store, against the reference stores; ``impl`` and
  ``topology`` are checked as loudly as the reference checks them;
- on the card (``cuda`` marker): the ``batched_knn`` kernel against its
  plain version, distances bit-equal and rows equal.

Tolerance: distances within rtol 1e-6 plus atol 2.2e-5 degrees against the
reference. XLA on the CPU fuses the decode ``f32(x) * s - 180`` into one FMA
(``bench.py:576-582``; its decoded columns equal an FMA's bit for bit),
where the port rounds the product and the difference alone, as the card's
kernel does; so a decoded coordinate differs by at most one f32 ulp, 2^-16
degrees below 256, and a distance by at most sqrt(2) x 2^-16 = 2.16e-5
(plus the relative rounding of d2 and its root). Rows are equal wherever a
slot's distance is apart from its neighbours' (and the k-th from the
(k+1)-th) by more than that band. Against the numpy brute force, which
rounds every step as the port does, and the kernel against its plain
version, everything is exact.
"""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

import geomesa_tpu  # noqa: F401  (x64 on)
import jax.numpy as jnp
from geomesa_tpu.geometry.types import Point as RefPoint
from geomesa_tpu.parallel.mesh import make_mesh
from geomesa_tpu.parallel.query import make_batched_knn_step, make_ring_knn_step
from geomesa_tpu.process import knn as ref_knn
from geomesa_tpu.schema import columnar as ref_columnar
from geomesa_tpu.store.backends import TpuBackend
from geomesa_tpu.store.datastore import DataStore as RefDataStore

from geomesa_tpu_torch.ops.kernels import batched_knn, batched_knn_plain, knn_degrees
from geomesa_tpu_torch.parallel.query import batched_knn_step
from geomesa_tpu_torch.process import knn as knn_mod
from geomesa_tpu_torch.process.knn import knn, knn_many
from geomesa_tpu_torch.schema import columnar
from geomesa_tpu_torch.schema.columnar import Point
from geomesa_tpu_torch.store.datastore import DataStore
from geomesa_tpu_torch.workload import SPEC, grid_columns, knn_points, synth_gdelt

from test_torch_kernels import CULL_N, _store_columns

RTOL, ATOL = 1e-6, 2.2e-5  # see the module note
ROOT = pathlib.Path(__file__).resolve().parent.parent


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _band(d):
    return ATOL + RTOL * np.abs(d)


def _assert_knn_close(got_d, got_r, want_d, want_r, next_d=None):
    """Distances within the band; rows equal where a slot's distance stands
    apart from its neighbours' by more than the band, and the row sets
    equal where the k-th stands apart from the (k+1)-th (``next_d``)."""
    assert got_d.shape == want_d.shape and got_r.shape == want_r.shape
    assert np.allclose(got_d, want_d, rtol=RTOL, atol=ATOL, equal_nan=False)
    for qi in range(got_d.shape[0]):
        d = want_d[qi].astype(np.float64)
        gap = np.diff(d) > _band(d[1:])
        alone = np.ones(len(d), bool)
        alone[1:] &= gap
        alone[:-1] &= gap
        assert np.array_equal(got_r[qi][alone], want_r[qi][alone]), qi
        if next_d is not None and next_d[qi] - d[-1] > _band(next_d[qi]):
            assert set(got_r[qi].tolist()) == set(want_r[qi].tolist()), qi


def _brute(x, y, true_n, qx, qy, k):
    """numpy f32 KNN over the valid rows, each step rounded alone, ordered
    by (d2, row); slots past the valid rows (inf, min(j, n - 1))."""
    n = len(x)
    xf = x.astype(np.float32) * np.float32(360.0 / 2**31) - np.float32(180.0)
    yf = y.astype(np.float32) * np.float32(180.0 / 2**31) - np.float32(90.0)
    limit = max(0, min(n, true_n))
    dist = np.full((len(qx), k), np.inf, np.float32)
    rows = np.tile(np.minimum(np.arange(k), n - 1), (len(qx), 1)).astype(np.int32)
    for qi in range(len(qx)):
        dx, dy = xf[:limit] - qx[qi], yf[:limit] - qy[qi]
        d2 = dx * dx + dy * dy
        order = np.lexsort((np.arange(limit), d2))[:k]
        dist[qi, :len(order)] = np.sqrt(d2[order])
        rows[qi, :len(order)] = order
    return dist, rows


_REF: dict = {}


def _ref_step(kind, k, impl, x, y, true_n, qx, qy):
    key = (kind, k, impl)
    if key not in _REF:
        make = make_ring_knn_step if kind == "ring" else make_batched_knn_step
        _REF[key] = make(make_mesh(1), k, impl=impl)
    d, r = _REF[key](jnp.asarray(x), jnp.asarray(y), jnp.int32(true_n), jnp.asarray(qx),
                     jnp.asarray(qy))
    return np.asarray(d), np.asarray(r)


@pytest.fixture(scope="module")
def z3_rows():
    cols, _, _ = _store_columns(7)
    return cols[0], cols[1]


@pytest.mark.parametrize("tail", [False, True])
@pytest.mark.parametrize("k", [1, 10, 64])
@pytest.mark.parametrize("kind,impl", [("gather", "map"), ("gather", "scan"),
                                       ("gather", "blocked"), ("gather", None),
                                       ("ring", "map")])
def test_knn_step_equals_reference(z3_rows, kind, impl, k, tail):
    x, y = z3_rows
    true_n = CULL_N - 3500 if tail else CULL_N
    pts = knn_points(16).astype(np.float32)
    qx, qy = pts[:, 0].copy(), pts[:, 1].copy()
    got_d, got_r = batched_knn_step((_t(x), _t(y)), true_n, qx, qy, k, impl=impl)
    want_d, want_r = _ref_step(kind, k, impl, x, y, true_n, qx, qy)
    nxt, _ = batched_knn_step((_t(x), _t(y)), true_n, qx, qy, k + 1)
    assert got_d.dtype == torch.float32 and got_r.dtype == torch.int32
    _assert_knn_close(got_d.numpy(), got_r.numpy(), want_d, want_r, nxt[:, -1].numpy())
    assert (got_r.numpy() < true_n).all()


@pytest.mark.parametrize("k", [1, 10, 64])
def test_knn_ties_go_to_the_lower_row(k):
    """Grid rows share coordinates, so points on the grid meet many equal
    distances: the step orders them by row, bit for bit against numpy."""
    x, y, _, _ = grid_columns(30_000, seed=11, values=40)
    xf, yf = (v.numpy() for v in knn_degrees(_t(x), _t(y)))
    rng = np.random.default_rng(k)
    pick = rng.integers(0, len(x), 12)
    qx, qy = xf[pick].copy(), yf[pick].copy()  # exactly on rows: distance 0 ties
    qx[:4] += np.float32(0.5)
    got_d, got_r = batched_knn_step((_t(x), _t(y)), len(x), qx, qy, k)
    want_d, want_r = _brute(x, y, len(x), qx, qy, k)
    assert np.array_equal(got_d.numpy().view(np.int32), want_d.view(np.int32))
    assert np.array_equal(got_r.numpy(), want_r)
    d = got_d.numpy()
    assert (d[:, 1:] == d[:, :-1]).sum() > 0 or k == 1  # the case holds ties
    for m in ("map", "scan", "blocked"):  # the reference's distances, inside the band
        ref_d, _ = _ref_step("gather", k, m, x, y, len(x), qx, qy)
        assert np.allclose(d, ref_d, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("n,true_n,k", [(7, 5, 10), (7, 7, 7), (3, 0, 4), (4096, 100, 64)])
def test_knn_inf_slots(n, true_n, k):
    """Fewer valid rows than k: the valid rows first, then (inf, min(j, n -
    1)) — where the reference's map form puts its inf slots when k <= n."""
    rng = np.random.default_rng(n + k)
    x = rng.integers(0, 2**31 - 1, n).astype(np.int32)
    y = rng.integers(0, 2**31 - 1, n).astype(np.int32)
    qx = np.array([10.0, -170.0], np.float32)
    qy = np.array([20.0, 80.0], np.float32)
    got_d, got_r = batched_knn_plain(_t(x), _t(y), 0, true_n, _t(qx), _t(qy), k)
    want_d, want_r = _brute(x, y, true_n, qx, qy, k)
    assert np.array_equal(got_d.numpy().view(np.int32), want_d.view(np.int32))
    assert np.array_equal(got_r.numpy(), want_r)
    if k <= n:  # the map form is defined there
        ref_d, ref_r = _ref_step("gather", k, "map", x, y, true_n, qx, qy)
        fin = np.isfinite(ref_d)
        assert np.array_equal(np.isfinite(got_d.numpy()), fin)
        assert np.allclose(got_d.numpy()[fin], ref_d[fin], rtol=RTOL, atol=ATOL)
        assert np.array_equal(got_r.numpy()[~fin], ref_r[~fin])


def test_knn_step_checks_impl_and_inputs():
    x = torch.zeros(10, dtype=torch.int32)
    with pytest.raises(ValueError, match="unknown KNN impl"):
        batched_knn_step((x, x), 10, [0.0], [0.0], 3, impl="mapp")
    with pytest.raises(ValueError):
        batched_knn(x, x, 0, 10, torch.zeros(2), torch.zeros(3), 3)
    with pytest.raises(TypeError):
        batched_knn(x.long(), x, 0, 10, torch.zeros(2), torch.zeros(2), 3)
    with pytest.raises(ValueError):
        batched_knn(x, x, 0, 10, torch.zeros(2), torch.zeros(2), 0)


def test_knn_points_match_bench():
    spec = importlib.util.spec_from_file_location("bench_for_port_knn", ROOT / "bench.py")
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    rng = np.random.default_rng(3)  # bench.py:560-565
    want = np.stack([bench.CITIES[rng.integers(0, len(bench.CITIES))] + rng.normal(0, 1, 2)
                     for _ in range(64)])
    assert np.array_equal(knn_points(64), want)


# -- the store ------------------------------------------------------------------

N = 20_000


@pytest.fixture(scope="module")
def stores():
    """Port device, port oracle, one-shard reference and reference oracle
    stores over the same GDELT-shaped rows."""
    lon, lat, t = synth_gdelt(N, seed=42)
    fids = [f"g.{i}" for i in range(N)]
    out = []
    for s, mod in ((DataStore(device="cpu"), columnar),
                   (DataStore(backend="oracle", device="cpu"), columnar),
                   (RefDataStore(backend=TpuBackend(mesh=make_mesh(1))), ref_columnar),
                   (RefDataStore(backend="oracle"), ref_columnar)):
        sft = s.create_schema("g", SPEC)
        s.write("g", mod.FeatureTable.from_columns(sft, fids, {
            "dtg": mod.Column(sft.attr("dtg").type, t.copy()),
            "geom": mod.point_column(lon.copy(), lat.copy())}))
        s.compact("g")
        out.append(s)
    return tuple(out)


def _answers(res):
    return ([r[0].fids.tolist() for r in res], [r[1] for r in res])


@pytest.mark.parametrize("topology", ["gather", "ring"])
@pytest.mark.parametrize("k", [1, 10])
def test_knn_many_equals_reference(stores, topology, k):
    port, _, ref, _ = stores
    pts = knn_points(12)
    got = knn_many(port, "g", [Point(*p) for p in pts], k=k, topology=topology)
    want = ref_knn.knn_many(ref, "g", [RefPoint(*p) for p in pts], k=k, topology=topology)
    (gf, gd), (wf, wd) = _answers(got), _answers(want)
    for qi in range(len(pts)):
        assert gd[qi].dtype == np.float64 and len(gd[qi]) == k
        assert np.allclose(gd[qi], wd[qi], rtol=RTOL, atol=ATOL)
        alone = np.ones(k, bool)
        gap = np.diff(wd[qi]) > _band(wd[qi][1:])
        alone[1:] &= gap
        alone[:-1] &= gap
        assert [f for f, a in zip(gf[qi], alone) if a] == [f for f, a in zip(wf[qi], alone) if a]


@pytest.mark.parametrize("which", ["device", "oracle"])
def test_knn_per_point_equals_reference(stores, which):
    port, port_oracle, ref, ref_oracle = stores
    ds, rs = (port, ref) if which == "device" else (port_oracle, ref_oracle)
    for p in knn_points(4, seed=5):
        got_t, got_d = knn(ds, "g", Point(*p), k=7)
        want_t, want_d = ref_knn.knn(rs, "g", RefPoint(*p), k=7)
        assert np.array_equal(got_d, want_d)
        assert got_t.fids.tolist() == want_t.fids.tolist()
    # the oracle backend's knn_many is the per-point search
    if which == "oracle":
        pts = knn_points(3, seed=6)
        got = knn_many(ds, "g", [Point(*p) for p in pts], k=5)
        want = ref_knn.knn_many(rs, "g", [RefPoint(*p) for p in pts], k=5)
        for (gt, gd), (wt, wd) in zip(got, want):
            assert np.array_equal(gd, wd) and gt.fids.tolist() == wt.fids.tolist()


def test_knn_many_agrees_with_knn_and_checks_arguments(stores):
    port = stores[0]
    pts = [Point(*p) for p in knn_points(6, seed=8)]
    for (bt, bd), p in zip(knn_many(port, "g", pts, k=6), pts):
        et, ed = knn(port, "g", p, k=6)
        assert np.allclose(bd, ed, rtol=1e-5, atol=1e-4)  # f32 degrees against f64
        assert np.allclose(bd, knn_mod._f32_dists(
            *(c.astype(np.float32) for c in (bt.geom_column().x, bt.geom_column().y)), p),
            rtol=1e-5, atol=1e-4)
    with pytest.raises(ValueError, match="topology"):
        knn_many(port, "g", pts, topology="tree")
    with pytest.raises(ValueError, match="unknown KNN impl"):
        knn_many(stores[1], "g", pts, impl="fast")  # loud on the per-point path too
    empty = DataStore(device="cpu")
    empty.create_schema("e", SPEC)
    res = knn_many(empty, "e", pts[:2], k=3)
    assert [len(t) for t, _ in res] == [0, 0]


def test_knn_many_k_beyond_rows():
    """k above the row count answers every row once (kk = min(k, rows))."""
    lon, lat, t = synth_gdelt(9, seed=3)
    ds = DataStore(device="cpu")
    sft = ds.create_schema("s", SPEC)
    ds.write("s", columnar.FeatureTable.from_columns(sft, [f"s.{i}" for i in range(9)], {
        "dtg": columnar.Column(sft.attr("dtg").type, t),
        "geom": columnar.point_column(lon, lat)}))
    (tab, d), = knn_many(ds, "s", [Point(0.0, 0.0)], k=20)
    assert len(tab) == 9 and sorted(tab.fids.tolist()) == sorted(f"s.{i}" for i in range(9))
    assert np.all(np.diff(d) >= 0)


# -- on the card ----------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 10, 64])
def test_batched_knn_kernel_matches_plain_on_card(z3_rows, k):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernel has no CPU mode")
    dev = torch.device("cuda")
    grid = grid_columns(30_000, seed=11, values=40)
    pts = knn_points(70).astype(np.float32)
    for (x, y), true_n in (((z3_rows[0], z3_rows[1]), CULL_N - 3500),
                           ((grid[0], grid[1]), 30_000), ((z3_rows[0][:5], z3_rows[1][:5]), 5)):
        for q in (1, 16, 70):
            args = (_t(x).to(dev), _t(y).to(dev), 0, true_n, _t(pts[:q, 0]).to(dev),
                    _t(pts[:q, 1]).to(dev), k)
            got_d, got_r = batched_knn(*args)
            want_d, want_r = batched_knn_plain(*args)
            torch.cuda.synchronize()
            assert torch.equal(got_d.view(torch.int32), want_d.view(torch.int32))
            assert torch.equal(got_r, want_r)
