"""The spatial join slice: the port's ``ops/join.py``, its block steps in
``parallel/query.py``, ``process/join.py`` and the ``polygon_join`` kernel's
plain version, each against geomesa_tpu on the same seeded inputs:

- ``pack_polygons``, ``pack_polygons_bucketed``, ``planned_candidate_rows``
  and ``polygon_block_plan`` equal the reference's; the reference plans on
  the tests' 8-device mesh, and its per-shard local block ids, made global,
  are the port's one-shard blocks;
- ``block_join_step`` (``polygon_join_plain`` on the CPU) equals
  ``make_block_join_step`` on the 8-device mesh per vertex bucket, with a
  polygon no block admits, one that covers every block and rows past
  ``true_n``; ``points_in_polygons_count`` and ``points_in_polygons_mask``
  equal the reference's; ``block_bbox_gather_step`` (``planned_gather``)
  gathers the reference's bbox candidates;
- ``join_rows_device``, ``join_within_device``, ``measured_pair_density``
  and ``join_counts_auto`` through the port's ``DataStore(device="cpu")``
  equal the reference store's on the same rows: row sets, counts, routes;
- ``workload.join_polygons`` equals ``bench.py``'s generator;
- the ``polygon_join`` wrapper refuses bad inputs; on the card (``cuda``
  marker) the kernel equals its plain version.

Tolerance: none. Counts and row sets are equal. The f32 crossing number
rounds each step alone in both packages: XLA on the CPU cannot contract
``x1 + (y - y1) * (x2 - x1) / dy`` into an FMA, since the division sits
between the product and the sum, so the port's plain torch and the
reference's XLA give the same bits.
"""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

import geomesa_tpu  # noqa: F401  (x64 on)
import jax.numpy as jnp
from geomesa_tpu.curve.sfc import Z2SFC as RefZ2SFC
from geomesa_tpu.geometry import types as ref_types
from geomesa_tpu.ops import join as ref_join
from geomesa_tpu.parallel.mesh import make_mesh, shard_columns
from geomesa_tpu.process import join as ref_pjoin
from geomesa_tpu.schema import columnar as ref_columnar
from geomesa_tpu.store.backends import TpuBackend
from geomesa_tpu.store.datastore import DataStore as RefDataStore

from geomesa_tpu_torch.geometry import types
from geomesa_tpu_torch.ops import join
from geomesa_tpu_torch.ops.kernels import (
    POLYGON_PASS_ROWS, polygon_join, polygon_join_plain, row_masks)
from geomesa_tpu_torch.parallel.query import (
    FULL_WINDOW, block_bbox_gather_step, block_join_step, join_pairs)
from geomesa_tpu_torch.process import join as pjoin
from geomesa_tpu_torch.schema import columnar
from geomesa_tpu_torch.store.datastore import DataStore
from geomesa_tpu_torch.workload import SPEC, join_polygons, synth_gdelt

ROOT = pathlib.Path(__file__).resolve().parent.parent
SHARDS = 8  # the reference's mesh in these tests (tests/conftest.py)
N = 60_000  # rows of the block-join inputs
EMPTY, WORLD = 40, 41  # the polygons no block admits and that covers every block
TAIL = 3_000  # rows past true_n that would count


def _ref_poly(p):
    """The reference's copy of a port geometry."""
    if isinstance(p, types.MultiPolygon):
        return ref_types.MultiPolygon([_ref_poly(q) for q in p.parts])
    return ref_types.Polygon(p.shell, tuple(p.holes))


def _special_polygons():
    """A polygon that no block admits (no points there), one covering every
    block, a MultiPolygon, one with a hole, and a wide many-vertex ring."""
    ang = np.linspace(0, 2 * np.pi, 200, endpoint=False)
    return [
        types.box(-170.0, -89.0, -160.0, -85.0),
        types.box(-180.0, -90.0, 180.0, 90.0),
        types.MultiPolygon([types.box(0.0, 50.0, 1.0, 52.0),
                            types.Polygon(np.stack([2.3 + 3 * np.cos(ang[::4]),
                                                    48.8 + 2 * np.sin(ang[::4])], 1))]),
        types.Polygon(np.array([[70.0, 20.0], [85.0, 20.0], [85.0, 35.0], [70.0, 35.0]]),
                      (np.array([[75.0, 25.0], [80.0, 25.0], [80.0, 30.0], [75.0, 30.0]]),)),
        types.Polygon(np.stack([116.4 + 0.4 * np.cos(ang), 39.9 + 0.3 * np.sin(ang)], 1)),
    ]


@pytest.fixture(scope="module")
def polygons():
    return join_polygons(40, seed=5) + _special_polygons()


@pytest.fixture(scope="module")
def z2_rows():
    """GDELT-shaped rows sorted by z2 as the bench sorts them, padded to
    whole blocks of the 8-shard layout with keys past every range."""
    lon, lat, _ = synth_gdelt(N, seed=42)
    z = RefZ2SFC().index(lon, lat)
    perm = np.argsort(z, kind="stable")
    return lon[perm], lat[perm], z[perm]


def _layout(z2_rows, block):
    lon, lat, zs = z2_rows
    mult = SHARDS * block
    pad_n = -(-N // mult) * mult
    xs = np.zeros(pad_n, np.float32)
    ys = np.zeros(pad_n, np.float32)
    xs[:N], ys[:N] = lon, lat
    padz = np.concatenate([zs, np.full(pad_n - N, 2**63, np.uint64)])
    return xs, ys, padz, pad_n


def _global_blocks(blk, nblk, p, per_shard):
    return sorted(int(blk[d, p, j]) + d * per_shard
                  for d in range(blk.shape[0]) for j in range(nblk[d, p]))


# -- the host copies --------------------------------------------------------------


@pytest.mark.parametrize("max_vertices", [128, 256])
def test_pack_polygons_equal_reference(polygons, max_vertices):
    fit = [p for p in polygons if isinstance(p, types.MultiPolygon)
           or len(p.shell) <= max_vertices]
    got = join.pack_polygons(fit, max_vertices)
    want = ref_join.pack_polygons([_ref_poly(p) for p in fit], max_vertices)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    for mod, point, big in ((join, types.Point(0.0, 0.0), polygons[-1]),
                            (ref_join, ref_types.Point(0.0, 0.0), _ref_poly(polygons[-1]))):
        with pytest.raises(ValueError, match="expected polygon"):
            mod.pack_polygons([point], 64)
        with pytest.raises(ValueError, match="vertices"):  # 201 > 64
            mod.pack_polygons([big], 64)


def test_pack_polygons_bucketed_equal_reference(polygons):
    got = join.pack_polygons_bucketed(polygons)
    want = ref_join.pack_polygons_bucketed([_ref_poly(p) for p in polygons])
    assert len(got) == len(want) >= 3
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    too_big = types.Polygon(np.random.default_rng(1).uniform(0, 1, (600, 2)))
    with pytest.raises(ValueError, match="max bucket"):
        join.pack_polygons_bucketed([too_big])


def test_planned_candidate_rows_equal_reference(z2_rows, polygons):
    _, _, zs = z2_rows
    bbox = np.array([p.bbox for p in polygons])
    got = join.planned_candidate_rows(zs, bbox)
    assert np.array_equal(got, ref_join.planned_candidate_rows(zs, bbox))
    assert got[EMPTY] == 0 and got[WORLD] == N


@pytest.mark.parametrize("block", [4096, 8192])
def test_polygon_block_plan_equals_reference(z2_rows, polygons, block):
    _, _, padz, pad_n = _layout(z2_rows, block)
    for _, _, bbox, _ in join.pack_polygons_bucketed(polygons):
        bb = bbox.astype(np.float64)
        offsets, blocks = join.polygon_block_plan(padz, bb, block, pad_n)
        assert offsets.dtype == np.int64 and blocks.dtype == np.int32
        assert offsets[0] == 0 and offsets[-1] == len(blocks)
        blk, nblk = ref_join.polygon_block_plan(padz, bb, block, pad_n // SHARDS, SHARDS)
        one, none = ref_join.polygon_block_plan(padz, bb, block, pad_n, 1)
        for p in range(len(bb)):
            mine = blocks[offsets[p]:offsets[p + 1]].tolist()
            assert mine == _global_blocks(blk, nblk, p, pad_n // SHARDS // block)
            assert mine == one[0, p, :none[0, p]].tolist()
    all_bb = np.array([p.bbox for p in polygons])
    offsets, blocks = join.polygon_block_plan(padz, all_bb, block, pad_n)
    counts = np.diff(offsets)
    assert counts[EMPTY] == 0 and counts[WORLD] == -(-N // block)
    with pytest.raises(ValueError):
        join.polygon_block_plan(padz, all_bb, block, pad_n + 1)


# -- the device steps ---------------------------------------------------------------


_STEP = {}


def _ref_block_join(block, cols, true_n, blk, nblk, verts, bbox):
    if block not in _STEP:
        _STEP[block] = ref_join.make_block_join_step(make_mesh(), block)
    return np.asarray(_STEP[block](cols["x"], cols["y"], jnp.int32(true_n), jnp.asarray(blk),
                                   jnp.asarray(nblk), jnp.asarray(verts), jnp.asarray(bbox)))


@pytest.mark.parametrize("block", [4096, 8192])
def test_block_join_step_equals_reference(z2_rows, polygons, block):
    """The port runs the bench's form, one launch per vertex bucket; the
    reference runs two packs (up to 16 vertices, and up to 128), so that it
    compiles two small shapes: its counts do not depend on the padding
    (padded edges never straddle)."""
    xs, ys, padz, pad_n = _layout(z2_rows, block)
    cols, _, rows_per_shard = shard_columns(make_mesh(), {"x": xs, "y": ys})
    true_n = N - TAIL
    x, y = torch.from_numpy(xs), torch.from_numpy(ys)
    got = np.zeros(len(polygons), dtype=np.int64)
    for ids, verts, bbox, nverts in join.pack_polygons_bucketed(polygons):
        offsets, blocks = join.polygon_block_plan(padz, bbox.astype(np.float64), block, pad_n)
        counts = block_join_step(x, y, true_n, join_pairs(offsets, blocks, "cpu"), verts, bbox,
                                 nverts, block)
        assert counts.dtype == torch.int32
        got[ids] = counts.numpy()
    want = np.zeros(len(polygons), dtype=np.int64)
    nv = np.array([join.pack_polygons([p], 512)[2][0] for p in polygons])
    for sel, v in ((np.nonzero(nv <= 16)[0], 16), (np.nonzero((nv > 16) & (nv <= 128))[0], 128)):
        verts, bbox, _ = join.pack_polygons([polygons[i] for i in sel], v)
        blk, nblk = ref_join.polygon_block_plan(padz, bbox.astype(np.float64), block,
                                                rows_per_shard, SHARDS)
        want[sel] = _ref_block_join(block, cols, true_n, blk, nblk, verts, bbox)
    ring = nv > 128  # bucket 256: against the dense plain count (the reference's in the next test)
    verts, bbox, _ = join.pack_polygons([polygons[i] for i in np.nonzero(ring)[0]], 256)
    want[ring] = join.points_in_polygons_mask(x[:true_n], y[:true_n], verts, bbox).sum(dim=1)
    assert nv[WORLD] <= 16 and ring.any() and np.array_equal(got, want) and want.sum() > 0
    assert want[EMPTY] == 0
    # rows past true_n would count: with them the whole-world polygon counts more
    world = join.pack_polygons([polygons[WORLD]], 16)
    offsets, blocks = join.polygon_block_plan(padz, world[1].astype(np.float64), block, pad_n)
    pairs = join_pairs(offsets, blocks, "cpu")
    inside = block_join_step(x, y, true_n, pairs, *world[:2], world[2], block)
    assert inside.item() == want[WORLD]
    assert inside.item() < block_join_step(x, y, N, pairs, *world[:2], world[2], block).item()


def test_join_pairs_order_by_block():
    offsets = np.array([0, 3, 3, 5])
    blocks = np.array([0, 4, 7, 4, 9], dtype=np.int32)
    pp, pb = join_pairs(offsets, blocks, "cpu")
    assert pb.tolist() == [0, 4, 4, 7, 9] and pp.tolist() == [0, 0, 2, 0, 2]
    assert pp.dtype == pb.dtype == torch.int32


def test_points_in_polygons_count_and_mask_equal_reference(z2_rows, polygons):
    lon, lat, _ = z2_rows
    n = 20_000  # ragged: padded to whole blocks inside
    xs, ys = lon[:n].astype(np.float32), lat[:n].astype(np.float32)
    pick = [p for p in polygons if not isinstance(p, types.MultiPolygon)][30:]
    verts, bbox, nverts = join.pack_polygons(pick, 256)  # the 200-vertex ring included
    want = np.asarray(ref_join.points_in_polygons_count(jnp.asarray(xs), jnp.asarray(ys),
                                                        jnp.asarray(verts), jnp.asarray(bbox)))
    x, y = torch.from_numpy(xs), torch.from_numpy(ys)
    got = join.points_in_polygons_count(x, y, verts, bbox)
    assert np.array_equal(got.numpy(), want) and want.sum() > 0
    assert np.array_equal(join.points_in_polygons_count(x, y, verts, bbox, nverts).numpy(), want)
    mask = join.points_in_polygons_mask(x, y, verts, bbox)
    want_mask = np.asarray(ref_join.points_in_polygons_mask(
        jnp.asarray(xs), jnp.asarray(ys), jnp.asarray(verts), jnp.asarray(bbox)))
    assert mask.dtype == torch.bool and np.array_equal(mask.numpy(), want_mask)
    assert np.array_equal(mask.sum(dim=1).numpy(), want)
    # true_n leaves the tail out
    assert np.array_equal(join.points_in_polygons_count(x, y, verts, bbox, true_n=n - 3000)
                          .numpy(), mask[:, :n - 3000].sum(dim=1).numpy())


_GATHER = {}


def test_block_bbox_gather_step_equals_reference(z2_rows, polygons):
    lon, lat, zs = z2_rows
    block = 4096
    nlon, nlat = RefZ2SFC().lon, RefZ2SFC().lat
    xi = nlon.normalize(lon).astype(np.int32)
    yi = nlat.normalize(lat).astype(np.int32)
    mult = SHARDS * block
    pad_n = -(-N // mult) * mult
    cols_np = {"x": np.zeros(pad_n, np.int32), "y": np.zeros(pad_n, np.int32)}
    cols_np["x"][:N], cols_np["y"][:N] = xi, yi
    mesh = make_mesh()
    cols, _, rps = shard_columns(mesh, cols_np)
    bb = np.array([p.bbox for p in polygons])
    ibox = np.array([[int(nlon.normalize(a)), int(nlon.normalize(c)), int(nlat.normalize(b)),
                      int(nlat.normalize(d))] for a, b, c, d in bb], dtype=np.int32)
    true_n = N - TAIL
    blk, nblk = ref_join.polygon_block_plan(zs, bb, block, rps, SHARDS)
    counts = np.asarray(ref_join.make_block_bbox_count_step(mesh, block)(
        cols["x"], cols["y"], jnp.int32(true_n), jnp.asarray(blk), jnp.asarray(nblk),
        jnp.asarray(ibox)))
    cap = 1 << (max(int(counts.max()), 1) - 1).bit_length()
    pos, hits = ref_join.make_block_bbox_gather_step(mesh, block, cap)(
        cols["x"], cols["y"], jnp.int32(true_n), jnp.asarray(blk), jnp.asarray(nblk),
        jnp.asarray(ibox))
    pos, hits = np.asarray(pos), np.asarray(hits)
    offsets, blocks = join.polygon_block_plan(zs, bb, block, pad_n)
    pair_q = np.repeat(np.arange(len(bb)), np.diff(offsets))
    zero = torch.zeros(pad_n, dtype=torch.int32)
    dev_cols = (torch.from_numpy(cols_np["x"]), torch.from_numpy(cols_np["y"]), zero, zero)
    got_pos, got_hits = block_bbox_gather_step(dev_cols, true_n, pair_q, blocks, ibox)
    per = np.bincount(pair_q, weights=got_hits.numpy(), minlength=len(bb)).astype(np.int64)
    assert np.array_equal(per, counts.sum(axis=0)) and np.array_equal(per, hits.sum(axis=0))
    split = np.split(got_pos.numpy(), np.cumsum(per)[:-1])
    for p in range(len(bb)):
        want = np.concatenate([pos[d, p, :hits[d, p]] for d in range(SHARDS)])
        assert np.array_equal(split[p], want), p  # ascending global positions
    assert per[EMPTY] == 0 and per[WORLD] == true_n  # every live row, none past true_n


@pytest.mark.parametrize("bins,offs", [(0, 0), (-5, -7), (2**31 - 1, 2**31 - 1),
                                       (-2**31, -2**31), (17, -1)])
def test_full_window_matches_every_row(bins, offs):
    """The join's time window takes every (bin, offset) pair, the extremes
    and negative offsets included, so the bbox alone decides."""
    one = torch.tensor([[0]], dtype=torch.int32)
    boxes = torch.tensor([[[0, 0, 0, 0]]], dtype=torch.int32)
    times = torch.from_numpy(FULL_WINDOW.reshape(1, 1, 4).copy())
    m, _ = row_masks(one, one, one * 0 + bins, one * 0 + offs, boxes, times)
    assert m.item()


# -- the store ------------------------------------------------------------------------

STORE_N = 30_000


@pytest.fixture(scope="module")
def stores():
    """The port's device store on the CPU and the reference's on a one-shard
    mesh, over the same GDELT-shaped rows; one point lies exactly on a
    shell vertex and one on a horizontal edge of the test polygons."""
    lon, lat, t = synth_gdelt(STORE_N, seed=42)
    lon[:3] = [-74.0, -73.0, -73.5]
    lat[:3] = [40.0, 40.0, 40.0]  # on box(-74, 40, -73, 41)'s vertices and lower edge
    fids = [f"j.{i}" for i in range(STORE_N)]
    out = []
    for s, mod in ((DataStore(device="cpu"), columnar),
                   (RefDataStore(backend=TpuBackend(mesh=make_mesh(1))), ref_columnar)):
        sft = s.create_schema("j", SPEC)
        s.write("j", mod.FeatureTable.from_columns(sft, fids, {
            "dtg": mod.Column(sft.attr("dtg").type, t.copy()),
            "geom": mod.point_column(lon.copy(), lat.copy())}))
        s.compact("j")
        out.append(s)
    return tuple(out)


def _store_polygons():
    ps = join_polygons(20, seed=9) + [types.box(-74.0, 40.0, -73.0, 41.0)]
    return ps + _special_polygons()[:4] + [None]


@pytest.mark.parametrize("pred", ["within", "intersects"])
def test_join_rows_device_equals_reference(stores, pred):
    port, ref = stores
    geoms = _store_polygons()
    table, got = pjoin.join_rows_device(port, "j", geoms, pred=pred)
    _, want = ref_pjoin.join_rows_device(
        ref, "j", [None if g is None else _ref_poly(g) for g in geoms], pred=pred)
    assert len(table) == STORE_N and [i for i, _ in got] == list(range(len(geoms)))
    for (gi, g_rows), (wi, w_rows) in zip(got, want):
        assert gi == wi and g_rows.dtype == np.int64
        assert np.array_equal(g_rows, w_rows), gi  # the same rows in the same order
    assert sum(len(r) for _, r in got) > 0 and len(got[-1][1]) == 0
    # a small gather budget splits the pairs over several launches, same answer
    _, split = pjoin.join_rows_device(port, "j", geoms, pred=pred, chunk_budget=8192)
    assert all(np.array_equal(a[1], b[1]) for a, b in zip(got, split))


def test_join_rows_device_vertex_and_edge_points(stores):
    port = stores[0]
    box = [types.box(-74.0, 40.0, -73.0, 41.0)]
    _, (( _, within),) = pjoin.join_rows_device(port, "j", box)
    _, ((_, touch),) = pjoin.join_rows_device(port, "j", box, pred="intersects")
    assert not set(within.tolist()) & {0, 1, 2}  # boundary: not within
    assert {0, 1, 2} <= set(touch.tolist())  # but intersecting


def test_join_within_device_and_auto_equal_reference(stores):
    port, ref = stores
    polys = [g for g in _store_polygons() if g is not None and
             not isinstance(g, types.MultiPolygon) and len(g.shell) <= 64]
    ref_polys = [_ref_poly(p) for p in polys]
    got = pjoin.join_within_device(port, "j", polys)
    want = ref_pjoin.join_within_device(ref, "j", ref_polys)
    assert got.dtype == np.int32 and np.array_equal(got, np.asarray(want))
    sparse = polys[:6]
    assert pjoin.measured_pair_density(port, "j", sparse) == ref_pjoin.measured_pair_density(
        ref, "j", [_ref_poly(p) for p in sparse])
    world = [types.box(-180.0, -90.0, 180.0, 90.0)]
    for case in (sparse, world):
        counts, route = pjoin.join_counts_auto(port, "j", case)
        want_counts, want_route = ref_pjoin.join_counts_auto(ref, "j",
                                                             [_ref_poly(p) for p in case])
        assert route == want_route and counts.dtype == np.int64
        assert np.array_equal(counts, want_counts)
    assert pjoin.join_counts_auto(port, "j", sparse)[1] == "block"
    assert pjoin.join_counts_auto(port, "j", world)[1] == "dense"


def test_join_routes_refuse_what_they_cannot_take(stores):
    port = stores[0]
    polys = [types.box(0.0, 0.0, 1.0, 1.0)]
    with pytest.raises(ValueError, match="unsupported predicate"):
        pjoin.join_rows_device(port, "j", polys, pred="contains")
    oracle = DataStore(backend="oracle", device="cpu")
    oracle.create_schema("o", SPEC)
    with pytest.raises(ValueError, match="no z2 device residency"):
        pjoin.join_rows_device(oracle, "o", polys)
    assert pjoin.measured_pair_density(oracle, "o", polys) is None
    counts, route = pjoin.join_counts_auto(oracle, "o", polys)  # empty: dense, zeros
    assert route == "dense" and counts.tolist() == [0]
    aged = DataStore(device="cpu")
    sft = aged.create_schema("a", SPEC + ",geomesa.age.off='86400000'")
    lon, lat, t = synth_gdelt(100, seed=1)
    aged.write("a", columnar.FeatureTable.from_columns(sft, [f"a.{i}" for i in range(100)], {
        "dtg": columnar.Column(sft.attr("dtg").type, t),
        "geom": columnar.point_column(lon, lat)}))
    with pytest.raises(NotImplementedError, match="A.8.2"):
        pjoin.join_rows_device(aged, "a", polys)


def test_join_polygons_match_bench():
    spec = importlib.util.spec_from_file_location("bench_for_port_join", ROOT / "bench.py")
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    rng = np.random.default_rng(5)  # bench.py:660-669
    want = []
    for _ in range(64):
        cx, cy = bench.CITIES[rng.integers(0, len(bench.CITIES))] + rng.normal(0, 4, 2)
        w, h = rng.uniform(0.2, 1.5, 2)
        nv = int(rng.integers(8, 96))
        ang = np.sort(rng.uniform(0, 2 * np.pi, nv))
        rad = rng.uniform(0.3, 1.0, nv)
        ring = np.stack([cx + w * rad * np.cos(ang), cy + h * rad * np.sin(ang)], 1)
        want.append(ref_types.Polygon(ring))
    got = join_polygons(64)
    assert all(np.array_equal(g.shell, w.shell) for g, w in zip(got, want))


# -- the kernel's wrapper ----------------------------------------------------------------


def _join_args(n=2 * POLYGON_PASS_ROWS, k=3, v=16):
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.uniform(-1, 1, n).astype(np.float32))
    y = torch.from_numpy(rng.uniform(-1, 1, n).astype(np.float32))
    verts, bbox, nverts = (torch.from_numpy(a) for a in join.pack_polygons(
        [types.box(-0.5, -0.5, 0.5 + i / 10, 0.5) for i in range(k)], v))
    pairs = (torch.tensor([0, 1, 2, 0], dtype=torch.int32),
             torch.tensor([0, 1, 1, 0], dtype=torch.int32))
    return x, y, pairs, verts, nverts, bbox


def test_polygon_join_plain_pairs_and_dense():
    x, y, (pp, pb), verts, nverts, bbox = _join_args()
    block = POLYGON_PASS_ROWS
    dense = polygon_join(x, y, x.shape[0], None, None, verts, nverts, bbox, block)
    mask = join.points_in_polygons_mask(x, y, verts, bbox)
    assert np.array_equal(dense.numpy(), mask.sum(dim=1).numpy())
    got = polygon_join(x, y, x.shape[0], pp, pb, verts, nverts, bbox, block)
    m = mask.view(3, 2, block).sum(dim=2)  # per polygon and block
    assert got.tolist() == [2 * m[0, 0].item(), m[1, 1].item(), m[2, 1].item()]  # twice listed
    out_of_range = (torch.tensor([5, -1, 0], dtype=torch.int32),
                    torch.tensor([0, 0, 9], dtype=torch.int32))
    assert polygon_join_plain(x, y, x.shape[0], *out_of_range, verts, nverts, bbox,
                              block).tolist() == [0, 0, 0]


def test_polygon_join_rejects_bad_inputs():
    x, y, pairs, verts, nverts, bbox = _join_args()
    block = POLYGON_PASS_ROWS
    ok = (x, y, 100, *pairs, verts, nverts, bbox, block)
    polygon_join(*ok)
    bad = [
        (TypeError, dict(x=x.double())),
        (ValueError, dict(y=y[:-1])),
        (ValueError, dict(block=1000)),
        (ValueError, dict(block=3 * POLYGON_PASS_ROWS)),
        (TypeError, dict(verts=verts.double())),
        (ValueError, dict(verts=verts[:, :, :1])),
        (ValueError, dict(nverts=nverts[:2])),
        (TypeError, dict(bbox=bbox.int())),
        (TypeError, dict(pair_poly=pairs[0].long())),
        (ValueError, dict(pair_blk=pairs[1][:2])),
        (ValueError, dict(pair_blk=None)),
        (ValueError, dict(verts=verts.to("meta"))),
        (ValueError, dict(bbox=torch.zeros((4, 3), dtype=torch.float32).t())),
    ]
    names = ["x", "y", "true_n", "pair_poly", "pair_blk", "verts", "nverts", "bbox", "block"]
    for err, change in bad:
        args = dict(zip(names, ok))
        args.update(change)
        with pytest.raises(err):
            polygon_join(**args)


# -- on the card -------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("block", [4096, 8192])
def test_polygon_join_kernel_matches_plain_on_card(z2_rows, polygons, block):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernel has no CPU mode")
    dev = torch.device("cuda")
    xs, ys, padz, pad_n = _layout(z2_rows, block)
    x, y = torch.from_numpy(xs).to(dev), torch.from_numpy(ys).to(dev)
    for _, verts, bbox, nverts in join.pack_polygons_bucketed(polygons):
        offsets, blocks = join.polygon_block_plan(padz, bbox.astype(np.float64), block, pad_n)
        pairs = join_pairs(offsets, blocks, dev)
        args = (x, y, N - TAIL, *pairs,
                *(torch.from_numpy(a).to(dev) for a in (verts, nverts, bbox)), block)
        got = polygon_join(*args)
        want = polygon_join_plain(*args)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        dense = polygon_join(x, y, N - TAIL, None, None, *args[5:])
        assert torch.equal(dense, polygon_join_plain(x, y, N - TAIL, None, None, *args[5:]))
