"""The ``polygon_join`` kernel's y-band edge lists, held to the reference.

The card's kernel tests a row inside a polygon's bbox only against the
edges listed in its y-band (``csrc/polygon_join.cu``). Its plain versions
in ``ops/kernels.py`` (``polygon_band_count``, ``band_grid``,
``band_index``, ``polygon_bands_plain``) build the same lists with the same
f32 steps; a walk here tests each row against its band's edges alone, with
the reference's crossing arithmetic, and must give geomesa_tpu's
``_membership`` (``ops/join.py:56``) and ``points_in_polygons_count``
(``:77``) and the port's ``crossing_parity`` bit for bit. The cases: rows
on band boundaries (a band's first f32 and the ulps around it), on every
vertex y and on horizontal edges; horizontal edges and edges with a NaN y;
vertices outside the bbox given; a zero-height bbox; rings of 8, 95 and 512
vertices; 1 to 64 bands. Every straddling (row, edge) pair must also lie in
the row's band. ``polygon_join_work``'s counts are held to brute force.

Tolerance: none. Counts, masks and band memberships are equal.
"""

import pathlib
import re

import numpy as np
import pytest
import torch

import geomesa_tpu  # noqa: F401  (x64 on)
import jax.numpy as jnp
from geomesa_tpu.ops import join as ref_join

from geomesa_tpu_torch.ops import kernels
from geomesa_tpu_torch.ops.kernels import (
    band_grid, band_index, crossing_parity, polygon_band_count, polygon_bands_plain,
    polygon_join_work)
from geomesa_tpu_torch.workload import star_ring

CSRC = pathlib.Path(kernels.__file__).resolve().parent.parent / "csrc" / "polygon_join.cu"
RING_SIZES = (8, 95, 512)
BANDS = (1, 2, 3, 5, 8, 16, 31, 32, 48, 64, None)  # None: the kernel's own count


def _boundaries(bbox: np.ndarray, nb: int) -> np.ndarray:
    """f32 values of y around each band boundary of ``bbox``: the first y
    of every band (found by a search over f32 ulps) and two ulps either
    side of it."""
    bands, inv = band_grid(torch.from_numpy(bbox), torch.tensor(nb))
    ymin = torch.tensor(bbox[1])
    out = []
    for j in range(1, int(bands)):
        lo, hi = np.float32(bbox[1]), np.float32(bbox[3])
        while np.nextafter(lo, hi) < hi:  # the least f32 y with j(y) >= j
            mid = np.float32(lo + (hi - lo) / 2)
            if mid <= lo or mid >= hi:
                mid = np.nextafter(lo, hi)
            if int(band_index(torch.tensor(mid), ymin, inv, bands)) >= j:
                hi = mid
            else:
                lo = mid
        v = hi
        out += [v, np.nextafter(v, -np.inf), np.nextafter(np.nextafter(v, -np.inf), -np.inf),
                np.nextafter(v, np.inf), np.nextafter(np.nextafter(v, np.inf), np.inf)]
    return np.array(out, dtype=np.float32)


def _rows(rng, ring: np.ndarray, bbox: np.ndarray, nb_list) -> tuple[np.ndarray, np.ndarray]:
    """Rows inside and around ``bbox``: uniform ones, every vertex y (some
    on the vertex itself), the bbox's edges, band boundaries of every band
    count in ``nb_list``, and a few NaN rows."""
    x0, y0, x1, y1 = (float(v) for v in bbox)
    dx, dy = max(x1 - x0, 1e-3), max(y1 - y0, 1e-3)
    n = 3000
    xs = [rng.uniform(x0 - 0.1 * dx, x1 + 0.1 * dx, n)]
    ys = [rng.uniform(y0 - 0.1 * dy, y1 + 0.1 * dy, n)]
    vy = ring[np.isfinite(ring[:, 1]), 1]
    for rep in range(3):
        xs.append(rng.uniform(x0, x1, len(vy)))
        ys.append(vy)
    fin = ring[np.isfinite(ring).all(axis=1)]
    xs.append(fin[:, 0])
    ys.append(fin[:, 1])
    xs.append(rng.uniform(x0, x1, 64))
    ys.append(np.repeat(np.array([y0, y1], np.float32), 32))
    for nb in nb_list:
        b = _boundaries(bbox, polygon_band_count(len(ring)) if nb is None else nb)
        for rep in range(2):
            xs.append(rng.uniform(x0, x1, len(b)))
            ys.append(b)
    xs.append(np.array([np.nan, x0, np.nan], np.float32))
    ys.append(np.array([y0, np.nan, np.nan], np.float32))
    return (np.concatenate(xs).astype(np.float32), np.concatenate(ys).astype(np.float32))


def _case(kind: str, nv: int):
    """(ring, bbox) of a test case: ``star`` (its own bbox), ``flat`` (many
    horizontal edges), ``nan`` (a vertex with a NaN y and one with a NaN
    x), ``inner`` (a bbox inside the ring's: vertices outside it) and
    ``zero`` (a zero-height bbox through the ring)."""
    rng = np.random.default_rng(nv * 7 + len(kind))
    ring = star_ring(rng, nv, 10.0, -20.0, 1.3, 0.8, levels=6 if kind == "flat" else 0)
    if kind == "nan":
        ring[nv // 3, 1] = np.nan
        ring[nv // 2, 0] = np.nan
    fin = ring[np.isfinite(ring).all(axis=1)]
    bbox = np.array([fin[:, 0].min(), fin[:, 1].min(), fin[:, 0].max(), fin[:, 1].max()],
                    np.float32)
    if kind == "inner":
        bbox = np.array([9.5, -20.4, 10.6, -19.7], np.float32)
    if kind == "zero":
        bbox = np.array([bbox[0], -20.1, bbox[2], -20.1], np.float32)
    return ring, bbox


CASES = [(kind, nv) for nv in RING_SIZES for kind in ("star", "flat", "nan", "inner", "zero")]


def _walk(xs, ys, ring, bbox, nb):
    """Each row inside ``bbox`` tested against its band's edges only, with
    the reference's f32 crossing arithmetic: (R,) bool."""
    bands, inv, offsets, edges = polygon_bands_plain(ring, bbox, nb)
    in_bb = (xs >= bbox[0]) & (xs <= bbox[2]) & (ys >= bbox[1]) & (ys <= bbox[3])
    j = band_index(ys, bbox[1], inv, torch.tensor(bands))
    out = torch.zeros(xs.shape[0], dtype=torch.bool)
    for b in range(bands):
        sel = in_bb & (j == b)
        es = edges[offsets[b]:offsets[b + 1]]
        if es.shape[0] == 0 or not bool(sel.any()):
            continue
        x1, y1 = ring[es, 0][:, None], ring[es, 1][:, None]
        x2, y2 = ring[es + 1, 0][:, None], ring[es + 1, 1][:, None]
        xc, yc = xs[sel][None, :], ys[sel][None, :]
        straddle = (y1 > yc) != (y2 > yc)
        xint = x1 + (yc - y1) * (x2 - x1) / (y2 - y1)  # a listed edge has y1 != y2
        out[sel] = ((straddle & (xc < xint)).sum(dim=0) % 2).bool()
    return out


_REF: dict = {}


def _reference(kind: str, nv: int):
    """The case's rows and the reference's membership of each."""
    if (kind, nv) not in _REF:
        ring, bbox = _case(kind, nv)
        xs, ys = _rows(np.random.default_rng(nv), ring, bbox, BANDS)
        want = np.asarray(ref_join._membership(jnp.asarray(xs), jnp.asarray(ys),
                                               jnp.asarray(ring), jnp.asarray(bbox)))
        _REF[kind, nv] = (ring, bbox, xs, ys, want)
    return _REF[kind, nv]


@pytest.mark.parametrize("kind,nv", CASES)
def test_band_walk_equals_reference_membership(kind, nv):
    ring, bbox, xs, ys, want = _reference(kind, nv)
    tr, tb, tx, ty = (torch.from_numpy(a) for a in (ring, bbox, xs, ys))
    in_bb = (tx >= tb[0]) & (tx <= tb[2]) & (ty >= tb[1]) & (ty <= tb[3])
    assert np.array_equal((crossing_parity(tx, ty, tr) & in_bb).numpy(), want)
    assert want.sum() > 0 or kind == "zero"
    for nb in BANDS:
        assert np.array_equal(_walk(tx, ty, tr, tb, nb).numpy(), want), nb


@pytest.mark.parametrize("kind,nv", CASES)
def test_every_straddling_edge_is_in_its_rows_band(kind, nv):
    ring, bbox, xs, ys, _ = _reference(kind, nv)
    tr, tb, tx, ty = (torch.from_numpy(a) for a in (ring, bbox, xs, ys))
    in_bb = (tx >= tb[0]) & (tx <= tb[2]) & (ty >= tb[1]) & (ty <= tb[3])
    yc = ty[in_bb][:, None]
    # an edge with a NaN y may straddle by the reference's booleans, but its
    # xint is NaN and it never crosses: the bands leave it out
    straddle = ((tr[:-1, 1][None, :] > yc) != (tr[1:, 1][None, :] > yc)) & (
        ~tr[:-1, 1].isnan() & ~tr[1:, 1].isnan())[None, :]
    lo = torch.minimum(tr[:-1, 1], tr[1:, 1])
    hi = torch.maximum(tr[:-1, 1], tr[1:, 1])
    degenerate = not (np.isfinite(bbox[3] - bbox[1]) and bbox[3] - bbox[1] > 0)
    for nb in BANDS:
        bands, inv, offsets, edges = polygon_bands_plain(tr, tb, nb)
        asked = polygon_band_count(nv) if nb is None else nb
        assert bands == (1 if degenerate else asked)
        member = torch.zeros((bands, nv - 1), dtype=torch.bool)
        for b in range(bands):
            member[b, edges[offsets[b]:offsets[b + 1]]] = True
        j = band_index(ty[in_bb], tb[1], inv, torch.tensor(bands))
        assert bool(member[j][straddle].all()), nb
        assert not bool(member[:, ~(lo < hi)].any())  # horizontal and NaN edges: in no band
        if nb is None:
            assert bands * (nv - 1) <= max(kernels.POLYGON_BAND_CAP, nv - 1)


@pytest.mark.parametrize("nv", RING_SIZES)
def test_band_walk_counts_equal_reference_count(nv):
    """K polygons of one vertex bucket, padded as ``pack_polygons`` pads:
    the band walk's counts equal ``points_in_polygons_count``'s."""
    rng = np.random.default_rng(nv + 1)
    rings = [star_ring(rng, int(rng.integers(max(4, nv // 2), nv + 1)), 0.0, 0.0, 1.0, 1.0,
                   levels=6 if i % 3 == 0 else 0) for i in range(6)]
    verts = np.zeros((len(rings), nv, 2), np.float32)
    nverts = np.zeros(len(rings), np.int32)
    bbox = np.zeros((len(rings), 4), np.float32)
    for i, r in enumerate(rings):
        verts[i, :len(r)] = r
        verts[i, len(r):] = r[-1]
        nverts[i] = len(r)
        bbox[i] = [r[:, 0].min(), r[:, 1].min(), r[:, 0].max(), r[:, 1].max()]
    xs = rng.uniform(-1.1, 1.1, 20000).astype(np.float32)
    ys = rng.uniform(-1.1, 1.1, 20000).astype(np.float32)
    ys[:2000] = np.resize(verts[:, :, 1].ravel(), 2000)
    want = np.asarray(ref_join.points_in_polygons_count(jnp.asarray(xs), jnp.asarray(ys),
                                                        jnp.asarray(verts), jnp.asarray(bbox)))
    tx, ty = torch.from_numpy(xs), torch.from_numpy(ys)
    for nb in (None, 1, 7, 64):
        got = [int(_walk(tx, ty, torch.from_numpy(verts[i, :nverts[i]]),
                         torch.from_numpy(bbox[i]), nb).sum()) for i in range(len(rings))]
        assert got == want.tolist()
        # any vertex count from the real one to V gives the same walk
        got_v = [int(_walk(tx, ty, torch.from_numpy(verts[i]), torch.from_numpy(bbox[i]),
                           nb).sum()) for i in range(len(rings))]
        assert got_v == want.tolist()


def test_band_count_and_grid():
    assert [polygon_band_count(nv) for nv in (0, 1, 2, 3, 4, 8, 9, 16, 95, 96, 128, 129, 256,
                                              512)] == [1, 1, 1, 1, 2, 4, 4, 8, 32, 32, 64, 64,
                                                        64, 32]
    for nv in range(1, kernels.POLYGON_MAX_VERTS + 1):
        nb = polygon_band_count(nv)
        assert 1 <= nb <= kernels.POLYGON_MAX_BANDS and nb & (nb - 1) == 0
        assert nb * (nv - 1) <= kernels.POLYGON_BAND_CAP
    nb = torch.tensor([8, 8, 8, 8, 8, 1])
    bbox = torch.tensor([[0, 1, 1, 3], [0, 2, 1, 2], [0, 3, 1, 2], [0, float("nan"), 1, 2],
                         [0, -3e38, 1, 3e38], [0, 0, 1, 1]], dtype=torch.float32)
    bands, inv = band_grid(bbox, nb)
    assert bands.tolist() == [8, 1, 1, 1, 1, 1] and inv.tolist() == [4.0, 0, 0, 0, 0, 0]
    bands, inv = band_grid(torch.tensor([0, 0, 1, 1e-45], dtype=torch.float32), torch.tensor(8))
    assert int(bands) == 1  # 8 / 1e-45 overflows: one band
    ys = torch.tensor([-1.0, 1.0, 1.25, 1.4999, 1.5, 3.0, 9.0, float("inf"), float("-inf")])
    assert band_index(ys, torch.tensor(1.0), torch.tensor(4.0), torch.tensor(8)).tolist() == [
        0, 0, 1, 1, 2, 7, 7, 7, 0]
    assert band_index(ys, torch.tensor(1.0), torch.tensor(0.0), torch.tensor(1)).tolist() == \
        [0] * 9


def test_constants_match_the_kernel_source():
    src = CSRC.read_text()
    for name, value in (("GROUP", kernels.POLYGON_GROUP_ROWS), ("PASS", kernels.POLYGON_PASS_ROWS),
                        ("TILE", kernels.POLYGON_TILE_ROWS), ("RUN", kernels.POLYGON_RUN),
                        ("MAX_VERTS", kernels.POLYGON_MAX_VERTS),
                        ("MAX_BANDS", kernels.POLYGON_MAX_BANDS),
                        ("BAND_CAP", kernels.POLYGON_BAND_CAP),
                        ("BUCKETS", kernels.POLYGON_BUCKETS)):
        m = re.search(rf"constexpr int {name} = (\d+);", src)
        assert m is not None and int(m.group(1)) == value, name


@pytest.mark.parametrize("dense", [False, True])
def test_polygon_join_work_counts(dense):
    """``polygon_join_work`` against a brute force over the same pairs."""
    rng = np.random.default_rng(3)
    block, n = 2048, 4 * 2048
    x = torch.from_numpy(rng.uniform(-2, 2, n).astype(np.float32))
    y = torch.from_numpy(rng.uniform(-2, 2, n).astype(np.float32))
    x[5], y[7] = float("nan"), float("nan")
    rings = [star_ring(rng, nv, 0.5 * i - 0.5, 0.0, 0.8, 0.9, levels=4 * (i == 1))
             for i, nv in enumerate((8, 20, 33))]
    v = 33
    verts = torch.zeros((3, v, 2), dtype=torch.float32)
    nverts = torch.tensor([len(r) for r in rings], dtype=torch.int32)
    for i, r in enumerate(rings):
        verts[i, :len(r)] = torch.from_numpy(r)
        verts[i, len(r):] = torch.from_numpy(r[-1])
    bbox = torch.stack([torch.tensor([r[:, 0].min(), r[:, 1].min(), r[:, 0].max(),
                                      r[:, 1].max()]) for r in rings])
    true_n = n - 100
    if dense:
        pp = pb = None
        pairs = [(p, b) for p in range(3) for b in range(4)]
    else:
        pairs = [(0, 1), (2, 3), (1, 0), (1, 0), (0, 3), (5, 1), (2, -1), (1, 2)]
        pp = torch.tensor([p for p, _ in pairs], dtype=torch.int32)
        pb = torch.tensor([b for _, b in pairs], dtype=torch.int32)
        pairs = pairs[:5] + pairs[7:]
    w = polygon_join_work(x, y, true_n, pp, pb, verts, nverts, bbox, block, nbs=(None, 1, 4),
                          chunk=3)
    in_rows = straddles = edge_tests = warps = met = met_rows = 0
    for p, b in pairs:
        rows = torch.arange(b * block, (b + 1) * block)
        bx, by, bb = x[rows], y[rows], bbox[p]
        inside = (rows < true_n) & (bx >= bb[0]) & (bx <= bb[2]) & (by >= bb[1]) & (by <= bb[3])
        in_rows += int(inside.sum())
        warps += int(inside.view(-1, 128).any(dim=1).sum())
        ring = verts[p, :nverts[p]]
        yc = by[inside][:, None]
        straddles += int(((ring[:-1, 1][None] > yc) != (ring[1:, 1][None] > yc)).sum())
        edge_tests += int(inside.sum()) * (int(nverts[p]) - 1)
        # the tile as the kernel stages it: live rows with a y by bucket, NaN padding
        live = ((rows < true_n) & ~by.isnan()).numpy()
        ylo, yhi = by.numpy()[live].min(), by.numpy()[live].max()
        scale = np.float32(kernels.POLYGON_BUCKETS) / (yhi - ylo)
        bucket = np.nan_to_num(np.clip((by.numpy() - ylo) * scale, 0,
                                       kernels.POLYGON_BUCKETS - 1)).astype(int)
        order = np.argsort(np.where(live, bucket, kernels.POLYGON_BUCKETS), kind="stable")
        sx = np.where(live[order], bx.numpy()[order], np.nan)
        sy = np.where(live[order], by.numpy()[order], np.nan)
        b0, b1, b2, b3 = (float(v) for v in bb)
        for g in range(block // 128):
            gx, gy = sx[g * 128:(g + 1) * 128], sy[g * 128:(g + 1) * 128]
            fx, fy = gx[~np.isnan(gx)], gy[~np.isnan(gy)]
            if len(fx) and fx.max() >= b0 and fx.min() <= b2 and fy.max() >= b1 and \
                    fy.min() <= b3:
                met += 1
                met_rows += int(((gx >= b0) & (gx <= b2) & (gy >= b1) & (gy <= b3)).sum())
    assert w["pairs"] == len(pairs) and w["in_rows"] == in_rows and w["warps_any"] == warps
    assert w["straddles"] == straddles and w["edge_tests"] == edge_tests
    assert w["groups"] == len(pairs) * block // 128 and w["groups_met"] == met
    assert met_rows == in_rows  # a skipped group holds no row inside the bbox
    assert w["candidates"][0] >= straddles and w["candidates"][2] >= straddles
    assert w["candidates"][1] == sum(
        int(((bbox[p, 0] <= x[b * block:(b + 1) * block])
             & (x[b * block:(b + 1) * block] <= bbox[p, 2])
             & (bbox[p, 1] <= y[b * block:(b + 1) * block])
             & (y[b * block:(b + 1) * block] <= bbox[p, 3])
             & (torch.arange(b * block, (b + 1) * block) < true_n)).sum())
        * int((verts[p, 1:nverts[p], 1] != verts[p, :nverts[p] - 1, 1]).sum())
        for p, b in pairs)
    assert (w["items"], w["stages"]) == ((4, 4) if dense else (1, 5))

