"""Bench config 10's trajectory plane: the port's corridor engine and
interlink against geomesa_tpu on the same seeded inputs, on the CPU (the
port's plain versions). It mirrors the reference's ``TestCorridor`` and
``TestInterlink`` (``tests/test_trajectory.py:344-590``).

- ``corridor_step`` against ``make_corridor_step`` in its four variants on
  rows placed on segments' buffer distances, on their end points and on
  zero-length segments, with NaN, infinite and null headings, padded
  segments and the unconstrained quad: the (cand, sure) masks equal;
- the gather form's plain version (``corridor_masks_gather_plain``: a
  point state's int32 columns read through positions and dequantized by
  ``corridor_dequantize``) equal to the row form's word for word on the
  same dequantized coordinates, across the variants, the tiling cases and
  the sentinels, and its unpacked masks against ``make_corridor_step``;
  the dequantization within a cell across the lon/lat range; the mask
  words' packing, unpacking and bit extraction; the kernel's reach-box
  skip exact on the plain version;
- ``corridor_masks_f64`` and ``_pack`` equal the reference's;
- ``tube_select_many`` (routes device and host), ``tube_select_device`` and
  ``route_search_device`` with the same fid sets as the reference's corridor
  engine and its host ``tube_select`` / ``route_search``, on seeded tracks
  stores; the heading legs with NaN and null headings, a mixed uni- and
  bidirectional batch (two launches) and a batch equal to its singles;
  empty candidates; ``prune_filter``'s candidate fid set; the device
  route over resident candidates (the gather form) on z3 and date-less z2
  stores with and without a caller filter, its exact residual only over
  the matched rows, and the row form's route on Oracle and line stores;
- ``interlink`` pair lists equal to the reference's and to
  ``interlink_referee`` for ``intersects`` and ``dwithin``, 2D and
  time-lifted, routes ``xz`` and ``block``; the forced block route refusing
  a time buffer and a right filter; an unsupported predicate raising;
- ``representative_xy`` on points and line strings; ``auths=`` raising
  ``NotImplementedError``; bench config 10's generators equal to
  ``bench.py``'s draws.

Tolerance: fid sets, pair lists, mask words and f64 masks compare exactly;
the dequantized coordinates within one 31-bit cell. The f32
band masks compare exactly too, except that where XLA's CPU fusion rounds
the reference's distance otherwise (an FMA; ROADMAP.md C's KNN note) a row
may differ only within 1e-4 degrees of the band's threshold; the masks
refined in f64 are equal exactly either way.
"""

import importlib.util

import numpy as np
import pytest
import torch

import geomesa_tpu  # noqa: F401  (x64 on)
import jax.numpy as jnp
from geomesa_tpu.geometry.types import Point as RefPoint, Polygon as RefPolygon
from geomesa_tpu.parallel.query import make_corridor_step
from geomesa_tpu.planning.planner import Query as RefQuery
from geomesa_tpu.process.processes import tube_select as ref_tube_select
from geomesa_tpu.process.tracks import route_search as ref_route_search
from geomesa_tpu.schema.sft import parse_spec as ref_parse_spec
from geomesa_tpu.store.datastore import DataStore as RefDataStore
from geomesa_tpu.trajectory import corridor as ref_corridor
from geomesa_tpu.trajectory.interlink import interlink as ref_interlink

from geomesa_tpu_torch.geometry.types import LineString, Point, Polygon
from geomesa_tpu_torch.ops import kernels
from geomesa_tpu_torch.parallel.query import corridor_step
from geomesa_tpu_torch.planning.planner import Query
from geomesa_tpu_torch.process.processes import tube_select
from geomesa_tpu_torch.process.tracks import route_search
from geomesa_tpu_torch.schema.columnar import FeatureTable, representative_xy
from geomesa_tpu_torch.schema.sft import parse_spec
from geomesa_tpu_torch.store.datastore import DataStore
from geomesa_tpu_torch.trajectory import corridor
from geomesa_tpu_torch.trajectory.corridor import (
    CorridorSpec, route_search_device, tube_select_device, tube_select_many)
from geomesa_tpu_torch.trajectory.interlink import interlink, interlink_referee
from geomesa_tpu_torch.workload import link_points, trajectory_workload

T0 = 1_600_000_000_000
BAND_TOL_DEG = 1e-4  # where the reference's fused f32 distance may round otherwise


def _records(n, n_tracks, seed, heading):
    rng = np.random.default_rng(seed)
    recs = []
    for i in range(n):
        rec = {"track": f"t{i % n_tracks}", "dtg": T0 + i * 60_000,
               "xy": (float(rng.uniform(-12, 12)), float(rng.uniform(-6, 6)))}
        if heading:
            rec["heading"] = None if i % 13 == 0 else float(rng.uniform(0, 360))
        recs.append(rec)
    return recs


def _track_stores(n=400, n_tracks=16, seed=7, heading=True, name="trk"):
    """The reference test's ``_track_store`` in both packages, from the
    same records and fids."""
    spec = "track:String,dtg:Date,*geom:Point:srid=4326"
    if heading:
        spec = "track:String,heading:Double,dtg:Date,*geom:Point:srid=4326"
    recs = _records(n, n_tracks, seed, heading)
    fids = [f"{name}.{i}" for i in range(n)]
    ds = DataStore(device="cpu")
    ds.create_schema(name, spec)
    ds.write(name, [{**{k: v for k, v in r.items() if k != "xy"}, "geom": Point(*r["xy"])}
                    for r in recs], fids=fids)
    ref = RefDataStore(backend="tpu")
    ref.create_schema(name, spec)
    ref.write(name, [{**{k: v for k, v in r.items() if k != "xy"}, "geom": RefPoint(*r["xy"])}
                     for r in recs], fids=fids)
    ref.compact(name)
    return ds, ref


def _fids(table):
    return sorted(str(f) for f in table.fids)


# -- corridor_step against make_corridor_step ------------------------------------

def _corridor_inputs(seed: int, heading: bool, bidirectional: bool):
    """Specs and rows around them: rows scattered near the corridors, rows
    on a segment's buffer distance (both sides of each band), on end
    points and on a zero-length segment; headings NaN, infinite, negative
    and past 360; times at a quad's edges and outside. Returns the port's
    specs, the reference's, and (xs, ys, tms, hdg) f64 arrays."""
    rng = np.random.default_rng(seed)
    specs, ref_specs = [], []
    for qi in range(7):
        npts = 2 + qi % 3
        pts = [(float(x), float(y)) for x, y in zip(np.sort(rng.uniform(-8, 8, npts)),
                                                    rng.uniform(-4, 4, npts))]
        if qi == 2:
            pts[1] = pts[0]  # a zero-length segment
        buf = float(rng.uniform(0.3, 1.5))
        tol = None if (not heading or qi == 4) else float(rng.uniform(10, 80))
        bidir = bidirectional and tol is not None  # one variant a launch
        if qi % 2:  # timed
            ts = [T0 + int(v) for v in np.sort(rng.integers(0, 86_400_000 * 3, npts))]
            tb = int(rng.integers(1, 10)) * 3_600_000
            args = ([(x, y, t) for (x, y), t in zip(pts, ts)], buf, tb)
            specs.append(CorridorSpec.tube(*args))
            ref_specs.append(ref_corridor.CorridorSpec.tube(*args))
            if tol is not None:  # a timed corridor with a heading constraint
                specs[-1] = CorridorSpec(specs[-1].pts, specs[-1].ts, buf, tb, tol, bidir)
                ref_specs[-1] = ref_corridor.CorridorSpec(ref_specs[-1].pts, ref_specs[-1].ts,
                                                          buf, tb, tol, bidir)
        else:
            specs.append(CorridorSpec.route(pts, buf, tol, bidir))
            ref_specs.append(ref_corridor.CorridorSpec.route(pts, buf, tol, bidir))
    xs, ys = [], []
    for spec in specs:
        x1, y1, x2, y2, _, _ = spec.segments()
        for k in range(len(x1)):
            dx, dy = x2[k] - x1[k], y2[k] - y1[k]
            norm = np.hypot(dx, dy) or 1.0
            nx, ny = -dy / norm, dx / norm
            for u in (0.0, 0.3, 0.5, 1.0):
                px, py = x1[k] + u * dx, y1[k] + u * dy
                for off in (spec.buffer_deg, -spec.buffer_deg, spec.buffer_deg + 2e-3,
                            spec.buffer_deg - 2e-3, spec.buffer_deg + 1e-7, 0.0):
                    xs.append(px + off * nx)
                    ys.append(py + off * ny)
            xs.append(x2[k] + spec.buffer_deg)  # beyond an end point, on the buffer
            ys.append(y2[k])
    m = len(xs)
    xs = np.concatenate([xs, rng.uniform(-10, 10, 3000)])
    ys = np.concatenate([ys, rng.uniform(-6, 6, 3000)])
    n = len(xs)
    tms = T0 + rng.integers(-86_400_000, 86_400_000 * 4, n)
    tms[:m:7] = T0  # the first waypoint's time
    hdg = rng.uniform(-720, 720, n)
    hdg[::11] = np.nan
    hdg[5::17] = np.inf
    hdg[7::19] = -np.inf
    with np.errstate(invalid="ignore"):
        hdg = hdg % 360.0  # NaN stays NaN; infinities become NaN, as the engine reads them
    return specs, ref_specs, (xs, ys, tms.astype(np.int64), hdg)


SFT_SPEC = "heading:Double,dtg:Date,*geom:Point:srid=4326"


@pytest.mark.parametrize("heading,bidirectional",
                         [(False, False), (True, False), (True, True), (False, True)])
def test_corridor_step_equals_jax(heading, bidirectional):
    """(cand, sure) of the port's step equal the reference's
    ``make_corridor_step`` on the same packed payloads; a differing row is
    one within ``BAND_TOL_DEG`` of its band threshold, and the masks refined
    in f64 equal exactly."""
    specs, ref_specs, (xs, ys, tms, hdg) = _corridor_inputs(3 + heading + 2 * bidirectional,
                                                            heading, bidirectional)
    sft, ref_sft = parse_spec("c", SFT_SPEC), ref_parse_spec("c", SFT_SPEC)
    segs, tq, brg, *bands = corridor._pack(specs, sft)
    rp = ref_corridor._pack(ref_specs, ref_sft)
    q, s = segs.shape[:2]
    np.testing.assert_array_equal(segs, rp[0][:q, :s])
    np.testing.assert_array_equal(tq, rp[1][:q, :s])
    np.testing.assert_array_equal(brg, rp[2][:q, :s])
    for b, rb in zip(bands, rp[3:7]):
        np.testing.assert_array_equal(b, rb[:q])
    from geomesa_tpu_torch.curve.binned_time import BinnedTime

    bins, offs = BinnedTime(sft.z3_interval).to_bin_and_offset(tms)
    rows = [xs.astype(np.float32), ys.astype(np.float32), bins.astype(np.int32),
            offs.astype(np.int32), hdg.astype(np.float32)]
    cand, sure = corridor_step(*(torch.from_numpy(np.ascontiguousarray(a)) for a in rows),
                               *(torch.from_numpy(a) for a in (segs, tq, brg, *bands)),
                               heading, bidirectional)
    rcand, rsure = make_corridor_step(heading, bidirectional)(
        *(jnp.asarray(a) for a in rows), *(jnp.asarray(a) for a in rp[:7]))
    rcand, rsure = np.asarray(rcand)[:q], np.asarray(rsure)[:q]
    assert cand.dtype == torch.int32 and cand.shape == (q, (len(xs) + 31) // 32)
    cand, sure = (kernels.unpack_mask_words(w, len(xs)).numpy() for w in (cand, sure))
    _assert_bands_match(cand, sure, rcand, rsure, specs, bands, (xs, ys), (xs, ys, tms, hdg))


def _assert_bands_match(cand, sure, rcand, rsure, specs, bands, seen, exact_rows):
    """The port's unpacked band masks against the reference step's on the
    same f32 inputs: a differing row lies within ``BAND_TOL_DEG`` of its
    band's threshold (``seen``: the coordinates both steps were fed), and
    both refine in f64 (from ``exact_rows``' coordinates, times and
    headings) to ``corridor_masks_f64``'s masks exactly."""
    xs, ys = seen
    q = len(specs)
    assert cand.sum() > 50 and sure.sum() > 50 and (cand & ~sure).sum() > 0
    assert not (sure & ~cand).any()
    for got, want, band in ((cand, rcand, 1), (sure, rsure, 0)):
        for qi, r in zip(*np.nonzero(got != want)):
            spec = specs[qi]
            thr = np.sqrt(bands[band][qi])
            x1, y1, x2, y2, _, _ = spec.segments()
            d = np.array([_seg_dist(xs[r], ys[r], x1[k], y1[k], x2[k], y2[k])
                          for k in range(len(x1))])
            assert np.min(np.abs(d - thr)) < BAND_TOL_DEG, (qi, r)

    ex, ey, tms, hdg = exact_rows

    def refine(c, s_):
        out = s_.copy()
        for qi in range(q):
            band_rows = np.nonzero(c[qi] & ~s_[qi])[0]
            out[qi, band_rows] |= corridor.corridor_masks_f64(
                ex[band_rows], ey[band_rows], tms[band_rows], hdg[band_rows], [specs[qi]])[0]
        return out

    exact = corridor.corridor_masks_f64(ex, ey, tms, hdg, specs)
    np.testing.assert_array_equal(refine(cand, sure), exact)
    np.testing.assert_array_equal(refine(rcand, rsure), exact)


def _seg_dist(px, py, x1, y1, x2, y2):
    dx, dy = x2 - x1, y2 - y1
    len2 = dx * dx + dy * dy
    t = 0.0 if len2 == 0 else min(max(((px - x1) * dx + (py - y1) * dy) / len2, 0.0), 1.0)
    return np.hypot(px - (x1 + t * dx), py - (y1 + t * dy))


def test_corridor_masks_plain_takes_its_sentinels():
    """A padded corridor (negative buf2) and padded segments (the
    unsatisfiable quad) pass no row; the unconstrained quad passes every
    row of a date-less store; a tolerance of 360 or more accepts NaN
    headings."""
    xs = torch.tensor([0.0, 0.1, 5.0], dtype=torch.float32)
    ys = torch.zeros(3, dtype=torch.float32)
    zeros = torch.zeros(3, dtype=torch.int32)
    hdg = torch.tensor([float("nan"), 90.0, 90.0])
    segs = torch.tensor([[[-1.0, 0.0, 1.0, 0.0], [-1.0, 0.0, 1.0, 0.0]],
                         [[-1.0, 0.0, 1.0, 0.0], [0.0, 0.0, 0.0, 0.0]]])
    unc = [0, -1, 2**31 - 1, 2**31 - 1]
    tq = torch.tensor([[unc, [1, 0, 0, -1]], [unc, [1, 0, 0, -1]]], dtype=torch.int32)
    brg = torch.full((2, 2), 90.0)
    lo = torch.tensor([0.04, -1.0])
    hi = torch.tensor([0.05, -1.0])
    tol = torch.tensor([999.0, 999.0])
    cand, sure = (kernels.unpack_mask_words(w, 3) for w in kernels.corridor_masks(
        xs, ys, zeros, zeros, hdg, segs, tq, brg, lo, hi, tol, tol, True, False))
    assert cand.tolist() == [[True, True, False], [False, False, False]]
    assert sure.tolist() == cand.tolist()
    tol = torch.tensor([45.0, 999.0])
    words, _ = kernels.corridor_masks(xs, ys, zeros, zeros, hdg, segs, tq, brg, hi, hi, tol,
                                      tol, True, False)
    assert words.tolist() == [[0b010], [0]]  # NaN fails a real tolerance; one word a corridor
    with pytest.raises(TypeError):
        kernels.corridor_masks(xs.double(), ys, zeros, zeros, hdg, segs, tq, brg, lo, hi, tol,
                               tol, True, False)


def test_corridor_masks_f64_equals_reference():
    specs, ref_specs, (xs, ys, tms, hdg) = _corridor_inputs(11, True, True)
    got = corridor.corridor_masks_f64(xs, ys, tms, hdg, specs)
    want = ref_corridor.corridor_masks_f64(xs, ys, tms, hdg, ref_specs)
    np.testing.assert_array_equal(got, want)
    assert got.sum() > 100
    assert corridor.DIST_SLACK_DEG == ref_corridor.DIST_SLACK_DEG
    assert corridor.HEADING_SLACK_DEG == ref_corridor.HEADING_SLACK_DEG


def _resident_case(xs, ys, tms, hdg, sft, seed, extra=257):
    """Resident int32 columns holding the rows (normalized at 31 bits, as
    a point state stages them) among ``extra`` other rows, in a shuffled
    order, and each row's position: candidate i is row i. Returns the
    (x, y, bins, offs) tensors, the int32 positions, the f32 headings and
    the (f64) coordinates the gather form dequantizes to."""
    from geomesa_tpu_torch.curve.binned_time import BinnedTime
    from geomesa_tpu_torch.curve.normalize import lat, lon

    rng = np.random.default_rng(seed)
    n = len(xs)
    allx = np.concatenate([xs, rng.uniform(-180, 180, extra)])
    ally = np.concatenate([ys, rng.uniform(-90, 90, extra)])
    allt = np.concatenate([tms, T0 + rng.integers(0, 86_400_000, extra)])
    order = rng.permutation(n + extra)  # resident position -> row
    cols = [lon(31).normalize(allx[order]), lat(31).normalize(ally[order]),
            *BinnedTime(sft.z3_interval).to_bin_and_offset(allt[order])]
    cols = [torch.from_numpy(np.ascontiguousarray(c, dtype=np.int32)) for c in cols]
    pos = torch.from_numpy(np.argsort(order)[:n].astype(np.int32))
    dx, dy = kernels.corridor_dequantize(cols[0][pos.long()], cols[1][pos.long()],
                                         torch.float64)
    return cols, pos, torch.from_numpy(hdg.astype(np.float32)), (dx.numpy(), dy.numpy())


def _row_form_of(cols, pos, hdg):
    """The row form's inputs for the gather form's candidates: the same
    dequantized f32 coordinates, (bin, offset) and headings."""
    p = pos.long()
    cx, cy = kernels.corridor_dequantize(cols[0][p], cols[1][p])
    return cx, cy, cols[2][p].contiguous(), cols[3][p].contiguous(), hdg


@pytest.mark.parametrize("heading,bidirectional",
                         [(False, False), (True, False), (True, True), (False, True)])
def test_corridor_gather_equals_row_form_and_jax(heading, bidirectional):
    """The gather form's plain version equals the row form's plain version
    word for word on the same dequantized coordinates (exact), over rows on
    the buffer distances, end points, NaN and infinite headings and the time
    quads' edges; its unpacked masks agree with the reference's
    ``make_corridor_step`` on those f32 inputs as the row form's do, and
    refine in f64 from the rows' exact coordinates to
    ``corridor_masks_f64``'s masks exactly (the dequantization's half cell
    is far under ``DIST_SLACK_DEG``)."""
    specs, ref_specs, (xs, ys, tms, hdg) = _corridor_inputs(23 + heading + 2 * bidirectional,
                                                            heading, bidirectional)
    sft, ref_sft = parse_spec("c", SFT_SPEC), ref_parse_spec("c", SFT_SPEC)
    cols, pos, h, seen = _resident_case(xs, ys, tms, hdg, sft, 5)
    payload = [torch.from_numpy(a) for a in corridor._pack(specs, sft)]
    got = kernels.corridor_masks_gather(*cols, pos, h if heading else None, *payload, heading,
                                        bidirectional)
    plain = kernels.corridor_masks_gather_plain(*cols, pos, h, *payload, heading, bidirectional)
    rows = _row_form_of(cols, pos, h)
    want = kernels.corridor_masks_plain(*rows, *payload, heading, bidirectional)
    for g, pl, w in zip(got, plain, want):
        assert g.shape == (len(specs), (len(xs) + 31) // 32)
        assert torch.equal(g, w) and torch.equal(pl, w)
    rp = ref_corridor._pack(ref_specs, ref_sft)
    rcand, rsure = make_corridor_step(heading, bidirectional)(
        *(jnp.asarray(a.numpy()) for a in rows), *(jnp.asarray(a) for a in rp[:7]))
    q = len(specs)
    cand, sure = (kernels.unpack_mask_words(w, len(xs)).numpy() for w in got)
    _assert_bands_match(cand, sure, np.asarray(rcand)[:q], np.asarray(rsure)[:q], specs,
                        [b.numpy() for b in payload[3:]], seen, (xs, ys, tms, hdg))


@pytest.mark.parametrize("case", ["long_corridor", "many_corridors", "padded_corridor"])
def test_corridor_gather_tiling_cases_equal_row_form(case):
    """The cases of the kernel's tiling loops and sentinels, gather form
    against row form word for word (exact): a corridor of 1,499 segments
    (more than one shared-memory tile holds), 300 corridors (more than one
    tile of 4-segment corridors), and a padded corridor (negative buf2),
    each with and without headings."""
    rng = np.random.default_rng({"long_corridor": 1, "many_corridors": 2,
                                 "padded_corridor": 3}[case])
    sft = parse_spec("c", SFT_SPEC)
    npts = {"long_corridor": [1500, 3], "many_corridors": [5] * 300,
            "padded_corridor": [3, 4, 2]}[case]
    specs = []
    for i, k in enumerate(npts):
        pts = list(zip(np.sort(rng.uniform(-8, 8, k)).tolist(), rng.uniform(-4, 4, k).tolist()))
        tol = float(rng.uniform(10, 80)) if i % 2 else None
        if i % 3 == 1:
            ts = np.sort(T0 + rng.integers(0, 3 * 86_400_000, k))
            specs.append(CorridorSpec(tuple(pts), tuple(int(t) for t in ts),
                                      float(rng.uniform(0.2, 1.5)), 3_600_000, tol))
        else:
            specs.append(CorridorSpec.route(pts, float(rng.uniform(0.2, 1.5)), tol))
    n = 700
    xs, ys = rng.uniform(-9, 9, n), rng.uniform(-5, 5, n)
    tms = T0 + rng.integers(-86_400_000, 4 * 86_400_000, n)
    hdg = rng.uniform(0, 360, n)
    hdg[::9] = np.nan
    cols, pos, h, _ = _resident_case(xs, ys, tms, hdg, sft, 7)
    payload = [torch.from_numpy(a) for a in corridor._pack(specs, sft)]
    if case == "padded_corridor":
        payload[3][-1] = payload[4][-1] = -1.0
    for heading in (False, True):
        got = kernels.corridor_masks_gather(*cols, pos, h if heading else None, *payload,
                                            heading, False)
        want = kernels.corridor_masks_plain(*_row_form_of(cols, pos, h), *payload, heading,
                                            False)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        assert int(kernels.unpack_mask_words(got[0], n).sum()) > 0
        if case == "padded_corridor":
            assert not got[0][-1].any() and not got[1][-1].any()


def test_corridor_dequantize_within_a_cell():
    """Every longitude and latitude, ±180 and ±90 included, comes back
    within one 31-bit cell of itself (the centre: within half a cell, in
    f64), and the f32 form is that f64 centre rounded once."""
    from geomesa_tpu_torch.curve.normalize import lat, lon

    rng = np.random.default_rng(3)
    cell_x, cell_y = 360.0 / 2**31, 180.0 / 2**31
    edges = np.arange(-4, 5) * cell_x
    vx = np.concatenate([[-180.0, 180.0, 0.0, -179.9999999, 179.9999999],
                         np.linspace(-180, 180, 10_001), rng.uniform(-180, 180, 20_000),
                         np.clip(12.345 + edges, -180, 180), [np.nextafter(180.0, 0)]])
    vy = np.concatenate([[-90.0, 90.0, 0.0, -89.9999999, 89.9999999],
                         np.linspace(-90, 90, 10_001), rng.uniform(-90, 90, 20_000),
                         np.clip(-45.6 + edges / 2, -90, 90), [np.nextafter(90.0, 0)]])
    x = torch.from_numpy(lon(31).normalize(vx).astype(np.int32))
    y = torch.from_numpy(lat(31).normalize(vy).astype(np.int32))
    dx, dy = kernels.corridor_dequantize(x, y, torch.float64)
    assert np.abs(dx.numpy() - vx).max() <= cell_x
    assert np.abs(dy.numpy() - vy).max() <= cell_y
    # the centre: half a cell, plus the f64 rounding of the difference itself
    assert np.abs(dx.numpy() - vx).max() <= 0.5 * cell_x + 1e-12
    assert np.abs(dy.numpy() - vy).max() <= 0.5 * cell_y + 1e-12
    fx, fy = kernels.corridor_dequantize(x, y)
    assert fx.dtype == torch.float32 and torch.equal(fx, dx.float())
    assert torch.equal(fy, dy.float())
    assert np.abs(fx.double().numpy() - vx).max() <= cell_x + 2.0**-17


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_reach_box_skip_is_exact(seed):
    """The kernel's skip of the distance test is exact: a row outside
    every segment's reach box (``corridor_reach_boxes``) is in neither band
    of the plain version, for segments anywhere up to ±180 and ±90 (zero-
    length and axis-aligned ones included, where a box's edge is the
    nearest a row outside it can come), buffers from 1e-4 to 5 degrees and
    rows a hair outside a box's edge."""
    rng = np.random.default_rng(seed)
    q, s, n = 40, 3, 4000
    base = rng.uniform([-180, -90], [180, 90], (q, 1, 2))
    p1 = np.clip(base + rng.normal(0, 2, (q, s, 2)), [-180, -90], [180, 90])
    p2 = np.clip(p1 + rng.normal(0, 1, (q, s, 2)), [-180, -90], [180, 90])
    p2[::7, 0] = p1[::7, 0]  # zero-length segments
    near = np.arange(1, q, 3)  # axis-aligned segments near the origin: the tightest edges
    p1[near] = rng.uniform(-1e-3, 1e-3, (len(near), s, 2))
    p2[near] = p1[near]
    p2[near[::2], :, 0] += rng.uniform(0.1, 2, (len(near[::2]), s))
    p2[near[1::2], :, 1] -= rng.uniform(0.1, 2, (len(near[1::2]), s))
    segs = torch.from_numpy(np.concatenate([p1, p2], axis=2)[..., [0, 1, 2, 3]]
                            .astype(np.float32))
    buf = 10.0 ** rng.uniform(-4, np.log10(5), q)
    hi = torch.from_numpy((buf ** 2).astype(np.float32))
    boxes = kernels.corridor_reach_boxes(segs, hi)
    # rows just outside one box of each corridor, by an ulp or a little more
    qi = rng.integers(0, q, n)
    si = rng.integers(0, s, n)
    b = boxes[qi, si].numpy().astype(np.float64)
    side = rng.integers(0, 4, n)
    px = rng.uniform(b[:, 0], b[:, 1])
    py = rng.uniform(b[:, 2], b[:, 3])
    nudge = np.where(rng.random(n) < 0.5, 0.0, rng.uniform(0, 1e-3, n))
    f32 = np.float32
    px = np.where(side == 0, np.nextafter(b[:, 0].astype(f32), f32(-np.inf)) - nudge, px)
    px = np.where(side == 1, np.nextafter(b[:, 1].astype(f32), f32(np.inf)) + nudge, px)
    py = np.where(side == 2, np.nextafter(b[:, 2].astype(f32), f32(-np.inf)) - nudge, py)
    py = np.where(side == 3, np.nextafter(b[:, 3].astype(f32), f32(np.inf)) + nudge, py)
    cx, cy = (torch.from_numpy(v.astype(np.float32)) for v in (px, py))
    bx = boxes.numpy()
    outside = np.ones((q, n), dtype=bool)  # row outside every segment's box of the corridor
    for k in range(s):
        inside = ((cx.numpy()[None, :] >= bx[:, k, 0:1]) & (cx.numpy()[None, :] <= bx[:, k, 1:2])
                  & (cy.numpy()[None, :] >= bx[:, k, 2:3])
                  & (cy.numpy()[None, :] <= bx[:, k, 3:4]))
        outside &= ~inside
    zeros = torch.zeros(n, dtype=torch.int32)
    unc = torch.tensor([0, -1, 2**31 - 1, 2**31 - 1], dtype=torch.int32).expand(q, s, 4)
    cand, sure = kernels.corridor_masks_plain(
        cx, cy, zeros, zeros, torch.zeros(n), segs, unc.contiguous(), torch.zeros(q, s), hi, hi,
        torch.full((q,), 999.0), torch.full((q,), 999.0), False, False)
    cand = kernels.unpack_mask_words(cand, n).numpy()
    assert outside.sum() > n // 2
    assert not (cand & outside).any()
    neg = kernels.corridor_reach_boxes(segs[:1], torch.tensor([-1.0]))
    assert torch.isnan(neg).all()


@pytest.mark.parametrize("n", [1, 31, 32, 33, 1000])
def test_mask_words_round_trip(n):
    """Packing and unpacking are inverses; bit j of word w is row 32 w + j
    (row 31 sets the sign bit) and the bits past N are zero."""
    rng = np.random.default_rng(n)
    m = torch.from_numpy(rng.random((3, n)) < 0.4)
    m[0, :] = True
    words = kernels.pack_mask_words(m)
    assert words.dtype == torch.int32 and words.shape == (3, (n + 31) // 32)
    assert torch.equal(kernels.unpack_mask_words(words, n), m)
    full = words[0].numpy().view(np.uint32)
    assert full[: n // 32].tolist() == [0xFFFFFFFF] * (n // 32)
    if n % 32:
        assert int(full[-1]) == (1 << (n % 32)) - 1
    rows = corridor._set_bits(words.numpy().view(np.uint32))
    assert [r.tolist() for r in rows] == [np.nonzero(r)[0].tolist() for r in m.numpy()]
    odd = corridor._set_bits(words[:1].numpy().view(np.uint32))  # an odd count of words
    assert odd[0].tolist() == np.nonzero(m[0].numpy())[0].tolist()


def test_corridor_gather_refuses_what_the_kernel_does_not_take():
    sft = parse_spec("c", SFT_SPEC)
    cols = [torch.zeros(8, dtype=torch.int32) for _ in range(4)]
    payload = [torch.from_numpy(a) for a in corridor._pack(
        [CorridorSpec.route([(0, 0), (1, 1)], 0.5)], sft)]
    with pytest.raises(TypeError, match="pos"):
        kernels.corridor_masks_gather(*cols, torch.zeros(3, dtype=torch.int64), None, *payload,
                                      False, False)
    with pytest.raises(TypeError, match="hdg"):
        kernels.corridor_masks_gather(*cols, torch.zeros(3, dtype=torch.int32), None, *payload,
                                      True, False)
    with pytest.raises(ValueError, match="hdg"):
        kernels.corridor_masks_gather(*cols, torch.zeros(3, dtype=torch.int32),
                                      torch.zeros(4), *payload, True, False)
    got = kernels.corridor_masks_gather(*cols, torch.zeros(0, dtype=torch.int32), None,
                                        *payload, False, False)
    assert got[0].shape == (1, 0)


# -- the corridor engine on stores --------------------------------------------------

def test_tube_select_randomized_grid_parity():
    """Device and host routes == the reference's device route and host
    ``tube_select``, on a randomized grid of tracks, buffers and time
    buffers."""
    ds, ref = _track_stores(450, n_tracks=18, seed=21, heading=False)
    rng = np.random.default_rng(77)
    for trial in range(6):
        npts = int(rng.integers(2, 5))
        xs = np.sort(rng.uniform(-11, 11, npts))
        ys = rng.uniform(-5, 5, npts)
        ts = np.sort(rng.integers(0, 450 * 60_000, npts)) + T0
        track = [(float(x), float(y), int(t)) for x, y, t in zip(xs, ys, ts)]
        buf = float(rng.uniform(0.3, 3.0))
        tb = int(rng.integers(1, 120)) * 60_000
        dev = tube_select_device(ds, "trk", track, buf, tb)
        host = tube_select(ds, "trk", track, buf, tb)
        want = _fids(ref_tube_select(ref, "trk", track, buf, tb))
        assert _fids(dev) == _fids(host) == want, (trial, buf, tb)
        assert want == _fids(ref_corridor.tube_select_device(ref, "trk", track, buf, tb))


def test_route_search_heading_legs_parity():
    """NaN and null headings: device route == host ``route_search`` == the
    reference's, uni- and bidirectional."""
    ds, ref = _track_stores(400, n_tracks=10, seed=31, heading=True)
    rng = np.random.default_rng(13)
    for trial in range(4):
        npts = int(rng.integers(2, 4))
        route = [(float(x), float(y))
                 for x, y in zip(np.sort(rng.uniform(-10, 10, npts)), rng.uniform(-4, 4, npts))]
        buf = float(rng.uniform(0.5, 2.5))
        tol = float(rng.uniform(20, 90))
        kw = dict(heading_field="heading", heading_tolerance_deg=tol, bidirectional=bool(trial % 2))
        dev = route_search_device(ds, "trk", route, buf, **kw)
        host = route_search(ds, "trk", route, buf, **kw)
        want = _fids(ref_route_search(ref, "trk", route, buf, **kw))
        assert _fids(dev) == _fids(host) == want, (trial, buf, tol)


def test_route_search_nan_heading_rows_never_aligned():
    ds = DataStore(device="cpu")
    ds.create_schema("rs", "heading:Double,dtg:Date,*geom:Point:srid=4326")
    ds.write("rs", [{"heading": 90.0, "dtg": T0, "geom": Point(0.5, 0.0)},
                    {"heading": None, "dtg": T0, "geom": Point(1.0, 0.0)},
                    {"heading": float("nan"), "dtg": T0, "geom": Point(1.5, 0.0)},
                    {"heading": 270.0, "dtg": T0, "geom": Point(2.0, 0.0)}])
    for fn in (route_search, route_search_device):
        r = fn(ds, "rs", [(0.0, 0.0), (3.0, 0.0)], 0.2, heading_field="heading",
               heading_tolerance_deg=30)
        assert len(r) == 1 and float(r.columns["heading"].values[0]) == 90.0
        r2 = fn(ds, "rs", [(0.0, 0.0), (3.0, 0.0)], 0.2, heading_field="heading",
                heading_tolerance_deg=30, bidirectional=True)
        assert len(r2) == 2


def test_batched_many_matches_singles_and_host_route():
    ds, ref = _track_stores(300, n_tracks=12, seed=41, heading=False)
    args = [([(-8, -3, T0), (0, 0, T0 + 10**7), (8, 3, T0 + 2 * 10**7)], 1.2, 3_600_000),
            ([(-4, 4, T0 + 10**6), (6, -4, T0 + 10**7)], 0.8, 1_800_000)]
    specs = [CorridorSpec.tube(*a) for a in args] + [CorridorSpec.route([(-10, 0), (10, 0)], 1.5)]
    ref_specs = ([ref_corridor.CorridorSpec.tube(*a) for a in args]
                 + [ref_corridor.CorridorSpec.route([(-10, 0), (10, 0)], 1.5)])
    batched = tube_select_many(ds, "trk", specs)
    host = tube_select_many(ds, "trk", specs, route="host")
    kernels.launches["corridor_masks"] = 0
    dev = tube_select_many(ds, "trk", specs, route="device")
    assert kernels.launches["corridor_masks"] == 0  # CPU tensors: the plain version
    want = ref_corridor.tube_select_many(ref, "trk", ref_specs, route="device")
    for i, (b, h, d, w) in enumerate(zip(batched, host, dev, want)):
        single = tube_select_many(ds, "trk", [specs[i]])[0]
        assert _fids(b) == _fids(h) == _fids(d) == _fids(w) == _fids(single)
    assert sum(len(b) for b in batched) > 0


def test_mixed_batch_headings_split_and_match():
    """A batch mixing unconstrained, unidirectional and bidirectional
    heading corridors (the device route's two launches) equals the host
    route, the reference's, and each corridor alone; NaN and null heading
    rows stay in the unconstrained corridor."""
    ds, ref = _track_stores(250, n_tracks=8, seed=121, heading=True)
    kinds = [(40, False), (None, False), (60, True), (30, False), (75, True)]
    specs = [CorridorSpec.route([(-10, 0), (10, 0)], 2.0, tol, bi) for tol, bi in kinds]
    ref_specs = [ref_corridor.CorridorSpec.route([(-10, 0), (10, 0)], 2.0, tol, bi)
                 for tol, bi in kinds]
    calls = []
    orig = corridor._corridor_kernel
    corridor._corridor_kernel = lambda *a: calls.append(len(a[1])) or orig(*a)
    try:
        dev = tube_select_many(ds, "trk", specs, heading_field="heading", route="device")
    finally:
        corridor._corridor_kernel = orig
    assert sorted(calls) == [2, 3]  # one launch per directionality
    host = tube_select_many(ds, "trk", specs, heading_field="heading", route="host")
    want = ref_corridor.tube_select_many(ref, "trk", ref_specs, heading_field="heading",
                                         route="device")
    for i, (d, h, w) in enumerate(zip(dev, host, want)):
        alone = tube_select_many(ds, "trk", [specs[i]], heading_field="heading")[0]
        assert _fids(d) == _fids(h) == _fids(w) == _fids(alone), i
    t = dev[1]
    hcol = t.columns["heading"]
    assert ((~hcol.is_valid()) | ~np.isfinite(hcol.values.astype(np.float64))).any()


def test_empty_candidates_and_auths():
    ds, _ = _track_stores(50, n_tracks=2, seed=71, heading=False)
    out = tube_select_device(ds, "trk", [(100.0, 80.0, T0), (101.0, 81.0, T0 + 1000)], 0.1, 1000)
    assert len(out) == 0
    assert tube_select_many(ds, "trk", []) == []
    with pytest.raises(NotImplementedError, match="A.8.6"):
        tube_select_device(ds, "trk", [(0.0, 0.0, T0), (1.0, 1.0, T0)], 0.1, 1000, auths=["a"])
    with pytest.raises(NotImplementedError, match="A.8.6"):
        interlink(ds, "trk", ds, "trk", auths=[])
    with pytest.raises(ValueError, match="heading_field"):
        tube_select_many(ds, "trk", [CorridorSpec.route([(0, 0), (1, 1)], 1.0, 30.0)])


def test_prune_filter_candidates_equal_reference():
    ds, ref = _track_stores(400, n_tracks=10, seed=5, heading=False)
    args = [([(-8, -3, T0), (0, 0, T0 + 10**7), (8, 3, T0 + 2 * 10**7)], 1.2, 3_600_000),
            ([(-4, 4, T0 + 10**6), (6, -4, T0 + 10**7)], 0.8, 1_800_000)]
    specs = [CorridorSpec.tube(*a) for a in args] + [CorridorSpec.route([(-10, 0), (10, 0)], 0.5)]
    ref_specs = ([ref_corridor.CorridorSpec.tube(*a) for a in args]
                 + [ref_corridor.CorridorSpec.route([(-10, 0), (10, 0)], 0.5)])
    got = ds.query("trk", Query(filter=corridor.prune_filter(ds.get_schema("trk"), specs)))
    want = ref.query("trk", RefQuery(filter=ref_corridor.prune_filter(ref.get_schema("trk"),
                                                                      ref_specs)))
    assert _fids(got.table) == _fids(want.table) and len(got.table) > 20


# -- the device route over resident candidates (the gather form) ---------------------

def _dateless_stores(n=360, n_tracks=12, seed=61, name="dl"):
    """A date-less point store (z2 alone) in both packages."""
    spec = "track:String,*geom:Point:srid=4326"
    rng = np.random.default_rng(seed)
    xy = [(float(rng.uniform(-12, 12)), float(rng.uniform(-6, 6))) for _ in range(n)]
    fids = [f"{name}.{i}" for i in range(n)]
    ds = DataStore(device="cpu")
    ds.create_schema(name, spec)
    ds.write(name, [{"track": f"t{i % n_tracks}", "geom": Point(*p)} for i, p in enumerate(xy)],
             fids=fids)
    ref = RefDataStore(backend="tpu")
    ref.create_schema(name, spec)
    ref.write(name, [{"track": f"t{i % n_tracks}", "geom": RefPoint(*p)}
                     for i, p in enumerate(xy)], fids=fids)
    ref.compact(name)
    return ds, ref


def _grid_specs(rng, timed: bool, k: int = 5):
    """Randomized corridors in both packages: tubes when ``timed`` (as in
    the randomized grid above), else routes, some of 3-4 waypoints."""
    specs, ref_specs = [], []
    for _ in range(k):
        npts = int(rng.integers(2, 5))
        xs, ys = np.sort(rng.uniform(-11, 11, npts)), rng.uniform(-5, 5, npts)
        buf = float(rng.uniform(0.3, 2.5))
        if timed:
            ts = np.sort(rng.integers(0, 420 * 60_000, npts)) + T0
            track = [(float(x), float(y), int(t)) for x, y, t in zip(xs, ys, ts)]
            tb = int(rng.integers(1, 120)) * 60_000
            specs.append(CorridorSpec.tube(track, buf, tb))
            ref_specs.append(ref_corridor.CorridorSpec.tube(track, buf, tb))
        else:
            pts = [(float(x), float(y)) for x, y in zip(xs, ys)]
            specs.append(CorridorSpec.route(pts, buf))
            ref_specs.append(ref_corridor.CorridorSpec.route(pts, buf))
    return specs, ref_specs


@pytest.mark.parametrize("store,with_filter", [("z3", False), ("z3", True), ("z2", False),
                                               ("z2", True)])
def test_resident_route_equals_reference_and_host(store, with_filter):
    """On a resident point state (z3; z2 on a date-less store) the device
    route runs the gather form over the device select's positions, and its
    fid sets equal the host route's, the reference's device route's and
    the reference's host ``tube_select`` (exact), with and without a
    caller filter that removes some matches."""
    if store == "z3":
        ds, ref = _track_stores(420, n_tracks=14, seed=51, heading=False, name="rz")
    else:
        ds, ref = _dateless_stores(name="rz")
    rng = np.random.default_rng(97 + (store == "z2"))
    specs, ref_specs = _grid_specs(rng, timed=store == "z3")
    flt = "track <> 't3' AND track <> 't6'" if with_filter else None
    tm = {}
    dev = tube_select_many(ds, "rz", specs, filter=flt, route="device", timings=tm)
    assert tm["route"] == "device:resident"
    assert tm["candidates"] > 0 and tm["kernel_ms"] >= 0 and "select_ms" in tm
    assert ds.resident_candidates("rz", Query(filter=corridor.prune_filter(
        ds.get_schema("rz"), specs))).plan_info.scan_index == store
    host_tm = {}
    host = tube_select_many(ds, "rz", specs, filter=flt, route="host", timings=host_tm)
    assert host_tm["route"] == "host"
    want = ref_corridor.tube_select_many(ref, "rz", ref_specs, filter=flt, route="device")
    for i, (d, h, w) in enumerate(zip(dev, host, want)):
        assert _fids(d) == _fids(h) == _fids(w), i
        assert list(d.fids) == sorted(d.fids, key=lambda f: int(str(f).split(".")[1]))
        if store == "z3":
            track = [(x, y, t) for (x, y), t in zip(specs[i].pts, specs[i].ts)]
            ref_host = ref_tube_select(ref, "rz", track, specs[i].buffer_deg,
                                       specs[i].time_buffer_ms, filter=flt)
            assert _fids(d) == _fids(ref_host), i
    assert sum(len(d) for d in dev) > 20
    if with_filter:
        unfiltered = tube_select_many(ds, "rz", specs, route="device")
        assert sum(len(u) for u in unfiltered) > sum(len(d) for d in dev)
        assert any("t3" in set(u.columns["track"].values) for u in unfiltered)
        assert not any("t3" in set(d.columns["track"].values) for d in dev)


@pytest.mark.parametrize("with_filter", [False, True])
def test_resident_route_residual_runs_on_matched_rows_only(with_filter, monkeypatch):
    """The resident route runs no exact residual over the candidates: none
    at all without a caller filter, and over no more rows than the
    unfiltered call returns with one. The table route (the row form over
    the candidate query's table, as on an Oracle store) gives every row of
    the device select to the residual."""
    from geomesa_tpu_torch.filter import ast as port_ast

    ds, _ = _track_stores(400, n_tracks=10, seed=83, heading=False, name="rr")
    specs, _ = _grid_specs(np.random.default_rng(5), timed=True, k=4)
    flt = "track <> 't2'" if with_filter else None
    unfiltered = sum(len(t) for t in tube_select_many(ds, "rr", specs))
    seen = []
    orig = port_ast.residual_mask
    monkeypatch.setattr(port_ast, "residual_mask",
                        lambda f, table, rows: seen.append(len(rows)) or orig(f, table, rows))
    tm = {}
    got = tube_select_many(ds, "rr", specs, filter=flt, timings=tm)
    assert tm["route"] == "device:resident" and tm["candidates"] > unfiltered
    assert sum(seen) == tm["residual_rows"] <= unfiltered
    assert (len(seen) == 1) == with_filter
    assert sum(len(t) for t in got) <= unfiltered
    seen.clear()
    table_tm = {}
    monkeypatch.setattr(ds, "resident_candidates", lambda *a: None)
    table = tube_select_many(ds, "rr", specs, filter=flt, timings=table_tm)
    assert table_tm["route"] == "device:table"
    assert sum(seen) >= table_tm["candidates"] > max(unfiltered, tm["residual_rows"])
    assert [_fids(a) for a in table] == [_fids(b) for b in got]


def test_row_form_serves_oracle_and_line_stores():
    """Stores without a resident point state take the row form over the
    candidate query's table (route "device:table"): the Oracle backend and
    a line-string store (its bbox state), each equal to the host route and,
    for the Oracle store, to the device store's resident route."""
    ds, _ = _track_stores(300, n_tracks=9, seed=91, heading=False, name="os")
    specs, _ = _grid_specs(np.random.default_rng(11), timed=True, k=3)
    oracle = DataStore(backend="oracle", device="cpu")
    oracle.create_schema("os", "track:String,dtg:Date,*geom:Point:srid=4326")
    oracle.write("os", ds.query("os", Query()).table)
    tm = {}
    got = tube_select_many(oracle, "os", specs, timings=tm)
    assert tm["route"] == "device:table"
    assert [_fids(a) for a in got] == [_fids(b) for b in tube_select_many(ds, "os", specs)]
    assert [_fids(a) for a in got] == [_fids(b) for b in tube_select_many(oracle, "os", specs,
                                                                          route="host")]
    rng = np.random.default_rng(12)
    lines = DataStore(device="cpu")
    lines.create_schema("ln", "dtg:Date,*geom:LineString:srid=4326")
    recs = []
    for i in range(240):
        x, y = float(rng.uniform(-10, 10)), float(rng.uniform(-5, 5))
        coords = np.array([[x, y], [x + rng.uniform(-1, 1), y + rng.uniform(-1, 1)]])
        recs.append({"dtg": T0 + i * 60_000, "geom": LineString(coords)})
    lines.write("ln", recs, fids=[f"ln.{i}" for i in range(240)])
    ltm = {}
    got = tube_select_many(lines, "ln", specs, timings=ltm)
    assert ltm["route"] == "device:table"
    host = tube_select_many(lines, "ln", specs, route="host")
    assert [_fids(a) for a in got] == [_fids(b) for b in host]
    assert sum(len(a) for a in got) > 0


def test_resident_route_heading_and_empty_candidates():
    """The heading legs on the resident route (NaN and null headings, a
    mixed uni- and bidirectional batch: two launches of the gather form)
    equal the host route; a batch with no candidates returns empty tables
    and launches nothing."""
    ds, ref = _track_stores(300, n_tracks=8, seed=131, heading=True, name="hr")
    kinds = [(35, False), (None, False), (70, True), (20, False)]
    specs = [CorridorSpec.route([(-10, -1), (0, 2), (10, 0)], 1.8, tol, bi) for tol, bi in kinds]
    ref_specs = [ref_corridor.CorridorSpec.route([(-10, -1), (0, 2), (10, 0)], 1.8, tol, bi)
                 for tol, bi in kinds]
    calls = []
    orig = corridor._corridor_kernel
    corridor._corridor_kernel = lambda *a: calls.append(type(a[2]).__name__) or orig(*a)
    tm = {}
    try:
        dev = tube_select_many(ds, "hr", specs, heading_field="heading", timings=tm)
    finally:
        corridor._corridor_kernel = orig
    assert calls == ["_ResidentRows", "_ResidentRows"] and tm["route"] == "device:resident"
    host = tube_select_many(ds, "hr", specs, heading_field="heading", route="host")
    want = ref_corridor.tube_select_many(ref, "hr", ref_specs, heading_field="heading",
                                         route="host")
    for i, (d, h, w) in enumerate(zip(dev, host, want)):
        assert _fids(d) == _fids(h) == _fids(w), i
    tm = {}
    far = [CorridorSpec.tube([(100.0, 80.0, T0), (101.0, 81.0, T0 + 1000)], 0.1, 1000)]
    out = tube_select_many(ds, "hr", far, timings=tm)
    assert tm["route"] == "device:resident" and tm["candidates"] == 0 and len(out[0]) == 0
    assert out[0].sft is ds.get_schema("hr")


# -- interlink ------------------------------------------------------------------------

def _link_stores(name, n, poly=False, seed=0):
    spec = "dtg:Date,*geom:" + ("Polygon" if poly else "Point") + ":srid=4326"
    r = np.random.default_rng(seed)
    ours, theirs = [], []
    for _ in range(n):
        x, y = float(r.uniform(-20, 20)), float(r.uniform(-10, 10))
        t = T0 + int(r.integers(0, 86_400_000))
        if poly:
            w, h = float(r.uniform(0.1, 2)), float(r.uniform(0.1, 2))
            ring = np.array([[x, y], [x + w, y], [x + w, y + h], [x, y + h], [x, y]])
            ours.append({"dtg": t, "geom": Polygon(ring)})
            theirs.append({"dtg": t, "geom": RefPolygon(ring)})
        else:
            ours.append({"dtg": t, "geom": Point(x, y)})
            theirs.append({"dtg": t, "geom": RefPoint(x, y)})
    fids = [f"{name}.{i}" for i in range(n)]
    ds = DataStore(device="cpu")
    ds.create_schema(name, spec)
    ds.write(name, ours, fids=fids)
    ref = RefDataStore(backend="tpu")
    ref.create_schema(name, spec)
    ref.write(name, theirs, fids=fids)
    ref.compact(name)
    return ds, ref


@pytest.fixture(scope="module")
def link_stores():
    return _link_stores("L", 100, poly=True, seed=1), _link_stores("R", 250, poly=False, seed=2)


@pytest.mark.parametrize("pred,dist,tb", [("intersects", 0.0, None), ("dwithin", 0.6, None),
                                          ("intersects", 0.0, 3_600_000),
                                          ("dwithin", 0.4, 7_200_000)])
def test_interlink_exact_pair_parity(link_stores, pred, dist, tb):
    (lds, lref), (rds, rref) = link_stores
    lt, rt = lds.query("L", Query()).table, rds.query("R", Query()).table
    live = interlink(lds, "L", rds, "R", pred=pred, distance=dist, time_buffer_ms=tb)
    assert live == interlink_referee(lt, rt, pred=pred, distance=dist, time_buffer_ms=tb)
    assert live == ref_interlink(lref, "L", rref, "R", pred=pred, distance=dist,
                                           time_buffer_ms=tb, route="xz")
    assert len(live) > 0 or pred == "intersects"


@pytest.mark.parametrize("pred,dist", [("intersects", 0.0), ("dwithin", 0.6)])
def test_interlink_block_route_parity(link_stores, pred, dist):
    """The blocked device join's pairing (``join_rows_device``, the
    ``planned_gather`` plain version on the CPU) gives the same pairs."""
    (lds, lref), (rds, rref) = link_stores
    lt, rt = lds.query("L", Query()).table, rds.query("R", Query()).table
    live = interlink(lds, "L", rds, "R", pred=pred, distance=dist, route="block")
    assert live == interlink_referee(lt, rt, pred=pred, distance=dist)
    assert live == ref_interlink(lref, "L", rref, "R", pred=pred, distance=dist,
                                           route="block")
    assert len(live) > 0


def test_interlink_block_route_falls_back_without_point_residency(link_stores):
    """A right store without point z2 residency (polygons) takes the XZ
    pairing: the layout test made before any launch."""
    (lds, _), (rds, _) = link_stores
    lt = lds.query("L", Query()).table
    assert interlink(rds, "R", lds, "L", pred="intersects", route="block") == \
        interlink_referee(rds.query("R", Query()).table, lt, pred="intersects")


def test_point_point_dwithin_and_bench_points():
    a, aref = _link_stores("A", 120, seed=5)
    b, bref = _link_stores("B", 120, seed=6)
    at, bt = a.query("A", Query()).table, b.query("B", Query()).table
    live = interlink(a, "A", b, "B", pred="dwithin", distance=1.0)
    assert live == interlink_referee(at, bt, "dwithin", 1.0)
    assert live == ref_interlink(aref, "A", bref, "B", pred="dwithin", distance=1.0)
    assert len(live) > 0


def test_interlink_refusals(link_stores):
    (lds, _), (rds, _) = link_stores
    with pytest.raises(ValueError, match="unsupported predicate"):
        interlink(lds, "L", rds, "R", pred="crosses")
    for kw in ({"rfilter": "INCLUDE"}, {"time_buffer_ms": 1000}):
        with pytest.raises(ValueError, match="route='block'"):
            interlink(lds, "L", rds, "R", route="block", **kw)
    with pytest.raises(ValueError, match="distance"):
        interlink(lds, "L", rds, "R", pred="dwithin", distance=-1.0)


def test_representative_xy_points_and_lines():
    from geomesa_tpu.schema.columnar import (
        FeatureTable as RefTable, representative_xy as ref_rxy)

    spec = "dtg:Date,*geom:LineString:srid=4326"
    lines = [np.array([[0.0, 0.0], [2.0, 1.0], [1.0, 3.0]]), np.array([[-5.0, 2.0], [-4.0, 2.5]])]
    recs = [{"dtg": T0, "geom": LineString(c)} for c in lines]
    from geomesa_tpu.geometry.types import LineString as RefLineString

    ref_recs = [{"dtg": T0, "geom": RefLineString(c)} for c in lines]
    got = representative_xy(FeatureTable.from_records(parse_spec("l", spec), recs))
    want = ref_rxy(RefTable.from_records(ref_parse_spec("l", spec), ref_recs))
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[0].tolist() == [1.0, -4.5] and got[1].tolist() == [1.5, 2.25]
    pts = {"dtg": T0, "geom": Point(3.0, 4.0)}
    gx, gy = representative_xy(FeatureTable.from_records(parse_spec("p", SFT_SPEC),
                                                         [{**pts, "heading": 1.0}]))
    assert (gx.tolist(), gy.tolist()) == ([3.0], [4.0])


def test_bench_generators_equal():
    """Config 10's generators draw what ``bench.py``'s ``bench_trajectory``
    and ``_pts`` draw, in its order (the bench's own code, re-run here at a
    small N)."""
    spec = importlib.util.spec_from_file_location("bench_traj_mod", "bench.py")
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    n = 5000
    lon, lat, t, tracks, n_tracks, corridors = trajectory_workload(n)
    rng = np.random.default_rng(15)
    nt = max(n // 256, 32)
    which = rng.integers(0, len(bench.CITIES), nt)
    tx = bench.CITIES[which, 0] + rng.normal(0, 3.0, nt)
    ty = bench.CITIES[which, 1] + rng.normal(0, 2.0, nt)
    owner = rng.integers(0, nt, n)
    np.testing.assert_array_equal(lon, np.clip(tx[owner] + rng.normal(0, 1.0, n), -179.9, 179.9))
    np.testing.assert_array_equal(lat, np.clip(ty[owner] + rng.normal(0, 0.8, n), -89.9, 89.9))
    np.testing.assert_array_equal(t, bench.T0 + rng.integers(0, bench.SPAN_DAYS * 86_400_000, n))
    assert n_tracks == nt and list(tracks[:3]) == [f"t{o}" for o in owner[:3]]
    for track, buf, tb in corridors:
        npts = int(rng.integers(2, 4))
        city = bench.CITIES[rng.integers(0, len(bench.CITIES))]
        xs = np.sort(city[0] + rng.uniform(-6, 6, npts))
        ys = city[1] + rng.uniform(-4, 4, npts)
        ts = bench.T0 + np.sort(rng.integers(0, bench.SPAN_DAYS * 86_400_000, npts))
        assert track == [(float(x), float(y), int(v)) for x, y, v in zip(xs, ys, ts)]
        assert buf == float(rng.uniform(0.3, 1.2))
        assert tb == int(rng.integers(1, 48)) * 3_600_000
    t2, x2, y2 = link_points(100, 31)
    s = np.random.default_rng(31)
    np.testing.assert_array_equal(t2, bench.T0 + s.integers(0, 86_400_000, 100))
    np.testing.assert_array_equal(x2, s.uniform(-20, 20, 100))
    np.testing.assert_array_equal(y2, s.uniform(-10, 10, 100))
