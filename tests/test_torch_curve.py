"""The port's host copies equal the reference's, exactly: normalize,
binned_time, zorder encode3/encode2, z3_sfc and Z2SFC index, normalized and
ranges, the payload
packers, and the bench workload generators.

Tolerance: none — every comparison is integer or bit-exact f64 equality.
"""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

import geomesa_tpu  # noqa: F401  (x64 on)
from geomesa_tpu.curve import binned_time as ref_bt
from geomesa_tpu.curve import normalize as ref_norm
from geomesa_tpu.curve import zorder as ref_zorder
from geomesa_tpu.curve.sfc import Z2SFC as RefZ2SFC
from geomesa_tpu.curve.sfc import z3_sfc as ref_z3_sfc
from geomesa_tpu.ops import refine as ref_refine

from geomesa_tpu_torch.curve import binned_time as bt
from geomesa_tpu_torch.curve import normalize as norm
from geomesa_tpu_torch.curve import zorder
from geomesa_tpu_torch.curve.sfc import Z2SFC, z3_sfc
from geomesa_tpu_torch.ops import refine
from geomesa_tpu_torch import workload

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def coords():
    rng = np.random.default_rng(5)
    lon = np.concatenate([rng.uniform(-180, 180, 5000), [-180.0, 180.0, 0.0, -1e-12]])
    lat = np.concatenate([rng.uniform(-90, 90, 5000), [-90.0, 90.0, 0.0, 1e-12]])
    return lon, lat


@pytest.mark.parametrize("bits", [31, 21])
def test_normalize(coords, bits):
    lon, lat = coords
    assert np.array_equal(norm.lon(bits).normalize(lon), ref_norm.lon(bits).normalize(lon))
    assert np.array_equal(norm.lat(bits).normalize(lat), ref_norm.lat(bits).normalize(lat))
    t = np.linspace(0, 604_800.0, 1001)
    assert np.array_equal(
        norm.time(bits, 604_800.0).normalize(t),
        ref_norm.time(bits, 604_800.0).normalize(t),
    )


@pytest.mark.parametrize("period", ["day", "week", "month", "year"])
def test_binned_time(period):
    rng = np.random.default_rng(6)
    ms = rng.integers(0, 2_000_000_000_000, 4000)
    mine = bt.BinnedTime(bt.TimePeriod(period))
    ref = ref_bt.BinnedTime(ref_bt.TimePeriod(period))
    for a, b in zip(mine.to_bin_and_offset(ms), ref.to_bin_and_offset(ms)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    bins = np.arange(0, 600)
    assert np.array_equal(mine.bin_start_millis(bins), ref.bin_start_millis(bins))
    assert mine.max_offset == ref.max_offset
    assert bt.MAX_BIN == ref_bt.MAX_BIN
    assert {k.value: v for k, v in bt.MAX_OFFSET.items()} == {
        k.value: v for k, v in ref_bt.MAX_OFFSET.items()
    }


def test_zorder_encode():
    rng = np.random.default_rng(7)
    x3, y3, t3 = (rng.integers(0, 2**21, 5000) for _ in range(3))
    assert np.array_equal(zorder.encode3(x3, y3, t3), ref_zorder.encode3(x3, y3, t3))
    x2, y2 = (rng.integers(0, 2**31, 5000) for _ in range(2))
    assert np.array_equal(zorder.encode2(x2, y2), ref_zorder.encode2(x2, y2))


@pytest.mark.parametrize("period", ["day", "week"])
def test_z3_index(coords, period):
    lon, lat = coords
    rng = np.random.default_rng(8)
    p = bt.TimePeriod(period)
    offs = rng.integers(0, int(bt.MAX_OFFSET[p]), len(lon))
    got = z3_sfc(p).index(lon, lat, offs)
    want = ref_z3_sfc(ref_bt.TimePeriod(period)).index(lon, lat, offs)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("period", ["day", "week"])
def test_z3_normalized(coords, period):
    lon, lat = coords
    p = bt.TimePeriod(period)
    offs = np.random.default_rng(9).integers(0, int(bt.MAX_OFFSET[p]), len(lon))
    got = z3_sfc(p).normalized(lon, lat, offs)
    want = ref_z3_sfc(ref_bt.TimePeriod(period)).normalized(lon, lat, offs)
    for g, w in zip(got, want):
        assert g.dtype == np.int32 and np.array_equal(g, w)
    assert np.array_equal(zorder.encode3(*got), z3_sfc(p).index(lon, lat, offs))


def test_z2_index_and_normalized(coords):
    lon, lat = coords
    got = Z2SFC().index(lon, lat)
    want = RefZ2SFC().index(lon, lat)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    for g, w in zip(Z2SFC().normalized(lon, lat), RefZ2SFC().normalized(lon, lat)):
        assert g.dtype == np.int32 and np.array_equal(g, w)


@pytest.mark.parametrize(
    "boxes,budget",
    [
        ([(-10.0, -10.0, 10.0, 10.0)], 2000),
        ([(170.0, -5.0, -170.0, 5.0)], 300),  # dateline
        ([(0.0, 0.0, 1.0, 1.0), (30.0, 30.0, 40.0, 35.0)], 64),
        ([(-180.0, -90.0, 180.0, 90.0)], 2000),
        ([(2.0, 48.0, 2.5, 49.0)], 8),
        ([(2.0, 48.0, 2.0, 48.0)], 2000),  # a point
    ],
)
def test_z2_ranges(boxes, budget):
    got = Z2SFC().ranges(boxes, budget)
    want = RefZ2SFC().ranges(boxes, budget)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize(
    "boxes,window,budget",
    [
        ([(-10.0, -10.0, 10.0, 10.0)], (0.0, 86_399_999.0), 2000),
        ([(170.0, -5.0, -170.0, 5.0)], (1000.0, 5_000_000.0), 300),  # dateline
        ([(0.0, 0.0, 1.0, 1.0), (30.0, 30.0, 40.0, 35.0)], (0.0, 43_200_000.0), 64),
        ([(-180.0, -90.0, 180.0, 90.0)], (0.0, 86_399_999.0), 2000),
        ([(2.0, 48.0, 2.5, 49.0)], (3_600_000.0, 3_600_000.0), 8),
    ],
)
def test_z3_ranges(boxes, window, budget):
    got = z3_sfc(bt.TimePeriod.DAY).ranges(boxes, window, budget)
    want = ref_z3_sfc(ref_bt.TimePeriod.DAY).ranges(boxes, window, budget)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_pack_helpers_byte_equal():
    rng = np.random.default_rng(9)
    for nboxes in (0, 1, 3, 8, 11):
        b = rng.integers(0, 2**31 - 1, (nboxes, 4)).astype(np.int32) if nboxes else None
        for slots in (1, 8):
            got, want = refine.pack_boxes(b, slots=slots), ref_refine.pack_boxes(b, slots=slots)
            assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    for ntimes in (0, 1, 5, 16, 20):
        t = rng.integers(0, 2**31 - 1, (ntimes, 4)).astype(np.int32) if ntimes else None
        for slots in (1, 16):
            got, want = refine.pack_times(t, slots=slots), ref_refine.pack_times(t, slots=slots)
            assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    for nb, nt in ((1, 1), (8, 16)):
        for a, b in zip(refine.unsat_rows(nb, nt), ref_refine.unsat_rows(nb, nt)):
            assert a.tobytes() == b.tobytes()
    assert (refine.MAX_BOXES, refine.MAX_TIMES) == (ref_refine.MAX_BOXES, ref_refine.MAX_TIMES)


def test_workload_matches_bench():
    spec = importlib.util.spec_from_file_location("bench_for_port", ROOT / "bench.py")
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    for a, b in zip(workload.synth_gdelt(5000, seed=42), bench.synth_gdelt(5000, seed=42)):
        assert np.array_equal(a, b)
    assert workload.make_queries(16, seed=7) == bench.make_queries(16, seed=7)
    assert workload.T0 == bench.T0 and workload.SPAN_DAYS == bench.SPAN_DAYS
    assert np.array_equal(workload.CITIES, bench.CITIES)


def test_index_helpers_and_time_quads():
    from geomesa_tpu.index import api as ref_api
    from geomesa_tpu.index.z3 import time_windows as ref_time_windows
    from geomesa_tpu.schema.sft import parse_spec as ref_parse_spec
    from geomesa_tpu.store.backends import time_quads as ref_time_quads

    from geomesa_tpu_torch.index import api
    from geomesa_tpu_torch.index.z3 import time_windows
    from geomesa_tpu_torch.schema.sft import parse_spec
    from geomesa_tpu_torch.store.backends import time_quads

    rng = np.random.default_rng(12)
    starts = np.sort(rng.choice(100_000, 40, replace=False))
    ivs = np.stack([starts, starts + rng.integers(1, 50, 40)], axis=1).astype(np.int64)
    idx, count = api.gather_indices(ivs)
    ref_idx, ref_count = ref_api.gather_indices(ivs)
    assert count == ref_count and np.array_equal(idx, ref_idx)
    pairs = [tuple(map(int, p)) for p in rng.integers(0, 1000, (60, 2))]
    pairs = [(a, a + b % 37 + 1) for a, b in pairs]
    assert np.array_equal(api.merge_intervals(list(pairs)), ref_api.merge_intervals(list(pairs)))
    keys = np.sort(rng.integers(0, 2**40, 5000).astype(np.uint64))
    kr = np.sort(rng.integers(0, 2**40, (30, 2)).astype(np.uint64), axis=1)
    assert api.intervals_from_key_ranges(keys, kr, 7) == ref_api.intervals_from_key_ranges(keys, kr, 7)

    spec = "dtg:Date,*geom:Point;geomesa.z3.interval='week'"
    ivals = [(1_498_867_200_000, 1_499_999_999_999), (-5, 10), (2**62 - 5, 2**62),
             (1_500_000_000_000, 1_400_000_000_000)]
    for chosen in ([ivals[0]], ivals, [ivals[3]], None):
        got = time_quads(parse_spec("t", spec), chosen)
        want = ref_time_quads(ref_parse_spec("t", spec), chosen)
        assert (got is None and want is None) or np.array_equal(got, want)
    binned = bt.BinnedTime(bt.TimePeriod.WEEK)
    ref_binned = ref_bt.BinnedTime(ref_bt.TimePeriod.WEEK)
    bins = np.arange(2470, 2490)
    for chosen in ([ivals[0]], ivals[:2], None):
        assert time_windows(binned, bins, chosen) == ref_time_windows(ref_binned, bins, chosen)


@pytest.mark.parametrize("n", [0, 1, 40, 3000])
def test_gather_indices_equals_reference(n):
    """The port expands a plan's intervals on a torch device (the CPU
    here) into the reference's slots."""
    from geomesa_tpu.index import api as ref_api

    from geomesa_tpu_torch.index import api

    rng = np.random.default_rng(n)
    starts = np.sort(rng.choice(10 * n + 10, n, replace=False))
    ivs = np.stack([starts, starts + rng.integers(1, 9, n)], axis=1).astype(np.int64)
    ivs = ivs[np.concatenate([[True], ivs[1:, 0] >= ivs[:-1, 1]])] if n else ivs.reshape(0, 2)
    idx, count = api.gather_indices(ivs)
    ref_idx, ref_count = ref_api.gather_indices(ivs)
    assert count == ref_count and idx.dtype == torch.int64
    assert np.array_equal(idx.numpy(), np.asarray(ref_idx)[:count])
