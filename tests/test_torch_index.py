"""The port's point indexes against the reference's, on the CPU.

- ``Z2Index.build`` (``z2_encode`` + one stable ``torch.sort`` on the
  store's device, here the CPU): permutation and sorted keys identical to
  the reference ``Z2Index.build`` (stable ``np.argsort``), duplicates and
  ties included; ``plan`` intervals equal the reference's;
- ``Z3Index.build`` through the device route: permutation and keys
  identical to the reference's (bin, z) ``lexsort``;
- ``build_indices`` honours ``geomesa.indices`` for z3/z2 and refuses what
  the port does not carry;
- the legacy-layout fault: the port's current curves key a legacy schema
  differently from the reference's legacy curves, so the port refuses it.

Tolerance: none — permutations, keys and intervals compare exactly.
"""

import numpy as np
import pytest
import torch

import geomesa_tpu  # noqa: F401  (x64 on)
from geomesa_tpu.filter.bounds import extract as ref_extract
from geomesa_tpu.filter.cql import parse as ref_parse
from geomesa_tpu.index.z2 import Z2Index as RefZ2Index
from geomesa_tpu.index.z3 import Z3Index as RefZ3Index
from geomesa_tpu.planning.planner import build_indices as ref_build_indices
from geomesa_tpu.schema import columnar as ref_columnar
from geomesa_tpu.schema.sft import parse_spec as ref_parse_spec

from geomesa_tpu_torch.filter.bounds import extract
from geomesa_tpu_torch.filter.cql import parse
from geomesa_tpu_torch.index.z2 import Z2Index
from geomesa_tpu_torch.index.z3 import Z3Index
from geomesa_tpu_torch.planning.planner import build_indices
from geomesa_tpu_torch.schema import columnar
from geomesa_tpu_torch.schema.sft import parse_spec
from geomesa_tpu_torch.store.datastore import DataStore
from geomesa_tpu_torch.workload import T0, synth_gdelt

CPU = torch.device("cpu")
SPEC = "dtg:Date,*geom:Point:srid=4326;geomesa.z3.interval='day'"
POINTS = "*geom:Point:srid=4326"


def _tables(spec, lon, lat, t=None, name="t"):
    """The same rows as a reference and a port FeatureTable."""
    out = []
    for mod, parse_fn in ((ref_columnar, ref_parse_spec), (columnar, parse_spec)):
        sft = parse_fn(name, spec)
        cols = {"geom": mod.point_column(lon.copy(), lat.copy())}
        if t is not None:
            cols["dtg"] = mod.Column(sft.attr("dtg").type, t.copy())
        out.append((sft, mod.FeatureTable.from_columns(
            sft, [f"f{i}" for i in range(len(lon))], cols)))
    return out


@pytest.fixture(scope="module")
def dup_points():
    """GDELT-shaped points with runs of exact duplicates (tie order)."""
    lon, lat, t = synth_gdelt(6000, seed=31)
    rng = np.random.default_rng(32)
    src = rng.integers(0, 6000, 1500)
    dst = rng.integers(0, 6000, 1500)
    lon[dst], lat[dst] = lon[src], lat[src]
    t[dst[:700]] = t[src[:700]]
    lon[:40], lat[:40] = 2.3, 48.8  # one cell holding 40 rows
    return lon, lat, t


def test_z2_build_is_identical_to_reference(dup_points):
    lon, lat, _ = dup_points
    (rsft, rtable), (sft, table) = _tables(POINTS, lon, lat)
    ref = RefZ2Index(rsft)
    ref.build(rtable)
    port = Z2Index(sft)
    perm = port.build(table, CPU)
    assert np.array_equal(perm, ref.perm)
    assert port.zs.dtype == ref.zs.dtype == np.uint64
    assert np.array_equal(port.zs, ref.zs)
    assert port.n == ref.n == len(lon)
    assert set(port.build_s) == {"normalize", "stage", "encode", "sort", "copy_back"}


BOXES_CQL = [
    "BBOX(geom, -80, 35, -70, 45)",
    "BBOX(geom, 170, -40, -170, 40)",  # antimeridian
    "BBOX(geom, -80, 35, -70, 45) OR BBOX(geom, 0, 45, 5, 55)",
    "BBOX(geom, 2.3, 48.8, 2.3, 48.8)",  # the duplicated point
    "BBOX(geom, 0, 0, 10, 10) AND BBOX(geom, 20, 20, 30, 30)",  # disjoint
    "INCLUDE",  # no box
    "name = 'x'",  # no box either
]


@pytest.mark.parametrize("cql", BOXES_CQL)
@pytest.mark.parametrize("budget", [2000, 16])
def test_z2_plan_equals_reference(dup_points, cql, budget):
    lon, lat, _ = dup_points
    (rsft, rtable), (sft, table) = _tables(POINTS, lon, lat)
    ref = RefZ2Index(rsft)
    ref.build(rtable)
    port = Z2Index(sft)
    port.build(table, CPU)
    want = ref.plan(ref_extract(ref_parse(cql), "geom", None), budget).intervals
    got = port.plan(extract(parse(cql), "geom", None), budget).intervals
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_z2_install_checks_the_order(dup_points):
    lon, lat, _ = dup_points
    (rsft, rtable), (sft, table) = _tables(POINTS, lon, lat)
    ref = RefZ2Index(rsft)
    ref.build(rtable)
    port = Z2Index(sft)
    port.install(table, ref.perm)
    assert np.array_equal(port.zs, ref.zs) and port.build_s == {}
    with pytest.raises(ValueError, match="does not sort"):
        Z2Index(sft).install(table, np.arange(len(lon)))
    with pytest.raises(ValueError, match="perm length"):
        Z2Index(sft).install(table, ref.perm[:-1])


def test_z3_device_build_is_identical_to_reference(dup_points):
    lon, lat, t = dup_points
    (rsft, rtable), (sft, table) = _tables(SPEC, lon, lat, t)
    ref = RefZ3Index(rsft)
    ref.build(rtable)
    port = Z3Index(sft)
    perm = port.build(table, CPU)
    assert np.array_equal(perm, ref.perm)
    assert np.array_equal(port.zs, ref.zs) and port.zs.dtype == np.uint64
    assert np.array_equal(port.bins, ref.bins)
    assert np.array_equal(port.bin_values, ref.bin_values)
    assert np.array_equal(port.bin_starts, ref.bin_starts)
    assert set(port.build_s) == {"normalize", "stage", "encode", "sort", "copy_back"}


def test_build_uses_the_kernel_wrappers(dup_points, monkeypatch):
    """The builds encode through ``z3_encode``/``z2_encode`` (the kernel on
    a card), never through the host ``sfc.index`` referee."""
    from geomesa_tpu_torch.index import z2 as z2_mod
    from geomesa_tpu_torch.index import z3 as z3_mod

    lon, lat, t = dup_points
    (_, _), (sft, table) = _tables(SPEC, lon, lat, t)
    calls = []
    for mod, name in ((z3_mod, "z3_encode"), (z2_mod, "z2_encode")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _r=real, _n=name: calls.append(_n) or _r(*a))

    def refuse(*_):
        raise AssertionError("the host referee ran on the write path")

    for index in (Z3Index(sft), Z2Index(sft)):
        monkeypatch.setattr(type(index.sfc), "index", refuse)
        index.build(table, CPU)
    assert calls == ["z3_encode", "z2_encode"]


@pytest.mark.parametrize("setting,want", [
    (None, {"z3", "z2"}),
    ("z3", {"z3"}),
    ("z2", {"z2"}),
    ("z3,z2,id", {"z3", "z2"}),
    ("z2,attr:name", {"z2"}),
])
def test_configured_indices_are_honoured(setting, want):
    spec = "name:String:index=true," + SPEC
    if setting is not None:
        spec += f",geomesa.indices='{setting}'"
    got = set(build_indices(parse_spec("t", spec)))
    assert got == want
    assert got == set(ref_build_indices(ref_parse_spec("t", spec))) & {"z3", "z2"}


@pytest.mark.parametrize("spec", [
    SPEC + ",geomesa.indices='xz2'",
    SPEC + ",geomesa.indices='id'",
    SPEC + ",geomesa.indices='attr:name,id'",
    POINTS + ";geomesa.indices='z3'",  # z3 needs a date: the reference builds id
])
def test_configured_indices_the_port_lacks_are_refused(spec):
    full = "name:String:index=true," + spec
    assert not set(ref_build_indices(ref_parse_spec("t", full))) & {"z3", "z2"}
    with pytest.raises(NotImplementedError, match="does not carry"):
        build_indices(parse_spec("t", full))
    with pytest.raises(NotImplementedError):
        DataStore(device="cpu").create_schema("t", full)


def test_legacy_layout_diverges_and_is_refused():
    """The fault: the port keyed a legacy-layout schema with its current
    curves. On one seeded table its z3 and z2 keys differ from the
    reference's legacy keys; the smallest input that diverges is one row,
    (-179.9999, 0.0) at T0. The port now refuses the layout."""
    legacy = SPEC + ",geomesa.index.layout='legacy'"
    lon, lat, t = synth_gdelt(2000, seed=33)
    for (xs, ys, ts), min_diff in (((lon, lat, t), 100), ((np.array([-179.9999]),
                                    np.array([0.0]), np.array([T0])), 1)):
        (rsft, rtable), _ = _tables(legacy, xs, ys, ts)
        _, (sft, table) = _tables(SPEC, xs, ys, ts)  # what the port built before
        for ref_cls, port_cls in ((RefZ3Index, Z3Index), (RefZ2Index, Z2Index)):
            ref = ref_cls(rsft)
            ref.build(rtable)
            port = port_cls(sft)
            port.build(table, CPU)
            ref_keys = np.sort(ref.zs)
            assert int((np.sort(port.zs) != ref_keys).sum()) >= min_diff
    sft = parse_spec("t", legacy)
    assert sft.index_layout == "legacy"
    for refuse in (lambda: DataStore(device="cpu").create_schema("t", legacy),
                   lambda: build_indices(sft), lambda: Z3Index(sft), lambda: Z2Index(sft)):
        with pytest.raises(NotImplementedError, match="legacy"):
            refuse()
