"""Track statistics: the port's trajectory state (``trajectory/state.py``)
and ``process.tracks.track_label`` against geomesa_tpu's on the same seeded
records, on the CPU (the ``track_stats`` kernel's plain version).

- ``build_track_state``: the CSR layout (entities, offsets, order, times,
  coordinates, the sorted table's fids) equal to the reference's, on
  ``tests/test_trajectory.py``-style track stores and on a store with
  rows of equal (track, time), where the lowest original row sorts last;
- ``track_stats_plain`` against the reference's
  ``cached_track_stats_step`` on the same padded columns (the reference's
  pad rows fall in a discard segment; the port takes the rows as they
  are), on random tracks, parked tracks (dwell), one-row entities, one
  entity holding half the rows and a row count that is not a multiple
  of 32;
- ``track_stats`` and ``track_stats_host`` against the reference's on the
  same store, the label columns exactly, the dwell case of
  ``tests/test_trajectory.py:183``;
- ``track_label`` against the reference, the tie rule and an empty table;
- the manager cache: ``get_track_state`` is served from the cache until a
  write or a compact moves the store's data epoch, ``invalidate`` drops
  states; ``validate`` is empty on a sound state and reports corrupted
  offsets; ``auths`` raises ``NotImplementedError`` naming A.8.6.

Tolerance: layouts, label columns, row counts and times compare exactly.
The f32 step sums within rtol 1e-4 + atol 1e-3: XLA on the CPU may contract
the reference's distance into an FMA and sums in another order. The f32
sums against the f64 referee within the reference's own rtol 5e-3 + atol
1e-3 (``tests/test_trajectory.py:176``).
"""

import numpy as np
import pytest
import torch

import geomesa_tpu  # noqa: F401  (x64 on)
import jax.numpy as jnp
from geomesa_tpu.geometry.types import Point as RefPoint
from geomesa_tpu.planning.planner import Query as RefQuery
from geomesa_tpu.process.tracks import track_label as ref_track_label
from geomesa_tpu.schema.columnar import FeatureTable as RefFeatureTable
from geomesa_tpu.schema.sft import parse_spec as ref_parse_spec
from geomesa_tpu.store.datastore import DataStore as RefDataStore
from geomesa_tpu.trajectory import state as ref_state

from geomesa_tpu_torch.geometry.types import Point
from geomesa_tpu_torch.ops.kernels import track_stats as track_stats_kernel, track_stats_plain
from geomesa_tpu_torch.planning.planner import Query
from geomesa_tpu_torch.process.tracks import track_label
from geomesa_tpu_torch.schema.columnar import FeatureTable
from geomesa_tpu_torch.schema.sft import parse_spec
from geomesa_tpu_torch.store.datastore import DataStore
from geomesa_tpu_torch.trajectory import state
from geomesa_tpu_torch.trajectory import (
    TrackState, build_track_state, track_stats, track_stats_host)

T0 = 1_600_000_000_000
SPEC = "track:String,dtg:Date,*geom:Point:srid=4326"
STEP_RTOL, STEP_ATOL = 1e-4, 1e-3
HOST_RTOL, HOST_ATOL = 5e-3, 1e-3
SUMS = ("length_deg", "duration_s", "avg_speed_deg_s", "heading_change_deg", "dwell_s")


def _records(n, n_tracks, seed, ties: bool = False):
    """``tests/test_trajectory.py:26``'s track rows; with ``ties`` the times
    repeat (minutes 0..29), so rows of one track share times."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        t = T0 + (int(rng.integers(0, 30)) if ties else i) * 60_000
        out.append((f"t{i % n_tracks}", t, float(rng.uniform(-12, 12)),
                    float(rng.uniform(-6, 6))))
    return out


def _stores(recs, name="trk"):
    fids = [f"f{i}" for i in range(len(recs))]
    ref = RefDataStore(backend="tpu")
    ref.create_schema(name, SPEC)
    ref.write(name, [{"track": a, "dtg": t, "geom": RefPoint(x, y)} for a, t, x, y in recs],
              fids=fids)
    ref.compact(name)
    port = DataStore(device="cpu")
    port.create_schema(name, SPEC)
    port.write(name, [{"track": a, "dtg": t, "geom": Point(x, y)} for a, t, x, y in recs],
               fids=fids)
    port.compact(name)
    return ref, port


STORES = {"tracks": (300, 9, 11, False), "many": (500, 20, 5, False),
          "ties": (400, 7, 3, True)}


@pytest.fixture(scope="module", params=sorted(STORES))
def stores(request):
    n, k, seed, ties = STORES[request.param]
    return _stores(_records(n, k, seed, ties))


def test_layout_equals_reference(stores):
    ref, port = stores
    rs = ref_state.build_track_state(ref, "trk", "track")
    ps = build_track_state(port, "trk", "track")
    assert isinstance(ps, TrackState)
    assert list(ps.entities) == list(rs.entities)
    for name in ("offsets", "order", "t_ms", "x", "y"):
        assert np.array_equal(getattr(ps, name), getattr(rs, name)), name
    assert list(ps.table.fids) == list(rs.table.fids)
    assert ps.n == rs.n and ps.n_entities == rs.n_entities
    assert ps.validate() == [] and rs.validate() == []


def test_tie_rule_lowest_row_sorts_last():
    recs = [("a", T0 + 5, 0.0, 0.0), ("a", T0 + 9, 1.0, 0.0), ("a", T0 + 9, 2.0, 0.0),
            ("b", T0 + 1, 3.0, 0.0), ("b", T0 + 1, 4.0, 0.0)]
    ref, port = _stores(recs, "ties")
    ps = build_track_state(port, "ties", "track")
    rs = ref_state.build_track_state(ref, "ties", "track")
    assert list(ps.table.fids) == list(rs.table.fids) == ["f0", "f2", "f1", "f4", "f3"]
    got = track_stats(port, "ties", "track", state=ps)
    assert list(got["last_fid"]) == ["f1", "f3"]


def _layout(kind: str, seed: int):
    """Host arrays of a track layout: (offsets, t_ms, x, y)."""
    rng = np.random.default_rng(seed)
    if kind == "random":
        sizes = rng.integers(1, 40, 30)
    elif kind == "dwell":
        sizes = rng.integers(2, 30, 12)
    elif kind == "singles":
        sizes = np.ones(77, dtype=np.int64)
    elif kind == "giant":
        sizes = np.r_[rng.integers(1, 20, 60), 2501, rng.integers(1, 20, 60)]
    else:  # "odd": 1001 rows, no multiple of 32
        sizes = np.r_[rng.integers(1, 60, 30)]
        sizes[-1] += 1001 - sizes.sum()
    offsets = np.r_[0, np.cumsum(sizes)].astype(np.int64)
    n = int(offsets[-1])
    t = T0 + np.cumsum(rng.integers(0, 90_000, n))
    x = rng.uniform(-30, 30, n)
    y = rng.uniform(-20, 20, n)
    if kind == "dwell":  # parked runs: repeated positions, and steps below the dwell threshold
        for k in range(0, n - 4, 7):
            x[k + 1:k + 4], y[k + 1:k + 4] = x[k], y[k]
        x[5::11] = x[4::11][: len(x[5::11])] + 5e-5
    return offsets, t, x, y


LAYOUTS = ("random", "dwell", "singles", "giant", "odd")


@pytest.mark.parametrize("kind", LAYOUTS)
def test_step_plain_equals_jax_step(kind):
    offsets, t, x, y = _layout(kind, seed=LAYOUTS.index(kind) + 3)
    n, e = int(offsets[-1]), len(offsets) - 1
    rs = ref_state.TrackState("t", "track", None, np.arange(e).astype(object), offsets, None,
                              np.arange(n), t, x, y)
    x32, y32, dt32, sid, first, n_cap, e_cap = rs.device_columns()
    want = ref_state.cached_track_stats_step(n_cap, e_cap)(
        x32, y32, dt32, sid, first, jnp.float32(ref_state.DEFAULT_DWELL_EPS_DEG))
    got = track_stats_plain(*(torch.from_numpy(np.array(a)[:n]) for a in (x32, y32, dt32)),
                            torch.from_numpy(offsets), ref_state.DEFAULT_DWELL_EPS_DEG)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == (e,)
        np.testing.assert_allclose(g.numpy(), np.asarray(w)[:e], rtol=STEP_RTOL, atol=STEP_ATOL)
    if kind == "dwell":
        assert float(got[3].sum()) > 0  # parked steps count


def test_step_wrapper_takes_plain_on_cpu_and_checks_inputs():
    offsets, t, x, y = _layout("random", seed=1)
    cols = [torch.from_numpy(a.astype(np.float32)) for a in (x, y, np.r_[0, np.diff(t)] / 1e3)]
    off = torch.from_numpy(offsets)
    got = track_stats_kernel(*cols, off, 1e-4)
    want = track_stats_plain(*cols, off, 1e-4)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    with pytest.raises(TypeError):
        track_stats_kernel(cols[0].double(), *cols[1:], off, 1e-4)
    with pytest.raises(TypeError):
        track_stats_kernel(*cols, off.int(), 1e-4)
    with pytest.raises(ValueError):
        track_stats_kernel(cols[0][:-1], *cols[1:], off, 1e-4)
    empty = [torch.zeros(0, dtype=torch.float32) for _ in range(3)]
    assert all(s.shape == (0,) for s in track_stats_kernel(*empty, torch.zeros(1,
                                                           dtype=torch.int64), 1e-4))


def test_track_stats_equals_reference(stores):
    ref, port = stores
    rs = ref_state.build_track_state(ref, "trk", "track")
    ps = build_track_state(port, "trk", "track")
    want = ref_state.track_stats(ref, "trk", "track", state=rs)
    got = track_stats(port, "trk", "track", state=ps)
    host = track_stats_host(ps)
    ref_host = ref_state.track_stats_host(rs)
    assert set(got) == set(want) == set(host)
    for k in ("track", "rows", "first_ms", "last_ms", "last_x", "last_y", "last_fid"):
        assert list(got[k]) == list(want[k]) == list(host[k]), k
    for k in SUMS:
        np.testing.assert_allclose(got[k], want[k], rtol=STEP_RTOL, atol=STEP_ATOL, err_msg=k)
        np.testing.assert_allclose(got[k], host[k], rtol=HOST_RTOL, atol=HOST_ATOL, err_msg=k)
        np.testing.assert_array_equal(host[k], ref_host[k], err_msg=k)
    assert list(got["last_fid"]) == [str(ps.table.fids[ps.offsets[e + 1] - 1])
                                     for e in range(ps.n_entities)]


def test_dwell_counts_stationary_time():
    recs = ([("a", T0 + i * 1000, 1.0, 1.0) for i in range(5)]
            + [("a", T0 + 5000 + i * 1000, 1.0 + 0.1 * (i + 1), 1.0) for i in range(3)])
    ref, port = _stores(recs, "dw")
    ps = build_track_state(port, "dw", "track")
    host = track_stats_host(ps)
    got = track_stats(port, "dw", "track", state=ps)
    want = ref_state.track_stats_host(ref_state.build_track_state(ref, "dw", "track"))
    assert host["dwell_s"][0] == pytest.approx(4.0) == want["dwell_s"][0]
    assert host["duration_s"][0] == pytest.approx(7.0)
    assert got["dwell_s"][0] == pytest.approx(4.0)
    assert got["heading_change_deg"][0] == pytest.approx(0.0, abs=1e-3)


def test_filtered_and_empty_states():
    ref, port = _stores(_records(200, 6, 9))
    f = "BBOX(geom, -12, -6, 0, 6)"
    ps = build_track_state(port, "trk", "track", filter=f)
    rs = ref_state.build_track_state(ref, "trk", "track", filter=f)
    assert np.array_equal(ps.offsets, rs.offsets) and list(ps.table.fids) == list(rs.table.fids)
    empty = build_track_state(port, "trk", "track", filter="track = 'nope'")
    assert empty.n == empty.n_entities == 0 and empty.validate() == []
    got = track_stats(port, "trk", "track", state=empty)
    assert all(len(v) == 0 for v in got.values())
    with pytest.raises(KeyError):
        build_track_state(port, "trk", "nope")


def _label_table(gmod, ft, parse, recs):
    sft = parse("lab", SPEC)
    return ft.from_records(sft, [{"track": a, "dtg": t, "geom": gmod(x, y)}
                                 for a, t, x, y in recs],
                           fids=[f"f{i}" for i in range(len(recs))])


@pytest.mark.parametrize("case", ["store", "ties", "empty"])
def test_track_label_equals_reference(case):
    if case == "store":
        recs = _records(300, 11, 3, ties=True)
    elif case == "ties":
        recs = [("a", T0 + 5, 0.0, 0.0), ("a", T0 + 9, 1.0, 0.0), ("a", T0 + 9, 2.0, 0.0),
                ("b", T0 + 1, 3.0, 0.0), ("b", T0 + 1, 4.0, 0.0)]
    else:
        recs = []
    got = track_label(_label_table(Point, FeatureTable, parse_spec, recs), "track")
    want = ref_track_label(_label_table(RefPoint, RefFeatureTable, ref_parse_spec, recs),
                           "track")
    assert list(got.fids) == list(want.fids)
    if case == "ties":
        assert list(got.fids) == ["f1", "f3"]


def test_cache_follows_the_data_epoch():
    _, port = _stores(_records(120, 5, 13))
    state.invalidate(port)
    a = state.get_track_state(port, "trk", "track")
    assert state.get_track_state(port, "trk", "track") is a
    assert a.epoch == port._state("trk").data_epoch()
    track_stats(port, "trk", "track")
    assert a.nbytes > 0
    before = port._state("trk").data_epoch()
    port.write("trk", [{"track": "t0", "dtg": T0, "geom": Point(0.0, 0.0)}], fids=["new"])
    assert port._state("trk").data_epoch() > before
    b = state.get_track_state(port, "trk", "track")
    assert b is not a and b.n == a.n + 1 and a.nbytes == 0  # the stale one released
    port.compact("trk")
    c = state.get_track_state(port, "trk", "track")
    assert c is not b and c.n == b.n
    assert state.get_track_state(port, "trk", "track", filter="track = 't1'") is not c
    state.invalidate(port, "other")
    assert state.get_track_state(port, "trk", "track") is c
    state.invalidate(port, "trk")
    d = state.get_track_state(port, "trk", "track")
    assert d is not c and c.nbytes == 0
    state.invalidate(port)


def test_validate_reports_corrupted_offsets():
    _, port = _stores(_records(150, 6, 17))
    st = build_track_state(port, "trk", "track")
    assert st.validate() == []
    good = st.offsets.copy()
    st.offsets = good[:-1]
    assert "offsets length" in st.validate()[0]
    st.offsets = good.copy()
    st.offsets[0] = 1
    assert any("offsets[0]" in v for v in st.validate())
    st.offsets = good.copy()
    st.offsets[-1] = st.n + 3
    assert any("offsets[-1]" in v for v in st.validate())
    st.offsets = good.copy()
    st.offsets[2], st.offsets[3] = good[3], good[2]
    assert "offsets decrease" in st.validate()
    st.offsets = good
    st.t_ms = st.t_ms.copy()
    st.t_ms[good[1] + 1] = st.t_ms[good[1]] - 5
    assert any("time not monotone" in v for v in st.validate())


def test_auths_raise():
    _, port = _stores(_records(20, 2, 1))
    for fn in (lambda: build_track_state(port, "trk", "track", auths=["a"]),
               lambda: state.get_track_state(port, "trk", "track", auths=["a"]),
               lambda: track_stats(port, "trk", "track", auths=["a"])):
        with pytest.raises(NotImplementedError, match="A.8.6"):
            fn()


def test_reference_queries_see_the_same_rows():
    """The scan's row set (the state's source) equals the reference's."""
    ref, port = _stores(_records(100, 4, 21))
    assert sorted(port.query("trk", Query()).table.fids) == sorted(
        ref.query("trk", RefQuery()).table.fids)
