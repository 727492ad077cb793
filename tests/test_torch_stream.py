"""The standing-query stream of the port against the reference, on the CPU.

- ``matrix_scan_step`` == ``make_matrix_scan_step(make_mesh(1), topk,
  impl="jnp")``: one shard on both sides (the default 8-shard CPU mesh
  samples positions per shard, which a one-card port does not);
- ``standing_query_payload`` == the reference's on supported predicates, and
  both raise ``ValueError`` on the same unsupported ones;
- ``SubscriptionMatrix``: one subscribe/unsubscribe sequence across a grow
  and a shrink gives equal capacity, slot map and payload matrices, and
  ``scan_host`` equal counts and merged positions;
- ``DeviceStreamScanner``: ``submit_chunk`` and fragmented ``submit_rows``
  (tags, wide-row envelopes, a raising callback) deliver equal ``HitBatch``
  fields and equal error counts;
- ``stream_chunk`` / ``pack_query_boxes`` equal ``bench.py``'s config 8 code.

Tolerance: none. Counts, positions, payloads and tags are integers or
strings and compare exactly. Every ``drain`` is bounded and asserted True.
"""

import importlib.util
import inspect
import pathlib
import textwrap

import numpy as np
import pytest
import torch

import geomesa_tpu  # noqa: F401  (x64 on)
import jax.numpy as jnp
from geomesa_tpu.parallel.mesh import make_mesh
from geomesa_tpu.parallel.query import make_matrix_scan_step
from geomesa_tpu.planning.planner import standing_query_payload as ref_standing_payload
from geomesa_tpu.schema.sft import parse_spec as ref_parse_spec
from geomesa_tpu.stream.matrix import SubscriptionMatrix as RefMatrix
from geomesa_tpu.stream import telemetry as ref_telemetry
from geomesa_tpu.stream.pipeline import DeviceStreamScanner as RefScanner

from geomesa_tpu_torch import workload
from geomesa_tpu_torch.parallel.query import matrix_scan_step
from geomesa_tpu_torch.planning.planner import standing_query_payload
from geomesa_tpu_torch.schema.sft import parse_spec
from geomesa_tpu_torch.stream.matrix import SubscriptionMatrix
from geomesa_tpu_torch.stream.pipeline import DeviceStreamScanner

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _clean_reference_telemetry():
    """The reference scanner registers its topics in the process-wide
    stream telemetry; drop them after each test, as the reference's own
    stream tests do, so that a later test file in the same worker (whose
    metrics endpoint renders that registry) starts from none."""
    yield
    ref_telemetry.reset()
SPEC = "name:String,dtg:Date,*geom:Point:srid=4326;geomesa.z3.interval='day'"
A = "2017-07-02T00:00:00.000Z/2017-07-05T00:00:00.000Z"
B = "2017-07-20T06:30:00.000Z/2017-07-22T00:00:00.000Z"
DRAIN_S = 60.0

SUPPORTED = [
    "INCLUDE",
    "EXCLUDE",
    "BBOX(geom, -10, -10, 10, 10)",
    f"dtg DURING {A}",
    f"BBOX(geom, -80, 35, -70, 45) AND dtg DURING {A}",
    "BBOX(geom, 170, -40, -170, 40)",  # dateline: two boxes
    f"(BBOX(geom, -80, 35, -70, 45) OR BBOX(geom, 0, 45, 5, 55)) AND "
    f"(dtg DURING {A} OR dtg DURING {B})",
    "BBOX(geom, 0, 0, 1, 1) OR BBOX(geom, 2, 2, 3, 3) OR BBOX(geom, 4, 4, 5, 5)",
    "dtg BETWEEN 2017-07-02T00:00:00Z AND 2017-07-05T00:00:00Z",
    "dtg >= 2017-07-03T00:00:00Z AND BBOX(geom, -20, 30, 40, 60)",
    "dtg < 2017-07-03T00:00:00Z",
    "dtg AFTER 2017-07-25T00:00:00Z AND BBOX(geom, 100, 20, 150, 50)",
    "BBOX(geom, 0, 0, 10, 10) AND BBOX(geom, 20, 20, 30, 30)",  # disjoint
    f"dtg DURING {A} AND dtg DURING {B}",  # disjoint in time
    f"BBOX(geom, -10, -10, 10, 10) AND (INCLUDE OR dtg DURING {A})",
]
REJECTED = [
    "NOT BBOX(geom, -10, -10, 10, 10)",
    f"BBOX(geom, -10, -10, 10, 10) OR dtg DURING {A}",
    "BBOX(geom, -10, -10, 10, 10) AND name = 'n1'",
    "name IN ('n0', 'n3')",
    "dtg <> 2017-07-03T00:00:00Z",
]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _cols(n, seed, n_bins=4):
    rng = np.random.default_rng(seed)
    return (
        rng.integers(0, 2**31 - 1, n).astype(np.int32),
        rng.integers(0, 2**31 - 1, n).astype(np.int32),
        rng.integers(0, n_bins, n).astype(np.int32),
        rng.integers(0, 86_400_000, n).astype(np.int32),
    )


def _packed(q, seed):
    """q one-box, one-window payloads over ``_cols`` data: (q, 1, 4) x 2."""
    rng = np.random.default_rng(seed)
    lo = rng.integers(0, 2**31 - 1, (q, 2))
    span = rng.integers(2**27, 2**30, (q, 2))
    hi = np.minimum(lo + span, 2**31 - 1)
    boxes = np.stack([lo[:, 0], hi[:, 0], lo[:, 1], hi[:, 1]], axis=1)
    blo = rng.integers(0, 3, q)
    times = np.stack([blo, rng.integers(0, 86_400_000, q), blo + rng.integers(0, 2, q),
                      rng.integers(0, 86_400_000, q)], axis=1)
    return boxes.astype(np.int32)[:, None, :], times.astype(np.int32)[:, None, :]


@pytest.mark.parametrize("n,q,topk,tail", [
    (1024, 8, 64, 0), (1024, 8, 200, 100), (4096, 16, 128, 0), (2048, 5, 7, 900),
])
def test_matrix_scan_step_matches_reference(n, q, topk, tail):
    cols = _cols(n, seed=n + q)
    boxes, times = _packed(q, seed=topk)
    true_n = n - tail
    want_c, want_p = make_matrix_scan_step(make_mesh(1), topk, impl="jnp")(
        *(jnp.asarray(c) for c in cols), jnp.int32(true_n),
        jnp.asarray(boxes), jnp.asarray(times))
    got_c, got_p = matrix_scan_step(*(_t(c) for c in cols), true_n, _t(boxes), _t(times), topk)
    assert got_p.shape == (q, 1, topk)
    assert np.array_equal(got_c.numpy(), np.asarray(want_c))
    assert np.array_equal(got_p.numpy(), np.asarray(want_p))
    assert int(got_c.sum()) > 0


def test_matrix_scan_step_needs_lane_multiple():
    cols = [torch.zeros(1000, dtype=torch.int32) for _ in range(4)]
    boxes = torch.zeros((1, 1, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="% 128"):
        matrix_scan_step(*cols, 1000, boxes, boxes.clone(), 8)


@pytest.mark.parametrize("slots", [(1, 1), (2, 2), (8, 16)])
def test_standing_query_payload_matches_reference(slots):
    sft, ref_sft = parse_spec("evt", SPEC), ref_parse_spec("evt", SPEC)
    for cql in SUPPORTED:
        got = standing_query_payload(sft, cql, *slots)
        want = ref_standing_payload(ref_sft, cql, *slots)
        for g, w in zip(got, want):
            assert g.dtype == np.int32 and g.tobytes() == np.asarray(w).tobytes(), cql
    for cql in REJECTED:
        with pytest.raises(ValueError):
            ref_standing_payload(ref_sft, cql, *slots)
        with pytest.raises(ValueError):
            standing_query_payload(sft, cql, *slots)


def _same_matrix(port, ref):
    assert port.capacity() == ref.capacity()
    assert port.active_count() == ref.active_count()
    assert port.snapshot().sids == ref.snapshot().sids
    assert np.array_equal(port._boxes, ref._boxes)
    assert np.array_equal(port._times, ref._times)
    assert port.validate_sentinels() == ref.validate_sentinels() == []


def test_matrix_churn_and_scan_host_match_reference():
    """Subscribe 20 CQL standing queries (8 → 16 → 32 slots), drop 15
    (32 → 16), with scans between: every step equals the reference."""
    sft, ref_sft = parse_spec("evt", SPEC), ref_parse_spec("evt", SPEC)
    port = SubscriptionMatrix(sft, device="cpu", topk=16)
    ref = RefMatrix(ref_sft, mesh=make_mesh(1), topk=16)
    boxes_f64, windows = workload.make_queries(20, seed=3)
    cqls = [workload.bbox_time_cql(b, w) for b, w in zip(boxes_f64, windows)]
    lon, lat, t = workload.synth_gdelt(3000, seed=5)
    x, y, bins, offs = _gdelt_cols(sft, lon, lat, t)

    def scan_equal():
        snap, counts, merged = port.scan_host(x, y, bins, offs)
        rsnap, rcounts, rmerged = ref.scan_host(x, y, bins, offs)
        assert snap.sids == rsnap.sids
        assert np.array_equal(counts, rcounts)
        assert len(merged) == len(rmerged)
        for a, b in zip(merged, rmerged):
            assert np.array_equal(a, b)
        return int(counts.sum())

    caps, sids, hits = [], [], 0
    for i, cql in enumerate(cqls):
        sids.append(port.subscribe(cql, None))
        assert ref.subscribe(cql, None) == sids[-1]
        _same_matrix(port, ref)
        caps.append(port.capacity())
        if i % 6 == 5:
            hits += scan_equal()
    for sid in sids[:15]:
        assert port.unsubscribe(sid) and ref.unsubscribe(sid)
        _same_matrix(port, ref)
        caps.append(port.capacity())
    assert not port.unsubscribe(sids[0]) and not ref.unsubscribe(sids[0])
    hits += scan_equal()
    assert {8, 16, 32} <= set(caps) and caps[-1] == 16
    assert hits > 0
    assert port.h2d_bytes > 0


def _gdelt_cols(sft, lon, lat, t):
    from geomesa_tpu_torch.store.backends import device_columns
    from geomesa_tpu_torch.schema.columnar import Column, FeatureTable, point_column
    from geomesa_tpu_torch.schema.sft import AttributeType

    names = np.array(["n"] * len(lon), dtype=object)
    table = FeatureTable.from_columns(sft, [str(i) for i in range(len(lon))], {
        "name": Column(AttributeType.STRING, names),
        "dtg": Column(AttributeType.DATE, t), "geom": point_column(lon, lat)})
    c = device_columns(sft, table)
    return c["x"], c["y"], c["bins"], c["offs"]


def _drive_scanner(make_matrix, make_scanner):
    """One feeding sequence: row fragments (tags, wide rows), a pre-built
    chunk, more fragments, drain. Returns (batches by sid, stats)."""
    matrix = make_matrix()
    got: dict[int, list] = {}
    boxes, times = _packed(12, seed=9)

    def collect(batch):
        got.setdefault(batch.sid, []).append(batch)

    def broken(batch):
        raise RuntimeError("subscriber failure")

    for i in range(12):
        matrix.subscribe_packed(boxes[i], times[i], broken if i == 4 else collect)
    scanner = make_scanner(matrix)
    try:
        rng = np.random.default_rng(21)
        fid = 0
        for size in (300, 1000, 50, 700, 9, 1500, 128):
            x, y, b, o = _cols(size, seed=size)
            tags = [f"f{fid + i}" for i in range(size)]
            fid += size
            env = [None] * size
            for i in rng.choice(size, max(1, size // 20), replace=False):
                lo = rng.integers(0, 2**31 - 1, 2)
                env[i] = (int(lo[0]), int(min(lo[0] + 2**28, 2**31 - 1)),
                          int(lo[1]), int(min(lo[1] + 2**28, 2**31 - 1)))
            scanner.submit_rows(x, y, b, o, tags=tags, envelopes=env)
            if size == 50:
                x, y, b, o = _cols(1000, seed=77)
                assert scanner.submit_chunk(x, y, b, o, tags=[f"c{i}" for i in range(1000)])
        assert scanner.drain(timeout_s=DRAIN_S)
        stats = scanner.stats()
    finally:
        scanner.close()
    return got, stats


def test_scanner_deliveries_match_reference():
    got, stats = _drive_scanner(
        lambda: SubscriptionMatrix(device="cpu", box_slots=1, time_slots=1, topk=40),
        lambda m: DeviceStreamScanner(m, chunk_rows=1024, flush_interval_s=60.0))
    want, ref_stats = _drive_scanner(
        lambda: RefMatrix(mesh=make_mesh(1), box_slots=1, time_slots=1, topk=40),
        lambda m: RefScanner(m, chunk_rows=1024, flush_interval_s=60.0, topic="t"))
    assert set(got) == set(want) and len(got) >= 5
    fields = ("sid", "predicate", "count", "total", "tags", "chunk", "base", "rows")
    for sid in want:
        assert len(got[sid]) == len(want[sid])
        for g, w in zip(got[sid], want[sid]):
            assert all(getattr(g, f) == getattr(w, f) for f in fields), sid
            assert g.positions.dtype == np.int64
            assert np.array_equal(g.positions, w.positions)
    for key in ("chunks", "rows", "deliveries", "callback_errors", "scan_errors", "h2d_bytes"):
        assert stats[key] == ref_stats[key], key
    assert stats["callback_errors"] > 0 and stats["scan_errors"] == 0
    assert stats["chunks"] == 6  # 3 cut by fragments, the pre-built one, 2 by drain
    assert any(b.tags and b.tags[0].startswith("c") for bs in got.values() for b in bs)


def test_envelope_hits_match_reference():
    """The wide-row host refine (bbox overlap, empty slots skipped) equals
    the reference's, vectorized and scalar."""
    from geomesa_tpu.stream.matrix import envelope_hit as ref_hit, envelope_hits as ref_hits

    from geomesa_tpu_torch.ops.refine import unsat_rows
    from geomesa_tpu_torch.stream.matrix import envelope_hit, envelope_hits

    rng = np.random.default_rng(31)
    lo = rng.integers(0, 2**31 - 1, (500, 2))
    hi = np.minimum(lo + rng.integers(0, 2**29, (500, 2)), 2**31 - 1)
    ix1, iy1, ix2, iy2 = lo[:, 0], lo[:, 1], hi[:, 0], hi[:, 1]
    b = rng.integers(0, 4, 500)
    o = rng.integers(0, 86_400_000, 500)
    boxes, times = _packed(6, seed=32)
    payloads = [(boxes[i], times[i]) for i in range(6)] + [unsat_rows(2, 2)]
    for pb, pt in payloads:
        want = ref_hits(pb, pt, ix1, ix2, iy1, iy2, b, o)
        assert np.array_equal(envelope_hits(pb, pt, ix1, ix2, iy1, iy2, b, o), want)
        for i in range(0, 500, 50):
            args = (int(ix1[i]), int(ix2[i]), int(iy1[i]), int(iy2[i]), int(b[i]), int(o[i]))
            assert envelope_hit(pb, pt, *args) == ref_hit(pb, pt, *args)
    assert not envelope_hits(*unsat_rows(2, 2), ix1, ix2, iy1, iy2, b, o).any()


def test_scanner_backpressure_and_close():
    """A blocking producer waits while the queue is full and every chunk is
    still delivered; after close, submissions are refused."""
    matrix = SubscriptionMatrix(device="cpu", box_slots=1, time_slots=1, topk=8)
    counts = []
    matrix.subscribe_packed([[0, 2**31 - 1, 0, 2**31 - 1]], [[0, 0, 10, 86_399_999]],
                            lambda b: counts.append(b.count))
    scanner = DeviceStreamScanner(matrix, chunk_rows=256, max_pending_chunks=1)
    try:
        for c in range(6):
            assert scanner.submit_chunk(*workload.stream_chunk(c, 256), block=True)
        assert scanner.drain(timeout_s=DRAIN_S)
        assert counts == [256] * 6 and scanner.lag() == 0
    finally:
        scanner.close()
    assert not scanner.submit_chunk(*workload.stream_chunk(0, 256))
    scanner.close()  # idempotent


def test_scanner_thread_death_unblocks_callers(monkeypatch):
    """A scan thread that dies outside the per-chunk handlers closes the
    scanner: a blocked producer and drain() return instead of hanging."""
    def die(self):
        raise RuntimeError("scan thread failure")

    monkeypatch.setattr(DeviceStreamScanner, "_scan_loop", die)
    matrix = SubscriptionMatrix(device="cpu", box_slots=1, time_slots=1, topk=8)
    scanner = DeviceStreamScanner(matrix, chunk_rows=256, max_pending_chunks=1)
    scanner._thread.join(timeout=10.0)
    assert not scanner._thread.is_alive()
    assert "scan thread failure" in scanner.last_error
    assert not scanner.submit_chunk(*workload.stream_chunk(0, 256), block=True)
    assert scanner.drain(timeout_s=DRAIN_S) is True  # nothing was accepted
    scanner.close()


def test_matrix_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SubscriptionMatrix()
    assert SubscriptionMatrix(device="cpu").device.type == "cpu"


def test_cuda_device_resolves_with_its_index(monkeypatch):
    """The scan thread selects its card by index, so an unindexed "cuda"
    must come back indexed (checked without a card: CUDA is faked)."""
    from geomesa_tpu_torch.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert resolve_device(None) == torch.device("cuda", 0)
    assert resolve_device("cuda") == torch.device("cuda", 0)
    assert resolve_device("cuda:1") == torch.device("cuda", 1)
    assert resolve_device("cpu") == torch.device("cpu")


def test_stream_workload_matches_bench():
    spec = importlib.util.spec_from_file_location("bench_for_port", ROOT / "bench.py")
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    # config 8's host_chunk is nested in bench_stream_1b: run its own source
    src = inspect.getsource(bench.bench_stream_1b)
    start = src.index("    def host_chunk(")
    end = src.index("\n\n", start)
    ns = {"np": np, "N": 3000, "max_off": 86_400_000 - 1}
    exec(textwrap.dedent(src[start:end]), ns)
    for c in (0, 1, 16):
        for a, b in zip(workload.stream_chunk(c, 3000), ns["host_chunk"](c)):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    from geomesa_tpu.curve.normalize import lat as ref_lat, lon as ref_lon

    boxes, _ = workload.make_queries(64)
    assert np.array_equal(workload.pack_query_boxes(boxes),
                          bench._pack_query_boxes(boxes, ref_lon(31), ref_lat(31)))
