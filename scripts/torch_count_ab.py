"""Time the port's count kernels, its edge gather, its planned gather, its
grouped aggregation and its spatial join of several checkouts against each
other in one run on a CUDA card.

    python3 scripts/torch_count_ab.py ROOT [ROOT ...] [--out DIR]
        [--join-only | --overlap-only | --agg-only | --fold-only | --track-only |
         --knn-only]

Each ROOT is a checkout of this repo: ``.``, or another commit unpacked with
``git archive`` into an ignored directory. The roots run one after another
in the order given (for two versions: parent, change, change, parent), each
in a process of its own that imports that root's ``geomesa_tpu_torch``, so
every root builds its kernels with its own ``build_kernels()`` and launches
them through its own wrappers. A process holds each kernel equal to its
plain version, times it with CUDA events (5 launches after a warm-up; a
wrapper that is mostly host work, as the planned gathers' and the work
list's, by the median of 5 readings of 10 calls) and prints one line per
shape:

- ``batched_count`` at bench config 2: 50M GDELT-shaped points through
  ``DataStore`` and the 64 city-box 2-7 day queries as ``DataStore`` packs
  them (B = 8, T = 16);
- ``batched_edge_gather`` at the same shape, first on the resident rows in
  z3 order, then on the same rows in a seeded random order (``config 2
  shuffled``: no chunk is culled);
- ``DataStore.count_many`` of the 64 queries, loose and exact, p50 of 10
  calls each on the host clock (the end-to-end batch, host work included);
- ``planned_gather`` at config 2's planned (query, block) pairs of the 64
  queries (as ``select_many`` plans them), and ``select_many`` of the 64
  queries, p50 of 3 calls on the host clock, with its gather split (the
  step and its device-to-host copy of the positions) per query;
- ``grouped_agg`` at bench config 9: the same 50M points with config 9's
  group ids (G = 1024) and values (V = 1) through ``DataStore`` and the 64
  city-box queries of seed 7, held to its plain version (integer outputs,
  min, max and the lanes that hold every boundary row exact, sums within a
  relative 1e-12);
- ``batched_count_hits`` at one of bench config 8's 60M-row chunks and its 64
  city boxes under one full-span window (B = T = 1, sparse matches);
- ``batched_count_hits`` at two dense payloads over 60M seeded random rows
  (B = T = 1): ``random``, one random box and window per query, and
  ``world``, a box and a window that hold every row;
- ``polygon_join`` at bench config 4: 100M GDELT-shaped points (seed 42) in
  z2 order as f32 columns, 10,000 polygons (``workload.join_polygons``,
  seed 5) planned onto 8192-row blocks, a launch per vertex bucket: held to
  its plain version on the first 256 polygons' pairs of each bucket, timed
  with CUDA events (5 runs of every bucket's launch), and a whole count run
  (``block_join_step`` per bucket and the counts' copies), p50 of 5 on the
  host clock, with the tested pairs per second. ``--join-only`` runs this
  shape alone.

``--overlap-only`` runs the bbox-overlap kernels instead, and nothing else:

- ``batched_overlap`` (no time) at bench config 5: 4M trajectory bboxes
  (``workload.xz_boxes``, seed 9) in xz2 order and the 64 city boxes of
  seed 7, one overlap slot each; then the same rows repeated to 64M (1 GB
  of columns); and config 5's batch (``batched_overlap_step`` and the
  counts' copy), p50 of 20 on the host clock;
- ``batched_overlap`` with time and ``batched_edge_gather_overlap`` at a
  line store shaped as ``chip_smoke.py``'s phase 9c: 4M line strings on
  config 5's boxes through ``DataStore`` (xz3 + xz2), config 2's 64
  queries as the planner packs them (B = 8, T = 16); and the store's
  ``count_many``, loose and exact, p50 of 10 on the host clock;
- ``planned_gather_overlap`` at the same store's planned (query, block)
  pairs of the 64 queries (as ``select_many`` plans them on xz3), held
  equal to its plain version, with the split of a call: the device time
  of its count pass, of the prefix sum of its counts (a ``torch.cumsum``
  or the count pass's own scan, by root), of the device-to-host copy of
  the total and of its write pass (``torch.profiler``, mean of 10 calls),
  the two passes back to back behind a spin of the card (CUDA events,
  their C entry points launched into outputs allocated beforehand), the
  wrapper by CUDA events (the median of 5 readings of 10 calls), its host
  clock per call (p50 of 20, each ending in a synchronise), the latency of
  the read of the total alone (p50 of 20 reads of one int64 on an idle
  card), the parts of its host work, and the planned pairs per distinct
  block.

Each overlap kernel is held equal to its plain version, then timed three
ways: the wrapper by CUDA events (10 calls after a warm-up), the bare C
entry point by CUDA events (10 launches into outputs allocated
beforehand), and the device time of each op of a wrapper call by
``torch.profiler`` (the kernel's own line is its device time; the rest are
the wrapper's fills and sorts), averaged over 10 calls. ``nvcc -Xptxas -v``
of the overlap sources prints each overlap kernel's registers, spills and
shared memory.

``--agg-only`` runs bench config 9's aggregation kernels instead, and
nothing else: 50M points with config 9's group ids (G = 1024) and values
(V = 1) through ``DataStore``, the 64 city-box queries of seed 7, 12,208
chunks of 4096 rows:

- ``agg_work_list`` at the target runs ``grouped_agg`` gives it, held
  equal to its plain version, then timed four ways: the wrapper by CUDA
  events (the median of 5 readings of 10 calls), the device work of a call behind a spin of the card
  (CUDA events around 10 calls enqueued while the card spins, as
  ``chip_smoke.device_ms``), the host clock of the same 10 enqueues (the
  wrapper's host work alone: the checks, allocations and the ctypes call),
  and each device op of a call by ``torch.profiler`` (mean of 10 calls:
  the kernel and any memset or fill by name), with the parts of its host
  work and its device time at fewer queries and chunks;
- ``grouped_agg`` (the work list, the fold and its fills and finish) held
  to its plain version, then timed the same four ways, with the device ops
  of one call and their count, and those of one ``aggregate_many`` call of
  the 64 queries;
- ``planned_gather`` at the planned (query, block) pairs of the same
  queries on this store, as in the default run but by the median of 5
  readings of 10 calls, with no ``select_many``;
  and on the pairs ``join_rows_device`` makes for the first 64 polygons of
  bench config 4 (``chip_smoke.py`` phase 8 (d)) on this store's z2 state;
- where the root has it, one empty kernel launch's CUDA-event time through
  the same ctypes path (``kernels.launch_floor_ms``): the floor a
  launch-bound kernel cannot go below;
- ``nvcc -Xptxas -v`` of ``grouped_agg.cu`` and ``planned_gather.cu``:
  every kernel's registers, spills and shared memory.

``--fold-only`` runs ``grouped_agg_overlap`` (the overlap fold of a line
store's ``aggregate_many``) at a line store shaped as ``chip_smoke.py``'s
phase 9c: 4M line strings on config 5's boxes with config 9's group key (G
= 1024) and a value column a tenth null, through ``DataStore``, and the 64
queries of seed 7 as ``aggregate_many`` packs them. It prints ``nvcc
-Xptxas -v`` of ``grouped_agg.cu``, holds the fold to its plain version
(counts, first rows, min, max and the lanes that hold every boundary row
exact, sums within a relative 1e-12), then times it: the wrapper by CUDA
events (the median of 5 readings of 10 calls), the device and host work of
a call behind a spin, the device time of each op of a call by
``torch.profiler`` (mean of 10 calls: the work list, the fold and the
finish), the work list's runs and the fold's flush atomics, and the
store's ``aggregate_many`` of the 64, p50 of 5 on the host clock.

``--track-only`` runs ``track_stats`` at bench config 10's shape: 2M track
points (``workload.trajectory_workload``, seed 15) through ``DataStore``
and ``build_track_state`` (7,812 entities). It prints ``nvcc -Xptxas -v``
of ``track_stats.cu``, holds the kernel to its plain version (rtol 1e-4 +
atol 1e-3) and two of its calls to each other (bit for bit or not), then
times it by CUDA events (20 launches), behind a spin, and by device op
(``torch.profiler``, mean of 10 calls: the kernel and any memset). The
two flags may be given together, and run in that order.

``--knn-only`` runs ``batched_knn`` at bench config 3's shape
(``chip_smoke.py``'s phase 7): 100M GDELT-shaped points (seed 42) through
``DataStore`` (z3 order), bench config 3's 64 points (``knn_points``) at k
= 10. It prints ``nvcc -Xptxas -v`` of ``batched_knn.cu``, holds the kernel
to its plain version (distances bit-equal, rows equal), then times it by
CUDA events (5 launches) and behind a spin (device and host work of a
call), splits a call's device time by kernel in launch order
(``torch.profiler``, mean of 10 calls: the cap's sample select and merge,
then the full select and merge), and times ``knn_many`` of the 64 points
and its step (``batched_knn_step`` with its uploads and copies), p50 of 10
on the host clock. Nothing else runs.

Each kernel's resource usage (``cuobjdump -res-usage``: registers, and
stack and local memory, where spills would show) is printed, and its SASS
written to ``--out`` (default ``chiprun_out/count_ab``), one folder per run.
At the end the count kernels' and the edge gather's SASS of every run is
compared with the first run's, instruction by instruction.
"""

from __future__ import annotations

import argparse
import inspect
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

STEMS = ("batched_count", "batched_count_hits", "batched_edge_gather", "planned_gather",
         "grouped_agg", "polygon_join")
SAME_SASS = STEMS[:3]  # the count kernels and the edge gather: their SASS must not change
N_ROWS, STREAM_ROWS, N_QUERIES, STREAM_CHUNKS = 50_000_000, 60_000_000, 64, 17
AGG_GROUPS, AGG_RTOL = 1024, 1e-12
JOIN_ROWS, JOIN_POLYGONS, JOIN_BLOCK, JOIN_CHECKED = 100_000_000, 10_000, 8192, 256
DAY_MS, N_BINS = 86_400_000, 40


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int = 5) -> float:
    fn()  # warm-up
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def dump_builds(kernels, label: str, out: Path) -> None:
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out.mkdir(parents=True, exist_ok=True)
    built = kernels.build_kernels()
    for stem in STEMS:
        res = subprocess.run([cuobjdump, "-res-usage", str(built[stem])], capture_output=True,
                             text=True, check=True).stdout
        usage = [ln.strip() for ln in res.splitlines() if "REG:" in ln]
        log(f"{label} {stem} resources: " + " | ".join(usage))
        sass = subprocess.run([cuobjdump, "-sass", str(built[stem])], capture_output=True,
                              text=True, check=True).stdout
        (out / f"{stem}.sass").write_text(sass)


def config2_inputs(dev):
    from geomesa_tpu_torch.filter.bounds import extract
    from geomesa_tpu_torch.filter.cql import parse
    from geomesa_tpu_torch.schema.columnar import Column, FeatureTable, point_column
    from geomesa_tpu_torch.schema.sft import AttributeType
    from geomesa_tpu_torch.store.datastore import DataStore
    from geomesa_tpu_torch.workload import SPEC, bbox_time_cql, make_queries, synth_gdelt

    lon, lat, t = synth_gdelt(N_ROWS, seed=42)
    boxes_f64, windows_ms = make_queries(N_QUERIES, seed=7)
    ds = DataStore(device=dev)
    sft = ds.create_schema("gdelt", SPEC)
    ds.write("gdelt", FeatureTable.from_columns(sft, np.arange(N_ROWS).astype("U9"), {
        "dtg": Column(AttributeType.DATE, t), "geom": point_column(lon, lat)}))
    ds.compact("gdelt")
    state = ds._state("gdelt").backend_state["z3"]
    pays = [ds.backend.payload(sft, extract(parse(bbox_time_cql(b, w)), "geom", "dtg"))
            for b, w in zip(boxes_f64, windows_ms)]
    boxes, times = (torch.from_numpy(np.ascontiguousarray(np.stack([p[k] for p in pays])))
                    .to(dev) for k in (0, 1))
    return ds, list(state.spatial_cols()), boxes, times, state.n


def stream_inputs(dev):
    from geomesa_tpu_torch.workload import (
        STREAM_MAX_OFF, make_queries, pack_query_boxes, stream_chunk)

    cols = [torch.from_numpy(a).to(dev) for a in stream_chunk(0, STREAM_ROWS)]
    boxes = torch.from_numpy(pack_query_boxes(make_queries(N_QUERIES)[0])).to(dev)
    window = torch.tensor([[[0, 0, STREAM_CHUNKS, STREAM_MAX_OFF]]], dtype=torch.int32)
    return cols, boxes, window.expand(N_QUERIES, 1, 4).contiguous().to(dev)


def dense_inputs(dev, world: bool):
    gen = torch.Generator(device=dev).manual_seed(3)
    top = (2**31 - 1, 2**31 - 1, N_BINS, DAY_MS)
    cols = [torch.randint(0, hi, (STREAM_ROWS,), generator=gen, device=dev, dtype=torch.int32)
            for hi in top]
    if world:
        boxes = np.tile(np.array([0, 2**31 - 1, 0, 2**31 - 1], np.int32), (N_QUERIES, 1, 1))
        times = np.tile(np.array([0, 0, N_BINS, DAY_MS], np.int32), (N_QUERIES, 1, 1))
    else:
        rng = np.random.default_rng(4)
        bx = np.sort(rng.integers(0, 2**31 - 1, (N_QUERIES, 2, 2)), axis=2)
        boxes = bx.reshape(N_QUERIES, 1, 4)
        tb = np.sort(rng.integers(0, N_BINS, (N_QUERIES, 2)), axis=1)
        to = rng.integers(0, DAY_MS, (N_QUERIES, 2))
        times = np.stack([tb[:, 0], to[:, 0], tb[:, 1], to[:, 1]], axis=1)[:, None, :]
    return cols, *(torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)
                   for a in (boxes, times))


def timed(label: str, shape: str, kernels, stem: str, cols, boxes, times,
          n: int | None = None) -> None:
    """Hold ``stem`` equal to its plain version over rows [0, ``n``) of
    ``cols`` (all of them by default), then time it."""
    kernel, plain = getattr(kernels, stem), getattr(kernels, stem + "_plain")
    n = cols[0].shape[0] if n is None else n
    got, want = kernel(*cols, 0, n, boxes, times), plain(*cols, 0, n, boxes, times)
    got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
    torch.cuda.synchronize()
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise SystemExit(f"{label} {shape}: {stem} disagrees with its plain version")
    ms = cuda_ms(lambda: kernel(*cols, 0, n, boxes, times))
    log(f"{label} {shape} {stem}: {ms:.4f} ms (CUDA events, 5 launches) at N={n} "
        f"Q={boxes.shape[0]} B={boxes.shape[1]} T={times.shape[1]}; equal to plain; "
        f"{int(want[0].long().sum())} matches")


def batch_p50(label: str, ds) -> None:
    """``count_many`` of config 2's 64 queries, loose and exact: p50 of 10
    calls each after one warm-up, host clock."""
    import time

    from geomesa_tpu_torch.workload import bbox_time_cql, make_queries

    cqls = [bbox_time_cql(b, w) for b, w in zip(*make_queries(N_QUERIES, seed=7))]
    for loose in (True, False):
        ds.count_many("gdelt", cqls, loose=loose)
        ms = []
        for _ in range(10):
            t0 = time.perf_counter()
            ds.count_many("gdelt", cqls, loose=loose)
            ms.append((time.perf_counter() - t0) * 1e3)
        log(f"{label} config 2 count_many {'loose' if loose else 'exact'}: p50 "
            f"{float(np.percentile(ms, 50)):.3f} ms over 10 calls (min {min(ms):.3f}, max "
            f"{max(ms):.3f}; host clock)")


def cuda_ms_p50(fn, iters: int = 10, reps: int = 5) -> float:
    """The median of ``reps`` readings of :func:`cuda_ms` (``iters`` calls
    each): a wrapper whose time is mostly host work reads steadier so."""
    return float(np.median([cuda_ms(fn, iters) for _ in range(reps)]))


def device_by_op(fn, calls: int = 1) -> dict[str, float]:
    """``calls`` calls of ``fn`` under ``torch.profiler``: device ms per
    call by kernel or copy name (the profiler's own clock, not CUDA
    events)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    by_name: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = e.name.replace("void ", "").replace("(anonymous namespace)::", "")
            name = name.split("(")[0][:48]
            by_name[name] = by_name.get(name, 0.0) + (e.time_range.end - e.time_range.start)
    return {name: t / 1e3 / calls for name, t in by_name.items()}


def device_breakdown(fn) -> str:
    """One call's :func:`device_by_op` as a line, largest first."""
    top = sorted(device_by_op(fn).items(), key=lambda kv: -kv[1])[:6]
    return "; ".join(f"{name} {t:.4f} ms" for name, t in top) or "no device events"


def spin_ms(fn, calls: int = 10) -> tuple[float | None, float | None]:
    """(device ms, host ms) of one call of ``fn``, which must not
    synchronise: ``calls`` calls enqueued behind a spin of the card
    (``torch.cuda._sleep``), CUDA events around them giving their device work
    back to back, the host clock around their enqueue giving the host's work
    per call with nothing waiting on the card (``chip_smoke.device_ms``'s
    method). The spin doubles until the host has enqueued every call before
    the card reaches the first event; (None, None) if it never does."""
    import time

    fn()
    torch.cuda.synchronize()
    spin = 1 << 24
    for _ in range(6):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        start.record()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        host = (time.perf_counter() - t0) * 1e3 / calls
        end.record()
        hidden = not start.query()
        torch.cuda.synchronize()
        if hidden:
            return start.elapsed_time(end) / calls, host
        spin *= 2
    return None, None


def fmt(v: float | None) -> str:
    return "not measured" if v is None else f"{v:.4f} ms"


def us(v: float | None) -> str:
    """A time in ms as µs, or "not measured"."""
    return "not measured" if v is None else f"{v * 1e3:.1f}"


def ops_line(ops: dict[str, float]) -> str:
    """:func:`device_by_op`'s result as a line, largest first."""
    return "; ".join(f"{name} {t:.4f} ms" for name, t in sorted(ops.items(),
                                                                 key=lambda kv: -kv[1])) or "none"


def gather_timed(label: str, kernels, ds, type_name: str = "gdelt",
                 select: bool = True) -> None:
    """``planned_gather`` at config 2's planned pairs against its plain
    version, then (with ``select``) ``select_many`` of the same queries with
    its split."""
    import time

    from geomesa_tpu_torch.parallel.query import intervals_to_block_pairs
    from geomesa_tpu_torch.planning.planner import Query, QueryPlanner
    from geomesa_tpu_torch.workload import bbox_time_cql, make_queries

    cqls = [bbox_time_cql(b, w) for b, w in zip(*make_queries(N_QUERIES, seed=7))]
    st = ds._state(type_name)
    planner = QueryPlanner(st.sft, st.indices)
    plans = [planner.plan(Query(c)) for c in cqls]
    pair_q, pair_blk = intervals_to_block_pairs([pl.intervals for pl, _, _ in plans],
                                                kernels.JOIN_BLOCK)
    state = st.backend_state["z3"]
    pays = [ds.backend.payload(st.sft, info.extraction) for _, _, info in plans]
    boxes, times = (torch.from_numpy(np.ascontiguousarray(np.stack([p[k] for p in pays])))
                    .cuda() for k in (0, 1))
    pq, pb = (torch.from_numpy(a.astype(np.int32)).cuda() for a in (pair_q, pair_blk))
    args = (*state.spatial_cols(), state.n, pq, pb, boxes, times)
    kw = {}
    if "plan" in inspect.signature(kernels.planned_gather).parameters:
        # uploaded once, as planned_gather_step uploads it with the pair lists
        kw["plan"] = torch.from_numpy(np.concatenate(kernels.block_runs(pair_q,
                                                                         pair_blk))).cuda()
    got_p, got_h = kernels.planned_gather(*args, **kw)
    want_p, want_h = kernels.planned_gather_plain(*args)
    torch.cuda.synchronize()
    if not (torch.equal(got_p.long(), want_p.long()) and torch.equal(got_h, want_h)):
        raise SystemExit(f"{label} config 2: planned_gather disagrees with its plain version")
    ms = cuda_ms_p50(lambda: kernels.planned_gather(*args, **kw))
    blocks = len(np.unique(pair_blk))
    log(f"{label} config 2 planned_gather: {ms:.4f} ms (CUDA events, median of 5 readings of "
        f"10 calls) for "
        f"{len(pair_q)} pairs over {blocks} distinct blocks; equal to plain; "
        f"{int(want_h.sum())} positions of {got_p.element_size()} B; device time by op: "
        + device_breakdown(lambda: kernels.planned_gather(*args, **kw)))
    if not select:
        return
    ds.select_many("gdelt", cqls)
    wall, gather = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        ds.select_many("gdelt", cqls)
        wall.append((time.perf_counter() - t0) * 1e3 / N_QUERIES)
        gather.append(ds.last_select_many["gather_ms"] / N_QUERIES)
    log(f"{label} config 2 select_many: p50 {float(np.percentile(wall, 50)):.3f} ms a query "
        f"over 3 calls (host clock); gather split p50 {float(np.percentile(gather, 50)):.3f} "
        f"ms a query (the step, its device-to-host copies and the split)")


def config9_inputs(dev):
    """Bench config 9's 50M points through ``DataStore`` and the staged
    aggregation columns: (grouped_agg arguments, the columns' extents or
    None)."""
    from geomesa_tpu_torch.planning.planner import Query
    from geomesa_tpu_torch.schema.columnar import Column, FeatureTable, point_column
    from geomesa_tpu_torch.schema.sft import AttributeType
    from geomesa_tpu_torch.store.datastore import DataStore
    from geomesa_tpu_torch.workload import (
        AGG_SPEC, bbox_time_cql, grouped_columns, make_queries, synth_gdelt)

    lon, lat, t = synth_gdelt(N_ROWS, seed=42)
    gid, vals = grouped_columns(N_ROWS, AGG_GROUPS)
    ds = DataStore(device=dev)
    sft = ds.create_schema("gagg", AGG_SPEC)
    ds.write("gagg", FeatureTable.from_columns(sft, np.arange(N_ROWS).astype("U9"), {
        "cat": Column(AttributeType.INT, gid), "val": Column(AttributeType.DOUBLE, vals),
        "dtg": Column(AttributeType.DATE, t), "geom": point_column(lon, lat)}))
    ds.compact("gagg")
    st = ds._state("gagg")
    state = st.backend_state["z3"]
    (dgid, _, keys), drowid, dvals, _ = ds._agg_residency(
        state, st.table, st.indices["z3"].perm, ["cat"], ["val"])
    cqls = [bbox_time_cql(b, w) for b, w in zip(*make_queries(N_QUERIES, seed=7))]
    pend = ds._batch_payloads(st, [Query(c) for c in cqls])
    boxes, times = (torch.from_numpy(np.stack([p[k] for _, p, _ in pend])).to(dev)
                    for k in (0, 1))
    g_pad = 1 << max(0, (len(keys) - 1).bit_length())
    args = (*state.spatial_cols(), dgid, drowid, dvals, 0, state.n, boxes, times, g_pad, 512)
    return ds, args, getattr(state, "extents", None)


def agg_timed(label: str, kernels, args, extents) -> None:
    """``grouped_agg`` at config 9 against its plain version, then timed."""
    kw = {"extents": extents} if extents is not None else {}
    got = kernels.grouped_agg(*args, **kw)
    want = kernels.grouped_agg_plain(*args)
    torch.cuda.synchronize()
    fits = want[7][:, 0] <= args[-1]
    exact = all(torch.equal(got[i], want[i]) for i in (0, 1, 2, 4, 5, 7))
    exact = exact and torch.equal(got[6][fits], want[6][fits])
    rel = float(((got[3] - want[3]).abs() / want[3].abs().clamp(min=1e-300)).max())
    if not exact or not rel <= AGG_RTOL:
        raise SystemExit(f"{label} config 9: grouped_agg disagrees with its plain version")
    ms = cuda_ms(lambda: kernels.grouped_agg(*args, **kw))
    mode = (f", {kernels.grouped_agg_mode(args[9].shape[1], args[10].shape[1], 1, args[-2])} "
            "mode" if hasattr(kernels, "grouped_agg_mode") else "")
    log(f"{label} config 9 grouped_agg: {ms:.4f} ms (CUDA events, 5 launches) at "
        f"N={args[0].shape[0]} Q={args[9].shape[0]} G={args[-2]} V=1{mode}; equal to plain "
        f"(sums within {rel:.3e}); {int(want[0].long().sum())} folded row-queries; device "
        f"time by op: " + device_breakdown(lambda: kernels.grouped_agg(*args, **kw)))


def work_list_timed(label: str, kernels, args, extents) -> None:
    """``agg_work_list`` at config 9 (the target runs ``grouped_agg`` gives
    it) against its plain version, then its wrapper by CUDA events, its
    device work and host work behind a spin, and its device ops by name."""
    boxes, times, g_pad = args[9], args[10], args[11]
    nb, nt = boxes.shape[1], times.shape[1]
    target = kernels.grouped_agg_target_runs(nb, nt, 1, g_pad, boxes.device)
    wl = (extents, args[0].shape[0], 0, args[8], boxes, times, target)
    got, want = kernels.agg_work_list(*wl), kernels.agg_work_list_plain(*wl)
    torch.cuda.synchronize()
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise SystemExit(f"{label} config 9: agg_work_list disagrees with its plain version")
    ms = cuda_ms_p50(lambda: kernels.agg_work_list(*wl))
    dev_ms, host_ms = spin_ms(lambda: kernels.agg_work_list(*wl))
    ops = device_by_op(lambda: kernels.agg_work_list(*wl), 10)
    log(f"{label} config 9 agg_work_list: wrapper {ms:.4f} ms (CUDA events, median of 5 readings "
        f"of 10 calls), device "
        f"{fmt(dev_ms)} and host {fmt(host_ms)} a call (10 calls behind a spin) over "
        f"{extents.shape[0]} chunks x {boxes.shape[0]} queries, {int(want[1].sum())} kept pairs "
        f"in {int(want[3][kernels.W_RUNS])} runs (target {target}); equal to plain; device ops "
        f"per call (torch.profiler, mean of 10 calls): {ops_line(ops)}")
    work_list_host_split(label, kernels, wl)
    # its device time against the queries and chunks it takes: what is fixed
    parts = []
    for q, c in ((1, 1), (64, 1), (1, extents.shape[0]), (8, extents.shape[0]),
                 (64, 1024), (64, extents.shape[0])):
        sub = (extents[:c], c * kernels.JOIN_BLOCK, 0, min(int(args[8]), c * kernels.JOIN_BLOCK),
               boxes[:q], times[:q], target)
        parts.append(f"Q={q} C={c} {fmt(spin_ms(lambda: kernels.agg_work_list(*sub))[0])}")
    log(f"{label} config 9 agg_work_list device time by shape (10 calls behind a spin): "
        + "; ".join(parts))


def host_us(fn, reps: int = 200) -> float:
    """Host clock per call of ``fn`` (µs, mean of ``reps`` after one), for
    host work that launches nothing."""
    import time

    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e6 / reps


def work_list_host_split(label: str, kernels, wl) -> None:
    """The parts of ``agg_work_list``'s host work on this root: its checks,
    its output allocations, the stream lookup, the device guard, and its C
    entry point alone (the launch and, where the root has them, its memsets;
    host clock behind a spin), in µs a call."""
    ext, n, base, true_n, boxes, times, target = wl
    dev, q, c = ext.device, boxes.shape[0], ext.shape[0]
    m = q + target

    def checks():
        kernels._check_extents(ext, n, dev)
        for t in (boxes, times):
            if not isinstance(t, torch.Tensor) or t.dtype != torch.int32 or t.dim() != 3 \
                    or t.shape[2] != 4 or not t.is_contiguous() or t.device != dev:
                raise SystemExit("bad payload")

    def allocs():
        return (torch.empty((q, c), dtype=torch.int32, device=dev),
                torch.empty(q, dtype=torch.int32, device=dev),
                torch.empty((3, m), dtype=torch.int32, device=dev),
                torch.empty(kernels.W_INTS, dtype=torch.int32, device=dev))

    def carved():
        out = torch.empty(q * c + q + 3 * m + kernels.W_INTS, dtype=torch.int32, device=dev)
        a, b, r, w = out.split((q * c, q, 3 * m, kernels.W_INTS))
        return a.view(q, c), b, r.view(3, m), w

    def guard():
        with torch.cuda.device(dev):
            pass

    chunks, kept, runs, work = allocs()
    fn = kernels._fn("geomesa_agg_work_list")
    stream = torch.cuda.current_stream(dev).cuda_stream
    head = [ext.data_ptr(), n, base, true_n, boxes.data_ptr(), times.data_ptr(), q,
            boxes.shape[1], times.shape[1], target, kernels.AGG_MIN_RUN, chunks.data_ptr(),
            kept.data_ptr(), runs[0].data_ptr(), runs[1].data_ptr(), runs[2].data_ptr(),
            work.data_ptr()]
    n_args = len(kernels._ENTRY_POINTS["geomesa_agg_work_list"][1])
    if n_args > 18:  # a scratch and fills
        scratch = torch.zeros(1 << 16, dtype=torch.int32, device=dev)
        head += [scratch.data_ptr(), scratch.numel()] + [None] * 8 + [0, 0, 0]
    if n_args > 31:  # the window runs' flag and cells (none: the point form's runs)
        head += [0, None]

    def entry():
        if fn(*head, stream):
            raise SystemExit("agg_work_list entry point failed")
    _, entry_ms = spin_ms(entry, 20)
    log(f"{label} config 9 agg_work_list host split (µs a call): checks "
        f"{host_us(checks):.1f}, four allocations {host_us(allocs):.1f}, one allocation and "
        f"its split {host_us(carved):.1f}, stream lookup "
        f"{host_us(lambda: kernels._stream_of(ext)):.1f}, device guard {host_us(guard):.1f}, "
        f"the C entry point {us(entry_ms)} (behind a spin: the launch and any memsets)")


def agg_split(label: str, kernels, args, extents) -> None:
    """``grouped_agg`` at config 9 behind a spin (device and host work of a
    call) and one call's device ops with their count."""
    from torch.profiler import ProfilerActivity, profile

    kw = {"extents": extents} if extents is not None else {}
    dev_ms, host_ms = spin_ms(lambda: kernels.grouped_agg(*args, **kw))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        kernels.grouped_agg(*args, **kw)
        torch.cuda.synchronize()
    names = [e.name.replace("void ", "").replace("(anonymous namespace)::", "").split("(")[0][:40]
             for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    log(f"{label} config 9 grouped_agg: device {fmt(dev_ms)} and host {fmt(host_ms)} a call "
        f"(10 calls behind a spin); one call's device ops ({len(names)}): " + ", ".join(names))


def launch_floor(label: str, kernels) -> None:
    """One empty kernel's launch by CUDA events, where the root has it."""
    if not hasattr(kernels, "launch_floor_ms"):
        log(f"{label} launch floor: not measured (this root has no empty launch)")
        return
    log(f"{label} launch floor: an empty kernel {kernels.launch_floor_ms(torch.device('cuda')):.4f}"
        " ms a launch (CUDA events over 20 launches through ctypes)")


def fused_aggregate(ds, type_name: str, cqls):
    """``aggregate_many`` by the fused path: the query cache, where the
    root's store has one, emptied first so that no call is a hit."""
    cache = getattr(ds, "agg_cache", None)
    if cache is not None:
        cache.invalidate(type_name)
    return ds.aggregate_many(type_name, cqls, group_by=["cat"], value_cols=["val"])


def agg_ops(label: str, ds) -> None:
    """One ``aggregate_many`` call of config 9's 64 queries: its device ops
    by name (kernels, memsets and copies) and their count."""
    from torch.profiler import ProfilerActivity, profile

    from geomesa_tpu_torch.workload import bbox_time_cql, make_queries

    cqls = [bbox_time_cql(b, w) for b, w in zip(*make_queries(N_QUERIES, seed=7))]

    def call():
        return fused_aggregate(ds, "gagg", cqls)

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    seen: dict[str, int] = {}
    events = sorted((e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    for e in events:
        name = e.name.replace("void ", "").replace("(anonymous namespace)::", "")
        name = name.split("(")[0].split("<")[0][:48]
        seen[name] = seen.get(name, 0) + 1
    log(f"{label} config 9 aggregate_many: one call's device ops ({len(events)}): "
        + ", ".join(f"{name} x{k}" for name, k in seen.items()))


def join_gather_timed(label: str, kernels, ds) -> None:
    """``planned_gather`` on the join's pairs, as ``join_rows_device`` makes
    them (``chip_smoke.py`` phase 8 (d)): the first 64 polygons of
    ``workload.join_polygons(seed=5)``, each its int bbox under the
    full-span window, against the z2 blocks its bbox touches, on this
    store's z2 state; held to the plain version, then timed."""
    from geomesa_tpu_torch.ops.join import polygon_block_plan
    from geomesa_tpu_torch.parallel.query import FULL_WINDOW
    from geomesa_tpu_torch.store.backends import int_boxes
    from geomesa_tpu_torch.workload import join_polygons

    st = ds._state("gagg")
    state, z2 = st.backend_state["z2"], st.indices["z2"]
    bb = np.array([g.bbox for g in join_polygons(10_000, seed=5)[:64]])
    off, blocks = polygon_block_plan(z2.zs, bb, kernels.JOIN_BLOCK, state.rows_per_shard)
    pair_q = np.repeat(np.arange(64, dtype=np.int32), np.diff(off))
    boxes = torch.from_numpy(int_boxes([tuple(b) for b in bb]).reshape(-1, 1, 4)).cuda()
    times = torch.from_numpy(np.tile(FULL_WINDOW, (64, 1)).reshape(-1, 1, 4)).cuda()
    pq, pb = (torch.from_numpy(a.astype(np.int32)).cuda() for a in (pair_q, blocks))
    args = (*state.spatial_cols(), state.n, pq, pb, boxes, times)
    got_p, got_h = kernels.planned_gather(*args)
    want_p, want_h = kernels.planned_gather_plain(*args)
    torch.cuda.synchronize()
    if not (torch.equal(got_p, want_p) and torch.equal(got_h, want_h)):
        raise SystemExit(f"{label}: planned_gather disagrees with plain on the join's pairs")
    ms = cuda_ms_p50(lambda: kernels.planned_gather(*args))
    log(f"{label} join-shaped planned_gather: {ms:.4f} ms (CUDA events, median of 5 readings of "
        f"10 calls) for "
        f"{len(pair_q)} (polygon, block) pairs over {len(np.unique(blocks))} distinct blocks of "
        f"config 9's z2 state, {int(want_h.sum())} candidates; equal to plain; device ops per "
        f"call: {ops_line(device_by_op(lambda: kernels.planned_gather(*args), 10))}")


def agg_worker(label: str, kernels, dev) -> None:
    """The ``--agg-only`` shapes (see the module docstring)."""
    ptxas_usage(kernels, label, ("grouped_agg", "planned_gather"), None)
    ds, args, extents = config9_inputs(dev)
    work_list_timed(label, kernels, args, extents)
    agg_timed(label, kernels, args, extents)
    agg_split(label, kernels, args, extents)
    agg_ops(label, ds)
    gather_timed(label, kernels, ds, "gagg", select=False)
    join_gather_timed(label, kernels, ds)
    launch_floor(label, kernels)


def planned_overlap_timed(label: str, kernels, ds, cqls, cols, n: int, boxes, times) -> None:
    """``planned_gather_overlap`` at the line store's planned pairs against
    its plain version, then the split of a call (see the module
    docstring)."""
    import time

    from geomesa_tpu_torch.parallel.query import intervals_to_block_pairs
    from geomesa_tpu_torch.planning.planner import Query, QueryPlanner

    st = ds._state("xz")
    planner = QueryPlanner(st.sft, st.indices)
    pair_q, pair_blk = intervals_to_block_pairs(
        [planner.plan(Query(c))[0].intervals for c in cqls], kernels.JOIN_BLOCK)
    pq, pb = (torch.from_numpy(a.astype(np.int32)).to(boxes.device) for a in (pair_q, pair_blk))
    plan = torch.from_numpy(np.concatenate(kernels.block_runs(pair_q, pair_blk))).to(boxes.device)
    args = (cols, n, pq, pb, boxes, times)
    got_p, got_h = kernels.planned_gather_overlap(*args, plan=plan)
    want_p, want_h = kernels.planned_gather_overlap_plain(*args)
    torch.cuda.synchronize()
    if not (torch.equal(got_p, want_p) and torch.equal(got_h, want_h)):
        raise SystemExit(f"{label} line store: planned_gather_overlap disagrees with plain")
    ms = cuda_ms_p50(lambda: kernels.planned_gather_overlap(*args, plan=plan))
    # the two passes alone, into outputs allocated here, the total read once
    n_pairs = pq.shape[0]
    n_blocks = (plan.shape[0] - 2 * n_pairs - 1) // 2
    hits = torch.empty(n_pairs, dtype=torch.int64, device=pq.device)
    ends = torch.empty(n_pairs, dtype=torch.int64, device=pq.device)
    masks = torch.empty((n_pairs, kernels.JOIN_BLOCK // 16), dtype=torch.int16, device=pq.device)
    stream = torch.cuda.current_stream(pq.device).cuda_stream
    count_fn = kernels._fn("geomesa_planned_gather_overlap_count")
    write_fn = kernels._fn("geomesa_planned_gather_write")
    count_args = ([c.data_ptr() for c in cols] + [cols[0].shape[0], int(n), plan.data_ptr(),
                  n_pairs, n_blocks, boxes.data_ptr(), times.data_ptr(), boxes.shape[0],
                  boxes.shape[1], times.shape[1], hits.data_ptr()])
    # a count pass that writes the prefix sum itself takes ends (and, in a
    # form that counts its blocks done, a zeroed counter)
    n_args = len(kernels._ENTRY_POINTS["geomesa_planned_gather_overlap_count"][1])
    fused = n_args > 19
    if n_args == 21:
        done = torch.zeros(2, dtype=torch.int32, device=pq.device)
        count_args += [ends.data_ptr(), masks.data_ptr(), done.data_ptr(), stream]
    elif fused:
        count_args += [ends.data_ptr(), masks.data_ptr(), stream]
    else:
        count_args += [masks.data_ptr(), stream]
    if count_fn(*count_args):
        raise SystemExit(f"{label}: planned_gather_overlap's count pass failed")
    if not fused:
        ends = torch.cumsum(hits, dim=0)
    positions = torch.empty(int(ends[-1]), dtype=torch.int32, device=pq.device)
    write_args = (pb.data_ptr(), n_pairs, hits.data_ptr(), ends.data_ptr(), masks.data_ptr(),
                  positions.data_ptr(), stream)

    def passes():
        if count_fn(*count_args) or write_fn(*write_args):
            raise SystemExit(f"{label}: planned_gather_overlap's passes failed")
    _, count_host = spin_ms(lambda: count_fn(*count_args))
    _, write_host = spin_ms(lambda: write_fn(*write_args))
    _, cumsum_host = spin_ms(lambda: torch.cumsum(hits, dim=0))
    checks = host_us(lambda: kernels._check_pair_args(cols, pq, pb, boxes, times))
    alloc = host_us(lambda: torch.empty(n_pairs, dtype=torch.int64, device=pq.device))
    split = (f"host split (µs a call): checks {checks:.1f}, the count entry point "
             f"{us(count_host)}, the write entry point {us(write_host)}"
             + ("" if fused else f", torch.cumsum {us(cumsum_host)}")
             + f", an allocation {alloc:.1f}")
    passes_ms, _ = spin_ms(passes)
    ops = device_by_op(lambda: kernels.planned_gather_overlap(*args, plan=plan), 10)
    wall, _, _ = host_p50(lambda: (kernels.planned_gather_overlap(*args, plan=plan),
                                   torch.cuda.synchronize()), 20)
    reads = []
    for _ in range(20):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        int(ends[-1])
        reads.append((time.perf_counter() - t0) * 1e3)
    runs = np.diff(kernels.block_runs(pair_q, pair_blk)[2])
    log(f"{label} line store planned pairs per distinct block: mean {runs.mean():.2f}, p50 "
        f"{np.percentile(runs, 50):.0f}, p99 {np.percentile(runs, 99):.0f}, max {runs.max()}, "
        f"the 10 largest {np.sort(runs)[-10:].tolist()}")
    log(f"{label} line store planned_gather_overlap: wrapper {ms:.4f} ms (CUDA events, median "
        f"of 5 readings of 10 calls), its two passes {fmt(passes_ms)} of device work (10 calls behind a spin), host "
        f"clock p50 {wall:.4f} ms a call (20 calls, each synchronised), the read of the total "
        f"alone p50 {float(np.percentile(reads, 50)):.4f} ms; {n_pairs} pairs over {n_blocks} "
        f"distinct blocks, {int(want_h.sum())} positions; equal to plain; device ops per call "
        f"(torch.profiler, mean of 10 calls): {ops_line(ops)}; {split}")


def config4_inputs(dev) -> dict:
    """Bench config 4 as ``chip_smoke.py``'s phase 8 builds it: the points
    z2-sorted on the card (``z2_encode``) as padded f32 columns, the
    polygons' vertex buckets and each bucket's block plan as pair lists.
    Returns {"x", "y", "n", "block", "buckets": [(ids, (pair_poly, pair_blk,
    verts, nverts, bbox) on the card, (verts, bbox, nverts) host arrays,
    pairs)], "tested": rows the plan tests}."""
    from geomesa_tpu_torch.curve.sfc import Z2SFC
    from geomesa_tpu_torch.ops.join import pack_polygons_bucketed, polygon_block_plan
    from geomesa_tpu_torch.ops.kernels import z2_encode
    from geomesa_tpu_torch.parallel.query import join_pairs
    from geomesa_tpu_torch.workload import join_polygons, synth_gdelt

    lon, lat, _ = synth_gdelt(JOIN_ROWS, seed=42)
    n, block = JOIN_ROWS, JOIN_BLOCK
    xi, yi = Z2SFC().normalized(lon, lat)
    zs, perm = torch.sort(z2_encode(torch.from_numpy(xi).to(dev), torch.from_numpy(yi).to(dev)),
                          stable=True)
    del xi, yi
    pad_n = -(-n // block) * block
    xs = torch.zeros(pad_n, dtype=torch.float32, device=dev)
    ys = torch.zeros(pad_n, dtype=torch.float32, device=dev)
    xs[:n] = torch.from_numpy(lon.astype(np.float32)).to(dev)[perm]
    ys[:n] = torch.from_numpy(lat.astype(np.float32)).to(dev)[perm]
    padz = np.concatenate([zs.cpu().numpy().view(np.uint64),
                           np.full(pad_n - n, 2**63, dtype=np.uint64)])
    del zs, perm, lon, lat
    buckets, tested = [], 0
    for ids, verts, bbox, nverts in pack_polygons_bucketed(join_polygons(JOIN_POLYGONS, seed=5)):
        offsets, blocks = polygon_block_plan(padz, bbox.astype(np.float64), block, pad_n)
        pairs = join_pairs(offsets, blocks, dev)
        args = (*pairs, *(torch.from_numpy(a).to(dev) for a in (verts, nverts, bbox)))
        buckets.append((ids, args, (verts, bbox, nverts), (offsets, blocks)))
        tested += len(blocks) * block
    return {"x": xs, "y": ys, "n": n, "block": block, "buckets": buckets, "tested": tested}


def join_timed(label: str, kernels, inp: dict) -> None:
    """``polygon_join`` at config 4: each bucket's kernel held to its plain
    version on the first ``JOIN_CHECKED`` polygons' pairs, the four
    launches timed together, then whole count runs on the host clock."""
    import time

    from geomesa_tpu_torch.parallel.query import block_join_step, join_pairs

    x, y, n, block = inp["x"], inp["y"], inp["n"], inp["block"]
    for ids, args, _, (offsets, blocks) in inp["buckets"]:
        m = min(JOIN_CHECKED, len(ids))
        sub = (*join_pairs(offsets[:m + 1], blocks[:offsets[m]], x.device),
               *(a[:m] for a in args[2:]))
        got = kernels.polygon_join(x, y, n, *sub, block)
        want = kernels.polygon_join_plain(x, y, n, *sub, block)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise SystemExit(f"{label} config 4: polygon_join disagrees with its plain version")
    ms = cuda_ms(lambda: [kernels.polygon_join(x, y, n, *a, block) for _, a, _, _ in
                          inp["buckets"]])
    total = sum(int(kernels.polygon_join(x, y, n, *a, block).sum()) for _, a, _, _ in
                inp["buckets"])

    def run():
        for _, args, (verts, bbox, nverts), _ in inp["buckets"]:
            block_join_step(x, y, n, args[:2], verts, bbox, nverts, block).cpu()

    run()
    runs = []
    for _ in range(5):
        t0 = time.perf_counter()
        run()
        runs.append((time.perf_counter() - t0) * 1e3)
    p50 = float(np.percentile(runs, 50))
    log(f"{label} config 4 polygon_join: {ms:.4f} ms (CUDA events, 5 runs of "
        f"{len(inp['buckets'])} launches) at N={n} K={JOIN_POLYGONS} block={block}, "
        f"{sum(len(b[3][1]) for b in inp['buckets'])} pairs; equal to plain on "
        f"{JOIN_CHECKED} polygons' pairs a bucket; {total} hits; count run p50 {p50:.3f} ms "
        f"over 5 (min {min(runs):.3f}, max {max(runs):.3f}; host clock), tested "
        f"{inp['tested'] / (p50 / 1e3) / 1e9:.4f} Gpairs/s; device time by op: "
        + device_breakdown(lambda: [kernels.polygon_join(x, y, n, *a, block)
                                    for _, a, _, _ in inp["buckets"]]))


XZ_ROWS, XZ_TILES, XZ_BATCHES = 4_000_000, 16, 20
TRACK_ROWS = 2_000_000  # bench config 10's track points
XZ_SOURCES = ("batched_overlap", "batched_edge_gather")


def ptxas_usage(kernels, label: str, sources=XZ_SOURCES, match: str | None = "overlap") -> None:
    """``nvcc -Xptxas -v`` of ``sources``: the registers, stack, spills and
    shared memory of each kernel whose name holds ``match`` (every kernel
    with None)."""
    import tempfile

    for stem in sources:
        src = kernels.CSRC / f"{stem}.cu"
        with tempfile.TemporaryDirectory() as tmp:
            log_ = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-o",
                                   str(Path(tmp) / "lib.so"), str(src)],
                                  capture_output=True, text=True, check=True).stderr
        entry = None
        for ln in log_.splitlines():
            if "Compiling entry function" in ln:
                entry = ln.split("'")[1]
                entry = entry if match is None or match in entry else None
            elif entry and ("Used" in ln or "spill" in ln):
                log(f"{label} ptxas {entry}: {ln.split(':', 1)[-1].strip()}")


def xz_columns(dev):
    """Bench config 5's bboxes normalized at 31 bits in xz2 order (codes on
    the host, a stable sort on the card), staged as ``DataStore`` stages
    them: (int32 columns padded to whole blocks, rows)."""
    from geomesa_tpu_torch.curve.normalize import lat as norm_lat, lon as norm_lon
    from geomesa_tpu_torch.curve.xz import xz2_sfc
    from geomesa_tpu_torch.parallel.residency import stage_columns
    from geomesa_tpu_torch.workload import xz_boxes

    b = xz_boxes(XZ_ROWS, 9)
    codes = xz2_sfc(12).index((b[0], b[1]), (b[2], b[3]))
    perm = torch.sort(torch.from_numpy(codes.view(np.int64)).to(dev), stable=True)
    perm = perm.indices.cpu().numpy()
    nlon, nlat = norm_lon(31), norm_lat(31)
    host = {k: norm.normalize(c).astype(np.int32)[perm]
            for k, norm, c in zip(("xmin", "ymin", "xmax", "ymax"),
                                  (nlon, nlat, nlon, nlat), b)}
    cols, _ = stage_columns(host, dev)
    return [cols[k] for k in ("xmin", "ymin", "xmax", "ymax")]


def xz_store(dev):
    """A line store shaped as ``chip_smoke.py``'s phase 9c: (the store,
    the 64 queries' CQL, the xz3 state's bbox columns, rows, boxes, times
    as the planner packs them)."""
    from geomesa_tpu_torch.planning.planner import Query, QueryPlanner
    from geomesa_tpu_torch.schema.columnar import Column, FeatureTable, linestring_column
    from geomesa_tpu_torch.schema.sft import AttributeType
    from geomesa_tpu_torch.store.datastore import DataStore
    from geomesa_tpu_torch.workload import (
        XZ_SPEC, bbox_time_cql, box_linestrings, make_queries, synth_gdelt, xz_boxes)

    coords, offsets = box_linestrings(*xz_boxes(XZ_ROWS, 9))
    cqls = [bbox_time_cql(b, w) for b, w in zip(*make_queries(N_QUERIES, 7))]
    ds = DataStore(device=dev)
    sft = ds.create_schema("xz", XZ_SPEC)
    ds.write("xz", FeatureTable.from_columns(sft, np.arange(XZ_ROWS).astype("U9"), {
        "dtg": Column(AttributeType.DATE, synth_gdelt(XZ_ROWS)[2]),
        "geom": linestring_column(coords, offsets)}))
    ds.compact("xz")
    st = ds._state("xz")
    state = st.backend_state["xz3"]
    planner = QueryPlanner(sft, st.indices)
    pays = [ds.backend.payload(sft, planner.plan(Query(c))[2].extraction, overlap=True)
            for c in cqls]
    boxes, times = (torch.from_numpy(np.ascontiguousarray(np.stack([p[k] for p in pays])))
                    .to(dev) for k in (0, 1))
    return ds, cqls, list(state.spatial_cols()), state.n, boxes, times


def bare_launch(kernels, cols, n: int, boxes, times, cap: int | None):
    """The overlap kernel's C entry point bound to its inputs and to outputs
    allocated here, launched on the current stream: no checks, no fills,
    no sort. For timing only (the outputs accumulate over launches)."""
    q = boxes.shape[0]
    outs = [torch.zeros(q, dtype=torch.int32, device=boxes.device)]
    if cap is not None:
        outs += [torch.zeros(q, dtype=torch.int32, device=boxes.device),
                 torch.full((q, cap), -1, dtype=torch.int32, device=boxes.device)]
    entry = "geomesa_batched_overlap" if cap is None else "geomesa_batched_edge_gather_overlap"
    fn = kernels._fn(entry)
    args = ([c.data_ptr() for c in cols] + [None] * (6 - len(cols))
            + [cols[0].shape[0], 0, n, boxes.data_ptr(),
               None if times is None else times.data_ptr(), q, boxes.shape[1],
               0 if times is None else times.shape[1],
               torch.cuda.get_device_properties(boxes.device).multi_processor_count]
            + [o.data_ptr() for o in outs] + ([] if cap is None else [cap])
            + [torch.cuda.current_stream(boxes.device).cuda_stream])

    def launch():
        rc = fn(*args)
        if rc:
            raise SystemExit(f"{entry}: cudaError {rc}")
    return launch


def overlap_timed(label: str, shape: str, kernels, stem: str, cols, n: int, boxes, times,
                  check: bool = True) -> None:
    """Hold ``stem`` (``batched_overlap`` or ``batched_edge_gather_overlap``)
    equal to its plain version, then time the wrapper, the bare launch and
    the device time by op."""
    cap = kernels.EDGE_CAPACITY if stem == "batched_edge_gather_overlap" else None
    extra = () if cap is None else (cap,)
    kernel, plain = getattr(kernels, stem), getattr(kernels, stem + "_plain")
    got = kernel(cols, 0, n, boxes, times, *extra)
    got = got if isinstance(got, tuple) else (got,)
    if check:
        want = plain(cols, 0, n, boxes, times, *extra)
        want = want if isinstance(want, tuple) else (want,)
        torch.cuda.synchronize()
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise SystemExit(f"{label} {shape}: {stem} disagrees with its plain version")
    ms = cuda_ms(lambda: kernel(cols, 0, n, boxes, times, *extra), 10)
    bare_ms = cuda_ms(bare_launch(kernels, cols, n, boxes, times, cap), 10)
    ops = device_by_op(lambda: kernel(cols, 0, n, boxes, times, *extra), 10)
    dev = [t for name, t in ops.items() if stem + "_kernel" in name]
    others = "; ".join(f"{name} {t:.4f} ms" for name, t in sorted(ops.items(),
                                                                   key=lambda kv: -kv[1])
                       if stem + "_kernel" not in name) or "none"
    dev_ms = f"{sum(dev):.4f} ms" if dev else "not measured (no record of the kernel)"
    log(f"{label} {shape} {stem}: wrapper {ms:.4f} ms (CUDA events, 10 calls), bare launch "
        f"{bare_ms:.4f} ms (CUDA events, 10 launches), device {dev_ms} (torch.profiler, "
        f"mean of 10 calls) at N={n} Q={boxes.shape[0]} B={boxes.shape[1]} "
        f"T={0 if times is None else times.shape[1]}; "
        f"{'equal to plain' if check else 'counts checked'}; {int(got[0].long().sum())} matches"
        + ("" if cap is None else f", {int(got[2].long().sum())} candidates")
        + f"; the wrapper's other device ops per call: {others}")


def host_p50(fn, reps: int) -> tuple[float, float, float]:
    import time

    fn()
    ms = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ms.append((time.perf_counter() - t0) * 1e3)
    return float(np.percentile(ms, 50)), min(ms), max(ms)


def overlap_worker(label: str, kernels, dev) -> None:
    """The ``--overlap-only`` shapes (see the module docstring)."""
    from geomesa_tpu_torch.parallel.query import batched_overlap_step
    from geomesa_tpu_torch.workload import make_queries, pack_query_boxes

    ptxas_usage(kernels, label)
    ptxas_usage(kernels, label, ("planned_gather",), None)
    cols = xz_columns(dev)
    boxes = torch.from_numpy(pack_query_boxes(make_queries(N_QUERIES, 7)[0],
                                              overlap=True)).to(dev)
    overlap_timed(label, "config 5", kernels, "batched_overlap", cols, XZ_ROWS, boxes, None)
    p50, lo, hi = host_p50(lambda: batched_overlap_step(cols, XZ_ROWS, boxes).cpu(), XZ_BATCHES)
    log(f"{label} config 5 batch: p50 {p50:.4f} ms over {XZ_BATCHES} (min {lo:.4f}, max "
        f"{hi:.4f}; host clock, batched_overlap_step and the counts' copy), "
        f"{p50 / N_QUERIES:.5f} ms a query")
    want = kernels.batched_overlap(cols, 0, XZ_ROWS, boxes).long() * XZ_TILES
    big = [c[:XZ_ROWS].repeat(XZ_TILES) for c in cols]
    del cols
    torch.cuda.empty_cache()
    bn = XZ_ROWS * XZ_TILES
    if not torch.equal(kernels.batched_overlap(big, 0, bn, boxes).long(), want):
        raise SystemExit(f"{label} 64M rows: batched_overlap != {XZ_TILES} x config 5's counts")
    overlap_timed(label, f"config 5 x{XZ_TILES}", kernels, "batched_overlap", big, bn, boxes,
                  None, check=False)
    del big
    torch.cuda.empty_cache()
    ds, cqls, cols, n, boxes, times = xz_store(dev)
    overlap_timed(label, "line store", kernels, "batched_overlap", cols, n, boxes, times)
    overlap_timed(label, "line store", kernels, "batched_edge_gather_overlap", cols, n, boxes,
                  times)
    for loose in (True, False):
        p50, lo, hi = host_p50(lambda: ds.count_many("xz", cqls, loose=loose), 10)
        log(f"{label} line store count_many {'loose' if loose else 'exact'}: p50 {p50:.3f} ms "
            f"over 10 (min {lo:.3f}, max {hi:.3f}; host clock; {ds.exact_fallbacks} "
            f"fallback(s) so far)")
    planned_overlap_timed(label, kernels, ds, cqls, cols, n, boxes, times)


def xz_agg_store(dev):
    """A line store as ``chip_smoke.py``'s phase 9c builds it for
    ``aggregate_many`` (see the module docstring): (the store, the 64
    queries' CQL, ``grouped_agg_overlap``'s arguments, the xz3 state's
    extents)."""
    from geomesa_tpu_torch.planning.planner import Query
    from geomesa_tpu_torch.schema.columnar import Column, FeatureTable, linestring_column
    from geomesa_tpu_torch.schema.sft import AttributeType
    from geomesa_tpu_torch.store.datastore import DataStore
    from geomesa_tpu_torch.workload import (
        XZ_AGG_SPEC, bbox_time_cql, box_linestrings, grouped_columns, make_queries, synth_gdelt,
        xz_boxes)

    coords, offsets = box_linestrings(*xz_boxes(XZ_ROWS, 9))
    gid, vals = grouped_columns(XZ_ROWS, AGG_GROUPS)
    valid = np.random.default_rng(19).random(XZ_ROWS) >= 0.1
    cqls = [bbox_time_cql(b, w) for b, w in zip(*make_queries(N_QUERIES, 7))]
    ds = DataStore(device=dev)
    sft = ds.create_schema("xz", XZ_AGG_SPEC)
    ds.write("xz", FeatureTable.from_columns(sft, np.arange(XZ_ROWS).astype("U9"), {
        "cat": Column(AttributeType.INT, gid), "val": Column(AttributeType.DOUBLE, vals, valid),
        "dtg": Column(AttributeType.DATE, synth_gdelt(XZ_ROWS)[2]),
        "geom": linestring_column(coords, offsets)}))
    ds.compact("xz")
    st = ds._state("xz")
    state = st.backend_state["xz3"]
    (dgid, _, keys), drowid, dvals, _ = ds._agg_residency(
        state, st.table, st.indices["xz3"].perm, ["cat"], ["val"])
    pend = ds._batch_payloads(st, [Query(c) for c in cqls])
    boxes, times = (torch.from_numpy(np.stack([p[k] for _, p, _ in pend])).to(dev)
                    for k in (0, 1))
    g_pad = 1 << max(0, (len(keys) - 1).bit_length())
    args = (state.spatial_cols(), dgid, drowid, dvals, 0, state.n, boxes, times, g_pad, 512)
    return ds, cqls, args, state.extents


def fold_timed(label: str, kernels, ds, cqls, args, extents) -> None:
    """``grouped_agg_overlap`` at the line store against its plain version,
    then timed (see the module docstring)."""
    got = kernels.grouped_agg_overlap(*args, extents=extents)
    want = kernels.grouped_agg_overlap_plain(*args)
    torch.cuda.synchronize()
    fits = want[7][:, 0] <= args[-1]
    exact = all(torch.equal(got[i], want[i]) for i in (0, 1, 2, 4, 5, 7))
    exact = exact and torch.equal(got[6][fits], want[6][fits])
    rel = float(((got[3] - want[3]).abs() / want[3].abs().clamp(min=1e-300)).max())
    if not exact or not rel <= AGG_RTOL:
        raise SystemExit(f"{label} line store: grouped_agg_overlap disagrees with its plain "
                         "version")
    work = kernels.grouped_agg_last_work()

    def call():
        return kernels.grouped_agg_overlap(*args, extents=extents)
    ms = cuda_ms_p50(call)
    dev_ms, host_ms = spin_ms(call)
    ops = device_by_op(call, 10)
    call()
    torch.cuda.synchronize()
    flushed = kernels.grouped_agg_last_work()["flush_atomics"]
    log(f"{label} line store grouped_agg_overlap: wrapper {ms:.4f} ms (CUDA events, median of 5 "
        f"readings of 10 calls), device {fmt(dev_ms)} and host {fmt(host_ms)} a call (10 calls "
        f"behind a spin) at N={args[5]} Q={args[6].shape[0]} G={args[8]} V=1, {work['mode']} "
        f"mode, {work['runs']} runs of up to {work['run_len']} chunks over {work['pairs']} kept "
        f"(chunk, query) pairs, {work.get('fold_runs', 1)} runs a fold block at once, "
        f"{flushed} flush atomics; equal to plain (sums within {rel:.3e}); "
        f"{int(want[0].long().sum())} folded row-queries; device ops per call (torch.profiler, "
        f"mean of 10 calls): {ops_line(ops)}")
    # the work list alone (without the fold's fills): the point form's runs and, where the
    # root has them, the window runs
    wl = (extents, args[5], 0, args[5], args[6], args[7],
          kernels.grouped_agg_target_runs(args[6].shape[1], args[7].shape[1], 1, args[8],
                                          args[6].device, True))
    forms = [("query runs", {})]
    if "overlap" in inspect.signature(kernels.agg_work_list).parameters:
        forms.append(("window runs", {"overlap": True}))
    parts = [f"{name} {fmt(spin_ms(lambda: kernels.agg_work_list(*wl, **kw))[0])}"
             for name, kw in forms]
    log(f"{label} line store agg_work_list alone (device, 10 calls behind a spin): "
        + "; ".join(parts))
    p50, lo, hi = host_p50(lambda: fused_aggregate(ds, "xz", cqls), 5)
    log(f"{label} line store aggregate_many: p50 {p50:.3f} ms over 5 (min {lo:.3f}, max "
        f"{hi:.3f}; host clock) for {len(cqls)} queries")


def track_timed(label: str, kernels, dev) -> None:
    """``track_stats`` at config 10's shape against its plain version, then
    timed (see the module docstring)."""
    from geomesa_tpu_torch.schema.columnar import Column, FeatureTable, point_column
    from geomesa_tpu_torch.schema.sft import AttributeType, parse_spec
    from geomesa_tpu_torch.store.datastore import DataStore
    from geomesa_tpu_torch.trajectory import state as tstate
    from geomesa_tpu_torch.workload import TRACK_SPEC, trajectory_workload

    lon, lat, t, tracks, _, _ = trajectory_workload(TRACK_ROWS, 16)
    ds = DataStore(device=dev)
    sft = ds.create_schema(parse_spec("tracks", TRACK_SPEC))
    ds.write("tracks", FeatureTable.from_columns(sft, np.arange(TRACK_ROWS).astype(str), {
        "track": Column(AttributeType.STRING, tracks),
        "dtg": Column(AttributeType.DATE, t.astype(np.int64)), "geom": point_column(lon, lat)}))
    ds.compact("tracks")
    st = tstate.build_track_state(ds, "tracks", "track")
    args = (*st.device_columns(dev), tstate.DEFAULT_DWELL_EPS_DEG)
    got, again = kernels.track_stats(*args), kernels.track_stats(*args)
    want = kernels.track_stats_plain(*args)
    torch.cuda.synchronize()
    worst = max(float(((g.double() - w.double()).abs()
                       / (1e-4 * w.double().abs() + 1e-3)).max()) for g, w in zip(got, want))
    if not worst <= 1:
        raise SystemExit(f"{label} config 10: track_stats disagrees with its plain version")
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    ms = cuda_ms(lambda: kernels.track_stats(*args), 20)
    dev_ms, host_ms = spin_ms(lambda: kernels.track_stats(*args))
    ops = device_by_op(lambda: kernels.track_stats(*args), 10)
    log(f"{label} config 10 track_stats: {ms:.4f} ms (CUDA events, 20 launches), device "
        f"{fmt(dev_ms)} and host {fmt(host_ms)} a call (10 calls behind a spin) at N={st.n} "
        f"E={st.n_entities}; within {worst:.4f} of the tolerance of plain; two calls "
        f"{'bit for bit equal' if same else 'differ in the last bits'}; device ops per call "
        f"(torch.profiler, mean of 10 calls): {ops_line(ops)}")


KNN_ROWS, KNN_POINTS, KNN_K = 100_000_000, 64, 10  # bench config 3 (bench.py:510)
KNN_OPS = ("sample gather", "sample select", "sample merge", "full select", "full merge")


def knn_in_order(fn, calls: int = 10) -> str:
    """Device ms of each kernel of one ``batched_knn`` call by its place in
    the call (:data:`KNN_OPS`; a call with no sample pass has the last
    two, a root whose sample pass reads the rows in place the last four),
    ``torch.profiler``, mean of ``calls`` calls."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    ev = sorted((e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                 and "knn_" in e.name), key=lambda e: e.time_range.start)
    if not ev or len(ev) % calls or len(ev) // calls not in (2, 4, 5):
        return f"not measured ({len(ev)} kernel records for {calls} calls)"
    names = KNN_OPS[-(len(ev) // calls):]  # a root with no sample gather: the last four
    out = dict.fromkeys(names, 0.0)
    for i, e in enumerate(ev):
        out[names[i % len(names)]] += (e.time_range.end - e.time_range.start) / 1e3 / calls
    return "; ".join(f"{name} {t:.4f} ms" for name, t in out.items())


def knn_timed(label: str, kernels, dev) -> None:
    """``batched_knn`` and ``knn_many`` at bench config 3 (see the module
    docstring)."""
    from geomesa_tpu_torch.parallel.query import batched_knn_step
    from geomesa_tpu_torch.process.knn import knn_many
    from geomesa_tpu_torch.schema.columnar import Column, FeatureTable, Point, point_column
    from geomesa_tpu_torch.schema.sft import AttributeType
    from geomesa_tpu_torch.store.datastore import DataStore
    from geomesa_tpu_torch.workload import SPEC, knn_points, synth_gdelt

    lon, lat, t = synth_gdelt(KNN_ROWS, seed=42)
    ds = DataStore(device=dev)
    sft = ds.create_schema("cfg3", SPEC)
    ds.write("cfg3", FeatureTable.from_columns(sft, np.arange(KNN_ROWS).astype("U9"), {
        "dtg": Column(AttributeType.DATE, t), "geom": point_column(lon, lat)}))
    ds.compact("cfg3")
    del lon, lat, t
    state = ds._state("cfg3").backend_state["z3"]
    cols = state.spatial_cols()
    pts = knn_points(KNN_POINTS)
    qx, qy = (torch.from_numpy(pts[:, i].astype(np.float32)).to(dev) for i in (0, 1))
    args = (cols[0], cols[1], 0, state.n, qx, qy, KNN_K)
    got_d, got_r = kernels.batched_knn(*args)
    want_d, want_r = kernels.batched_knn_plain(*args)
    torch.cuda.synchronize()
    if not (torch.equal(got_d.view(torch.int32), want_d.view(torch.int32))
            and torch.equal(got_r, want_r)):
        raise SystemExit(f"{label} config 3: batched_knn disagrees with its plain version")
    ms = cuda_ms(lambda: kernels.batched_knn(*args))
    dev_ms, host_ms = spin_ms(lambda: kernels.batched_knn(*args))
    log(f"{label} config 3 batched_knn: {ms:.4f} ms (CUDA events, 5 launches), device "
        f"{fmt(dev_ms)} and host {fmt(host_ms)} a call (10 calls behind a spin) at "
        f"N={state.n} Q={KNN_POINTS} k={KNN_K}; equal to plain; by kernel (torch.profiler, mean "
        f"of 10 calls): {knn_in_order(lambda: kernels.batched_knn(*args))}")
    points = [Point(*p) for p in pts]
    step = host_p50(lambda: [v.cpu() for v in batched_knn_step(cols, state.n, pts[:, 0],
                                                                  pts[:, 1], KNN_K)], 10)
    call = host_p50(lambda: knn_many(ds, "cfg3", points, k=KNN_K), 10)
    log(f"{label} config 3 knn_many: p50 {call[0]:.3f} ms a call of {KNN_POINTS} (min "
        f"{call[1]:.3f}, max {call[2]:.3f}), {call[0] / KNN_POINTS:.4f} ms a point; its step "
        f"(batched_knn_step with its uploads and copies) p50 {step[0]:.3f} ms (min "
        f"{step[1]:.3f}, max {step[2]:.3f}); host clock, 10 calls each")


def worker(label: str, out: Path, join_only: bool = False, overlap_only: bool = False,
           agg_only: bool = False, fold_only: bool = False, track_only: bool = False,
           knn_only: bool = False) -> None:
    sys.path.insert(0, os.getcwd())
    os.environ.setdefault("TEARDOWN_CUPTI", "0")  # several profiler windows in one process
    from geomesa_tpu_torch.ops import kernels

    dev = torch.device("cuda")
    if knn_only:
        ptxas_usage(kernels, label, ("batched_knn",), None)
        knn_timed(label, kernels, dev)
        return
    if fold_only or track_only:
        if fold_only:
            ptxas_usage(kernels, label, ("grouped_agg",), None)
            fold_timed(label, kernels, *xz_agg_store(dev))
            torch.cuda.empty_cache()
        if track_only:
            ptxas_usage(kernels, label, ("track_stats",), None)
            track_timed(label, kernels, dev)
        return
    if overlap_only:
        overlap_worker(label, kernels, dev)
        return
    if agg_only:
        agg_worker(label, kernels, dev)
        return
    dump_builds(kernels, label, out)
    if join_only:
        join_timed(label, kernels, config4_inputs(dev))
        return
    ds, *inputs = config2_inputs(dev)
    batch_p50(label, ds)
    timed(label, "config 2", kernels, "batched_count", *inputs)
    timed(label, "config 2", kernels, "batched_edge_gather", *inputs)
    cols, boxes, times, n = inputs
    perm = torch.randperm(n, generator=torch.Generator().manual_seed(5)).to(dev)
    shuffled = [torch.cat([c[:n][perm], c[n:]]) for c in cols]
    timed(label, "config 2 shuffled", kernels, "batched_edge_gather", shuffled, boxes, times, n)
    gather_timed(label, kernels, ds)
    del ds, inputs, cols, shuffled
    torch.cuda.empty_cache()
    ds, args, extents = config9_inputs(dev)
    agg_timed(label, kernels, args, extents)
    del ds, args, extents
    torch.cuda.empty_cache()
    for shape, make in (("config 8 chunk", stream_inputs),
                        ("dense random", lambda d: dense_inputs(d, world=False)),
                        ("dense world", lambda d: dense_inputs(d, world=True))):
        timed(label, shape, kernels, "batched_count_hits", *make(dev))
        torch.cuda.empty_cache()
    join_timed(label, kernels, config4_inputs(dev))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="*", help="checkouts of this repo, in the order to run")
    ap.add_argument("--out", default="chiprun_out/count_ab")
    ap.add_argument("--join-only", action="store_true",
                    help="time polygon_join at bench config 4 and nothing else")
    ap.add_argument("--overlap-only", action="store_true",
                    help="time the bbox-overlap kernels at bench config 5 and a line store, "
                         "and nothing else")
    ap.add_argument("--agg-only", action="store_true",
                    help="time agg_work_list, grouped_agg and planned_gather at bench config 9's "
                         "points, and nothing else")
    ap.add_argument("--fold-only", action="store_true",
                    help="time grouped_agg_overlap at a phase-9c line store, and nothing else")
    ap.add_argument("--track-only", action="store_true",
                    help="time track_stats at bench config 10, and nothing else")
    ap.add_argument("--knn-only", action="store_true",
                    help="time batched_knn and knn_many at bench config 3, and nothing else")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    out = Path(args.out).resolve()
    if args.worker:
        return worker(args.worker, out, args.join_only, args.overlap_only, args.agg_only,
                      args.fold_only, args.track_only, args.knn_only)
    if not args.roots:
        ap.error("give at least one ROOT")
    log("card: " + subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    for i, root in enumerate(args.roots):
        label = f"run{i + 1}:{Path(root).resolve().name}"
        subprocess.run([sys.executable, str(Path(__file__).resolve()), "--worker", label,
                        "--out", str(out / f"run{i + 1}")]
                       + (["--join-only"] if args.join_only else [])
                       + (["--overlap-only"] if args.overlap_only else [])
                       + (["--agg-only"] if args.agg_only else [])
                       + (["--fold-only"] if args.fold_only else [])
                       + (["--track-only"] if args.track_only else [])
                       + (["--knn-only"] if args.knn_only else []), cwd=root, check=True)
    only = (args.join_only or args.overlap_only or args.agg_only or args.fold_only
            or args.track_only or args.knn_only)
    for stem in () if only else SAME_SASS:
        first = sass_instructions(out / "run1" / f"{stem}.sass")
        for i in range(2, len(args.roots) + 1):
            same = sass_instructions(out / f"run{i}" / f"{stem}.sass") == first
            log(f"{stem} SASS of run{i} vs run1: "
                f"{'identical' if same else 'DIFFERS'} ({len(first)} instructions)")


def sass_instructions(path: Path) -> list[str]:
    """The instruction lines of a ``cuobjdump -sass`` listing, without the
    header lines that name the library file."""
    return [ln.split("*/", 1)[1].strip() for ln in path.read_text().splitlines()
            if ln.strip().startswith("/*") and "*/" in ln
            and ln.split("*/", 1)[1].strip()]


if __name__ == "__main__":
    main()
