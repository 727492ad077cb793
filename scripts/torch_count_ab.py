"""Time the port's two count kernels and its edge gather of several
checkouts against each other in one run on a CUDA card.

    python3 scripts/torch_count_ab.py ROOT [ROOT ...] [--out DIR]

Each ROOT is a checkout of this repo: ``.``, or another commit unpacked with
``git archive`` into an ignored directory. The roots run one after another
in the order given (for two versions: parent, change, change, parent), each
in a process of its own that imports that root's ``geomesa_tpu_torch``, so
every root builds its kernels with its own ``build_kernels()`` and launches
them through its own wrappers. A process holds each kernel equal to its
plain version, times it with CUDA events (5 launches after a warm-up) and
prints one line per shape:

- ``batched_count`` at bench config 2: 50M GDELT-shaped points through
  ``DataStore`` and the 64 city-box 2-7 day queries as ``DataStore`` packs
  them (B = 8, T = 16);
- ``batched_edge_gather`` at the same shape, first on the resident rows in
  z3 order, then on the same rows in a seeded random order (``config 2
  shuffled``: no chunk is culled);
- ``DataStore.count_many`` of the 64 queries, loose and exact, p50 of 10
  calls each on the host clock (the end-to-end batch, host work included);
- ``batched_count_hits`` at one of bench config 8's 60M-row chunks and its 64
  city boxes under one full-span window (B = T = 1, sparse matches);
- ``batched_count_hits`` at two dense payloads over 60M seeded random rows
  (B = T = 1): ``random``, one random box and window per query, and
  ``world``, a box and a window that hold every row.

Each kernel's resource usage (``cuobjdump -res-usage``: registers, and
stack and local memory, where spills would show) is printed, and its SASS
written to ``--out`` (default ``chiprun_out/count_ab``), one folder per run.
At the end the count kernels' SASS of every run is compared with the first
run's, instruction by instruction.
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

STEMS = ("batched_count", "batched_count_hits", "batched_edge_gather")
COUNT_STEMS = STEMS[:2]  # their SASS must not change
N_ROWS, STREAM_ROWS, N_QUERIES, STREAM_CHUNKS = 50_000_000, 60_000_000, 64, 17
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


def worker(label: str, out: Path) -> None:
    sys.path.insert(0, os.getcwd())
    from geomesa_tpu_torch.ops import kernels

    dev = torch.device("cuda")
    dump_builds(kernels, label, out)
    ds, *inputs = config2_inputs(dev)
    batch_p50(label, ds)
    timed(label, "config 2", kernels, "batched_count", *inputs)
    timed(label, "config 2", kernels, "batched_edge_gather", *inputs)
    cols, boxes, times, n = inputs
    perm = torch.randperm(n, generator=torch.Generator().manual_seed(5)).to(dev)
    shuffled = [torch.cat([c[:n][perm], c[n:]]) for c in cols]
    timed(label, "config 2 shuffled", kernels, "batched_edge_gather", shuffled, boxes, times, n)
    del ds, inputs, cols, shuffled
    torch.cuda.empty_cache()
    for shape, make in (("config 8 chunk", stream_inputs),
                        ("dense random", lambda d: dense_inputs(d, world=False)),
                        ("dense world", lambda d: dense_inputs(d, world=True))):
        timed(label, shape, kernels, "batched_count_hits", *make(dev))
        torch.cuda.empty_cache()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="*", help="checkouts of this repo, in the order to run")
    ap.add_argument("--out", default="chiprun_out/count_ab")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    out = Path(args.out).resolve()
    if args.worker:
        return worker(args.worker, out)
    if not args.roots:
        ap.error("give at least one ROOT")
    log("card: " + subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    for i, root in enumerate(args.roots):
        label = f"run{i + 1}:{Path(root).resolve().name}"
        subprocess.run([sys.executable, str(Path(__file__).resolve()), "--worker", label,
                        "--out", str(out / f"run{i + 1}")], cwd=root, check=True)
    for stem in COUNT_STEMS:
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
