"""Hand-written CUDA kernels, their build, their bindings and plain versions.

``batched_count`` replaces the Pallas kernel
``geomesa_tpu/ops/pallas_kernels.py:150`` (``batched_count`` →
``_count_kernel`` :95, predicate ``_tile_mask`` :46): Q bbox+time count
queries over the resident int32 columns in one pass. Its source is
``csrc/batched_count.cu``; the note there gives the bound (integer
instructions per row, query and live slot, above the 16 B/row of column
reads) and what the design does about it.

``batched_count_hits`` replaces ``pallas_kernels.py:217``
(``batched_count_hits`` → ``_count_hits_kernel`` :118): the same counts plus
the newest matched global row per 128-row lane, the subscription matrix's
fused scan. Its source is ``csrc/batched_count_hits.cu``.

Both count kernels run the staged predicate and row scan of
``csrc/count_predicate.cuh``. Each block stages its query tile once in
shared memory, keeping only the live slots (a box is live iff ``xlo <= xhi
and ylo <= yhi``, a window iff ``(blo, olo) <= (bhi, ohi)``; a dead slot
matches no row, so dropping it is exact for any payload) and only the
queries with a live box and a live window. A box is staged as ``(xlo, xhi -
xlo, ylo, yhi - ylo)`` and tested as ``(uint32)(x - xlo) <= (uint32)(xhi -
xlo)`` per axis; ``(bin, off)`` becomes the 64-bit key ``bin << 32 |
(uint32)(off ^ 0x80000000)``, whose signed order is the lexicographic order
of the pairs (negative offsets included), and a window is two compares of
such keys. A thread holds 16 consecutive rows per column (16-byte loads);
a tile whose active queries have one live box and one live window each runs
a compile-time single-slot row loop, any other tile the general one
(:func:`path_blocks` counts the blocks that took each).

``batched_edge_gather`` replaces no TPU kernel: the reference computes it
in XLA (``geomesa_tpu/parallel/query.py:342``,
``make_batched_edge_gather_step``). It is written by hand because its eager
torch form would do at least ``batched_count_plain``'s work. One pass gives
``batched_count``'s counts and each query's edge candidates, the rows where
the int-domain count and the f64 predicate can differ: the device half of
the exact batched ``count_many``. Its source is
``csrc/batched_edge_gather.cu``, on the same staged predicate; it culls
per 4096-row chunk the queries whose live slots cannot meet the chunk's
extent (``csrc/chunk_cull.cuh``; :func:`chunk_query_pairs` is the cull's
plain version).

``planned_gather`` replaces no TPU kernel either: the reference computes it
in XLA (``geomesa_tpu/parallel/query.py:820``, ``make_planned_gather_step``).
It is ``select_many``'s batched row retrieval over planned (query, block)
pairs: a count pass with one 256-thread block per distinct block of the
pairs (each block's rows read once; each pair's 512 B match mask kept for
the next pass) with a one-block scan of the counts after it, and a write
pass with one block per pair that reads only its mask. Its source is
``csrc/planned_gather.cu``; its plain version (:func:`planned_gather_plain`)
is the eager torch form it replaced.

``grouped_agg`` replaces no TPU kernel either: the reference computes it in
XLA (``geomesa_tpu/parallel/query.py:1498``, ``make_grouped_agg_step``,
whose MXU bincount ``_onehot_bincount`` :1464 this card does with
atomics). It is ``aggregate_many``'s fused GROUP BY: the edge gather's
match and edge split, whose boundary rows go to lanes for the host's exact
re-test while every other matching row folds into its group (count, first
row, and per value column count, sum, min and max). Its source is
``csrc/grouped_agg.cu``: a work-list kernel (:func:`agg_work_list`, whose
plain version builds on :func:`chunk_query_pairs`) lists each query's kept
4096-row chunks from the columns' cached extents (:func:`chunk_extents`)
and cuts them into runs; the fold takes one run at a time, one query a
block, and folds into that query's group partials in shared memory, then
adds them to the outputs with one global atomic per touched group and
field (a G x V too large for shared memory folds with global atomics
instead: :func:`grouped_agg_mode`). The overlap form
(:func:`grouped_agg_overlap`, a line or polygon store's bbox columns) cuts
the runs at aligned windows of ``AGG_WINDOW`` chunks in (window, query)
order, and its fold takes up to ``AGG_FOLD_K`` runs a block, reading each
chunk once for all of them. Its note gives the bound (bytes); its plain
version (:func:`grouped_agg_plain`) is torch ``index_add_`` /
``scatter_reduce_``.

``batched_density`` replaces no TPU kernel either: the reference computes it
in XLA (``geomesa_tpu/parallel/query.py:1193``, ``make_batched_density_step``,
whose TPU form counts with one-hot matmuls on the MXU). It is the density
heatmap of ``density_many``: per query, every row matching its live slots
adds 1.0 to its cell of the query's own grid, the cell computed in f32 as
the reference computes it (:func:`density_cells`). Its source is
``csrc/batched_density.cu``, the edge gather's culled chunk scan with one
global atomic per match; its plain version (:func:`batched_density_plain`)
is the reference's scatter form in torch.

``batched_knn`` replaces no TPU kernel either: the reference computes it in
XLA (``geomesa_tpu/parallel/query.py:1125``, ``make_batched_knn_step``, and
the ring merge of ``make_ring_knn_step`` :1295, which on one card has no
hop). Per query point, the k rows nearest in f32 degrees, ties to the lower
row. Its source is ``csrc/batched_knn.cu``: blocks over grid-strided
chunks of rows keep per-query sorted lists in shared memory behind a bound,
capped from the start by the k-th distance of a strided sample of the rows,
and skip each (256-row tile, query) pair whose least distance over the
tile's extent exceeds it (:func:`knn_tile_keep_plain` models the rule); a
merge launch joins the blocks' lists. Its plain version
(:func:`batched_knn_plain`) is the reference's ``map`` form, one query at a
time.

``polygon_join`` replaces no TPU kernel either: the reference computes it
in XLA (``geomesa_tpu/ops/join.py:357``, ``make_block_join_step``, over the
f32 crossing number ``_membership`` :56, which ``points_in_polygons_count``
:77 maps over every point). Per polygon, the resident f32 points strictly
inside it, over the row blocks its plan names (or every block). Its source
is ``csrc/polygon_join.cu``: a CTA per work item (a run of pairs that
share a block, whose tile of rows it stages in shared memory once, in y
order: :func:`staged_tile`), the rows inside each polygon's bbox
compacted, and each tested only against the edges of its y-band
(:func:`polygon_bands_plain` builds the same lists); its plain version
(:func:`polygon_join_plain`) is the reference's crossing number in torch,
chunked.

``batched_overlap`` replaces no TPU kernel either: the reference computes it
in XLA (``geomesa_tpu/parallel/query.py:914``, ``make_batched_overlap_step``,
in both its forms). It is the bbox-overlap count of an extended-geometry
store over its per-feature int32 bounds (xmin, ymin, xmax, ymax), with or
without the time columns: bench config 5's step and the loose
``count_many`` of a line or polygon store. Its source is
``csrc/batched_overlap.cu``, a culled chunk scan over the bbox columns
(``csrc/overlap_cull.cuh``); its plain version
(:func:`batched_overlap_plain`) runs :func:`overlap_masks`. The overlap
forms of the edge gather (:func:`batched_edge_gather_overlap`, launches
counted as ``batched_edge_gather_overlap``; ``make_batched_edge_gather_step
(overlap=True)``) and of the planned gather
(:func:`planned_gather_overlap`, counted as ``planned_gather_overlap``;
``make_planned_gather_step(..., overlap=True)``) are second instances in
``csrc/batched_edge_gather.cu`` and ``csrc/planned_gather.cu`` over the
same predicate. A box slot of the overlap predicate is live iff ``xlo <=
xhi and ylo <= yhi``, in the kernels and in the plain versions alike. The
scan of ``batched_overlap`` and of the overlap edge gather runs 512-thread
blocks over a two-chunk ring, each warp culling the queries on its own 256
rows of a chunk (:func:`overlap_warp_pairs` is the cull's plain version);
the edge gather tests a warp's rows for edge candidates only where
:func:`overlap_edge_possible` (its plain version) allows one, and both edge
gathers sort their lanes on the card.

``planned_count`` replaces no TPU kernel either: the reference computes it
in XLA (``geomesa_tpu/parallel/query.py:716``, ``make_planned_count_step``,
point and overlap forms). It is bench config 7's index-pruned resident
count: per (query, block) pair, the rows of the block that pass the query,
added into the query's count. Its source is ``csrc/planned_count.cu``: one
CTA per pair over 1024- or 4096-row blocks, the query staged by
``count_predicate.cuh``'s ``stage_tile`` and tested by its (or
``overlap_cull.cuh``'s) row masks, one atomic a CTA; its plain version
(:func:`planned_count_plain`) gathers each pair's block and runs
:func:`row_masks` or :func:`overlap_masks` in chunks.

``corridor_masks`` replaces no TPU kernel either: the reference computes it
in XLA (``geomesa_tpu/parallel/query.py:1371``, ``make_corridor_step``). It
is the corridor engine's fused pass: per (corridor, row), the f32 clamped
point-to-segment distance against two bands, the (bin, offset) time window
of each segment and the heading test, into the ``cand`` and ``sure`` masks,
packed one bit a (corridor, row) into 32-bit words
(:func:`unpack_mask_words` turns them back into bools). Its source is
``csrc/corridor_masks.cu``, in two entry forms: the row form
(:func:`corridor_masks`) over f32 rows, and the gather form
(:func:`corridor_masks_gather`) over a point state's resident int32 columns
read through candidate positions and dequantized by one rule
(:func:`corridor_dequantize`). Four rows a thread, the corridors staged in
shared memory, a warp's ballot a word, the f32 arithmetic in
round-to-nearest intrinsics in the plain version's order, so that the
words equal its plain versions' (:func:`corridor_masks_plain`, the
reference's per-corridor map in torch, and
:func:`corridor_masks_gather_plain`) bit for bit.

``track_stats`` replaces no TPU kernel either: the reference computes it in
XLA (``geomesa_tpu/trajectory/state.py:364``, ``cached_track_stats_step``).
Per entity of a track layout (rows sorted by entity and time, CSR offsets),
the sums of step length, step duration, heading change between consecutive
moving steps and dwell time. Its source is ``csrc/track_stats.cu``: a
segmented reduction over tiles of ``TRACK_TILE`` sorted rows, each entity's
sums written once by the tile holding its last row, the carry across tiles
by a look-back, the step distance in round-to-nearest intrinsics in the
plain version's order (:func:`track_stats_tiles_plain` models the tiles);
its plain version (:func:`track_stats_plain`) is the reference's step in
torch, ``index_add_`` for the segment sums.

``z3_encode`` and ``z2_encode`` replace ``pallas_kernels.py:380`` and
``:393`` (``_elementwise_call`` :357 → ``_z3_kernel`` :340 /
``_z2_kernel`` :349): the Morton interleave of normalized int32 coordinates
into int64 curve keys, the index builds' encode. Their source is
``csrc/morton_encode.cu``; its note gives the bound (bytes: 12 or 8 B read
and 8 B written per row).

Build: every ``csrc/*.cu`` is compiled with ``nvcc -gencode
arch=compute_90a,code=sm_90a -O3 -shared`` into ``_build/`` (git-ignored) at
first use, one ``nvcc`` per source, all started together, and loaded with
``ctypes`` (a plain C entry point, pointers and the stream as ``c_void_p``).
A library's name carries a digest of its source, every ``csrc/*.cuh`` and
the flags, so an edit to a shared header rebuilds every kernel. Nothing is
built at import.

Dispatch: a CUDA tensor launches the kernel or raises (a build failure, a
refused launch, a non-zero ``cudaGetLastError`` and, for the kernels that
load 16-byte vectors (all but the Morton encodes), a column or payload that
does not start on a 16-byte boundary are all errors); the plain PyTorch
version runs only for tensors on the CPU.
``launches`` counts kernel launches per kernel name, incremented only where
a launch happens.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import math
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np
import torch

# Rows per block of the resident layout and per chunk of every row-scan
# kernel: csrc/count_predicate.cuh CHUNK (THREADS x ROWS), which
# csrc/planned_gather.cu ties to its JOIN_BLOCK by a static_assert
# (reference geomesa_tpu/store/backends.py:36). parallel/residency.py pads
# to it.
JOIN_BLOCK = 4096

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD = PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

launches = {"batched_count": 0, "batched_count_hits": 0, "batched_edge_gather": 0,
            "planned_gather": 0, "agg_work_list": 0, "grouped_agg": 0, "batched_density": 0,
            "batched_knn": 0, "polygon_join": 0, "z3_encode": 0, "z2_encode": 0,
            "batched_overlap": 0, "batched_edge_gather_overlap": 0,
            "planned_gather_overlap": 0, "planned_count": 0, "corridor_masks": 0,
            "corridor_masks_gather": 0, "grouped_agg_overlap": 0, "track_stats": 0}

_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
# entry point → (source stem, argtypes); every entry point returns a C int
_COUNT_ARGS = [_P] * 4 + [_LL] * 3 + [_P, _P, _I, _I, _I, _I]
# (bbox columns x6, n, base, true_n, boxes, times, q, nb, nt, sms, counts)
_BOX_ARGS = [_P] * 6 + [_LL] * 3 + [_P, _P, _I, _I, _I, _I, _P]
_ENTRY_POINTS = {
    # (columns x4, n, base, true_n, boxes, times, q, nb, nt, sms, outputs..., stream)
    "geomesa_batched_count": ("batched_count", _COUNT_ARGS + [_P] * 2),
    "geomesa_batched_count_hits": ("batched_count_hits", _COUNT_ARGS + [_P] * 3),
    # (..., counts, hits, positions, capacity, stream)
    "geomesa_batched_edge_gather": ("batched_edge_gather", _COUNT_ARGS + [_P] * 3 + [_I, _P]),
    # (box slots, time slots) → queries per shared-memory tile
    "geomesa_batched_count_q_tile": ("batched_count", [_I, _I]),
    "geomesa_batched_count_hits_q_tile": ("batched_count_hits", [_I, _I]),
    "geomesa_batched_edge_gather_q_tile": ("batched_edge_gather", [_I, _I]),
    # (host out: 2 x uint64) → blocks per row-loop path since the last call
    "geomesa_batched_count_path_blocks": ("batched_count", [_P]),
    "geomesa_batched_count_hits_path_blocks": ("batched_count_hits", [_P]),
    "geomesa_batched_edge_gather_path_blocks": ("batched_edge_gather", [_P]),
    # (columns x4, n, true_n, block-major plan, pairs, distinct blocks, boxes, times,
    #  q, nb, nt, pair_hits, ends (their inclusive prefix sums), masks, stream)
    "geomesa_planned_gather_count": ("planned_gather", [_P] * 4 + [_LL, _LL, _P, _LL, _LL, _P,
                                                        _P, _I, _I, _I] + [_P] * 4),
    # (pair_blk, pairs, pair_hits, their inclusive prefix sums, masks, positions, stream)
    "geomesa_planned_gather_write": ("planned_gather", [_P, _LL] + [_P] * 5),
    # (extents, n, base, true_n, boxes, times, q, nb, nt, target runs, min run,
    #  chunks, kept, run_q, run_s, run_e, work, scratch, scratch ints, the fold's
    #  cnt, first, vcnt, vsum, vmin, vmax, hits, positions to fill (or null),
    #  values, groups, capacity, window (0: query runs), cells, stream)
    "geomesa_agg_work_list": ("grouped_agg", [_P, _LL, _LL, _LL, _P, _P] + [_I] * 5
                              + [_P] * 7 + [_LL] + [_P] * 8 + [_I] * 4 + [_P, _P]),
    # (stream): one empty kernel, the launch floor
    "geomesa_empty_launch": ("grouped_agg", [_P]),
    # (..., chunks, run_q, run_s, run_e, work, gid, rowid, vals, cnt, first, vcnt, vsum,
    #  vmin, vmax, hits, positions, values, groups, capacity, stream)
    "geomesa_grouped_agg": ("grouped_agg", _COUNT_ARGS + [_P] * 16 + [_I] * 3 + [_P]),
    # (bbox columns x6, n, base, true_n, boxes, times, q, nb, nt, sms, then as above)
    "geomesa_grouped_agg_overlap": ("grouped_agg", _BOX_ARGS[:-1] + [_P] * 16 + [_I] * 3
                                    + [_P]),
    # (nb, nt, values, groups, overlap?) → 1 for the shared-memory fold, 0 for the global one
    "geomesa_grouped_agg_mode": ("grouped_agg", [_I] * 5),
    # (nb, nt, values, groups, overlap?) → the runs a fold block takes at once
    "geomesa_grouped_agg_fold_runs": ("grouped_agg", [_I] * 5),
    # (nb, nt, values, groups, sms, overlap?, host out: 1 x int) → runs the work list aims at
    "geomesa_grouped_agg_target_runs": ("grouped_agg", [_I] * 6 + [_P]),
    # (shared mode?, overlap?, host out: 2 x int) → registers and local-memory bytes per thread
    "geomesa_grouped_agg_attrs": ("grouped_agg", [_I, _I, _P]),
    # (..., grid_bounds, grids, width, height, stream)
    "geomesa_batched_density": ("batched_density", _COUNT_ARGS + [_P] * 2 + [_I, _I, _P]),
    "geomesa_batched_density_q_tile": ("batched_density", [_I, _I]),
    # (n, q, k, sms, host out: 1 x int) → the row segments of a launch
    "geomesa_batched_knn_segments": ("batched_knn", [_LL, _I, _I, _I, _P]),
    # (x, y, n, base, true_n, qx, qy, q, k, segments, scratch d, scratch rows, scratch cap,
    #  scratch sample, its rows a column, dist, rows, stream)
    "geomesa_batched_knn": ("batched_knn", [_P, _P, _LL, _LL, _LL, _P, _P, _I, _I, _I]
                            + [_P] * 4 + [_LL] + [_P] * 3),
    # (x, y, n, true_n, pair_poly, pair_blk, pairs, verts, V, nverts, bbox, K, block,
    #  counts, stream)
    "geomesa_polygon_join": ("polygon_join", [_P, _P, _LL, _LL, _P, _P, _LL, _P, _I, _P, _P, _I,
                                              _I, _P, _P]),
    # (xmin, ymin, xmax, ymax, bins, offs, n, base, true_n, boxes, times, q, nb, nt
    #  (0: no time), sms, counts, stream)
    "geomesa_batched_overlap": ("batched_overlap", _BOX_ARGS + [_P]),
    "geomesa_batched_overlap_q_tile": ("batched_overlap", [_I, _I]),
    # (..., counts, hits, positions, capacity, stream)
    "geomesa_batched_edge_gather_overlap": ("batched_edge_gather",
                                            _BOX_ARGS[:-1] + [_P] * 3 + [_I, _P]),
    # (bbox columns x6, n, true_n, block-major plan, pairs, distinct blocks, boxes, times,
    #  q, nb, nt, pair_hits, ends, masks, stream)
    "geomesa_planned_gather_overlap_count": ("planned_gather", [_P] * 6 + [_LL, _LL, _P, _LL,
                                                                          _LL, _P, _P, _I, _I,
                                                                          _I] + [_P] * 4),
    # (columns x6 (x, y, bins, offs, -, - or the bbox form's six), n, true_n, pair_q,
    #  pair_blk, pairs, boxes, times, q, nb, nt, block_rows, overlap?, counts, stream)
    "geomesa_planned_count": ("planned_count", [_P] * 6 + [_LL, _LL, _P, _P, _LL, _P, _P]
                              + [_I] * 5 + [_P, _P]),
    # (cx, cy, bins, offs, hdg, n, segs, tq, brg, buf2_lo, buf2_hi, tol_lo, tol_hi, q, s,
    #  heading?, bidirectional?, cand words, sure words, stream)
    "geomesa_corridor_masks": ("corridor_masks", [_P] * 5 + [_LL] + [_P] * 7 + [_I] * 4
                               + [_P] * 3),
    # (x, y, bins, offs, positions, hdg, n candidates, segs, ..., the same as above)
    "geomesa_corridor_masks_gather": ("corridor_masks", [_P] * 6 + [_LL] + [_P] * 7
                                      + [_I] * 4 + [_P] * 3),
    # (x, y, dt, offsets, n, entities, dwell_eps, out (4, E), scratch, scratch ints, epoch,
    #  stream)
    "geomesa_track_stats": ("track_stats", [_P] * 4 + [_LL, _I, ctypes.c_float, _P, _P, _LL,
                                                       _I, _P]),
    # (coordinate columns..., n, sms, out, stream)
    "geomesa_z3_encode": ("morton_encode", [_P] * 3 + [_LL, _I, _P, _P]),
    "geomesa_z2_encode": ("morton_encode", [_P] * 2 + [_LL, _I, _P, _P]),
}

_LIBS: dict[str, ctypes.CDLL] = {}
_FNS: dict[str, object] = {}
_LOCK = threading.Lock()

def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
        shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"
    ]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _lib_path(src: Path) -> Path:
    """The library built from ``src``: its name hashes the source, every
    header under ``csrc/`` (a source may include any of them) and the flags."""
    digest = hashlib.sha256(src.read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        digest.update(hdr.name.encode() + b"\0" + hdr.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD / f"lib{src.stem}-{digest.hexdigest()[:12]}.so"


def build_kernels() -> dict[str, Path]:
    """Compile every ``csrc/*.cu`` that has no up-to-date library yet, in
    parallel; returns {source stem: library path}. Raises on any failure."""
    BUILD.mkdir(parents=True, exist_ok=True)
    out = {src.stem: _lib_path(src) for src in sorted(CSRC.glob("*.cu"))}
    todo = []
    for src in sorted(CSRC.glob("*.cu")):
        lib = out[src.stem]
        if not lib.exists():
            tmp = lib.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            todo.append((src, tmp, lib, proc))
    errors = []
    for src, tmp, lib, proc in todo:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {src.name} (rc {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, lib)
    if errors:
        raise RuntimeError("\n".join(errors))
    return out


def _fn(entry: str):
    """The bound C entry point ``entry``, its library built at first use."""
    with _LOCK:
        fn = _FNS.get(entry)
        if fn is None:
            stem, argtypes = _ENTRY_POINTS[entry]
            lib = _LIBS.get(stem)
            if lib is None:
                lib = _LIBS[stem] = ctypes.CDLL(str(build_kernels()[stem]))
            fn = getattr(lib, entry)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _FNS[entry] = fn
        return fn


_RAW_STREAM = getattr(torch._C, "_cuda_getCurrentRawStream", None)  # absent without CUDA


def _stream_of(t: torch.Tensor) -> int:
    """The handle of the current stream of ``t``'s card, read without
    making a ``torch.cuda.Stream`` object where torch offers that."""
    if _RAW_STREAM is not None:
        return _RAW_STREAM(t.device.index)
    return torch.cuda.current_stream(t.device).cuda_stream


def _on_device(dev: torch.device):
    """The device guard of a launch: none where ``dev`` is current already
    (a guard's enter and exit cost more host time than a small launch)."""
    return (contextlib.nullcontext() if torch.cuda.current_device() == dev.index
            else torch.cuda.device(dev))


_SCRATCH: dict = {}  # (device index, stream) → the work list's self-clearing int32 scratch
_SCRATCH_LOCK = threading.Lock()


def _stream_scratch(dev: torch.device, stream: int, ints: int) -> torch.Tensor:
    """An int32 scratch of at least ``ints`` on ``dev`` for the kernels
    launched on ``stream``: zeroed when allocated, and every launch that
    uses it leaves it zeroed, so launches on one stream (which run one
    after another) share it. A launch that needs more replaces it with a
    larger zeroed one."""
    key = (dev.index, stream)
    buf = _SCRATCH.get(key)
    if buf is None or buf.numel() < ints:
        with _SCRATCH_LOCK:
            buf = _SCRATCH.get(key)
            if buf is None or buf.numel() < ints:
                buf = _SCRATCH[key] = torch.zeros(max(ints, 1024), dtype=torch.int32,
                                                  device=dev)
    return buf


def launch_floor_ms(device, launches: int = 20) -> float:
    """The CUDA-event time of one empty kernel's launch through this
    module's ctypes path on ``device`` (mean of ``launches`` after a
    warm-up): the floor under any launch-bound kernel here. For
    measurements; nothing on a path calls it."""
    dev = torch.device(device)
    fn = _fn("geomesa_empty_launch")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for _ in range(2):
            if fn(stream):
                raise RuntimeError("empty launch failed")
        torch.cuda.synchronize(dev)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            if fn(stream):
                raise RuntimeError("empty launch failed")
        end.record()
        torch.cuda.synchronize(dev)
    return start.elapsed_time(end) / launches


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    """The card's SMs (asked once per device: the launches size their grids
    by it)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


# ---------------------------------------------------------------------------
# batched_count
# ---------------------------------------------------------------------------


def q_tile_for(box_slots: int, time_slots: int, kernel: str = "batched_count") -> int:
    """Queries whose staged payload one block of ``kernel`` holds in shared
    memory at once (larger batches tile over Q). The launch geometry and the
    staged bytes per query live in the kernel's sources alone; this asks the
    built library."""
    return _fn(f"geomesa_{kernel}_q_tile")(box_slots, time_slots)


def path_blocks(kernel: str = "batched_count") -> tuple[int, int]:
    """Blocks of ``kernel`` that ran its single-slot row loop and its
    general row loop since the last call (then zeroed); blocks with no
    active query ran neither. Reads the card's counters, so it synchronises
    the device. The counters are one pair per kernel library, summed over
    every launch on every stream and thread: a reading is one caller's only
    while nothing else launches ``kernel`` (a running stream scanner and a
    ``count_many`` on the same card would mix their blocks)."""
    out = (ctypes.c_ulonglong * 2)()
    rc = _fn(f"geomesa_{kernel}_path_blocks")(ctypes.addressof(out))
    if rc != 0:
        raise RuntimeError(f"{kernel} path counters: cudaError {rc}")
    return int(out[0]), int(out[1])


def _check_count_args(x, y, bins, offs, boxes, times):
    cols = (x, y, bins, offs)
    for name, t in zip(("x", "y", "bins", "offs"), cols):
        if not isinstance(t, torch.Tensor) or t.dtype != torch.int32 or t.dim() != 1:
            raise TypeError(f"{name} must be a 1-D int32 tensor")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.shape != x.shape or t.device != x.device:
            raise ValueError(f"{name} must match x in length and device")
    for name, t in (("boxes", boxes), ("times", times)):
        if not isinstance(t, torch.Tensor) or t.dtype != torch.int32:
            raise TypeError(f"{name} must be an int32 tensor")
        if t.dim() != 3 or t.shape[2] != 4 or t.shape[1] < 1:
            raise ValueError(f"{name} must have shape (Q, slots >= 1, 4)")
        if not t.is_contiguous() or t.device != x.device:
            raise ValueError(f"{name} must be contiguous and on {x.device}")
    if boxes.shape[0] != times.shape[0]:
        raise ValueError("boxes and times must hold the same number of queries")
    if x.shape[0] >= 2**31:
        raise ValueError("columns of 2^31 rows or more would overflow int32 counts")


def _launch(stem: str, x, y, bins, offs, base: int, true_n: int, boxes, times, *outs,
            ints: tuple = ()):
    """Launch ``stem``'s kernel on the current stream of the columns' card
    with its further pointer arguments ``outs`` (any inputs past the
    payloads, then its preallocated outputs) and ``ints`` after them;
    raises on a refused launch."""
    q, nb, nt = boxes.shape[0], boxes.shape[1], times.shape[1]
    n = x.shape[0]
    if q == 0 or n == 0:
        return
    for name, t in zip(("x", "y", "bins", "offs", "boxes", "times"),
                       (x, y, bins, offs, boxes, times)):
        if t.data_ptr() % 16:
            raise ValueError(f"{stem}: {name} must start on a 16-byte boundary "
                             "(the kernel loads 16-byte vectors)")
    sms = _sm_count(x.device)
    fn = _fn(f"geomesa_{stem}")
    with _on_device(x.device):
        rc = fn(x.data_ptr(), y.data_ptr(), bins.data_ptr(), offs.data_ptr(),
                n, int(base), int(true_n), boxes.data_ptr(), times.data_ptr(),
                q, nb, nt, sms, *(o.data_ptr() for o in outs), *ints, _stream_of(x))
    if rc != 0:
        raise RuntimeError(f"{stem} launch failed: cudaError {rc}")
    launches[stem] += 1


def batched_count(x, y, bins, offs, base: int, true_n: int, boxes, times) -> torch.Tensor:
    """Q bbox+time count queries over one int32 column slice, one pass.

    ``x, y, bins, offs``: (N,) int32 sorted columns; ``base``: global row
    offset of the slice; ``true_n``: global unpadded row count (rows at
    ``base + lpos >= true_n`` never match); ``boxes`` (Q, B, 4) int32
    [xlo, xhi, ylo, yhi]; ``times`` (Q, T, 4) int32 [bin_lo, off_lo,
    bin_hi, off_hi]. Returns (Q,) int32 counts, on the columns' device.

    On the card each block stages its query tile with the live slots first
    (a box is live iff ``xlo <= xhi and ylo <= yhi``, a window iff
    ``(bin_lo, off_lo) <= (bin_hi, off_hi)``): boxes as ``(xlo, xhi - xlo,
    ylo, yhi - ylo)``, tested as ``(uint32)(x - xlo) <= (uint32)(xhi -
    xlo)``; windows as two biased keys ``bin << 32 | (uint32)(off ^
    0x80000000)``, compared as signed 64-bit integers. Dead slots and
    queries with no live box or window cost no row work; the answer is the
    same for any payload.
    """
    _check_count_args(x, y, bins, offs, boxes, times)
    if x.device.type == "cpu":
        return batched_count_plain(x, y, bins, offs, base, true_n, boxes, times)
    if x.device.type != "cuda":
        raise ValueError(f"batched_count runs on cuda or cpu, not {x.device}")
    out = torch.zeros(boxes.shape[0], dtype=torch.int32, device=x.device)
    _launch("batched_count", x, y, bins, offs, base, true_n, boxes, times, out)
    return out


def row_masks(xi, yi, bi, oi, boxes, times, edges: bool = False):
    """The bbox+time predicate of every count kernel, broadcast: rows ``xi,
    yi, bi, oi`` of shape (G or 1, R) against payloads ``boxes`` (G, B, 4) and
    ``times`` (G, T, 4) → ``in_box & in_time`` (G, R) bool, the reference's
    ``_batched_masks`` (``parallel/query.py:287``) without the row-validity
    term. With ``edges`` also the edge mask of ``make_batched_edge_gather_step``
    (``:389-418``): the OR over box slots of inside the slot and on one of
    its four edges (``_slot_point`` :309), or the OR over valid windows of
    the (bin, offset) pair at one of its endpoints (``_slot_time_edge``
    :331); otherwise ``None``."""
    in_box = torch.zeros(torch.broadcast_shapes(xi.shape, boxes.shape[:1] + (1,)),
                         dtype=torch.bool, device=xi.device)
    on_edge = torch.zeros_like(in_box) if edges else None
    for k in range(boxes.shape[1]):
        b = boxes[:, k, :, None]
        inside = (xi >= b[:, 0]) & (xi <= b[:, 1]) & (yi >= b[:, 2]) & (yi <= b[:, 3])
        in_box |= inside
        if edges:
            on_edge |= inside & ((xi == b[:, 0]) | (xi == b[:, 1])
                                 | (yi == b[:, 2]) | (yi == b[:, 3]))
    return in_box & _time_masks(bi, oi, times, in_box, on_edge), on_edge


def _time_masks(bi, oi, times, like, on_edge=None):
    """The windows' part of :func:`row_masks` and :func:`overlap_masks`:
    (G, R) bool rows inside any window of ``times`` (G, T, 4), shaped like
    ``like``; with ``on_edge`` it also ORs in place the rows at an endpoint
    of a valid window (``_slot_time_edge``)."""
    in_time = torch.zeros_like(like)
    for k in range(times.shape[1]):
        t = times[:, k, :, None]
        after = (bi > t[:, 0]) | ((bi == t[:, 0]) & (oi >= t[:, 1]))
        before = (bi < t[:, 2]) | ((bi == t[:, 2]) & (oi <= t[:, 3]))
        in_time |= after & before
        if on_edge is not None:
            valid = (t[:, 0] < t[:, 2]) | ((t[:, 0] == t[:, 2]) & (t[:, 1] <= t[:, 3]))
            on_edge |= valid & (((bi == t[:, 0]) & (oi == t[:, 1]))
                                | ((bi == t[:, 2]) & (oi == t[:, 3])))
    return in_time


def _plain_masks(x, y, bins, offs, base: int, true_n: int, boxes, times, chunk: int,
                 edges: bool = False):
    """Yield ``(s, e, mask (Q, e - s) bool, edge mask or None)`` over row
    chunks: :func:`row_masks` with the rows' validity, chunked so the
    (Q, chunk) masks stay bounded. The edge mask is within the match mask."""
    n = x.shape[0]
    for s in range(0, n, chunk):
        e = min(n, s + chunk)
        m, edge = row_masks(x[s:e][None, :], y[s:e][None, :], bins[s:e][None, :],
                            offs[s:e][None, :], boxes, times, edges)
        lpos = torch.arange(s, e, dtype=torch.int64, device=x.device)
        m &= ((int(base) + lpos) < int(true_n))[None, :]
        yield s, e, m, (edge & m if edges else None)


def batched_count_plain(x, y, bins, offs, base: int, true_n: int, boxes, times,
                        chunk: int = 1 << 20) -> torch.Tensor:
    """The plain PyTorch version of :func:`batched_count`."""
    counts = torch.zeros(boxes.shape[0], dtype=torch.int64, device=x.device)
    for _, _, m, _ in _plain_masks(x, y, bins, offs, base, true_n, boxes, times, chunk):
        counts += m.sum(dim=1)
    return counts.to(torch.int32)


# ---------------------------------------------------------------------------
# batched_count_hits
# ---------------------------------------------------------------------------

LANES = 128  # lanes of the hit scoreboard: position residues mod 128


def batched_count_hits(x, y, bins, offs, base: int, true_n: int, boxes, times):
    """:func:`batched_count` plus the newest match per 128-row lane, one pass.

    Same inputs, predicate and staged layout as :func:`batched_count`.
    Returns ``(counts (Q,) int32, lane_pos (Q, 128) int32)``:
    ``lane_pos[q, l]`` is the greatest global position ``base + lpos`` of a
    row matching query ``q`` with ``lpos % 128 == l``, or -1 where that lane
    never matched. On the card a thread holds consecutive rows, so its rows
    fall in the lanes ``(lpos0 + r) % 128``; each matched row folds into its
    own lane of a shared scoreboard (``atomicMax``), then one global
    ``atomicMax`` per matched (query, lane) per block.
    """
    _check_count_args(x, y, bins, offs, boxes, times)
    if int(base) + x.shape[0] > 2**31 - 1:
        raise ValueError("base + rows must stay below 2^31: positions are int32")
    if x.device.type == "cpu":
        return batched_count_hits_plain(x, y, bins, offs, base, true_n, boxes, times)
    if x.device.type != "cuda":
        raise ValueError(f"batched_count_hits runs on cuda or cpu, not {x.device}")
    q = boxes.shape[0]
    counts = torch.zeros(q, dtype=torch.int32, device=x.device)
    lane_pos = torch.full((q, LANES), -1, dtype=torch.int32, device=x.device)
    _launch("batched_count_hits", x, y, bins, offs, base, true_n, boxes, times,
            counts, lane_pos)
    return counts, lane_pos


def batched_count_hits_plain(x, y, bins, offs, base: int, true_n: int, boxes, times,
                             chunk: int = 1 << 20):
    """The plain PyTorch version of :func:`batched_count_hits`: the
    reference's jnp path (``parallel/query.py:552-557``: mask,
    ``where(m, gpos, -1)``, reshape ``(Q, n/128, 128)``, max over axis 1),
    chunked over rows; ``chunk`` must be a multiple of 128."""
    if chunk % LANES:
        raise ValueError(f"chunk must be a multiple of {LANES}")
    q = boxes.shape[0]
    counts = torch.zeros(q, dtype=torch.int64, device=x.device)
    lane_pos = torch.full((q, LANES), -1, dtype=torch.int64, device=x.device)
    for s, e, m, _ in _plain_masks(x, y, bins, offs, base, true_n, boxes, times, chunk):
        counts += m.sum(dim=1)
        gpos = torch.arange(int(base) + s, int(base) + e, dtype=torch.int64, device=x.device)
        posq = torch.where(m, gpos[None, :], -1)
        pad = -(e - s) % LANES
        if pad:
            posq = torch.nn.functional.pad(posq, (0, pad), value=-1)
        lane_pos = torch.maximum(lane_pos, posq.reshape(q, -1, LANES).amax(dim=1))
    return counts.to(torch.int32), lane_pos.to(torch.int32)


# ---------------------------------------------------------------------------
# batched_edge_gather
# ---------------------------------------------------------------------------

EDGE_CAPACITY = 512  # candidate lanes per query (the reference's ``cap``, datastore.py:2026)
EDGE_MAX_LANES = 32768  # lanes a query the card's edge gathers sort (csrc MAX_SORT_LANES)
_I32_MAX = 2**31 - 1


def batched_edge_gather(x, y, bins, offs, base: int, true_n: int, boxes, times,
                        capacity: int = EDGE_CAPACITY):
    """:func:`batched_count` plus each query's edge candidates, one pass.

    Same inputs, predicate and staged layout as :func:`batched_count`.
    Returns ``(counts (Q,) int32, positions (Q, 1, capacity) int32, hits
    (Q, 1) int32)``, the reference's shapes with one shard: ``counts`` are
    :func:`batched_count`'s; a row is a candidate of query ``q`` when it
    matches ``q`` and lies inside a live box of ``q`` on one of that box's
    edges, or at an endpoint of a live window of ``q`` (:func:`row_masks`);
    ``hits`` is the true number of candidates and may exceed ``capacity``;
    ``positions`` hold global positions ``base + lpos`` of candidates, -1
    padded.

    Lane contract: where ``hits <= capacity`` the lanes hold every candidate
    in row order, as the plain version's do. Where ``hits > capacity`` they
    hold ``capacity`` of the candidates, which ones undefined (the kernel
    appends in no particular order): the caller must not use them.

    On the card each block tests a 4096-row chunk only against the queries
    that :func:`chunk_query_pairs` keeps for it; a culled pair holds no
    match, so the outputs are those of a full scan. The kernel appends the
    candidates in no order; a second kernel of the same launch sorts each
    query's lanes, so the card takes at most :data:`EDGE_MAX_LANES` of them.
    """
    _check_count_args(x, y, bins, offs, boxes, times)
    _check_edge_capacity(capacity, base, x)
    if x.device.type == "cpu":
        return batched_edge_gather_plain(x, y, bins, offs, base, true_n, boxes, times,
                                         capacity)
    if x.device.type != "cuda":
        raise ValueError(f"batched_edge_gather runs on cuda or cpu, not {x.device}")
    return _edge_outputs(boxes.shape[0], capacity, x, lambda *outs: _launch(
        "batched_edge_gather", x, y, bins, offs, base, true_n, boxes, times, *outs,
        ints=(int(capacity),)))


def _check_edge_capacity(capacity: int, base: int, x) -> None:
    if capacity < 0:
        raise ValueError(f"capacity must be >= 0, got {capacity}")
    if int(base) + x.shape[0] > _I32_MAX:
        raise ValueError("base + rows must stay below 2^31: positions are int32")
    if x.device.type == "cuda" and capacity > EDGE_MAX_LANES:
        raise ValueError(f"capacity must be <= {EDGE_MAX_LANES} on the card (the lanes' sort "
                         f"holds a query's lanes in shared memory), got {capacity}")


def _edge_outputs(q: int, capacity: int, x, launch):
    """An edge gather's ``(counts (Q,), positions (Q, 1, capacity), hits (Q,
    1))`` on the card: allocated here and written whole by ``launch(counts,
    hits, positions)`` (the entry point zeroes the counts and hits, and sorts
    and pads the lanes); with no row, no launch and the empty answer."""
    if q == 0 or x.shape[0] == 0:
        return (torch.zeros(q, dtype=torch.int32, device=x.device),
                torch.full((q, 1, capacity), -1, dtype=torch.int32, device=x.device),
                torch.zeros((q, 1), dtype=torch.int32, device=x.device))
    out = torch.empty((2, q), dtype=torch.int32, device=x.device)
    pos = torch.empty((q, capacity), dtype=torch.int32, device=x.device)
    launch(out[0], out[1], pos)
    return out[0], pos[:, None, :], out[1][:, None]


def batched_edge_gather_plain(x, y, bins, offs, base: int, true_n: int, boxes, times,
                              capacity: int = EDGE_CAPACITY, chunk: int = 1 << 20):
    """The plain PyTorch version of :func:`batched_edge_gather`: the
    reference's ``one`` (``parallel/query.py:400-428``), chunked over rows.
    Candidates fill the lanes in row order by a running prefix sum; past
    ``capacity`` they are counted in ``hits`` and dropped."""
    return _gather_lanes(_plain_masks(x, y, bins, offs, base, true_n, boxes, times, chunk,
                                      edges=True),
                         boxes.shape[0], base, capacity, x.device)


def _gather_lanes(masks, q: int, base: int, capacity: int, device):
    """Counts, lanes and hits of the plain edge gathers over ``masks``, the
    ``(s, e, match, edge)`` chunks of :func:`_plain_masks`."""
    counts = torch.zeros(q, dtype=torch.int64, device=device)
    hits = torch.zeros(q, dtype=torch.int64, device=device)
    pos = torch.full((q, capacity), -1, dtype=torch.int32, device=device)
    for s, _, m, edge in masks:
        counts += m.sum(dim=1)
        slot = hits[:, None] + torch.cumsum(edge, dim=1) - 1
        qi, ri = (edge & (slot < capacity)).nonzero(as_tuple=True)
        pos[qi, slot[qi, ri]] = (int(base) + s + ri).to(torch.int32)
        hits += edge.sum(dim=1)
    return counts.to(torch.int32), pos[:, None, :], hits.to(torch.int32)[:, None]


_M32 = 0xFFFFFFFF


def _time_keys(bins, offs) -> torch.Tensor:
    """The biased 64-bit time keys ``bin << 32 | (uint32)(off ^
    0x80000000)`` (signed order == the lexicographic order of (bin, off))."""
    return bins.long() * 2**32 + ((offs.long() ^ 0x80000000) & _M32)


def chunk_extents(x, y, bins, offs, step: int = 1 << 22) -> torch.Tensor:
    """Each ``JOIN_BLOCK``-row chunk's extent, as the edge gather's cull
    takes it (``csrc/chunk_cull.cuh``): the min and max of x, of y and of
    the biased time key over every row of the chunk, valid or not, rows past
    N of the last chunk as zeros. Returns (ceil(N / JOIN_BLOCK), 4) int64 in
    the kernels' ``Extent`` layout, 32 B a chunk: column 0 holds xlo and xhi
    as two int32 (``ext[:, :2].view(torch.int32)`` gives xlo, xhi, ylo,
    yhi), columns 2 and 3 the key's min and max. Torch reductions over
    ``step`` rows at a time (a multiple of ``JOIN_BLOCK``), so the keys'
    int64 temporaries stay bounded; ``DeviceBackend.load`` computes them
    once per staged state."""
    return _chunk_extents(x, x, y, y, bins, offs, step)


def chunk_extents_bbox(xmin, ymin, xmax, ymax, bins=None, offs=None,
                       step: int = 1 << 22) -> torch.Tensor:
    """:func:`chunk_extents` over per-feature bounds, as the overlap
    kernels' cull takes it (``csrc/overlap_cull.cuh``): per chunk the min of
    xmin, the max of xmax, the min of ymin, the max of ymax and the time
    key's min and max (zeros without ``bins``/``offs``)."""
    return _chunk_extents(xmin, xmax, ymin, ymax, bins, offs, step)


def _chunk_extents(xlo, xhi, ylo, yhi, bins, offs, step: int) -> torch.Tensor:
    if step % JOIN_BLOCK:
        raise ValueError(f"step must be a multiple of {JOIN_BLOCK}")
    n = xlo.shape[0]
    out = torch.zeros((-(-n // JOIN_BLOCK), 4), dtype=torch.int64, device=xlo.device)
    for s in range(0, n, step):
        e = min(n, s + step)
        c0, c1 = s // JOIN_BLOCK, -(-e // JOIN_BLOCK)

        def chunks(col):
            return torch.nn.functional.pad(col, (0, c1 * JOIN_BLOCK - e)).view(c1 - c0,
                                                                              JOIN_BLOCK)

        bounds = [chunks(xlo[s:e]).amin(dim=1), chunks(xhi[s:e]).amax(dim=1),
                  chunks(ylo[s:e]).amin(dim=1), chunks(yhi[s:e]).amax(dim=1)]
        out[c0:c1, :2] = torch.stack(bounds, dim=1).view(torch.int64)
        if bins is not None:
            keys = chunks(_time_keys(bins[s:e], offs[s:e]))
            out[c0:c1, 2], out[c0:c1, 3] = keys.amin(dim=1), keys.amax(dim=1)
    return out


def _check_extents(ext, n: int, device) -> None:
    if not isinstance(ext, torch.Tensor) or ext.dtype != torch.int64:
        raise TypeError("extents must be an int64 tensor")
    if tuple(ext.shape) != (-(-n // JOIN_BLOCK), 4) or not ext.is_contiguous() \
            or ext.device != device:
        raise ValueError(f"extents must be contiguous ({-(-n // JOIN_BLOCK)}, 4) on {device} "
                         "(chunk_extents of the columns)")


def _pairs_from_extents(ext, n: int, base: int, true_n: int, boxes, times,
                        first_rows=None) -> torch.Tensor:
    """(chunks, Q) bool: the cull's test of :func:`chunk_query_pairs` on
    :func:`chunk_extents`' output (or :func:`chunk_extents_bbox`'; no
    window test when ``times`` is None). ``first_rows``: each group's first
    local row where the groups are not whole chunks (the overlap scan's
    warps); a group from it on keeps no query past the valid rows."""
    xy = ext[:, :2].contiguous().view(torch.int32).long()
    xlo, xhi, ylo, yhi = (xy[:, i, None, None] for i in range(4))
    klo, khi = ext[:, 2, None, None], ext[:, 3, None, None]
    b = boxes.long()[None]  # (1, Q, B, 4)
    box_meets = ((b[..., 0] <= b[..., 1]) & (b[..., 2] <= b[..., 3])
                 & (b[..., 0] <= xhi) & (xlo <= b[..., 1])
                 & (b[..., 2] <= yhi) & (ylo <= b[..., 3])).any(dim=2)
    limit = min(n, int(true_n) - int(base))
    if first_rows is None:
        first_rows = torch.arange(ext.shape[0], device=ext.device) * JOIN_BLOCK
    alive = first_rows < limit
    if times is None:  # the no-time overlap count
        return box_meets & alive[:, None]
    t = times.long()[None]
    lo, hi = _time_keys(t[..., 0], t[..., 1]), _time_keys(t[..., 2], t[..., 3])
    win_meets = ((lo <= hi) & (lo <= khi) & (klo <= hi)).any(dim=2)
    return box_meets & win_meets & alive[:, None]


def chunk_query_pairs(x, y, bins, offs, base: int, true_n: int, boxes, times) -> torch.Tensor:
    """The (chunk, query) pairs that :func:`batched_edge_gather`'s cull
    keeps, as a (ceil(N / JOIN_BLOCK), Q) bool tensor, a chunk being
    ``JOIN_BLOCK`` rows as the kernel's is: the plain version of
    ``csrc/chunk_cull.cuh``.

    A pair survives when its chunk holds a valid row (local position below
    ``min(N, true_n - base)``) and the query has a live box meeting the
    chunk's x/y extent and a live window meeting its extent of the biased
    time key ``bin << 32 | (uint32)(off ^ 0x80000000)`` (signed order, the
    lexicographic order of (bin, off)). The extent (:func:`chunk_extents`)
    runs over every row the kernel loads, valid or not, with the rows past
    N of the last chunk as zeros, as the kernel's zero-filled copies are.
    No culled pair holds a match. For tests and bounds: nothing on the
    card's main path calls it.
    """
    _check_count_args(x, y, bins, offs, boxes, times)
    return _pairs_from_extents(chunk_extents(x, y, bins, offs), x.shape[0], base, true_n,
                               boxes, times)


# ---------------------------------------------------------------------------
# grouped_agg
# ---------------------------------------------------------------------------

def _check_agg_args(x, gid, rowid, vals, n_groups: int, capacity: int) -> None:
    for name, t in (("gid", gid), ("rowid", rowid)):
        if not isinstance(t, torch.Tensor) or t.dtype != torch.int32 or t.dim() != 1:
            raise TypeError(f"{name} must be a 1-D int32 tensor")
        if t.shape != x.shape or t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous and match x in length and device")
    if not isinstance(vals, torch.Tensor) or vals.dtype != torch.float64 or vals.dim() != 2:
        raise TypeError("vals must be a (V, N) float64 tensor")
    if vals.shape[1] != x.shape[0] or vals.device != x.device or not vals.is_contiguous():
        raise ValueError("vals must be contiguous, (V, N) with N the columns' length, on "
                         "their device")
    if n_groups < 1 or capacity < 0:
        raise ValueError(f"need n_groups >= 1 and capacity >= 0, got {n_groups}, {capacity}")


# the work ints of a grouped_agg launch (csrc/grouped_agg.cu W_*)
W_DONE, W_NEXT, W_RUNS, W_RUN_LEN, W_PAIRS, W_FLUSHED, W_INTS = range(7)
AGG_MIN_RUN = 8  # chunks a run of the grouped fold holds at least (all of a shorter list)
AGG_MAX_LANES = 4096  # lanes a query the card's grouped_agg sorts (csrc MAX_LANES)
AGG_LIST_CHUNKS = 1024  # chunks one item of the card's work list tests (csrc LIST_SEG_CHUNKS)
AGG_WINDOW = 8  # chunks of a window of the overlap form's runs (csrc WINDOW)
_LIST_FLAGS = 1  # the work list scratch's ints before its flags (csrc S_FLAGS)


def agg_work_list(extents, n: int, base: int, true_n: int, boxes, times, target_runs: int,
                  min_run: int = AGG_MIN_RUN, overlap: bool = False):
    """The kept (chunk, query) pairs of a ``grouped_agg`` launch in query-major
    order, cut into runs: the fold's work list.

    ``extents``: :func:`chunk_extents` of the (N,) columns; ``n``, ``base``,
    ``true_n``, ``boxes`` and ``times`` as :func:`batched_count`'s. A pair is
    kept as :func:`chunk_query_pairs` keeps it. Returns ``(chunks (Q, C)
    int32, kept (Q,) int32, runs (3, R) int32, work (W_INTS,) int32)``:
    query q's kept chunks in order in ``chunks[q, :kept[q]]`` (-1 after
    them); the runs as (query, first, end) columns of ``runs`` (-1 after
    them); ``work`` the blocks done (Q), the next run (0), the runs,
    ``run_len``, the kept pairs and 0. The point form's runs (R = Q +
    ``target_runs``) hold ``run_len = max(min_run, ceil(pairs /
    target_runs))`` chunks each but for each query's last, in query order;
    with ``overlap`` (``grouped_agg_overlap``'s runs, R = Q x ceil(C /
    ``AGG_WINDOW``)) each query's kept chunks are cut at the edges of
    aligned windows of ``AGG_WINDOW`` chunks, in (window, query) order
    (:func:`work_runs_overlap`; ``run_len`` is the window).

    On the card the ``agg_work_list`` kernel (``csrc/grouped_agg.cu``: one
    launch over ceil(Q / 8) x ceil(C / ``AGG_LIST_CHUNKS``) items, each 8
    queries' segment of chunks, each query's kept chunks of the segment
    placed by the counts of its earlier segments; the last block cuts the
    runs; :func:`agg_work_list_segments` models it); on the CPU
    :func:`agg_work_list_plain`."""
    _check_extents(extents, n, extents.device)
    for name, t in (("boxes", boxes), ("times", times)):
        if not isinstance(t, torch.Tensor) or t.dtype != torch.int32 or t.dim() != 3 \
                or t.shape[2] != 4 or not t.is_contiguous() or t.device != extents.device:
            raise ValueError(f"{name} must be a contiguous (Q, slots, 4) int32 tensor on "
                             f"{extents.device}")
    if target_runs < 1 or min_run < 1:
        raise ValueError(f"need target_runs >= 1 and min_run >= 1, got {target_runs}, {min_run}")
    if extents.device.type == "cpu":
        return agg_work_list_plain(extents, n, base, true_n, boxes, times, target_runs, min_run,
                                   overlap)
    if extents.device.type != "cuda":
        raise ValueError(f"agg_work_list runs on cuda or cpu, not {extents.device}")
    return _work_list_launch(extents, n, base, true_n, boxes, times, target_runs, min_run,
                             overlap=overlap)


def _max_runs(q: int, c: int, target_runs: int, overlap: bool) -> int:
    """The run table's length: Q + ``target_runs``, or with ``overlap`` one
    run a (window, query) cell."""
    return q * -(-c // AGG_WINDOW) if overlap else q + int(target_runs)


def _work_list_launch(extents, n: int, base: int, true_n: int, boxes, times, target_runs: int,
                      min_run: int, fills: tuple = (), ints: tuple = (0, 0, 0),
                      overlap: bool = False):
    """The ``agg_work_list`` kernel's launch; with ``fills`` (the fold's cnt,
    first, vcnt, vsum, vmin, vmax, hits and positions) and ``ints`` (V, G,
    capacity), it also fills the fold's outputs with their initial values;
    with ``overlap``, window runs."""
    dev = extents.device
    q, c = boxes.shape[0], extents.shape[0]
    m = _max_runs(q, c, target_runs, overlap)
    if q == 0:
        return (torch.empty((0, c), dtype=torch.int32, device=dev),
                torch.empty(0, dtype=torch.int32, device=dev),
                torch.full((3, m), -1, dtype=torch.int32, device=dev),
                torch.tensor([0, 0, 0, AGG_WINDOW if overlap else min_run, 0, 0],
                             dtype=torch.int32, device=dev))
    if boxes.data_ptr() % 16 or times.data_ptr() % 16:
        raise ValueError("agg_work_list: boxes and times must start on a 16-byte boundary")
    # one allocation, every int of it written by the launch: the window runs'
    # (first slot, count) cells first (8-byte aligned), the lists with their
    # -1 tails, the counts, the runs with theirs and the work ints
    cells = 2 * m if overlap else 0
    out = torch.empty(cells + q * c + q + 3 * m + W_INTS, dtype=torch.int32, device=dev)
    _, chunks, kept, runs, work = out.split((cells, q * c, q, 3 * m, W_INTS))
    at = out.data_ptr() + 4 * (cells + q * c + q)
    stream = _stream_of(extents)
    segs = max(1, -(-c // AGG_LIST_CHUNKS))
    scratch = _stream_scratch(dev, stream, _LIST_FLAGS + q * segs)
    with _on_device(dev):
        rc = _fn("geomesa_agg_work_list")(
            extents.data_ptr(), int(n), int(base), int(true_n), boxes.data_ptr(),
            times.data_ptr(), q, boxes.shape[1], times.shape[1], int(target_runs), int(min_run),
            at - 4 * (q * c + q), at - 4 * q, at, at + 4 * m, at + 8 * m, at + 12 * m,
            scratch.data_ptr(), scratch.numel(),
            *([t.data_ptr() for t in fills] if fills else [None] * 8), *ints,
            AGG_WINDOW if overlap else 0, out.data_ptr() if overlap else None, stream)
    if rc != 0:
        raise RuntimeError(f"agg_work_list launch failed: cudaError {rc}")
    launches["agg_work_list"] += 1
    return chunks.view(q, c), kept, runs.view(3, m), work


def agg_work_list_plain(extents, n: int, base: int, true_n: int, boxes, times,
                        target_runs: int, min_run: int = AGG_MIN_RUN, overlap: bool = False):
    """The plain PyTorch version of :func:`agg_work_list`."""
    keep = _pairs_from_extents(extents, n, base, true_n, boxes, times).T  # (Q, C)
    q, c = keep.shape
    dev = extents.device
    kept = keep.sum(dim=1)
    idx = torch.where(keep, torch.arange(c, device=dev)[None, :], c).sort(dim=1).values
    chunks = torch.where(idx < c, idx, -1).to(torch.int32)
    runs = work_runs_overlap(keep) if overlap else _work_runs(kept, target_runs, min_run)
    return (chunks, kept.to(torch.int32), *runs)


def work_runs_overlap(keep):
    """The overlap form's runs and work ints of the kept (Q, C) pairs
    ``keep``: what the card's last work-list block writes from the window
    cells. Query q's kept chunks are cut at the edges of aligned windows of
    ``AGG_WINDOW`` chunks; a (window, query) cell that kept a chunk is one
    run (query, first, end), ``first`` and ``end`` slots of the query's
    list; runs in (window, query) order, -1 after them."""
    q, c = keep.shape
    dev = keep.device
    nw = -(-c // AGG_WINDOW)
    k = keep.long()
    grid = torch.zeros((q, nw * AGG_WINDOW), dtype=torch.long, device=dev)
    grid[:, :c] = k
    count = grid.view(q, nw, AGG_WINDOW).sum(dim=2)  # (Q, W)
    start = torch.cumsum(count, dim=1) - count  # each cell's first slot in its query's list
    wi, qi = (count.T > 0).nonzero(as_tuple=True)  # (window, query) order
    runs = torch.full((3, _max_runs(q, c, 0, True)), -1, dtype=torch.int32, device=dev)
    n_runs = wi.shape[0]
    runs[0, :n_runs] = qi.to(torch.int32)
    runs[1, :n_runs] = start[qi, wi].to(torch.int32)
    runs[2, :n_runs] = (start[qi, wi] + count[qi, wi]).to(torch.int32)
    work = torch.tensor([q, 0, n_runs, AGG_WINDOW, int(k.sum()), 0], dtype=torch.int32,
                        device=dev)
    return runs, work


AGG_FOLD_K = 3  # runs an overlap fold block takes at once at most (csrc FOLD_K)


def overlap_fold_walk(chunks, runs, work, k: int = AGG_FOLD_K) -> list:
    """A plain model of the overlap fold's items: the card's blocks take
    the window runs ``k`` at a time in table order (``runs``, ``work`` and
    the kept ``chunks`` lists as :func:`agg_work_list` returns them with
    ``overlap``), and each walks the union of its runs' chunks in order,
    window by window, reading each chunk once for every run that keeps it.
    Returns one list an item of ``(chunk, [runs of the item that keep
    it])``. For tests: nothing calls it."""
    items = []
    n_runs = int(work[W_RUNS])
    for r0 in range(0, n_runs, k):
        per_run = []
        for r in range(r0, min(r0 + k, n_runs)):
            q, s, e = (int(v) for v in runs[:, r])
            per_run.append(chunks[q, s:e].tolist())
        walk: dict = {}
        for ki, cs in enumerate(per_run):
            for c in cs:
                walk.setdefault(c, []).append(ki)
        items.append(sorted(walk.items()))
    return items


def _work_runs(kept, target_runs: int, min_run: int):
    """The runs and work ints of a work list with these per-query counts:
    what the card's last work-list block writes."""
    q, dev = kept.shape[0], kept.device
    pairs = int(kept.sum())
    run_len = max(min_run, -(-pairs // target_runs))
    per_q = (kept + run_len - 1) // run_len
    n_runs = int(per_q.sum())
    run_q = torch.repeat_interleave(torch.arange(q, device=dev), per_q)
    within = torch.arange(n_runs, device=dev) - torch.repeat_interleave(
        torch.cumsum(per_q, 0) - per_q, per_q)
    runs = torch.full((3, q + target_runs), -1, dtype=torch.int32, device=dev)
    runs[0, :n_runs] = run_q.to(torch.int32)
    runs[1, :n_runs] = (within * run_len).to(torch.int32)
    runs[2, :n_runs] = torch.minimum(kept[run_q], (within + 1) * run_len).to(torch.int32)
    work = torch.tensor([q, 0, n_runs, run_len, pairs, 0], dtype=torch.int32, device=dev)
    return runs, work


def agg_work_list_segments(extents, n: int, base: int, true_n: int, boxes, times,
                           target_runs: int, min_run: int = AGG_MIN_RUN,
                           segments: int | None = None, overlap: bool = False):
    """A plain model of the card's work list segment by segment; it returns
    what :func:`agg_work_list_plain` returns, for any split. Each query's C
    chunks are cut into ``segments`` segments of ceil(C / segments) chunks
    (by default the card's: ``AGG_LIST_CHUNKS`` chunks each, the last
    shorter; a card block takes one segment of 8 queries). A segment is
    tested in steps of 32 chunks (a warp's ballot); its count is published,
    and each kept chunk is written at the sum of the query's earlier
    segments' counts (the look-back) plus the kept chunks before it in its
    steps and lanes, over the -1 each segment first writes in its own
    slots; the query's last segment gives ``kept``. The runs and work ints
    come from the counts as the last block cuts them (with ``overlap``,
    the window runs of the kept pairs: :func:`work_runs_overlap`). For
    tests: nothing calls it."""
    keep = _pairs_from_extents(extents, n, base, true_n, boxes, times).T  # (Q, C)
    q, c = keep.shape
    dev = extents.device
    segs = segments or max(1, -(-c // AGG_LIST_CHUNKS))
    seg_len = max(1, -(-c // segs))
    width = -(-seg_len // 32) * 32  # a segment's chunks in whole steps of 32 lanes
    idx = torch.arange(c, device=dev)
    grid = torch.zeros((q, segs, width), dtype=torch.long, device=dev)
    grid[:, idx // seg_len, idx % seg_len] = keep.long()
    ballots = grid.view(q, segs, width // 32, 32)
    step_counts = ballots.sum(dim=3)
    count = step_counts.sum(dim=2)  # each block's published count
    offset = torch.cumsum(count, dim=1) - count  # the look-back over earlier segments
    slot = (offset[:, :, None, None] + (torch.cumsum(step_counts, dim=2) - step_counts)[..., None]
            + torch.cumsum(ballots, dim=3) - ballots)
    qi, si, ki, li = ballots.nonzero(as_tuple=True)
    chunks = torch.full((q, c), -1, dtype=torch.int32, device=dev)  # each segment's fill
    chunks[qi, slot[qi, si, ki, li]] = (si * seg_len + ki * 32 + li).to(torch.int32)
    kept = count.sum(dim=1)
    runs = work_runs_overlap(keep) if overlap else _work_runs(kept, target_runs, min_run)
    return (chunks, kept.to(torch.int32), *runs)


def grouped_agg_mode(box_slots: int, time_slots: int, n_vals: int, n_groups: int,
                     overlap: bool = False) -> str:
    """The fold's mode at this shape, as the card's kernel chooses it:
    ``"shared"`` (each run's group partials in shared memory, then one
    global atomic per touched group and field) where G x (8 + 28 V) B fit
    a block beside its 64 KB row buffer (the overlap form,
    :func:`grouped_agg_overlap`: G x (8 + 20 V) B beside its 96 KB ring,
    its sums going to the outputs), else ``"global"`` (the fold's atomics on
    the outputs). Asks the built library."""
    return ("shared" if _fn("geomesa_grouped_agg_mode")(box_slots, time_slots, n_vals,
                                                        n_groups, int(overlap)) else "global")


@functools.lru_cache(maxsize=64)
def grouped_agg_target_runs(box_slots: int, time_slots: int, n_vals: int, n_groups: int,
                            device, overlap: bool = False) -> int:
    """The runs :func:`agg_work_list` aims at for a ``grouped_agg`` (or,
    with ``overlap``, ``grouped_agg_overlap``) launch on ``device`` at this
    shape: a few per fold block resident on the card in the shape's mode.
    Asks the built library."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    out = ctypes.c_int()
    with torch.cuda.device(device):
        rc = _fn("geomesa_grouped_agg_target_runs")(box_slots, time_slots, n_vals, n_groups,
                                                     sms, int(overlap), ctypes.addressof(out))
    if rc != 0:
        raise RuntimeError(f"grouped_agg occupancy: cudaError {rc}")
    return out.value


_last_agg: dict = {}  # the last card launch's work ints and shape (grouped_agg_last_work)


def grouped_agg(x, y, bins, offs, gid, rowid, vals, base: int, true_n: int, boxes, times,
                n_groups: int, capacity: int = EDGE_CAPACITY, extents=None):
    """Q bbox+time GROUP BY queries over one column slice, one pass.

    ``x, y, bins, offs`` and the payloads as :func:`batched_count`; ``gid``
    (N,) int32 group ids in ``[0, n_groups)`` (a row outside folds nowhere);
    ``rowid`` (N,) int32 each row's original row index; ``vals`` (V, N)
    float64 value columns, NaN for nulls; ``extents`` the columns'
    :func:`chunk_extents` (computed here when None). Returns the
    reference's eight outputs with one shard (``make_grouped_agg_step``,
    ``geomesa_tpu/parallel/query.py:1508-1525``)::

        cnt (Q, G) int32, first (Q, G) int32 (int32 max where empty),
        vcnt (Q, V, G) int32, vsum, vmin, vmax (Q, V, G) float64
        (+inf / -inf where empty), positions (Q, 1, capacity) int32,
        hits (Q, 1) int32

    over each query's fold rows: its matches (:func:`row_masks`) that are
    not boundary rows, a boundary row being :func:`batched_edge_gather`'s
    candidate (on an edge bucket of a live box it is inside, or at an
    endpoint of a live window). The boundary rows' global positions take
    the lanes as the edge gather's candidates do (the same lane contract:
    every one in row order where ``hits <= capacity``).

    On the card, three launches: :func:`agg_work_list`'s kernel (the kept
    (chunk, query) pairs in query-major runs; the same launch fills the
    outputs with their initial values), the ``grouped_agg`` kernel over the
    runs in the mode :func:`grouped_agg_mode` names, and a kernel that
    decodes min and max and sorts each query's lanes (``capacity`` at most
    ``AGG_MAX_LANES``); its f64 sums are folded with atomics in no fixed
    order. On the CPU: :func:`grouped_agg_plain`.
    """
    _check_count_args(x, y, bins, offs, boxes, times)
    _check_agg_args(x, gid, rowid, vals, n_groups, capacity)
    if x.device.type == "cpu":
        _check_agg_slice(x, base, extents)
        return grouped_agg_plain(x, y, bins, offs, gid, rowid, vals, base, true_n, boxes,
                                 times, n_groups, capacity)
    return _agg_launch("grouped_agg", (x, y, bins, offs), gid, rowid, vals, base, true_n, boxes,
                       times, n_groups, capacity, extents)


def grouped_agg_overlap(cols, gid, rowid, vals, base: int, true_n: int, boxes, times,
                        n_groups: int, capacity: int = EDGE_CAPACITY, extents=None):
    """:func:`grouped_agg` over a line or polygon store's bbox columns
    ``cols`` (xmin, ymin, xmax, ymax, bins, offs) with the overlap
    predicate: the overlap mode of ``make_grouped_agg_step(overlap=True)``
    (``geomesa_tpu/parallel/query.py:1498``, per-slot ``_slot_overlap``
    :316). A row matches when its bbox overlaps a live box and it lies in a
    live window (:func:`overlap_masks`); a boundary row is a match that
    shares an opposing edge bucket with a live box it overlaps or sits at a
    window's endpoint, the overlap edge gather's candidate
    (:func:`batched_edge_gather_overlap`). Same outputs and lane contract;
    ``extents`` the columns' :func:`chunk_extents_bbox` (computed here when
    None), whose work list is the point form's (its extent test is an exact
    superset for overlap) with window runs (:func:`work_runs_overlap`). On
    the card the work list, then ``csrc/grouped_agg.cu``'s overlap fold
    (launches counted as ``grouped_agg_overlap``: a block takes up to three
    runs of a window at once and reads each of their chunks once) and the
    finish; on the CPU :func:`grouped_agg_overlap_plain`."""
    _check_box_args(cols, boxes, times)
    if times is None:
        raise ValueError("the overlap grouped fold needs the time columns and windows")
    x = cols[0]
    _check_agg_args(x, gid, rowid, vals, n_groups, capacity)
    if x.device.type == "cpu":
        _check_agg_slice(x, base, extents)
        return grouped_agg_overlap_plain(cols, gid, rowid, vals, base, true_n, boxes, times,
                                         n_groups, capacity)
    return _agg_launch("grouped_agg_overlap", tuple(cols), gid, rowid, vals, base, true_n,
                       boxes, times, n_groups, capacity, extents)


def _check_agg_slice(x, base: int, extents) -> None:
    if int(base) + x.shape[0] > _I32_MAX:
        raise ValueError("base + rows must stay below 2^31: positions are int32")
    if extents is not None:
        _check_extents(extents, x.shape[0], x.device)


def _agg_launch(stem: str, cols: tuple, gid, rowid, vals, base: int, true_n: int, boxes,
                times, n_groups: int, capacity: int, extents):
    """The card's three launches of a grouped fold (``stem``: the point or
    the overlap form): the work list with the fills, the fold, the finish."""
    x = cols[0]
    _check_agg_slice(x, base, extents)
    if x.device.type != "cuda":
        raise ValueError(f"{stem} runs on cuda or cpu, not {x.device}")
    if capacity > AGG_MAX_LANES:
        raise ValueError(f"{stem} on the card sorts at most {AGG_MAX_LANES} lanes a query")
    overlap = len(cols) == 6
    q, nv, g, dev = boxes.shape[0], vals.shape[0], int(n_groups), x.device
    nb, nt, n = boxes.shape[1], times.shape[1], x.shape[0]
    if q == 0 or n == 0:  # nothing to fold: the outputs' initial values
        return _agg_initial(q, nv, g, int(capacity), dev)
    # the work list's launch fills them (the finish decodes vmin / vmax to doubles)
    cnt = torch.empty((q, g), dtype=torch.int32, device=dev)
    first = torch.empty((q, g), dtype=torch.int32, device=dev)
    vcnt = torch.empty((q, nv, g), dtype=torch.int32, device=dev)
    vsum = torch.empty((q, nv, g), dtype=torch.float64, device=dev)
    vmin = torch.empty((q, nv, g), dtype=torch.float64, device=dev)
    vmax = torch.empty((q, nv, g), dtype=torch.float64, device=dev)
    hits = torch.empty(q, dtype=torch.int32, device=dev)
    pos = torch.empty((q, capacity), dtype=torch.int32, device=dev)
    if extents is None:
        extents = (chunk_extents_bbox(*cols) if overlap else chunk_extents(*cols))
    target = grouped_agg_target_runs(nb, nt, nv, g, dev, overlap)
    chunks, _, runs, work = _work_list_launch(extents, n, base, true_n, boxes, times, target,
                                              AGG_MIN_RUN, (cnt, first, vcnt, vsum, vmin, vmax,
                                                            hits, pos), (nv, g, int(capacity)),
                                              overlap=overlap)
    fold = (chunks, runs[0], runs[1], runs[2], work, gid, rowid, vals, cnt, first, vcnt, vsum,
            vmin, vmax, hits, pos)
    ints = (nv, g, int(capacity))
    if overlap:
        _launch_overlap("geomesa_grouped_agg_overlap", stem, cols, base, true_n, boxes, times,
                        *fold, ints=ints)
    else:
        _launch(stem, *cols, base, true_n, boxes, times, *fold, ints=ints)
    _last_agg.update(work=work, shape=(nb, nt, nv, g, overlap), target_runs=target)
    return (cnt, first, vcnt, vsum, vmin, vmax, pos[:, None, :], hits[:, None])


def _agg_initial(q: int, nv: int, g: int, capacity: int, dev):
    """:func:`grouped_agg`'s outputs over no row."""
    return (torch.zeros((q, g), dtype=torch.int32, device=dev),
            torch.full((q, g), _I32_MAX, dtype=torch.int32, device=dev),
            torch.zeros((q, nv, g), dtype=torch.int32, device=dev),
            torch.zeros((q, nv, g), dtype=torch.float64, device=dev),
            torch.full((q, nv, g), float("inf"), dtype=torch.float64, device=dev),
            torch.full((q, nv, g), float("-inf"), dtype=torch.float64, device=dev),
            torch.full((q, 1, capacity), -1, dtype=torch.int32, device=dev),
            torch.zeros((q, 1), dtype=torch.int32, device=dev))


def grouped_agg_last_work() -> dict:
    """The last card launch of :func:`grouped_agg` or
    :func:`grouped_agg_overlap` (any thread's): its mode, whether it was
    the overlap form, the runs the work list aimed at and made, ``run_len``
    (the overlap form's window), the runs a fold block takes at once, the
    kept (chunk, query) pairs, and the global atomics of the shared mode's
    flushes. Reads the card's work ints, so it synchronises the device."""
    w = _last_agg["work"].tolist()
    shape = _last_agg["shape"]
    return {"mode": grouped_agg_mode(*shape), "overlap": shape[4],
            "target_runs": _last_agg["target_runs"], "runs": w[W_RUNS],
            "run_len": w[W_RUN_LEN],
            "fold_runs": _fn("geomesa_grouped_agg_fold_runs")(*shape[:4], int(shape[4])),
            "pairs": w[W_PAIRS], "flush_atomics": w[W_FLUSHED]}


def grouped_agg_attrs(mode: str = "shared", overlap: bool = False) -> tuple[int, int]:
    """The ``grouped_agg`` kernel's registers and local-memory (spill)
    bytes per thread in ``mode`` (``"shared"`` or ``"global"``), of the
    point form or (``overlap``) the overlap form, as compiled for the
    card."""
    if mode not in ("shared", "global"):
        raise ValueError(f"mode must be shared or global, not {mode!r}")
    out = (ctypes.c_int * 2)()
    rc = _fn("geomesa_grouped_agg_attrs")(int(mode == "shared"), int(overlap),
                                          ctypes.addressof(out))
    if rc != 0:
        raise RuntimeError(f"grouped_agg attributes: cudaError {rc}")
    return int(out[0]), int(out[1])


def grouped_agg_plain(x, y, bins, offs, gid, rowid, vals, base: int, true_n: int, boxes,
                      times, n_groups: int, capacity: int = EDGE_CAPACITY,
                      chunk: int = 1 << 20):
    """The plain PyTorch version of :func:`grouped_agg`: the reference's
    ``one`` (``parallel/query.py:1611-1687``) with ``segment_sum`` /
    ``segment_min`` / ``segment_max`` as ``index_add_`` /
    ``scatter_reduce_`` over ``query * G + gid``, chunked over rows; the
    boundary rows fill the lanes in row order by a running prefix sum, as in
    :func:`batched_edge_gather_plain`."""
    return _agg_plain(_plain_masks(x, y, bins, offs, base, true_n, boxes, times, chunk,
                                   edges=True), gid, rowid, vals, base, boxes.shape[0],
                      n_groups, capacity)


def grouped_agg_overlap_plain(cols, gid, rowid, vals, base: int, true_n: int, boxes, times,
                              n_groups: int, capacity: int = EDGE_CAPACITY,
                              chunk: int = 1 << 20):
    """The plain PyTorch version of :func:`grouped_agg_overlap`: the fold of
    :func:`grouped_agg_plain` over :func:`overlap_masks`' matches and edges
    (the reference's ``one`` in overlap mode)."""
    return _agg_plain(_overlap_plain_masks(cols, base, true_n, boxes, times, chunk, edges=True),
                      gid, rowid, vals, base, boxes.shape[0], n_groups, capacity)


def _agg_plain(masks, gid, rowid, vals, base: int, q: int, n_groups: int, capacity: int):
    """The grouped fold of both plain versions over ``masks``' chunks of
    (start, end, match mask, edge mask)."""
    nv, g, dev = vals.shape[0], int(n_groups), gid.device
    cnt = torch.zeros(q * g, dtype=torch.int64, device=dev)
    first = torch.full((q * g,), _I32_MAX, dtype=torch.int64, device=dev)
    vcnt = torch.zeros(q * nv * g, dtype=torch.int64, device=dev)
    vsum = torch.zeros(q * nv * g, dtype=torch.float64, device=dev)
    vmin = torch.full((q * nv * g,), float("inf"), dtype=torch.float64, device=dev)
    vmax = torch.full((q * nv * g,), float("-inf"), dtype=torch.float64, device=dev)
    hits = torch.zeros(q, dtype=torch.int64, device=dev)
    pos = torch.full((q, capacity), -1, dtype=torch.int32, device=dev)
    for s, e, m, edge in masks:
        slot = hits[:, None] + torch.cumsum(edge, dim=1) - 1
        qi, ri = (edge & (slot < capacity)).nonzero(as_tuple=True)
        pos[qi, slot[qi, ri]] = (int(base) + s + ri).to(torch.int32)
        hits += edge.sum(dim=1)
        qi, ri = (m & ~edge).nonzero(as_tuple=True)
        grp = gid[s:e][ri].long()
        keep = (grp >= 0) & (grp < g)
        qi, ri, grp = qi[keep], ri[keep], grp[keep]
        at = qi * g + grp
        cnt.index_add_(0, at, torch.ones_like(at))
        first.scatter_reduce_(0, at, rowid[s:e][ri].long(), "amin")
        for k in range(nv):
            val = vals[k, s:e][ri]
            ok = ~torch.isnan(val)
            atk = (qi[ok] * nv + k) * g + grp[ok]
            val = val[ok]
            vcnt.index_add_(0, atk, torch.ones_like(atk))
            vsum.index_add_(0, atk, val)
            vmin.scatter_reduce_(0, atk, val, "amin")
            vmax.scatter_reduce_(0, atk, val, "amax")
    return (cnt.view(q, g).to(torch.int32), first.view(q, g).to(torch.int32),
            vcnt.view(q, nv, g).to(torch.int32), vsum.view(q, nv, g), vmin.view(q, nv, g),
            vmax.view(q, nv, g), pos[:, None, :], hits.to(torch.int32)[:, None])


# ---------------------------------------------------------------------------
# planned_gather
# ---------------------------------------------------------------------------

# rows one chunk of planned_gather_plain gathers at most (about 32 B each)
PLANNED_CHUNK_ROWS = 1 << 22


def _check_pair_args(cols, pair_q, pair_blk, boxes, times):
    if len(cols) == 4:
        _check_count_args(*cols, boxes, times)
    else:
        _check_box_args(cols, boxes, times)
    x = cols[0]
    if x.shape[0] % JOIN_BLOCK:
        raise ValueError(f"residency not block-aligned: {x.shape[0]} % {JOIN_BLOCK}")
    for name, t in (("pair_q", pair_q), ("pair_blk", pair_blk)):
        if not isinstance(t, torch.Tensor) or t.dtype != torch.int32 or t.dim() != 1:
            raise TypeError(f"{name} must be a 1-D int32 tensor")
        if not t.is_contiguous() or t.device != x.device:
            raise ValueError(f"{name} must be contiguous and on {x.device}")
    if pair_q.shape != pair_blk.shape:
        raise ValueError("pair_q and pair_blk must have one length")


def block_runs(pair_q, pair_blk):
    """The block-major order of (query, block) pairs that the planned
    gather's count pass walks: ``(order, order_q, starts, blocks)`` int32
    numpy arrays, ``order`` the pair indices stably sorted by block (so a
    block's pairs keep their pair order), ``order_q`` their queries,
    ``blocks`` the distinct blocks in ascending order and ``starts`` (D +
    1,) where each one's run of ``order`` starts (and the end). Their
    concatenation is :func:`planned_gather`'s ``plan``."""
    pair_q = np.asarray(pair_q).reshape(-1)
    pair_blk = np.asarray(pair_blk).reshape(-1)
    order = np.argsort(pair_blk, kind="stable")
    blocks, starts = np.unique(pair_blk[order], return_index=True)
    starts = np.append(starts, len(order))
    return (order.astype(np.int32), pair_q[order].astype(np.int32), starts.astype(np.int32),
            blocks.astype(np.int32))


def planned_gather(x, y, bins, offs, true_n: int, pair_q, pair_blk, boxes, times, plan=None):
    """Batched row retrieval over planned (query, block) pairs, one shard.

    ``x, y, bins, offs``: the (N,) int32 resident columns, N a multiple of
    ``JOIN_BLOCK``; ``true_n``: the true row count (rows at it or past it
    never match); ``pair_q``/``pair_blk``: (P,) int32 pair lists on the
    columns' device, each query in ``[0, Q)`` and each block in ``[0, N /
    JOIN_BLOCK)`` (the caller checks the ranges; the kernel counts a pair
    out of range as 0); ``boxes`` (Q, B, 4) / ``times`` (Q, T, 4) int32
    payloads; ``plan``: the concatenated :func:`block_runs` of the same
    pairs, an int32 tensor on the columns' device (built from the pair
    lists, with a device-to-host copy, when None). Returns ``(positions
    (H,) int32, pair_hits (P,) int64)``: the global positions (int32, the
    reference's contract) of each pair's block rows that pass its query,
    in pair order and each pair's in row order, and each pair's count.

    On the card (``csrc/planned_gather.cu``): a count pass with one block
    per distinct block of the pairs (each block's rows read once, each
    pair's 512 B match mask to scratch) and a one-block scan of the counts
    from the same entry point, one device-to-host read of the total, and a
    write pass over the masks; an empty pair list launches nothing. On the
    CPU:
    :func:`planned_gather_plain`.
    """
    _check_pair_args((x, y, bins, offs), pair_q, pair_blk, boxes, times)
    if x.device.type == "cpu":
        return planned_gather_plain(x, y, bins, offs, true_n, pair_q, pair_blk, boxes, times)
    return _planned_launch("geomesa_planned_gather_count", "planned_gather", (x, y, bins, offs),
                           true_n, pair_q, pair_blk, boxes, times, plan)


def _planned_launch(count_entry: str, counter: str, cols, true_n: int, pair_q, pair_blk, boxes,
                    times, plan):
    """The card's two passes of :func:`planned_gather` and
    :func:`planned_gather_overlap`: ``count_entry`` over the columns
    ``cols``, then the shared write pass."""
    x = cols[0]
    if x.device.type != "cuda":
        raise ValueError(f"{counter} runs on cuda or cpu, not {x.device}")
    n_pairs = pair_q.shape[0]
    if n_pairs == 0:
        return (torch.empty(0, dtype=torch.int32, device=x.device),
                torch.empty(0, dtype=torch.int64, device=x.device))
    ptrs = [t.data_ptr() for t in (*cols, boxes, times)]
    for i, ptr in enumerate(ptrs):
        if ptr % 16:
            raise ValueError(f"{counter}: input {i} must start on a 16-byte boundary "
                             "(the kernel loads 16-byte vectors)")
    if plan is None:
        plan = torch.from_numpy(np.concatenate(
            block_runs(pair_q.cpu().numpy(), pair_blk.cpu().numpy()))).to(x.device)
    n_blocks = (plan.shape[0] - 2 * n_pairs - 1) // 2
    if plan.dtype != torch.int32 or plan.dim() != 1 or plan.device != x.device \
            or not plan.is_contiguous() or n_blocks < 1 \
            or plan.shape[0] != 2 * n_pairs + 2 * n_blocks + 1:
        raise ValueError("plan must be the concatenated block_runs of these pairs, a "
                         f"contiguous int32 tensor on {x.device}")
    hits = torch.empty(n_pairs, dtype=torch.int64, device=x.device)
    # the counts' prefix sums, then each pair's 512 B match mask: one allocation
    scratch = torch.empty(n_pairs * (1 + JOIN_BLOCK // 64), dtype=torch.int64, device=x.device)
    stream = _stream_of(x)
    with _on_device(x.device):
        rc = _fn(count_entry)(
            *ptrs[:-2], x.shape[0], int(true_n), plan.data_ptr(), n_pairs, n_blocks, ptrs[-2],
            ptrs[-1], boxes.shape[0], boxes.shape[1], times.shape[1], hits.data_ptr(),
            scratch.data_ptr(), scratch.data_ptr() + 8 * n_pairs, stream)
        if rc != 0:
            raise RuntimeError(f"{counter} count pass failed: cudaError {rc}")
        total = int(scratch[n_pairs - 1])  # the one device-to-host read: the output's size
        positions = torch.empty(total, dtype=torch.int32, device=x.device)
        if total:
            rc = _fn("geomesa_planned_gather_write")(
                pair_blk.data_ptr(), n_pairs, hits.data_ptr(), scratch.data_ptr(),
                scratch.data_ptr() + 8 * n_pairs, positions.data_ptr(), stream)
            if rc != 0:
                raise RuntimeError(f"{counter} write pass failed: cudaError {rc}")
    launches[counter] += 1
    return positions, hits


def planned_gather_plain(x, y, bins, offs, true_n: int, pair_q, pair_blk, boxes, times):
    """The plain PyTorch version of :func:`planned_gather`: each pair's
    block is gathered (a row of the columns viewed as (N / JOIN_BLOCK,
    JOIN_BLOCK)) and tested against its one query by :func:`row_masks`,
    with rows at ``true_n`` or past it masked.

    Memory: pairs run in chunks of at most ``PLANNED_CHUNK_ROWS`` gathered
    rows (the four columns, the masks of the predicate and the positions:
    about 32 B per row, so about 128 MiB), so a query covering every block,
    such as ``INCLUDE``, never allocates N x ``JOIN_BLOCK``."""
    return _planned_plain((x, y, bins, offs), true_n, pair_q, pair_blk, boxes, times, row_masks)


def _planned_plain(cols, true_n: int, pair_q, pair_blk, boxes, times, masks_of):
    """:func:`planned_gather_plain` over ``cols`` with the predicate
    ``masks_of(*rows, boxes, times) -> (mask, _)``."""
    x = cols[0]
    if pair_q.shape[0] == 0:
        return (torch.empty(0, dtype=torch.int32, device=x.device),
                torch.empty(0, dtype=torch.int64, device=x.device))
    blocks = [c.view(-1, JOIN_BLOCK) for c in cols]
    pq, pb = pair_q.long(), pair_blk.long()
    lrow = torch.arange(JOIN_BLOCK, device=x.device)
    step = max(1, PLANNED_CHUNK_ROWS // JOIN_BLOCK)
    positions, hits = [], []
    for s in range(0, pq.shape[0], step):
        q, b = pq[s:s + step], pb[s:s + step]
        m, _ = masks_of(*(c.index_select(0, b) for c in blocks),
                        boxes.index_select(0, q), times.index_select(0, q))
        gpos = b[:, None] * JOIN_BLOCK + lrow[None, :]
        m &= gpos < int(true_n)
        hits.append(m.sum(dim=1))
        positions.append(gpos[m].to(torch.int32))
    return torch.cat(positions), torch.cat(hits)


# ---------------------------------------------------------------------------
# batched_overlap, and the overlap forms of the edge gather and planned gather
# ---------------------------------------------------------------------------

def overlap_masks(x0, y0, x1, y1, bi, oi, boxes, times, edges: bool = False):
    """The bbox-overlap predicate of every overlap kernel, broadcast: rows'
    bounds ``x0, y0, x1, y1`` (xmin, ymin, xmax, ymax) and time columns
    ``bi, oi``, each (G or 1, R), against payloads ``boxes`` (G, B, 4) and
    ``times`` (G, T, 4) or None (the no-time form: ``bi``, ``oi`` unread) →
    ``in_box & in_time`` (G, R) bool, the reference's
    ``_batched_overlap_masks`` (``parallel/query.py:636``) without the row
    validity. A box slot is live iff ``xlo <= xhi and ylo <= yhi``, as the
    kernels stage it; a dead slot matches no row (on the payloads
    ``ops.refine.pack_boxes(..., overlap=True)`` packs, the reference's
    test). With ``edges`` also the edge mask of
    ``make_batched_edge_gather_step(overlap=True)``: the OR over live slots
    of overlapping the slot with ``x0 == xhi | x1 == xlo | y0 == yhi | y1 ==
    ylo`` (``_slot_overlap`` :316), or the (bin, offset) at an endpoint of a
    valid window; otherwise ``None``."""
    in_box = torch.zeros(torch.broadcast_shapes(x0.shape, boxes.shape[:1] + (1,)),
                         dtype=torch.bool, device=x0.device)
    on_edge = torch.zeros_like(in_box) if edges else None
    for k in range(boxes.shape[1]):
        b = boxes[:, k, :, None]
        inside = ((b[:, 0] <= b[:, 1]) & (b[:, 2] <= b[:, 3])
                  & (x0 <= b[:, 1]) & (x1 >= b[:, 0]) & (y0 <= b[:, 3]) & (y1 >= b[:, 2]))
        in_box |= inside
        if edges:
            on_edge |= inside & ((x0 == b[:, 1]) | (x1 == b[:, 0])
                                 | (y0 == b[:, 3]) | (y1 == b[:, 2]))
    if times is None:
        return in_box, on_edge
    return in_box & _time_masks(bi, oi, times, in_box, on_edge), on_edge


def _check_box_args(cols, boxes, times):
    """Four bbox columns and no times (the no-time form) or six columns
    (with bins, offs) and times."""
    if len(cols) not in (4, 6) or (times is None) != (len(cols) == 4):
        raise ValueError("give (xmin, ymin, xmax, ymax) without times or "
                         "(xmin, ymin, xmax, ymax, bins, offs) with times")
    x = cols[0]
    for i, t in enumerate(cols):
        if not isinstance(t, torch.Tensor) or t.dtype != torch.int32 or t.dim() != 1:
            raise TypeError(f"column {i} must be a 1-D int32 tensor")
        if not t.is_contiguous() or t.shape != x.shape or t.device != x.device:
            raise ValueError(f"column {i} must be contiguous and match column 0")
    for name, t in (("boxes", boxes), ("times", times)):
        if t is None:
            continue
        if not isinstance(t, torch.Tensor) or t.dtype != torch.int32:
            raise TypeError(f"{name} must be an int32 tensor")
        if t.dim() != 3 or t.shape[2] != 4 or t.shape[1] < 1:
            raise ValueError(f"{name} must have shape (Q, slots >= 1, 4)")
        if not t.is_contiguous() or t.device != x.device:
            raise ValueError(f"{name} must be contiguous and on {x.device}")
    if times is not None and boxes.shape[0] != times.shape[0]:
        raise ValueError("boxes and times must hold the same number of queries")
    if x.shape[0] >= 2**31:
        raise ValueError("columns of 2^31 rows or more would overflow int32 counts")


def _overlap_rows(cols, s: int, e: int):
    """Rows [s, e) of the bbox columns as (1, e - s) tensors, six of them
    (the time columns None in the no-time form)."""
    rows = [c[s:e][None, :] for c in cols]
    return rows + [None] * (6 - len(rows))


def _overlap_plain_masks(cols, base: int, true_n: int, boxes, times, chunk: int,
                         edges: bool = False):
    """:func:`_plain_masks` for the overlap predicate."""
    n = cols[0].shape[0]
    for s in range(0, n, chunk):
        e = min(n, s + chunk)
        m, edge = overlap_masks(*_overlap_rows(cols, s, e), boxes, times, edges)
        lpos = torch.arange(s, e, dtype=torch.int64, device=cols[0].device)
        m &= ((int(base) + lpos) < int(true_n))[None, :]
        yield s, e, m, (edge & m if edges else None)


def _launch_overlap(entry: str, counter: str, cols, base: int, true_n: int, boxes, times, *outs,
                    ints: tuple = ()):
    """Launch an overlap kernel (``entry``) on the current stream of the
    columns' card, its outputs ``outs`` and ``ints`` after the payloads;
    raises on a refused launch."""
    q, nb = boxes.shape[0], boxes.shape[1]
    nt = 0 if times is None else times.shape[1]
    x = cols[0]
    if q == 0 or x.shape[0] == 0:
        return
    for i, t in enumerate((*cols, boxes) + (() if times is None else (times,))):
        if t.data_ptr() % 16:
            raise ValueError(f"{counter}: input {i} must start on a 16-byte boundary "
                             "(the kernel loads 16-byte vectors)")
    ptrs = [c.data_ptr() for c in cols] + [None] * (6 - len(cols))
    sms = _sm_count(x.device)
    with _on_device(x.device):
        rc = _fn(entry)(*ptrs, x.shape[0], int(base), int(true_n), boxes.data_ptr(),
                        None if times is None else times.data_ptr(), q, nb, nt, sms,
                        *(o.data_ptr() for o in outs), *ints, _stream_of(x))
    if rc != 0:
        raise RuntimeError(f"{counter} launch failed: cudaError {rc}")
    launches[counter] += 1


def batched_overlap(cols, base: int, true_n: int, boxes, times=None) -> torch.Tensor:
    """Q bbox-overlap count queries over one slice of bbox columns, one pass.

    ``cols``: (xmin, ymin, xmax, ymax) (N,) int32, the no-time form, or
    (xmin, ymin, xmax, ymax, bins, offs) with ``times`` (Q, T, 4) int32;
    ``base``/``true_n`` as in :func:`batched_count`; ``boxes`` (Q, B, 4)
    int32 [xlo, xhi, ylo, yhi]. Returns (Q,) int32: per query the rows whose
    bbox overlaps a live box and, with time, lies in a live window
    (:func:`overlap_masks`).

    On the card (``csrc/batched_overlap.cu``) each warp tests its 256 rows
    of a 4096-row chunk only against the queries :func:`overlap_warp_pairs`
    keeps for it; a culled pair holds no match."""
    _check_box_args(cols, boxes, times)
    x = cols[0]
    if x.device.type == "cpu":
        return batched_overlap_plain(cols, base, true_n, boxes, times)
    if x.device.type != "cuda":
        raise ValueError(f"batched_overlap runs on cuda or cpu, not {x.device}")
    out = torch.zeros(boxes.shape[0], dtype=torch.int32, device=x.device)
    _launch_overlap("geomesa_batched_overlap", "batched_overlap", cols, base, true_n, boxes,
                    times, out)
    return out


def batched_overlap_plain(cols, base: int, true_n: int, boxes, times=None,
                          chunk: int = 1 << 20) -> torch.Tensor:
    """The plain PyTorch version of :func:`batched_overlap`."""
    counts = torch.zeros(boxes.shape[0], dtype=torch.int64, device=cols[0].device)
    for _, _, m, _ in _overlap_plain_masks(cols, base, true_n, boxes, times, chunk):
        counts += m.sum(dim=1)
    return counts.to(torch.int32)


def overlap_chunk_pairs(cols, base: int, true_n: int, boxes, times=None) -> torch.Tensor:
    """The (chunk, query) pairs whose chunk extent (:func:`chunk_extents_bbox`,
    rows past N of the last chunk as zeros, as the kernels load them) a live
    slot of the query meets, as a (ceil(N / JOIN_BLOCK), Q) bool tensor. No
    culled pair holds a match; the kernels' own cull is finer
    (:func:`overlap_warp_pairs`) and keeps a warp of a chunk only where
    this keeps the chunk. For tests and bounds."""
    _check_box_args(cols, boxes, times)
    ext = chunk_extents_bbox(*cols[:4], *(cols[4:] if times is not None else ()))
    return _pairs_from_extents(ext, cols[0].shape[0], base, true_n, boxes, times)


OVERLAP_THREADS = 512  # threads of a block of the overlap scan (csrc OV_THREADS)
OVERLAP_WARP_ROWS = JOIN_BLOCK * 32 // OVERLAP_THREADS  # rows of a chunk one warp holds: 256


def overlap_warp_pairs(cols, base: int, true_n: int, boxes, times=None) -> torch.Tensor:
    """The (warp, query) pairs the overlap kernels' cull keeps: the plain
    version of ``csrc/overlap_cull.cuh``'s cull. Row ``g`` of the
    (ceil(N / JOIN_BLOCK) x 16, Q) bool result is warp ``g % 16`` of chunk
    ``g // 16``, which holds the chunk's rows :func:`overlap_warp_rows`
    names; its extent is taken over those rows, valid or not (rows past N as
    zeros), a warp from whose first row on no row is valid keeps no query,
    and the test is :func:`overlap_chunk_pairs`'. No culled pair holds a
    match. For tests and bounds."""
    _check_box_args(cols, boxes, times)
    n = cols[0].shape[0]
    chunks, warps = -(-n // JOIN_BLOCK), OVERLAP_THREADS // 32
    runs = JOIN_BLOCK // OVERLAP_THREADS // 4  # a warp's runs of 128 rows in a chunk

    def by_warp(col):  # (chunks x 16, 256): the rows of each warp
        v = torch.nn.functional.pad(col, (0, chunks * JOIN_BLOCK - n))
        return v.view(chunks, runs, warps, -1).transpose(1, 2).reshape(chunks * warps, -1)

    xmin, ymin, xmax, ymax = (by_warp(c) for c in cols[:4])
    bounds = [xmin.amin(dim=1), xmax.amax(dim=1), ymin.amin(dim=1), ymax.amax(dim=1)]
    ext = torch.zeros((chunks * warps, 4), dtype=torch.int64, device=xmin.device)
    ext[:, :2] = torch.stack(bounds, dim=1).view(torch.int64)
    if times is not None:
        keys = _time_keys(by_warp(cols[4]), by_warp(cols[5]))
        ext[:, 2], ext[:, 3] = keys.amin(dim=1), keys.amax(dim=1)
    g = torch.arange(chunks * warps, device=xmin.device)
    first = g // warps * JOIN_BLOCK + g % warps * (JOIN_BLOCK // runs // warps)
    return _pairs_from_extents(ext, n, base, true_n, boxes, times, first)


def overlap_warp_rows() -> torch.Tensor:
    """(16, 256) int64: the rows of a ``JOIN_BLOCK``-row chunk each warp of
    the overlap scan holds (``csrc/overlap_cull.cuh``): thread ``t`` holds
    rows ``j * 2048 + 4t .. + 3`` for ``j = 0, 1``, so warp ``w`` holds
    rows ``128w .. 128w + 127`` and ``2048 + 128w .. 2048 + 128w + 127``."""
    warps, groups = OVERLAP_THREADS // 32, JOIN_BLOCK // OVERLAP_THREADS // 4
    t = torch.arange(OVERLAP_THREADS).view(warps, 32, 1, 1)
    j = torch.arange(groups).view(1, 1, groups, 1)
    return (j * 4 * OVERLAP_THREADS + 4 * t + torch.arange(4)).reshape(warps, -1)


def planned_overlap_rows() -> torch.Tensor:
    """(512, 8) int64: the rows of a ``JOIN_BLOCK``-row block each thread of
    ``planned_gather_overlap``'s count pass holds (``csrc/planned_gather.cu``):
    two 256-thread blocks a block, one a half; thread ``t`` of half ``h``
    (row ``256h + t`` here) holds rows ``2048h + 1024j + 4t .. + 3`` at bits
    ``4j .. 4j + 3`` (``j = 0, 1``)."""
    h = torch.arange(2).view(2, 1, 1, 1)
    t = torch.arange(256).view(1, 256, 1, 1)
    j = torch.arange(2).view(1, 1, 2, 1)
    return (2048 * h + 1024 * j + 4 * t + torch.arange(4)).reshape(512, 8)


def overlap_mask_words(bits) -> torch.Tensor:
    """The plain version of ``csrc/planned_gather.cu``'s ``store_half_words``:
    the overlap count pass's match bits of one block, (..., 512) ints whose
    bit ``r`` at thread row ``i`` is row ``planned_overlap_rows()[i, r]``,
    as the (..., JOIN_BLOCK // 16) int16 mask words the write pass reads:
    bit ``b`` of word ``w`` is row ``16w + b``. Of half ``h``, the low
    nibbles of threads ``4u .. 4u + 3`` make word ``128h + u`` in order, their
    high nibbles word ``128h + 64 + u``."""
    b = torch.as_tensor(bits).long()
    shifts = torch.tensor([0, 4, 8, 12], device=b.device)

    def pack(nibbles):  # four threads' nibbles a word
        return (nibbles.view(*nibbles.shape[:-1], -1, 4) << shifts).sum(dim=-1)

    halves = b.view(*b.shape[:-1], 2, 256)
    words = torch.cat([pack(halves & 0xF), pack((halves >> 4) & 0xF)], dim=-1)  # (..., 2, 128)
    return words.reshape(*b.shape[:-1], -1).to(torch.int16)


def overlap_edge_possible(x0, y0, x1, y1, keys, boxes, times) -> torch.Tensor:
    """The overlap edge gather's per-warp skip, plain: which (row group,
    query) pairs can hold an edge candidate. ``x0, y0, x1, y1`` (xmin, ymin,
    xmax, ymax) and ``keys`` (the biased time keys of :func:`chunk_extents`)
    are (G, R), a group's rows as one warp of the kernel holds them
    (:func:`overlap_warp_rows`); ``boxes`` (Q, B, 4), ``times`` (Q, T, 4).
    Returns (G, Q) bool: True where a live box has ``qxhi`` in the group's
    [min xmin, max xmin], ``qxlo`` in [min xmax, max xmax], ``qyhi`` in
    [min ymin, max ymin] or ``qylo`` in [min ymax, max ymax], or a live
    window has an endpoint in [min key, max key]. A row can share an
    opposing edge bucket with a box, or sit at a window's endpoint, only
    then, so a group this returns False for holds no candidate of
    :func:`overlap_masks` (``edges=True``): the kernel runs the edge test
    only where it is True."""
    def span(v):
        return v.long().amin(dim=1)[:, None, None], v.long().amax(dim=1)[:, None, None]

    def within(v, lo_hi):
        return (lo_hi[0] <= v[None]) & (v[None] <= lo_hi[1])

    b = boxes.long()
    live = (b[..., 0] <= b[..., 1]) & (b[..., 2] <= b[..., 3])
    box = live[None] & (within(b[..., 1], span(x0)) | within(b[..., 0], span(x1))
                        | within(b[..., 3], span(y0)) | within(b[..., 2], span(y1)))
    t = times.long()
    lo, hi = _time_keys(t[..., 0], t[..., 1]), _time_keys(t[..., 2], t[..., 3])
    k = span(keys)
    win = (lo <= hi)[None] & (within(lo, k) | within(hi, k))
    return box.any(dim=2) | win.any(dim=2)


def batched_edge_gather_overlap(cols, base: int, true_n: int, boxes, times,
                                capacity: int = EDGE_CAPACITY):
    """:func:`batched_overlap` with time plus each query's edge candidates,
    one pass: the overlap form of :func:`batched_edge_gather`.

    ``cols``: (xmin, ymin, xmax, ymax, bins, offs). Returns ``(counts (Q,)
    int32, positions (Q, 1, capacity) int32, hits (Q, 1) int32)`` under the
    point form's lane contract. A row is a candidate of query ``q`` when it
    matches ``q`` and overlaps a live box of ``q`` with one of ``xmin ==
    qxhi``, ``xmax == qxlo``, ``ymin == qyhi``, ``ymax == qylo``, or lies at
    an endpoint of a live window (:func:`overlap_masks`). On the card
    ``csrc/batched_edge_gather.cu``'s overlap instance, which runs the edge
    test only on the warps where :func:`overlap_edge_possible` allows a
    candidate, and sorts the lanes as :func:`batched_edge_gather` does."""
    _check_box_args(cols, boxes, times)
    if times is None:
        raise ValueError("the overlap edge gather needs the time columns and windows")
    x = cols[0]
    _check_edge_capacity(capacity, base, x)
    if x.device.type == "cpu":
        return batched_edge_gather_overlap_plain(cols, base, true_n, boxes, times, capacity)
    if x.device.type != "cuda":
        raise ValueError(f"batched_edge_gather_overlap runs on cuda or cpu, not {x.device}")
    return _edge_outputs(boxes.shape[0], capacity, x, lambda *outs: _launch_overlap(
        "geomesa_batched_edge_gather_overlap", "batched_edge_gather_overlap", cols, base, true_n,
        boxes, times, *outs, ints=(int(capacity),)))


def batched_edge_gather_overlap_plain(cols, base: int, true_n: int, boxes, times,
                                      capacity: int = EDGE_CAPACITY, chunk: int = 1 << 20):
    """The plain PyTorch version of :func:`batched_edge_gather_overlap`: the
    reference's ``one`` in overlap mode, chunked over rows."""
    return _gather_lanes(_overlap_plain_masks(cols, base, true_n, boxes, times, chunk,
                                              edges=True),
                         boxes.shape[0], base, capacity, cols[0].device)


def planned_gather_overlap(cols, true_n: int, pair_q, pair_blk, boxes, times, plan=None):
    """:func:`planned_gather` over the bbox columns ``cols`` (xmin, ymin,
    xmax, ymax, bins, offs) with the overlap predicate: the overlap form of
    ``select_many``'s retrieval. Same pairs, plan and outputs; on the card
    ``csrc/planned_gather.cu``'s overlap count pass (two 256-thread blocks a
    distinct block, one a half, 8 rows a thread in registers as
    :func:`planned_overlap_rows` names them, each pair's mask regrouped by
    :func:`overlap_mask_words`' rule) and the shared write pass."""
    _check_pair_args(cols, pair_q, pair_blk, boxes, times)
    if cols[0].device.type == "cpu":
        return planned_gather_overlap_plain(cols, true_n, pair_q, pair_blk, boxes, times)
    return _planned_launch("geomesa_planned_gather_overlap_count", "planned_gather_overlap", cols,
                           true_n, pair_q, pair_blk, boxes, times, plan)


def planned_gather_overlap_plain(cols, true_n: int, pair_q, pair_blk, boxes, times):
    """The plain PyTorch version of :func:`planned_gather_overlap`."""
    return _planned_plain(cols, true_n, pair_q, pair_blk, boxes, times, overlap_masks)


# ---------------------------------------------------------------------------
# planned_count
# ---------------------------------------------------------------------------

PLANNED_COUNT_BLOCKS = (1024, 4096)  # block sizes the card's kernel is built for


def _check_planned_count_args(cols, pair_q, pair_blk, boxes, times, block_rows: int):
    if len(cols) == 4:
        _check_count_args(*cols, boxes, times)
    elif len(cols) == 6:
        _check_box_args(cols, boxes, times)
    else:
        raise ValueError("give (x, y, bins, offs) or (xmin, ymin, xmax, ymax, bins, offs)")
    x = cols[0]
    if block_rows < 1 or x.shape[0] % block_rows:
        raise ValueError(f"columns of {x.shape[0]} rows are not a multiple of block_rows "
                         f"{block_rows}")
    for name, t in (("pair_q", pair_q), ("pair_blk", pair_blk)):
        if not isinstance(t, torch.Tensor) or t.dtype != torch.int32 or t.dim() != 1:
            raise TypeError(f"{name} must be a 1-D int32 tensor")
        if not t.is_contiguous() or t.device != x.device:
            raise ValueError(f"{name} must be contiguous and on {x.device}")
    if pair_q.shape != pair_blk.shape:
        raise ValueError("pair_q and pair_blk must have one length")


def planned_count(cols, true_n: int, pair_q, pair_blk, boxes, times,
                  block_rows: int) -> torch.Tensor:
    """Index-pruned counts over planned (query, block) pairs, one batch.

    ``cols``: the (N,) int32 ``x, y, bins, offs`` columns or, in the
    overlap form, ``xmin, ymin, xmax, ymax, bins, offs``, N a multiple of
    ``block_rows`` (else ``ValueError``); ``pair_q``/``pair_blk``: (P,)
    int32 pair lists on the columns' device, a pair with query -1
    (``pad_block_pairs``' padding) counting nothing; ``boxes`` (Q, B, 4) /
    ``times`` (Q, T, 4) int32 payloads. Returns (Q,) int32: per query the
    rows of its pairs' blocks below ``true_n`` that pass it
    (:func:`row_masks`, or :func:`overlap_masks` in the overlap form).

    On the card (``csrc/planned_count.cu``, ``block_rows`` 1024 or 4096) one
    CTA per pair reads the pair's block, stages its query and adds its
    matches to the query's count with one atomic; an empty pair list
    launches nothing. On the CPU: :func:`planned_count_plain`."""
    _check_planned_count_args(cols, pair_q, pair_blk, boxes, times, block_rows)
    x = cols[0]
    if x.device.type == "cpu":
        return planned_count_plain(cols, true_n, pair_q, pair_blk, boxes, times, block_rows)
    if x.device.type != "cuda":
        raise ValueError(f"planned_count runs on cuda or cpu, not {x.device}")
    if block_rows not in PLANNED_COUNT_BLOCKS:
        raise ValueError(f"the card's planned_count takes block_rows in {PLANNED_COUNT_BLOCKS}, "
                         f"not {block_rows}")
    q = boxes.shape[0]
    counts = torch.zeros(q, dtype=torch.int32, device=x.device)
    n_pairs = pair_q.shape[0]
    if n_pairs == 0 or q == 0 or x.shape[0] == 0:
        return counts
    for i, t in enumerate((*cols, boxes, times)):
        if t.data_ptr() % 16:
            raise ValueError(f"planned_count: input {i} must start on a 16-byte boundary "
                             "(the kernel loads 16-byte vectors)")
    ptrs = [c.data_ptr() for c in cols] + [None] * (6 - len(cols))
    with _on_device(x.device):
        rc = _fn("geomesa_planned_count")(
            *ptrs, x.shape[0], int(true_n), pair_q.data_ptr(), pair_blk.data_ptr(), n_pairs,
            boxes.data_ptr(), times.data_ptr(), q, boxes.shape[1], times.shape[1], block_rows,
            int(len(cols) == 6), counts.data_ptr(), _stream_of(x))
    if rc != 0:
        raise RuntimeError(f"planned_count launch failed: cudaError {rc}")
    launches["planned_count"] += 1
    return counts


def planned_count_plain(cols, true_n: int, pair_q, pair_blk, boxes, times,
                        block_rows: int) -> torch.Tensor:
    """The plain PyTorch version of :func:`planned_count`: each live pair's
    block is gathered (a row of the columns viewed as (N / block_rows,
    block_rows)) and tested against its one query, in chunks of at most
    ``PLANNED_CHUNK_ROWS`` gathered rows, as :func:`planned_gather_plain`
    bounds its memory."""
    x = cols[0]
    counts = torch.zeros(boxes.shape[0], dtype=torch.int64, device=x.device)
    pq, pb = pair_q.long(), pair_blk.long()
    live = pq >= 0
    pq, pb = pq[live], pb[live]
    masks_of = overlap_masks if len(cols) == 6 else row_masks
    blocks = [c.view(-1, block_rows) for c in cols]
    lrow = torch.arange(block_rows, device=x.device)
    step = max(1, PLANNED_CHUNK_ROWS // block_rows)
    for s in range(0, pq.shape[0], step):
        q, b = pq[s:s + step], pb[s:s + step]
        m, _ = masks_of(*(c.index_select(0, b) for c in blocks),
                        boxes.index_select(0, q), times.index_select(0, q))
        m &= (b[:, None] * block_rows + lrow[None, :]) < int(true_n)
        counts.index_add_(0, q, m.sum(dim=1))
    return counts.to(torch.int32)


# ---------------------------------------------------------------------------
# corridor_masks
# ---------------------------------------------------------------------------


CORRIDOR_WORD_BITS = 32  # rows a mask word of corridor_masks holds (csrc: a warp's ballot)
# the gather form's dequantization (csrc LON_CELL, LAT_CELL): each
# dimension's lower end and a normalized 31-bit cell's width in degrees,
# exact in f64
_CORRIDOR_CELLS = ((-180.0, 360.0 / 2**31), (-90.0, 180.0 / 2**31))


def corridor_words(n: int) -> int:
    """Mask words a corridor takes over ``n`` rows: ceil(n / 32)."""
    return (int(n) + CORRIDOR_WORD_BITS - 1) // CORRIDOR_WORD_BITS


def corridor_dequantize(x: torch.Tensor, y: torch.Tensor,
                        dtype: torch.dtype = torch.float32) -> tuple[torch.Tensor, torch.Tensor]:
    """Resident 31-bit normalized ``x, y`` (int32) → degrees, the gather
    form's one rule: the cell's centre, ``lo + (i + 0.5) * cell`` in f64
    (exact: every term is a multiple of 2^-30, under 2^38 of them), rounded
    once to ``dtype`` (f32, as ``csrc/corridor_masks.cu`` computes it; f64
    keeps the exact centre). The centre is within half a cell (8.4e-8
    degrees of longitude, 4.2e-8 of latitude) of every value the cell
    holds; the f32 rounding adds at most half an f32 ulp (7.6e-6 near
    180)."""
    cx, cy = (((v.double() + 0.5) * cell + lo).to(dtype)
              for v, (lo, cell) in zip((x, y), _CORRIDOR_CELLS))
    return cx, cy


# the kernel's reach box (csrc REACH_SCALE, REACH_PAD, REACH_REL)
CORRIDOR_REACH = (1.001, 1e-3, 1e-6)


def corridor_reach_boxes(segs: torch.Tensor, buf2_hi: torch.Tensor) -> torch.Tensor:
    """The plain form of the kernel's reach boxes: each segment's bbox grown
    by ``sqrt(buf2_hi) * 1.001 + 1e-3 + 1e-6 * m`` (``m`` the segment's
    largest |coordinate|), in f32, (Q, S, 4) [xlo, xhi, ylo, yhi]. The
    kernel skips the distance test of a row outside its segment's box:
    such a row's f32 squared distance exceeds ``buf2_hi`` (the argument is
    in ``csrc/corridor_masks.cu``), so neither band holds it; a negative
    ``buf2_hi`` gives NaN edges, which skip nothing."""
    scale, pad, rel = (torch.tensor(v, dtype=torch.float32) for v in CORRIDOR_REACH)
    x1, y1, x2, y2 = segs.unbind(dim=2)
    m = torch.maximum(torch.maximum(x1.abs(), x2.abs()), torch.maximum(y1.abs(), y2.abs()))
    reach = (torch.sqrt(buf2_hi)[:, None] * scale + pad) + m * rel
    return torch.stack([torch.minimum(x1, x2) - reach, torch.maximum(x1, x2) + reach,
                        torch.minimum(y1, y2) - reach, torch.maximum(y1, y2) + reach], dim=2)


def pack_mask_words(masks: torch.Tensor) -> torch.Tensor:
    """(Q, N) bool → (Q, ceil(N / 32)) int32 words, bit j of word w the row
    32 w + j (the kernel's ballot order), the bits past N zero."""
    q, n = masks.shape
    w = corridor_words(n)
    padded = torch.zeros((q, w * CORRIDOR_WORD_BITS), dtype=torch.int64, device=masks.device)
    padded[:, :n] = masks.long()
    shifts = torch.arange(CORRIDOR_WORD_BITS, dtype=torch.int64, device=masks.device)
    words = (padded.view(q, w, CORRIDOR_WORD_BITS) << shifts).sum(dim=2)
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def unpack_mask_words(words: torch.Tensor, n: int) -> torch.Tensor:
    """The inverse of :func:`pack_mask_words`: (Q, W) int32 words → (Q, n)
    bool."""
    shifts = torch.arange(CORRIDOR_WORD_BITS, dtype=torch.int64, device=words.device)
    bits = (words.long()[..., None] >> shifts) & 1
    return bits.reshape(words.shape[0], -1)[:, :n].bool()


def _check_vectors(specs, n: int, device) -> None:
    """Each ``(name, tensor, dtype)`` a contiguous 1-D tensor of ``n`` on
    ``device``."""
    for name, t, dtype in specs:
        if not isinstance(t, torch.Tensor) or t.dtype != dtype or t.dim() != 1:
            raise TypeError(f"{name} must be a 1-D {dtype} tensor")
        if not t.is_contiguous() or t.shape[0] != n or t.device != device:
            raise ValueError(f"{name} must be contiguous, of length {n} and on {device}")


def _check_corridor_payload(segs, tq, brg, bands, device) -> None:
    q = segs.shape[0] if isinstance(segs, torch.Tensor) else -1
    for name, t, dtype, shape in (("segs", segs, torch.float32, None),
                                  ("tq", tq, torch.int32, None),
                                  ("brg", brg, torch.float32, segs.shape[:2]),
                                  *((nm, b, torch.float32, (q,)) for nm, b in
                                    zip(("buf2_lo", "buf2_hi", "tol_lo", "tol_hi"), bands))):
        if not isinstance(t, torch.Tensor) or t.dtype != dtype:
            raise TypeError(f"{name} must be a {dtype} tensor")
        if shape is None and (t.dim() != 3 or t.shape[2] != 4 or t.shape[:2] != segs.shape[:2]):
            raise ValueError(f"{name} must have shape (Q, S, 4), one for segs and tq")
        if shape is not None and tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} must have shape {tuple(shape)}")
        if not t.is_contiguous() or t.device != device:
            raise ValueError(f"{name} must be contiguous and on {device}")
    if segs.shape[1] < 1:
        raise ValueError("corridors need at least one segment slot")


def _check_corridor_args(cx, cy, bins, offs, hdg, segs, tq, brg, bands):
    if not isinstance(cx, torch.Tensor):
        raise TypeError("cx must be a 1-D torch.float32 tensor")
    _check_vectors((("cx", cx, torch.float32), ("cy", cy, torch.float32),
                    ("bins", bins, torch.int32), ("offs", offs, torch.int32),
                    ("hdg", hdg, torch.float32)), cx.shape[0], cx.device)
    _check_corridor_payload(segs, tq, brg, bands, cx.device)


def _check_corridor_gather_args(x, y, bins, offs, pos, hdg, segs, tq, brg, bands,
                                heading: bool):
    if not isinstance(x, torch.Tensor) or not isinstance(pos, torch.Tensor):
        raise TypeError("x and pos must be 1-D torch.int32 tensors")
    _check_vectors((("x", x, torch.int32), ("y", y, torch.int32), ("bins", bins, torch.int32),
                    ("offs", offs, torch.int32)), x.shape[0], x.device)
    _check_vectors((("pos", pos, torch.int32),), pos.shape[0], x.device)
    if heading or hdg is not None:
        _check_vectors((("hdg", hdg, torch.float32),), pos.shape[0], x.device)
    _check_corridor_payload(segs, tq, brg, bands, x.device)


def _corridor_launch(entry: str, counter: str, rows: tuple, n: int, segs, tq, brg, bands,
                     heading: bool, bidirectional: bool, device):
    """Allocate the two (Q, W) word masks and launch ``entry`` (the row or
    the gather form) over ``n`` rows, ``rows`` the form's row pointers;
    nothing is launched for no rows or no corridors."""
    q, s = segs.shape[0], segs.shape[1]
    out = torch.empty((2, q, corridor_words(n)), dtype=torch.int32, device=device)
    if q == 0 or n == 0:
        return out[0], out[1]
    for name, t in (("segs", segs), ("tq", tq)):
        if t.data_ptr() % 16:
            raise ValueError(f"corridor_masks: {name} must start on a 16-byte boundary "
                             "(the kernel loads 16-byte vectors)")
    with _on_device(device):
        rc = _fn(entry)(*rows, n, segs.data_ptr(), tq.data_ptr(), brg.data_ptr(),
                        *(b.data_ptr() for b in bands), q, s, int(bool(heading)),
                        int(bool(bidirectional)), out[0].data_ptr(), out[1].data_ptr(),
                        _stream_of(segs))
    if rc != 0:
        raise RuntimeError(f"{counter} launch failed: cudaError {rc}")
    launches[counter] += 1
    return out[0], out[1]


def corridor_masks(cx, cy, bins, offs, hdg, segs, tq, brg, buf2_lo, buf2_hi, tol_lo, tol_hi,
                   heading: bool, bidirectional: bool):
    """The corridor engine's two band masks over N rows and Q corridors,
    the row form.

    ``cx, cy``: (N,) f32 row coordinates in degrees; ``bins, offs``: (N,)
    int32 time columns; ``hdg``: (N,) f32 headings in degrees (read only
    with ``heading``); ``segs`` (Q, S, 4) f32 [x1, y1, x2, y2]; ``tq`` (Q,
    S, 4) int32 time quads [bin_lo, off_lo, bin_hi, off_hi]; ``brg`` (Q, S)
    f32 segment bearings; ``buf2_lo``, ``buf2_hi``, ``tol_lo``, ``tol_hi``
    (Q,) f32 bands. Returns ``(cand, sure)``, (Q, ceil(N / 32)) int32
    words in :func:`pack_mask_words`' layout (:func:`unpack_mask_words`
    gives the (Q, N) bools): a row is in ``cand`` of a corridor when some
    segment has the row's squared f32 distance at most ``buf2_hi``, its
    (bin, offset) inside the segment's quad and, with ``heading``, its
    heading within ``tol_hi`` of the bearing (``bidirectional``: of the
    bearing or its reverse; a tolerance of 360 or more accepts any heading,
    NaN included); ``sure`` the same with ``buf2_lo`` and ``tol_lo``. The
    reference's ``make_corridor_step`` (``geomesa_tpu/parallel/query.py:1371``).

    On the card (``csrc/corridor_masks.cu``) four rows a thread, the
    corridors staged in shared memory, the f32 arithmetic in the plain
    version's order with round-to-nearest intrinsics (no FMA), so the words
    equal :func:`corridor_masks_plain`'s bit for bit. On the CPU: the plain
    version."""
    bands = (buf2_lo, buf2_hi, tol_lo, tol_hi)
    _check_corridor_args(cx, cy, bins, offs, hdg, segs, tq, brg, bands)
    if cx.device.type == "cpu":
        return corridor_masks_plain(cx, cy, bins, offs, hdg, segs, tq, brg, *bands,
                                    heading, bidirectional)
    if cx.device.type != "cuda":
        raise ValueError(f"corridor_masks runs on cuda or cpu, not {cx.device}")
    rows = (cx.data_ptr(), cy.data_ptr(), bins.data_ptr(), offs.data_ptr(), hdg.data_ptr())
    return _corridor_launch("geomesa_corridor_masks", "corridor_masks", rows, cx.shape[0], segs,
                            tq, brg, bands, heading, bidirectional, cx.device)


def corridor_masks_plain(cx, cy, bins, offs, hdg, segs, tq, brg, buf2_lo, buf2_hi, tol_lo,
                         tol_hi, heading: bool, bidirectional: bool):
    """The plain PyTorch version of :func:`corridor_masks`: the reference's
    per-corridor map, (S, N) intermediates one corridor at a time, each f32
    operation a torch op of its own (so none fuses into an FMA), the masks
    packed by :func:`pack_mask_words`."""
    q, n = segs.shape[0], cx.shape[0]
    cand = torch.zeros((q, n), dtype=torch.bool, device=cx.device)
    sure = torch.zeros_like(cand)
    key = _time_keys(bins, offs)[None, :]
    px, py = cx[None, :], cy[None, :]
    for qi in range(q):
        sg = segs[qi]
        x1, y1, x2, y2 = (sg[:, i, None] for i in range(4))
        dx, dy = x2 - x1, y2 - y1
        len2 = dx * dx + dy * dy
        safe = torch.where(len2 > 0, len2, torch.ones_like(len2))
        tp = ((px - x1) * dx + (py - y1) * dy) / safe
        tp = torch.where(len2 > 0, tp, torch.zeros_like(tp)).clamp(0.0, 1.0)
        ex = px - (x1 + tp * dx)
        ey = py - (y1 + tp * dy)
        d2 = ex * ex + ey * ey
        t = tq[qi]
        ok = (key >= _time_keys(t[:, 0], t[:, 1])[:, None]) \
            & (key <= _time_keys(t[:, 2], t[:, 3])[:, None])
        c = ok & (d2 <= buf2_hi[qi])
        s = ok & (d2 <= buf2_lo[qi])
        if heading:
            diff = torch.abs(torch.remainder(hdg[None, :] - brg[qi][:, None] + 180.0, 360.0)
                             - 180.0)
            if bidirectional:
                diff = torch.minimum(diff, 180.0 - diff)
            c &= (diff <= tol_hi[qi]) | (tol_hi[qi] >= 360.0)
            s &= (diff <= tol_lo[qi]) | (tol_lo[qi] >= 360.0)
        cand[qi] = c.any(dim=0)
        sure[qi] = s.any(dim=0)
    return pack_mask_words(cand), pack_mask_words(sure)


def corridor_masks_gather(x, y, bins, offs, pos, hdg, segs, tq, brg, buf2_lo, buf2_hi, tol_lo,
                          tol_hi, heading: bool, bidirectional: bool):
    """:func:`corridor_masks` over a point state's resident rows, the gather
    form: ``x, y, bins, offs`` the state's (R,) int32 sorted columns
    (``IndexState.spatial_cols()``), ``pos`` (C,) int32 candidate
    sorted-order positions, each below R (not checked: the plain version
    raises on one past R, the kernel would read past the columns), ``hdg``
    (C,) f32 headings aligned with the candidates, or None without
    ``heading``; the corridors as in :func:`corridor_masks`. Each
    candidate's coordinates are :func:`corridor_dequantize`'s. Returns
    ``(cand, sure)``, (Q, ceil(C / 32)) int32 words over the candidates.

    On the card one launch of the row form's kernel reading its rows
    through ``pos``, equal to :func:`corridor_masks_gather_plain` bit for
    bit; on the CPU that plain version."""
    bands = (buf2_lo, buf2_hi, tol_lo, tol_hi)
    _check_corridor_gather_args(x, y, bins, offs, pos, hdg, segs, tq, brg, bands, heading)
    if x.device.type == "cpu":
        return corridor_masks_gather_plain(x, y, bins, offs, pos, hdg, segs, tq, brg, *bands,
                                           heading, bidirectional)
    if x.device.type != "cuda":
        raise ValueError(f"corridor_masks_gather runs on cuda or cpu, not {x.device}")
    rows = (x.data_ptr(), y.data_ptr(), bins.data_ptr(), offs.data_ptr(), pos.data_ptr(),
            None if hdg is None else hdg.data_ptr())
    return _corridor_launch("geomesa_corridor_masks_gather", "corridor_masks_gather", rows,
                            pos.shape[0], segs, tq, brg, bands, heading, bidirectional,
                            x.device)


def corridor_masks_gather_plain(x, y, bins, offs, pos, hdg, segs, tq, brg, buf2_lo, buf2_hi,
                                tol_lo, tol_hi, heading: bool, bidirectional: bool):
    """The plain PyTorch version of :func:`corridor_masks_gather`: the
    candidates' columns gathered, dequantized by :func:`corridor_dequantize`
    and fed to :func:`corridor_masks_plain`."""
    p = pos.long()
    cx, cy = corridor_dequantize(x[p], y[p])
    h = hdg if hdg is not None else torch.zeros_like(cx)
    return corridor_masks_plain(cx, cy, bins[p], offs[p], h, segs, tq, brg, buf2_lo, buf2_hi,
                                tol_lo, tol_hi, heading, bidirectional)


# ---------------------------------------------------------------------------
# batched_density
# ---------------------------------------------------------------------------


def density_scale(lo: torch.Tensor, hi: torch.Tensor, cells: int) -> torch.Tensor:
    """``cells / (hi - lo + 1)`` in f32, each step rounded alone, as the
    reference computes a grid's scale (``parallel/query.py:1252``): f32
    bounds, a correctly rounded division (not torch's ``cells / t``, which
    multiplies by the reciprocal)."""
    d = (hi - lo) + 1.0
    return torch.full_like(d, float(cells)) / d


def density_cells(v: torch.Tensor, lo: torch.Tensor, scale: torch.Tensor,
                  cells: int) -> torch.Tensor:
    """The cell of f32 coordinates ``v`` along an axis of ``cells`` cells
    from ``lo`` at ``scale`` (:func:`density_scale`): ``clip(int((v - lo) *
    scale), 0, cells - 1)`` in f32, truncating toward zero
    (``parallel/query.py:1254``). The product is clamped into [-1, cells]
    first (a NaN to 0), which gives XLA's saturating conversion's cell for
    any product, where torch's own conversion of an out-of-range float is
    undefined. Returns int64 cells."""
    f = (v - lo) * scale
    f = torch.where(torch.isnan(f), 0.0, f).clamp(-1.0, float(cells))
    return f.to(torch.int32).clamp(0, cells - 1).long()


def _check_density_args(x, boxes, grid_bounds, width: int, height: int) -> None:
    if not isinstance(grid_bounds, torch.Tensor) or grid_bounds.dtype != torch.int32:
        raise TypeError("grid_bounds must be an int32 tensor")
    if tuple(grid_bounds.shape) != (boxes.shape[0], 4) or not grid_bounds.is_contiguous() \
            or grid_bounds.device != x.device:
        raise ValueError(f"grid_bounds must be a contiguous ({boxes.shape[0]}, 4) tensor on "
                         f"{x.device}")
    if width < 1 or height < 1 or width * height >= 2**31:
        raise ValueError(f"need 1 <= width, height and width x height < 2^31, got {width} x "
                         f"{height}")


def batched_density(x, y, bins, offs, base: int, true_n: int, boxes, times, grid_bounds,
                    width: int, height: int) -> torch.Tensor:
    """Q bbox+time density grids over one int32 column slice, one pass.

    ``x, y, bins, offs``, ``base``, ``true_n``, ``boxes`` and ``times`` as
    :func:`batched_count`; ``grid_bounds`` (Q, 4) int32 [xlo, xhi, ylo, yhi]
    in the columns' normalized domain, each query's own. Returns (Q,
    height, width) float32 grids: each row matching query q adds 1.0 to its
    cell (:func:`density_cells` of its x and y against q's bounds); a
    matching row outside the bounds lands in an edge cell, as in the
    reference's step. Row 0 is the ylo edge.

    On the card (``csrc/batched_density.cu``) each block culls per 4096-row
    chunk, as :func:`batched_edge_gather` does, and adds each match with a
    global atomic; on the CPU :func:`batched_density_plain`."""
    _check_count_args(x, y, bins, offs, boxes, times)
    _check_density_args(x, boxes, grid_bounds, width, height)
    if x.device.type == "cpu":
        return batched_density_plain(x, y, bins, offs, base, true_n, boxes, times, grid_bounds,
                                     width, height)
    if x.device.type != "cuda":
        raise ValueError(f"batched_density runs on cuda or cpu, not {x.device}")
    grids = torch.zeros((boxes.shape[0], height, width), dtype=torch.float32, device=x.device)
    _launch("batched_density", x, y, bins, offs, base, true_n, boxes, times, grid_bounds, grids,
            ints=(int(width), int(height)))
    return grids


def batched_density_plain(x, y, bins, offs, base: int, true_n: int, boxes, times, grid_bounds,
                          width: int, height: int, chunk: int = 1 << 20) -> torch.Tensor:
    """The plain PyTorch version of :func:`batched_density`: the reference's
    scatter form (``parallel/query.py:1215-1261``), every query at once and
    chunked over rows, ``index_add_`` of the matches into the flat grids."""
    q = boxes.shape[0]
    grids = torch.zeros(q * height * width, dtype=torch.float32, device=x.device)
    gb = grid_bounds.float()
    xlo, xhi, ylo, yhi = (gb[:, i, None] for i in range(4))
    sx, sy = density_scale(xlo, xhi, width), density_scale(ylo, yhi, height)
    at = torch.arange(q, device=x.device)[:, None] * (height * width)
    for s, e, m, _ in _plain_masks(x, y, bins, offs, base, true_n, boxes, times, chunk):
        cx = density_cells(x[s:e].float()[None, :], xlo, sx, width)
        cy = density_cells(y[s:e].float()[None, :], ylo, sy, height)
        flat = (at + cy * width + cx)[m]
        grids.index_add_(0, flat, torch.ones(flat.shape[0], dtype=torch.float32,
                                             device=x.device))
    return grids.view(q, height, width)


# ---------------------------------------------------------------------------
# batched_knn
# ---------------------------------------------------------------------------

KNN_MAX_K = 256  # neighbours a query the card's kernel keeps at most (csrc MAX_K)
KNN_TILE_ROWS = 256  # rows under one extent in the card's select (csrc TILE)
KNN_CHUNK_ROWS = 2048  # rows a block of the select decodes at once (csrc CH)
KNN_SAMPLE_ROWS = 1 << 18  # rows the cap's sample pass aims at (csrc SAMPLE_ROWS)
KNN_MIN_STRIDE = 16  # the sample takes at most every 16th row (csrc MIN_STRIDE)
_KNN_SX = 360.0 / 2**31  # the decode's scales (parallel/query.py:971-972), exact in f32
_KNN_SY = 180.0 / 2**31


def knn_degrees(x: torch.Tensor, y: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Normalized int32 coordinates → f32 degrees, ``f32(x) * (360 / 2^31) -
    180`` and ``f32(y) * (180 / 2^31) - 90``, each step rounded alone (the
    reference's ``_knn_valid_and_degrees``, ``parallel/query.py:968``)."""
    return x.float() * _KNN_SX - 180.0, y.float() * _KNN_SY - 90.0


def _check_knn_args(x, y, qx, qy, k: int) -> None:
    for name, t in (("x", x), ("y", y)):
        if not isinstance(t, torch.Tensor) or t.dtype != torch.int32 or t.dim() != 1:
            raise TypeError(f"{name} must be a 1-D int32 tensor")
        if not t.is_contiguous() or t.shape != x.shape or t.device != x.device:
            raise ValueError(f"{name} must be contiguous and match x in length and device")
    for name, t in (("qx", qx), ("qy", qy)):
        if not isinstance(t, torch.Tensor) or t.dtype != torch.float32 or t.dim() != 1:
            raise TypeError(f"{name} must be a 1-D float32 tensor")
        if not t.is_contiguous() or t.shape != qx.shape or t.device != x.device:
            raise ValueError(f"{name} must be contiguous, as long as qx, and on {x.device}")
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    if x.shape[0] < 1:
        raise ValueError("batched_knn needs at least one row")


def batched_knn(x, y, base: int, true_n: int, qx, qy, k: int):
    """The ``k`` nearest rows of each query point, one pass over the rows.

    ``x, y``: (N,) int32 normalized columns; ``base`` / ``true_n`` as in
    :func:`batched_count` (rows at ``base + lpos >= true_n`` are invalid);
    ``qx, qy``: (Q,) float32 query points in degrees. Distances are planar
    f32 degrees over :func:`knn_degrees`, ``sqrt((xf - qx)^2 + (yf -
    qy)^2)``, each step rounded alone. Returns ``(dist (Q, k) float32, rows
    (Q, k) int32)``: slot j holds the j-th smallest (d2, lpos) over the
    valid rows whose d2 is not NaN, ties to the lower row, as ``sqrt(d2)``
    and the global position ``base + lpos``; a slot past them holds ``(inf,
    base + min(j, N - 1))``, where the reference's ``map`` form puts its inf
    slots.

    On the card (``csrc/batched_knn.cu``; ``k`` at most ``KNN_MAX_K``) a
    select and a merge over a strided sample of the rows (from 32,768
    valid rows up, :func:`knn_sample_rows`), whose k-th distance caps the
    lists of a select and a merge over every row; each select skips the
    (tile, query) pairs :func:`knn_tile_keep_plain` rules out. On the CPU
    :func:`batched_knn_plain`."""
    _check_knn_args(x, y, qx, qy, k)
    n = x.shape[0]
    if int(base) + n > _I32_MAX:
        raise ValueError("base + rows must stay below 2^31: rows are int32")
    if x.device.type == "cpu":
        return batched_knn_plain(x, y, base, true_n, qx, qy, k)
    if x.device.type != "cuda":
        raise ValueError(f"batched_knn runs on cuda or cpu, not {x.device}")
    if k > KNN_MAX_K:
        raise ValueError(f"batched_knn on the card keeps at most {KNN_MAX_K} neighbours, got {k}")
    q, dev = qx.shape[0], x.device
    dist = torch.empty((q, k), dtype=torch.float32, device=dev)
    rows = torch.empty((q, k), dtype=torch.int32, device=dev)
    if q == 0:
        return dist, rows
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    segs = ctypes.c_int()
    with torch.cuda.device(dev):
        rc = _fn("geomesa_batched_knn_segments")(n, q, int(k), sms, ctypes.addressof(segs))
        if rc != 0:
            raise RuntimeError(f"batched_knn occupancy: cudaError {rc}")
        cand_d = torch.empty((q, segs.value, k), dtype=torch.float32, device=dev)
        cand_r = torch.empty((q, segs.value, k), dtype=torch.int32, device=dev)
        cap = torch.empty(q, dtype=torch.float32, device=dev)
        sample_cap = -(-knn_sample_rows(n, base, true_n)[1] // 4) * 4
        sample = torch.empty(max(2 * sample_cap, 1), dtype=torch.int32, device=dev)
        rc = _fn("geomesa_batched_knn")(
            x.data_ptr(), y.data_ptr(), n, int(base), int(true_n), qx.data_ptr(), qy.data_ptr(),
            q, int(k), segs.value, cand_d.data_ptr(), cand_r.data_ptr(), cap.data_ptr(),
            sample.data_ptr(), sample_cap, dist.data_ptr(), rows.data_ptr(), _stream_of(x))
    if rc != 0:
        raise RuntimeError(f"batched_knn launch failed: cudaError {rc}")
    launches["batched_knn"] += 1
    return dist, rows


def batched_knn_plain(x, y, base: int, true_n: int, qx, qy, k: int):
    """The plain PyTorch version of :func:`batched_knn`: the reference's
    ``map`` form (``parallel/query.py:1035``), one query at a time, so memory
    stays O(N). Per query a ``torch.topk`` of the masked d2 (an ineligible
    row as +inf), then a tie fix-up that takes the rows equal to the k-th
    value in row order (``topk`` promises no order among ties), then an
    order by (d2, row)."""
    n = x.shape[0]
    q, dev = qx.shape[0], x.device
    xf, yf = knn_degrees(x, y)
    limit = max(0, min(n, int(true_n) - int(base)))
    valid = torch.arange(n, device=dev) < limit
    kk = min(k, n)
    dist = torch.full((q, k), float("inf"), dtype=torch.float32, device=dev)
    rows = (int(base) + torch.arange(k, device=dev).clamp(max=n - 1)).to(torch.int32)
    rows = rows.repeat(q, 1)
    for qi in range(q):
        dx, dy = xf - qx[qi], yf - qy[qi]
        d2 = dx * dx + dy * dy
        d2 = torch.where(valid & (d2 == d2), d2, float("inf"))
        top = torch.topk(d2, kk, largest=False)
        kth = top.values.max()
        below = top.indices[top.values < kth]
        ties = torch.nonzero(d2 == kth).flatten()[: kk - below.shape[0]]
        idx = torch.cat([below, ties]).sort().values
        idx = idx[torch.sort(d2[idx], stable=True).indices]
        # IEEE f32 roots: the f64 root rounded once is the correctly rounded
        # f32 root (torch's own f32 sqrt on the CPU may be one ulp off)
        dist[qi, :kk] = torch.sqrt(d2[idx].double()).float()
        rows[qi, :kk] = (int(base) + idx).to(torch.int32)
    return dist, rows


def knn_sample_rows(n: int, base: int, true_n: int) -> tuple[int, int]:
    """The card's cap pass over ``n`` rows of which ``limit = min(n, true_n
    - base)`` are valid: ``(stride, sampled rows)``, every stride-th valid
    row from the first; ``(0, 0)`` where there is no sample pass (fewer
    than :data:`KNN_CHUNK_ROWS` sampled rows)."""
    limit = max(0, min(n, int(true_n) - int(base)))
    stride = max(limit // KNN_SAMPLE_ROWS, KNN_MIN_STRIDE)
    if limit // stride < KNN_CHUNK_ROWS:
        return 0, 0
    return stride, -(-limit // stride)


def knn_tile_extents_plain(x, y, base: int, true_n: int) -> torch.Tensor:
    """The decoded extent of each tile of :data:`KNN_TILE_ROWS` rows in the
    card's order (rows ``[t * 256, (t + 1) * 256)`` of ``x, y``), over its
    valid rows: ``(T, 4)`` float32 ``(xlo, xhi, ylo, yhi)`` in degrees
    (:func:`knn_degrees`); a tile with no valid row holds ``(+inf, -inf,
    +inf, -inf)``, an empty extent."""
    n = x.shape[0]
    limit = max(0, min(n, int(true_n) - int(base)))
    tiles = -(-n // KNN_TILE_ROWS)
    pad = tiles * KNN_TILE_ROWS - n
    xf, yf = (torch.nn.functional.pad(v, (0, pad)).view(tiles, KNN_TILE_ROWS)
              for v in knn_degrees(x, y))
    valid = (torch.arange(tiles * KNN_TILE_ROWS, device=x.device) < limit).view(xf.shape)
    inf = torch.tensor(float("inf"), device=x.device)
    return torch.stack([torch.where(valid, xf, inf).amin(1), torch.where(valid, xf, -inf).amax(1),
                        torch.where(valid, yf, inf).amin(1), torch.where(valid, yf, -inf).amax(1)],
                       dim=1)


def knn_tile_bound_plain(ext, qx, qy) -> torch.Tensor:
    """The least d2 of each query over each tile's extent, ``(T, Q)``
    float32, as the card's select takes it: ``dx = max(0, xlo - qx, qx -
    xhi)``, the same for ``dy``, then ``dx^2 + dy^2``, each operation
    rounded alone as the distances are, so it is at most the d2 of every
    row of the tile, bit for bit. A NaN query gives NaN."""
    xlo, xhi, ylo, yhi = (ext[:, i, None] for i in range(4))
    zero = torch.zeros((), dtype=torch.float32, device=ext.device)

    def gap(lo, hi, v):
        d = torch.maximum(lo - v, v - hi)  # maximum propagates NaN
        return torch.where(d < 0, zero, d)
    dx, dy = gap(xlo, xhi, qx[None, :]), gap(ylo, yhi, qy[None, :])
    return dx * dx + dy * dy


def knn_tile_keep_plain(ext, qx, qy, bound) -> torch.Tensor:
    """The (tile, query) pairs the card's select keeps: ``(T, Q)`` bool,
    true where the tile's extent ``ext`` (:func:`knn_tile_extents_plain`)
    is not empty and its lower bound (:func:`knn_tile_bound_plain`) is not
    above the query's ``bound`` (Q,) f32 d2, inclusive. Every other pair
    holds no row whose d2 is at most the bound."""
    lb = knn_tile_bound_plain(ext, qx, qy)
    return (ext[:, :1] <= ext[:, 1:2]) & ~(lb > bound[None, :])


# ---------------------------------------------------------------------------
# polygon_join
# ---------------------------------------------------------------------------

POLYGON_PASS_ROWS = 1024  # rows a CTA of polygon_join stages per pass (csrc PASS)
POLYGON_MAX_VERTS = 512  # ring vertices the card's kernel stages (csrc MAX_VERTS)
POLYGON_PLAIN_CHUNK = 1 << 20  # (edge, row) elements per intermediate of the plain version
POLYGON_GROUP_ROWS = 128  # rows under one x/y extent in the kernel (csrc GROUP)
POLYGON_TILE_ROWS = 8192  # rows of a block the kernel stages at once (csrc TILE)
POLYGON_RUN = 32  # pairs of one work item at most (csrc RUN)
POLYGON_MAX_BANDS = 64  # y-bands of a ring at most (csrc MAX_BANDS)
POLYGON_BAND_CAP = 16384  # band-list entries of a ring at most (csrc BAND_CAP)
POLYGON_BUCKETS = 256  # y-buckets a tile's rows are staged in order of (csrc BUCKETS)


def _check_polygon_args(x, y, pair_poly, pair_blk, verts, nverts, bbox, block: int) -> None:
    for name, t in (("x", x), ("y", y)):
        if not isinstance(t, torch.Tensor) or t.dtype != torch.float32 or t.dim() != 1:
            raise TypeError(f"{name} must be a 1-D float32 tensor")
        if not t.is_contiguous() or t.shape != x.shape or t.device != x.device:
            raise ValueError(f"{name} must be contiguous and match x in length and device")
    if block < 1 or block % POLYGON_PASS_ROWS or x.shape[0] % block:
        raise ValueError(f"block must be a positive multiple of {POLYGON_PASS_ROWS} that "
                         f"divides the {x.shape[0]} rows, got {block}")
    if not isinstance(verts, torch.Tensor) or verts.dtype != torch.float32:
        raise TypeError("verts must be a float32 tensor")
    if verts.dim() != 3 or verts.shape[2] != 2 or verts.shape[1] < 1:
        raise ValueError("verts must have shape (K, V >= 1, 2)")
    k = verts.shape[0]
    for name, t, dtype, shape in (("nverts", nverts, torch.int32, (k,)),
                                  ("bbox", bbox, torch.float32, (k, 4))):
        if not isinstance(t, torch.Tensor) or t.dtype != dtype:
            raise TypeError(f"{name} must be a {dtype} tensor")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}")
    if (pair_poly is None) != (pair_blk is None):
        raise ValueError("pair_poly and pair_blk are both given or both None")
    pairs = () if pair_poly is None else (("pair_poly", pair_poly), ("pair_blk", pair_blk))
    for name, t in pairs:
        if not isinstance(t, torch.Tensor) or t.dtype != torch.int32 or t.dim() != 1:
            raise TypeError(f"{name} must be a 1-D int32 tensor")
        if t.shape != pair_poly.shape:
            raise ValueError("pair_poly and pair_blk must have one length")
    for name, t in (("verts", verts), ("nverts", nverts), ("bbox", bbox), *pairs):
        if not t.is_contiguous() or t.device != x.device:
            raise ValueError(f"{name} must be contiguous and on {x.device}")


def polygon_join(x, y, true_n: int, pair_poly, pair_blk, verts, nverts, bbox,
                 block: int) -> torch.Tensor:
    """Per polygon, the rows strictly inside it by the f32 crossing number,
    over planned (polygon, block) pairs: the block join's count.

    ``x, y``: (N,) float32 resident columns in degrees, N a multiple of
    ``block`` (a positive multiple of ``POLYGON_PASS_ROWS``); ``true_n``:
    rows at it or past it never count; ``pair_poly``/``pair_blk``: (P,)
    int32 pairs on the columns' device, polygon in ``[0, K)`` and block in
    ``[0, N / block)`` (a pair out of range counts nothing), any order, or
    both ``None`` for every block of every polygon; ``verts`` (K, V, 2)
    float32 closed rings padded by repeating their last vertex, ``nverts``
    (K,) int32 their real vertex counts (at most V; the padded edges never
    straddle, so any count from it to V gives the same answer) and
    ``bbox`` (K, 4) float32 [xmin, ymin, xmax, ymax]. A row counts for p
    when it lies inside ``bbox[p]`` and an odd number of p's edges cross
    the rightward ray from it (``_membership``, ``ops/join.py:56``). A
    pair listed twice counts twice. Returns (K,) int32 counts.

    On the card (``csrc/polygon_join.cu``, V at most ``POLYGON_MAX_VERTS``)
    a CTA per work item (a run of at most ``POLYGON_RUN`` pairs and a tile
    of their block, staged in shared memory once, in y order), the rows
    inside each bbox compacted and tested against their y-band's edges
    only; on the CPU :func:`polygon_join_plain`."""
    _check_polygon_args(x, y, pair_poly, pair_blk, verts, nverts, bbox, block)
    if x.device.type == "cpu":
        return polygon_join_plain(x, y, true_n, pair_poly, pair_blk, verts, nverts, bbox, block)
    if x.device.type != "cuda":
        raise ValueError(f"polygon_join runs on cuda or cpu, not {x.device}")
    k, v = verts.shape[0], verts.shape[1]
    if v > POLYGON_MAX_VERTS:
        raise ValueError(f"polygon_join on the card takes at most {POLYGON_MAX_VERTS} vertices "
                         f"a ring, got {v}")
    for name, t in (("x", x), ("y", y), ("bbox", bbox)):
        if t.data_ptr() % 16:
            raise ValueError(f"polygon_join: {name} must start on a 16-byte boundary "
                             "(the kernel loads 16-byte vectors)")
    if verts.data_ptr() % 8:
        raise ValueError("polygon_join: verts must start on an 8-byte boundary")
    counts = torch.zeros(k, dtype=torch.int32, device=x.device)
    n = x.shape[0]
    n_pairs = k * (n // block) if pair_poly is None else pair_poly.shape[0]
    if n_pairs == 0 or k == 0:
        return counts
    with torch.cuda.device(x.device):
        rc = _fn("geomesa_polygon_join")(
            x.data_ptr(), y.data_ptr(), n, int(true_n),
            None if pair_poly is None else pair_poly.data_ptr(),
            None if pair_blk is None else pair_blk.data_ptr(), n_pairs, verts.data_ptr(), v,
            nverts.data_ptr(), bbox.data_ptr(), k, int(block), counts.data_ptr(),
            _stream_of(x))
    if rc != 0:
        raise RuntimeError(f"polygon_join launch failed: cudaError {rc}")
    launches["polygon_join"] += 1
    return counts


def polygon_band_count(nv: int) -> int:
    """The y-bands the card's kernel gives a ring of ``nv`` vertices: half
    of the largest power of two at most ``nv``, at most
    ``POLYGON_MAX_BANDS``, halved until the bands' lists (room for ``nv -
    1`` entries each: a band lists an edge once) fit ``POLYGON_BAND_CAP``;
    at least 1. :func:`band_grid` takes one band for a degenerate bbox."""
    nb = max(1, min(POLYGON_MAX_BANDS, (1 << (max(nv, 1).bit_length() - 1)) // 2))
    while nb > 1 and nb * (nv - 1) > POLYGON_BAND_CAP:
        nb //= 2
    return nb


def band_grid(bbox, nb):
    """The kernel's band grid over each polygon's bbox height: ``bbox`` (...,
    4) float32 [xmin, ymin, xmax, ymax] and ``nb`` the bands asked for (an
    int64 tensor that broadcasts with it) → (bands (...,) int64, inv (...,)
    float32), ``inv = nb / (ymax - ymin)`` rounded once. A zero-height,
    negative, NaN or non-finite height, or an infinite ``inv``, takes one
    band (``inv`` 0)."""
    h = bbox[..., 3] - bbox[..., 1]
    inv = nb.to(torch.float32) / h
    ok = (nb > 1) & (h > 0) & torch.isfinite(h) & torch.isfinite(inv)
    return torch.where(ok, nb, torch.ones_like(nb)), torch.where(ok, inv, torch.zeros_like(inv))


def band_index(ys, ymin, inv, nb):
    """The kernel's j(y) = clamp(trunc((y - ymin) * inv), 0, nb - 1), each
    float32 step rounded alone; 0 where ``nb`` is 1. j is monotone in y, so
    an edge listed in bands j(lo)..j(hi) is in the band of every row whose
    horizontal line it straddles (lo <= y < hi). A NaN step gives 0, as the
    kernel's ``fmaxf`` does. Returns int64."""
    v = (ys - ymin) * inv
    v = torch.minimum(v.clamp(min=0), (nb - 1).to(torch.float32))
    return torch.where(nb > 1, torch.nan_to_num(v, nan=0.0).to(torch.int64), 0)


def polygon_bands_plain(ring, bbox, nb: int | None = None):
    """The plain version of the kernel's y-band lists of one polygon:
    ``ring`` (nv, 2) float32 its first ``nv`` vertices (edges ``(ring[e],
    ring[e + 1])``), ``bbox`` (4,) float32, ``nb`` the bands asked for.
    Each edge with ``lo = min(y1, y2) < hi = max(y1, y2)`` goes into bands
    ``j(lo)..j(hi)``; a horizontal edge or one with a NaN y straddles no
    row's line and goes into none. By default the kernel's count,
    :func:`polygon_band_count`. Returns ``(bands, inv, offsets (bands + 1,)
    int64, edges (M,) int64)``: band j's edges are
    ``edges[offsets[j]:offsets[j + 1]]``, ascending."""
    nv = ring.shape[0]
    want = polygon_band_count(nv) if nb is None else int(nb)
    y1, y2 = ring[:-1, 1], ring[1:, 1]
    lo, hi = torch.minimum(y1, y2), torch.maximum(y1, y2)
    live = lo < hi  # False for a horizontal edge and, minimum propagating NaN, a NaN y
    bands, inv = band_grid(bbox, torch.tensor(want, dtype=torch.int64, device=ring.device))
    j0, j1 = (band_index(v, bbox[1], inv, bands) for v in (lo, hi))
    js = torch.arange(int(bands), device=ring.device)[:, None]
    member = live[None, :] & (j0[None, :] <= js) & (js <= j1[None, :])  # (bands, E)
    offsets = torch.zeros(int(bands) + 1, dtype=torch.int64, device=ring.device)
    offsets[1:] = torch.cumsum(member.sum(dim=1), 0)
    return int(bands), inv, offsets, torch.nonzero(member)[:, 1]


def _band_lengths(verts, nverts, bbox, nb: int | None):
    """Per polygon of a bucket, its bands' list lengths as the kernel builds
    them (``nb`` bands asked for each, or :func:`polygon_band_count`):
    returns (lengths (K, POLYGON_MAX_BANDS) int64, bands (K,), inv (K,))."""
    k, v = verts.shape[0], verts.shape[1]
    dev = verts.device
    nv = nverts.long().clamp(0, v)
    asked = torch.tensor([polygon_band_count(int(c)) if nb is None else nb for c in nv.tolist()],
                         dtype=torch.int64, device=dev)
    bands, inv = band_grid(bbox, asked)
    y1, y2 = verts[:, :-1, 1], verts[:, 1:, 1]
    lo, hi = torch.minimum(y1, y2), torch.maximum(y1, y2)
    live = (lo < hi) & (torch.arange(v - 1, device=dev)[None, :] < (nv - 1)[:, None])
    j0, j1 = (band_index(t, bbox[:, 1:2], inv[:, None], bands[:, None]) for t in (lo, hi))
    lengths = torch.zeros((k, POLYGON_MAX_BANDS), dtype=torch.int64, device=dev)
    for j in range(POLYGON_MAX_BANDS):
        lengths[:, j] = (live & (j0 <= j) & (j <= j1)).sum(dim=1)
    return lengths, bands, inv


def staged_tile(xs, ys, live):
    """The kernel's staging of tiles, in plain torch: ``xs``, ``ys`` (P, R)
    float32 rows of P tiles, ``live`` (P, R) the rows below true_n. The
    live rows with a y, bucketed by y into ``POLYGON_BUCKETS`` buckets over
    their y range (in row order within a bucket), then NaN padding: returns
    the staged (x, y), each (P, R)."""
    live = live & ~ys.isnan()
    inf = torch.tensor(float("inf"), dtype=ys.dtype, device=ys.device)
    lo = torch.where(live, ys, inf).amin(dim=1, keepdim=True)
    hi = torch.where(live, ys, -inf).amax(dim=1, keepdim=True)
    scale = POLYGON_BUCKETS / (hi - lo)
    scale = torch.where((hi > lo) & torch.isfinite(scale), scale, torch.zeros_like(scale))
    bucket = ((ys - lo) * scale).clamp(0, POLYGON_BUCKETS - 1).nan_to_num(0.0).long()
    order = torch.sort(torch.where(live, bucket, POLYGON_BUCKETS), dim=1, stable=True).indices
    keep = live.gather(1, order)
    nan = torch.full_like(xs, float("nan"))
    return (torch.where(keep, xs.gather(1, order), nan),
            torch.where(keep, ys.gather(1, order), nan))


def polygon_join_work(x, y, true_n: int, pair_poly, pair_blk, verts, nverts, bbox, block: int,
                      nbs=(None,), chunk: int = 64) -> dict:
    """What the card's ``polygon_join`` does on these inputs, counted from
    the data in plain torch, ``chunk`` pairs at a time (on any device):

    - ``pairs``: the valid pairs; ``items``: work items (runs of at most
      ``POLYGON_RUN`` pairs, times the tiles of a block); ``stages``: block
      tiles staged (an item stages again where its block changes);
    - ``tested_rows``: the pairs' rows below ``true_n``; ``groups`` and
      ``groups_met``: the ``POLYGON_GROUP_ROWS``-row groups of their tiles
      as the kernel stages them (:func:`staged_tile`; rows of one y-bucket
      in row order, where the kernel's order within a bucket varies), and
      those whose exact x/y extent meets the polygon's bbox (the rest are
      skipped); ``in_rows``: rows inside the bbox (compacted);
      ``warps_any``: 128-row groups in row order with a row inside the bbox
      (a warp of the one-CTA-per-pair kernel ran its edge loop for each);
    - ``edge_tests``: (in-bbox row, edge) pairs over every edge of the ring;
      ``straddles``: those whose edge straddles the row's horizontal line;
      ``candidates``: per entry of ``nbs`` (bands asked for, ``None`` for
      :func:`polygon_band_count`), the (row, edge) tests of a band walk.

    With ``pair_poly`` None every block is a pair of every polygon."""
    dev = x.device
    k, v = verts.shape[0], verts.shape[1]
    n_blocks = x.shape[0] // block
    if pair_poly is None:
        pp = torch.arange(k, device=dev).repeat_interleave(n_blocks)
        pb = torch.arange(n_blocks, device=dev).repeat(k)
        runs = -(-k // POLYGON_RUN) * n_blocks
        stages = runs
    else:
        pp, pb = pair_poly.long(), pair_blk.long()
        runs = -(-pp.shape[0] // POLYGON_RUN)
        keep = (pp >= 0) & (pp < k) & (pb >= 0) & (pb < n_blocks)
        item = torch.nonzero(keep).flatten() // POLYGON_RUN
        pp, pb = pp[keep], pb[keep]
        # a valid pair stages its block where it starts an item or follows
        # another block in its item
        stages = int(pb.shape[0] and 1) + int(((item[1:] != item[:-1])
                                                | (pb[1:] != pb[:-1])).sum())
    tiles = -(-block // POLYGON_TILE_ROWS)
    nv = nverts.long().clamp(0, v)
    tables = [_band_lengths(verts, nverts, bbox, nb) for nb in nbs]
    out = dict(pairs=int(pp.shape[0]), items=runs * tiles, stages=stages * tiles, tested_rows=0,
               groups=0, groups_met=0, in_rows=0, warps_any=0, edge_tests=0, straddles=0,
               candidates=[0] * len(nbs))
    xb, yb = x.view(n_blocks, block), y.view(n_blocks, block)
    lrow = torch.arange(block, device=dev)
    g = POLYGON_GROUP_ROWS
    e_at = torch.arange(v - 1, device=dev)
    for s in range(0, pp.shape[0], chunk):
        p, b = pp[s:s + chunk], pb[s:s + chunk]
        xs, ys = xb.index_select(0, b), yb.index_select(0, b)
        bb = bbox.index_select(0, p)
        valid = (b[:, None] * block + lrow[None, :]) < int(true_n)
        inside = valid & (xs >= bb[:, 0:1]) & (xs <= bb[:, 2:3]) & (ys >= bb[:, 1:2]) & (
            ys <= bb[:, 3:4])
        for t0 in range(0, block, POLYGON_TILE_ROWS):
            t1 = min(block, t0 + POLYGON_TILE_ROWS)
            sx, sy = staged_tile(xs[:, t0:t1], ys[:, t0:t1], valid[:, t0:t1])
            gx, gy = sx.view(p.shape[0], -1, g), sy.view(p.shape[0], -1, g)
            lo_x = torch.where(gx.isnan(), float("inf"), gx).amin(dim=2)
            hi_x = torch.where(gx.isnan(), float("-inf"), gx).amax(dim=2)
            lo_y = torch.where(gy.isnan(), float("inf"), gy).amin(dim=2)
            hi_y = torch.where(gy.isnan(), float("-inf"), gy).amax(dim=2)
            met = ((hi_x >= bb[:, 0:1]) & (lo_x <= bb[:, 2:3]) & (hi_y >= bb[:, 1:2])
                   & (lo_y <= bb[:, 3:4]))
            out["groups"] += met.numel()
            out["groups_met"] += int(met.sum())
        out["tested_rows"] += int(valid.sum())
        out["warps_any"] += int(inside.view(p.shape[0], -1, g).any(dim=2).sum())
        pi, ri = torch.nonzero(inside, as_tuple=True)
        out["in_rows"] += int(pi.shape[0])
        rp, ry = p[pi], ys[pi, ri]
        out["edge_tests"] += int((nv[rp] - 1).clamp(min=0).sum())
        for r in range(0, rp.shape[0], 1 << 16):
            q, yy = rp[r:r + (1 << 16)], ry[r:r + (1 << 16), None]
            ring = verts.index_select(0, q)
            straddle = (ring[:, :-1, 1] > yy) != (ring[:, 1:, 1] > yy)
            out["straddles"] += int((straddle & (e_at[None, :] < (nv[q] - 1)[:, None])).sum())
        for i, (lengths, bands, inv) in enumerate(tables):
            j = band_index(ry, bbox[rp, 1], inv[rp], bands[rp])
            out["candidates"][i] += int(lengths[rp, j].sum())
    return out


def crossing_parity(xs, ys, ring, chunk: int = POLYGON_PLAIN_CHUNK) -> torch.Tensor:
    """(R,) bool: an odd number of the closed ``ring``'s (E + 1, 2) float32
    edges cross the rightward ray from each f32 point, ``_membership``'s
    crossing number (``ops/join.py:63-72``) without its bbox term: straddle
    ``(y1 > y) != (y2 > y)``, ``xint = x1 + (y - y1) * (x2 - x1) / dy``
    (``dy`` 1 where it is 0), each step rounded alone, and ``x < xint``.
    Rows run in chunks of at most ``chunk`` (edge, row) elements."""
    out = torch.zeros(xs.shape[0], dtype=torch.bool, device=xs.device)
    e = ring.shape[0] - 1
    if e < 1 or xs.shape[0] == 0:
        return out
    x1, y1 = ring[:-1, 0, None], ring[:-1, 1, None]
    x2, y2 = ring[1:, 0, None], ring[1:, 1, None]
    dy = y2 - y1
    safe_dy = torch.where(dy == 0, torch.ones_like(dy), dy)
    dx = x2 - x1
    step = max(1, chunk // e)
    for s in range(0, xs.shape[0], step):
        xc, yc = xs[None, s:s + step], ys[None, s:s + step]
        straddle = (y1 > yc) != (y2 > yc)
        xint = x1 + (yc - y1) * dx / safe_dy
        out[s:s + step] = ((straddle & (xc < xint)).sum(dim=0) % 2).bool()
    return out


def polygon_join_plain(x, y, true_n: int, pair_poly, pair_blk, verts, nverts, bbox, block: int,
                       chunk: int = POLYGON_PLAIN_CHUNK) -> torch.Tensor:
    """The plain PyTorch version of :func:`polygon_join`: per polygon, its
    pairs' blocks gathered (rows of the columns viewed as (N / block,
    block)) a chunk at a time, the rows inside its bbox and below
    ``true_n`` taken by a boolean index, and :func:`crossing_parity` over
    its first ``nverts`` vertices. No intermediate holds more than about
    ``chunk`` elements, so every block of 100M rows never allocates (V,
    N)."""
    k = verts.shape[0]
    dev = x.device
    counts = torch.zeros(k, dtype=torch.int64, device=dev)
    n_blocks = x.shape[0] // block
    if k == 0 or n_blocks == 0:
        return counts.to(torch.int32)
    xb, yb = x.view(n_blocks, block), y.view(n_blocks, block)
    if pair_poly is None:
        order = None
        offsets = [i * n_blocks for i in range(k + 1)]
    else:
        keep = ((pair_poly >= 0) & (pair_poly < k) & (pair_blk >= 0)
                & (pair_blk < n_blocks))
        pp, pb = pair_poly[keep].long(), pair_blk[keep].long()
        order = torch.argsort(pp, stable=True)
        offsets = [0] + torch.cumsum(torch.bincount(pp, minlength=k), 0).tolist()
    nv = nverts.clamp(0, verts.shape[1]).tolist()
    lrow = torch.arange(block, device=dev)
    per = max(1, chunk // block)  # blocks gathered at a time
    for p in range(k):
        s, e = offsets[p], offsets[p + 1]
        if s == e or nv[p] < 1:
            continue
        blks = (torch.arange(n_blocks, device=dev) if order is None else pb[order[s:e]])
        bb = bbox[p]
        ring = verts[p, :nv[p]]
        for c in range(0, blks.shape[0], per):
            b = blks[c:c + per]
            xs, ys = xb.index_select(0, b), yb.index_select(0, b)
            live = ((b[:, None] * block + lrow[None, :]) < int(true_n)) & (
                (xs >= bb[0]) & (xs <= bb[2]) & (ys >= bb[1]) & (ys <= bb[3]))
            counts[p] += crossing_parity(xs[live], ys[live], ring, chunk).sum()
    return counts.to(torch.int32)


# ---------------------------------------------------------------------------
# z3_encode / z2_encode
# ---------------------------------------------------------------------------

# spread masks (curve/zorder.py _M3/_M2), each below 2^63 so they are int64
_M3 = (0x00000000001FFFFF, 0x001F00000000FFFF, 0x001F0000FF0000FF,
       0x100F00F00F00F00F, 0x10C30C30C30C30C3, 0x1249249249249249)
_M3_SHIFTS = (32, 16, 8, 4, 2)
_M2 = (0x00000000FFFFFFFF, 0x0000FFFF0000FFFF, 0x00FF00FF00FF00FF,
       0x0F0F0F0F0F0F0F0F, 0x3333333333333333, 0x5555555555555555)
_M2_SHIFTS = (16, 8, 4, 2, 1)


def _check_morton_args(cols) -> None:
    x = cols[0]
    for name, t in zip("xyt", cols):
        if not isinstance(t, torch.Tensor) or t.dtype != torch.int32 or t.dim() != 1:
            raise TypeError(f"{name} must be a 1-D int32 tensor")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.shape != x.shape or t.device != x.device:
            raise ValueError(f"{name} must match x in length and device")
    if x.shape[0] >= 2**31:
        raise ValueError("columns of 2^31 rows or more are not taken")


def _encode(name: str, plain, cols) -> torch.Tensor:
    """Check, then run ``name``'s kernel on a CUDA tensor or its ``plain``
    version on a CPU tensor; returns (N,) int64 codes."""
    _check_morton_args(cols)
    x = cols[0]
    if x.device.type == "cpu":
        return plain(*cols)
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {x.device}")
    out = torch.empty(x.shape[0], dtype=torch.int64, device=x.device)
    if x.shape[0] == 0:
        return out
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    with torch.cuda.device(x.device):
        rc = _fn(f"geomesa_{name}")(*(c.data_ptr() for c in cols), x.shape[0], sms,
                                    out.data_ptr(), _stream_of(x))
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")
    launches[name] += 1
    return out


def z3_encode(x, y, t) -> torch.Tensor:
    """Morton-interleave three (N,) int32 columns of ≤21-bit normalized
    coordinates into (N,) int64 z3 codes (bit 63 always 0), on their device.

    Equals ``curve/zorder.encode3`` and the Pallas ``z3_encode``'s
    ``hi << 32 | lo``; each input is masked to its low 21 bits first."""
    return _encode("z3_encode", z3_encode_plain, (x, y, t))


def z2_encode(x, y) -> torch.Tensor:
    """Morton-interleave two (N,) int32 columns of ≤31-bit normalized
    coordinates into (N,) int64 z2 codes, on their device.

    Equals ``curve/zorder.encode2`` and the Pallas ``z2_encode``'s
    ``hi << 32 | lo``; like them it keeps all 32 bits of each input, so only
    a negative input reaches bit 62 or 63."""
    return _encode("z2_encode", z2_encode_plain, (x, y))


def _spread_plain(v: torch.Tensor, masks, shifts) -> torch.Tensor:
    # int64 throughout: torch on the CPU has no shifts on uint32; the first
    # mask takes the input's low bits (two's complement for a negative int32)
    v = v.to(torch.int64) & masks[0]
    for s, m in zip(shifts, masks[1:]):
        v = (v | (v << s)) & m
    return v


def z3_encode_plain(x, y, t) -> torch.Tensor:
    """The plain PyTorch version of :func:`z3_encode`."""
    return (_spread_plain(x, _M3, _M3_SHIFTS) | (_spread_plain(y, _M3, _M3_SHIFTS) << 1)
            | (_spread_plain(t, _M3, _M3_SHIFTS) << 2))


def z2_encode_plain(x, y) -> torch.Tensor:
    """The plain PyTorch version of :func:`z2_encode`."""
    return _spread_plain(x, _M2, _M2_SHIFTS) | (_spread_plain(y, _M2, _M2_SHIFTS) << 1)


# ---------------------------------------------------------------------------
# track_stats
# ---------------------------------------------------------------------------

_RAD2DEG = 180.0 / math.pi
TRACK_TILE = 2048  # rows a block of the card's track_stats takes (csrc TILE)
_TRACK_EPOCHS = (1 << 29) - 1  # launch epochs a track_stats scratch takes (csrc EPOCH_BITS)
_TRACK_SCRATCH: dict = {}  # (device index, stream) → [int32 scratch, the last launch's epoch]


def _track_scratch(dev: torch.device, stream: int, ints: int) -> tuple[torch.Tensor, int]:
    """``track_stats``' scratch for launches on ``stream`` (a status and four
    sums a tile) and the next launch's epoch. A status is tagged with its
    launch's epoch, so launches leave the scratch as it is and need no
    memset; a new or larger scratch is zeroed and its epochs start at 1, as
    they do again once they run out."""
    key = (dev.index, stream)
    with _SCRATCH_LOCK:
        entry = _TRACK_SCRATCH.get(key)
        if entry is None or entry[0].numel() < ints or entry[1] >= _TRACK_EPOCHS:
            entry = _TRACK_SCRATCH[key] = [
                torch.zeros(max(ints, 5 * 1024), dtype=torch.int32, device=dev), 0]
        entry[1] += 1
        return entry[0], entry[1]


def _check_track_args(x, y, dt, offsets) -> None:
    for name, t in (("x", x), ("y", y), ("dt", dt)):
        if not isinstance(t, torch.Tensor) or t.dtype != torch.float32 or t.dim() != 1:
            raise TypeError(f"{name} must be a 1-D float32 tensor")
        if t.shape != x.shape or t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous and match x in length and device")
    if not isinstance(offsets, torch.Tensor) or offsets.dtype != torch.int64 \
            or offsets.dim() != 1 or offsets.shape[0] < 1:
        raise TypeError("offsets must be a 1-D int64 tensor of E + 1 >= 1 entries")
    if offsets.device != x.device or not offsets.is_contiguous():
        raise ValueError("offsets must be contiguous and on the columns' device")
    if offsets.shape[0] - 1 >= 2**31 or x.shape[0] >= 2**62:
        raise ValueError("too many entities or rows")


def track_stats(x, y, dt, offsets, dwell_eps: float):
    """Every entity's track sums over a track layout, one pass.

    ``x, y`` (N,) float32 coordinates and ``dt`` (N,) float32 seconds since
    the previous row of the entity (0 on its first row), rows sorted by
    (entity, time); ``offsets`` (E + 1,) int64, nondecreasing from 0 to N:
    entity ``e`` owns rows ``offsets[e]`` to ``offsets[e + 1] - 1``.
    Returns ``(length_deg, duration_s, heading_change_deg, dwell_s)``, each
    (E,) float32 (``cached_track_stats_step``,
    ``geomesa_tpu/trajectory/state.py:379-399``): the sums of step distance,
    of step duration, of ``|remainder(b_i - b_{i-1} + 180, 360) - 180|`` over
    consecutive steps that both moved (distance > 0; ``b`` the step bearing
    in degrees clockwise from north) and of the duration of steps no longer
    than ``dwell_eps`` degrees. On the card one launch of
    ``csrc/track_stats.cu`` (tiles of ``TRACK_TILE`` rows, each entity's
    sums written once; :func:`track_stats_tiles_plain` models it); on the
    CPU :func:`track_stats_plain`."""
    _check_track_args(x, y, dt, offsets)
    if x.device.type == "cpu":
        return track_stats_plain(x, y, dt, offsets, dwell_eps)
    if x.device.type != "cuda":
        raise ValueError(f"track_stats runs on cuda or cpu, not {x.device}")
    e, n = offsets.shape[0] - 1, x.shape[0]
    if e >= 2**30:
        raise ValueError("track_stats on the card takes fewer than 2^30 entities")
    out = torch.empty((4, e), dtype=torch.float32, device=x.device)
    if e:
        stream = _stream_of(x)
        scratch, epoch = _track_scratch(x.device, stream, 5 * -(-n // TRACK_TILE))
        with _on_device(x.device):
            rc = _fn("geomesa_track_stats")(x.data_ptr(), y.data_ptr(), dt.data_ptr(),
                                            offsets.data_ptr(), n, e, float(dwell_eps),
                                            out.data_ptr(), scratch.data_ptr(), scratch.numel(),
                                            epoch, stream)
        if rc != 0:
            raise RuntimeError(f"track_stats launch failed: cudaError {rc}")
        launches["track_stats"] += 1
    return tuple(out.unbind(0))


def track_terms(x, y, dt, offsets, dwell_eps: float):
    """The per-row terms of :func:`track_stats_plain` before their segment
    sums: ``(sid (N,) int64, dist, step_dt, turn, dwell)``. The reference's
    step (``state.py:379-394``) line by line, ``jnp.concatenate`` shifts as
    ``torch.cat``, ``jnp.mod`` as ``torch.remainder`` (both floor modulo)."""
    n, e = x.shape[0], offsets.shape[0] - 1
    counts = offsets[1:] - offsets[:-1]
    sid = torch.repeat_interleave(torch.arange(e, device=x.device), counts, output_size=n)
    first = torch.zeros(n, dtype=torch.bool, device=x.device)
    first[offsets[:-1][counts > 0]] = True
    dx = x - torch.cat([x[:1], x[:-1]])
    dy = y - torch.cat([y[:1], y[:-1]])
    dist = torch.where(first, 0.0, torch.sqrt(dx * dx + dy * dy))
    step_dt = torch.where(first, 0.0, dt)
    brg = torch.atan2(dx, dy) * _RAD2DEG
    moved = ~first & (dist > 0)
    pbrg = torch.cat([brg[:1], brg[:-1]])
    pmoved = torch.cat([torch.zeros(1, dtype=torch.bool, device=x.device), moved[:-1]])
    turn = torch.abs(torch.remainder(brg - pbrg + 180.0, 360.0) - 180.0)
    turn = torch.where(moved & pmoved, turn, 0.0)
    dwell = torch.where(dist <= torch.tensor(dwell_eps, dtype=torch.float32), step_dt, 0.0)
    return sid, dist, step_dt, turn, dwell


def track_stats_plain(x, y, dt, offsets, dwell_eps: float):
    """The plain PyTorch version of :func:`track_stats`: the per-row terms
    of :func:`track_terms`, summed per entity by ``index_add_``."""
    e = offsets.shape[0] - 1
    if x.shape[0] == 0:
        z = torch.zeros(e, dtype=torch.float32, device=x.device)
        return z, z.clone(), z.clone(), z.clone()
    sid, *terms = track_terms(x, y, dt, offsets, float(dwell_eps))
    return tuple(torch.zeros(e, dtype=torch.float32, device=x.device).index_add_(0, sid, v)
                 for v in terms)


def track_stats_tiles_plain(x, y, dt, offsets, dwell_eps: float, tile: int = TRACK_TILE):
    """A plain model of the card's ``track_stats`` tile by tile; it returns
    what :func:`track_stats_plain` returns, within f32 rounding. The rows
    are cut into tiles of ``tile`` rows. Each tile finds the entity of the
    row before it (``lo``, by search) and of its last row (``hi``; the last
    tile's runs to E - 1), marks the first row of each non-empty entity in
    (lo, hi] as a head and writes 0 for each empty one; its rows' terms
    (:func:`track_terms`) are summed per segment between heads, and the tile
    publishes its tail (the sums from its last head on, ``HEAD``) or, with
    no head, its whole sums (``PART``). A tile whose first row is not a
    head takes as carry the published sums from the nearest earlier
    ``HEAD`` tile to the tile before it, added in tile order (the card's
    look-back), and every segment that ends an entity in the tile is
    written there: its sums, plus the carry for the tile's first entity.
    Raises if an entity is written other than once. For tests: nothing
    calls it."""
    n, e = x.shape[0], offsets.shape[0] - 1
    dev = x.device
    out = torch.zeros((4, e), dtype=torch.float32, device=dev)
    if n == 0:
        return tuple(out.unbind(0))
    written = torch.zeros(e, dtype=torch.long, device=dev)
    terms = torch.stack(track_terms(x, y, dt, offsets, float(dwell_eps))[1:], dim=1)  # (N, 4)
    counts = offsets[1:] - offsets[:-1]
    ent_at = torch.full((n,), -1, dtype=torch.long, device=dev)
    ent_at[offsets[:-1][counts > 0]] = torch.nonzero(counts > 0)[:, 0]

    def entity(row: int) -> int:  # the largest e in [0, E - 1] with offsets[e] <= row
        return min(int(torch.searchsorted(offsets, torch.tensor([row], device=dev),
                                          right=True)) - 1, e - 1)

    tiles = -(-n // tile)
    published, has_head, parts = [], [], []
    for t in range(tiles):
        r0, r1 = t * tile, min((t + 1) * tile, n)
        lo = entity(r0 - 1) if r0 else -1
        hi = e - 1 if t == tiles - 1 else entity(r1 - 1)
        empty = torch.arange(lo + 1, hi + 1, device=dev)
        empty = empty[counts[lo + 1:hi + 1] == 0]
        out[:, empty] = 0.0
        written[empty] += 1
        heads = (torch.nonzero(ent_at[r0:r1] >= 0)[:, 0] + r0).tolist()
        bounds = sorted({r0, *heads}) + [r1]
        segs = [(int(ent_at[a]), a, b, terms[a:b].sum(dim=0)) for a, b in zip(bounds, bounds[1:])]
        parts.append((lo, segs))
        has_head.append(bool(heads))
        published.append(segs[-1][3])
    for t, (lo, segs) in enumerate(parts):
        carry = torch.zeros(4, dtype=torch.float32, device=dev)
        if segs[0][0] < 0:  # the first row continues an entity: the look-back
            h = t - 1
            while not has_head[h]:
                h -= 1
            for b in range(h, t):
                carry = carry + published[b]
        for ent, a, b, sums in segs:
            if b < n and ent_at[b] < 0:  # the entity goes on past the segment
                continue
            at = ent if ent >= 0 else lo
            out[:, at] = sums if ent >= 0 else carry + sums
            written[at] += 1
    if not bool((written == 1).all()):
        raise RuntimeError("an entity was written other than once")
    return tuple(out.unbind(0))
