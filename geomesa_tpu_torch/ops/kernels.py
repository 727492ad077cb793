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
pairs, one 256-thread block per pair in a count pass and a write pass. Its
source is ``csrc/planned_gather.cu``; its plain version
(:func:`planned_gather_plain`) is the eager torch form it replaced.

``grouped_agg`` replaces no TPU kernel either: the reference computes it in
XLA (``geomesa_tpu/parallel/query.py:1498``, ``make_grouped_agg_step``,
whose MXU bincount ``_onehot_bincount`` :1464 this card does with
atomics). It is ``aggregate_many``'s fused GROUP BY: the edge gather's
culled scan, whose boundary rows go to lanes for the host's exact re-test
while every other matching row folds into its group (count, first row, and
per value column count, sum, min and max) with global atomics. Its source is
``csrc/grouped_agg.cu``; its note gives the bound (bytes, with 2 + 4 V
atomics per folded row beside them); its plain version
(:func:`grouped_agg_plain`) is torch ``index_add_`` / ``scatter_reduce_``.

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

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

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
            "planned_gather": 0, "grouped_agg": 0, "z3_encode": 0, "z2_encode": 0}

_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
# entry point → (source stem, argtypes); every entry point returns a C int
_COUNT_ARGS = [_P] * 4 + [_LL] * 3 + [_P, _P, _I, _I, _I, _I]
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
    # (columns x4, n, true_n, pair_q, pair_blk, pairs, boxes, times, q, nb, nt,
    #  pair_hits, offsets or NULL, positions, stream)
    "geomesa_planned_gather": ("planned_gather", [_P] * 4 + [_LL, _LL, _P, _P, _LL, _P, _P,
                                                  _I, _I, _I, _P, _P, _P, _P]),
    # (..., gid, rowid, vals, cnt, first, vcnt, vsum, vmin, vmax, hits, positions,
    #  values, groups, capacity, stream)
    "geomesa_grouped_agg": ("grouped_agg", _COUNT_ARGS + [_P] * 11 + [_I] * 3 + [_P]),
    # (host out: 2 x int) → registers and local-memory bytes per thread
    "geomesa_grouped_agg_attrs": ("grouped_agg", [_P]),
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


def _stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


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
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    fn = _fn(f"geomesa_{stem}")
    with torch.cuda.device(x.device):
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
    in_time = torch.zeros_like(in_box)
    for k in range(times.shape[1]):
        t = times[:, k, :, None]
        after = (bi > t[:, 0]) | ((bi == t[:, 0]) & (oi >= t[:, 1]))
        before = (bi < t[:, 2]) | ((bi == t[:, 2]) & (oi <= t[:, 3]))
        in_time |= after & before
        if edges:
            valid = (t[:, 0] < t[:, 2]) | ((t[:, 0] == t[:, 2]) & (t[:, 1] <= t[:, 3]))
            on_edge |= valid & (((bi == t[:, 0]) & (oi == t[:, 1]))
                                | ((bi == t[:, 2]) & (oi == t[:, 3])))
    return in_box & in_time, on_edge


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
    match, so the outputs are those of a full scan.
    """
    _check_count_args(x, y, bins, offs, boxes, times)
    if capacity < 0:
        raise ValueError(f"capacity must be >= 0, got {capacity}")
    if int(base) + x.shape[0] > _I32_MAX:
        raise ValueError("base + rows must stay below 2^31: positions are int32")
    if x.device.type == "cpu":
        return batched_edge_gather_plain(x, y, bins, offs, base, true_n, boxes, times,
                                         capacity)
    if x.device.type != "cuda":
        raise ValueError(f"batched_edge_gather runs on cuda or cpu, not {x.device}")
    q = boxes.shape[0]
    counts = torch.zeros(q, dtype=torch.int32, device=x.device)
    hits = torch.zeros(q, dtype=torch.int32, device=x.device)
    pos = torch.full((q, capacity), -1, dtype=torch.int32, device=x.device)
    _launch("batched_edge_gather", x, y, bins, offs, base, true_n, boxes, times,
            counts, hits, pos, ints=(int(capacity),))
    return counts, _sorted_lanes(pos)[:, None, :], hits[:, None]


def _sorted_lanes(pos: torch.Tensor) -> torch.Tensor:
    """(Q, capacity) lanes a kernel appended in no order, sorted per query
    with the -1 padding last."""
    pos = torch.where(pos < 0, _I32_MAX, pos).sort(dim=1).values
    pos[pos == _I32_MAX] = -1
    return pos


def batched_edge_gather_plain(x, y, bins, offs, base: int, true_n: int, boxes, times,
                              capacity: int = EDGE_CAPACITY, chunk: int = 1 << 20):
    """The plain PyTorch version of :func:`batched_edge_gather`: the
    reference's ``one`` (``parallel/query.py:400-428``), chunked over rows.
    Candidates fill the lanes in row order by a running prefix sum; past
    ``capacity`` they are counted in ``hits`` and dropped."""
    q = boxes.shape[0]
    counts = torch.zeros(q, dtype=torch.int64, device=x.device)
    hits = torch.zeros(q, dtype=torch.int64, device=x.device)
    pos = torch.full((q, capacity), -1, dtype=torch.int32, device=x.device)
    for s, _, m, edge in _plain_masks(x, y, bins, offs, base, true_n, boxes, times, chunk,
                                      edges=True):
        counts += m.sum(dim=1)
        slot = hits[:, None] + torch.cumsum(edge, dim=1) - 1
        qi, ri = (edge & (slot < capacity)).nonzero(as_tuple=True)
        pos[qi, slot[qi, ri]] = (int(base) + s + ri).to(torch.int32)
        hits += edge.sum(dim=1)
    return counts.to(torch.int32), pos[:, None, :], hits.to(torch.int32)[:, None]


_M32 = 0xFFFFFFFF


def chunk_query_pairs(x, y, bins, offs, base: int, true_n: int, boxes, times) -> torch.Tensor:
    """The (chunk, query) pairs that :func:`batched_edge_gather`'s cull
    keeps, as a (ceil(N / JOIN_BLOCK), Q) bool tensor, a chunk being
    ``JOIN_BLOCK`` rows as the kernel's is: the plain version of
    ``csrc/chunk_cull.cuh``.

    A pair survives when its chunk holds a valid row (local position below
    ``min(N, true_n - base)``) and the query has a live box meeting the
    chunk's x/y extent and a live window meeting its extent of the biased
    time key ``bin << 32 | (uint32)(off ^ 0x80000000)`` (signed order, the
    lexicographic order of (bin, off)). The extent runs over every row the
    kernel loads, valid or not, with the rows past N of the last chunk as
    zeros, as the kernel's zero-filled copies are. No culled pair holds a
    match. For tests and bounds: nothing on the card's main path calls it.
    """
    _check_count_args(x, y, bins, offs, boxes, times)
    n = x.shape[0]
    n_chunks = -(-n // JOIN_BLOCK)
    pad = n_chunks * JOIN_BLOCK - n

    def extent(col):
        v = torch.nn.functional.pad(col, (0, pad)).view(n_chunks, JOIN_BLOCK)
        return v.amin(dim=1)[:, None, None], v.amax(dim=1)[:, None, None]

    (xlo, xhi), (ylo, yhi) = extent(x), extent(y)
    (klo, khi) = extent(bins.long() * 2**32 + ((offs.long() ^ 0x80000000) & _M32))
    b = boxes.long()[None]  # (1, Q, B, 4)
    box_meets = ((b[..., 0] <= b[..., 1]) & (b[..., 2] <= b[..., 3])
                 & (b[..., 0] <= xhi) & (xlo <= b[..., 1])
                 & (b[..., 2] <= yhi) & (ylo <= b[..., 3])).any(dim=2)
    t = times.long()[None]
    lo = t[..., 0] * 2**32 + ((t[..., 1] ^ 0x80000000) & _M32)
    hi = t[..., 2] * 2**32 + ((t[..., 3] ^ 0x80000000) & _M32)
    win_meets = ((lo <= hi) & (lo <= khi) & (klo <= hi)).any(dim=2)
    limit = min(n, int(true_n) - int(base))
    alive = torch.arange(n_chunks, device=x.device) * JOIN_BLOCK < limit
    return box_meets & win_meets & alive[:, None]


# ---------------------------------------------------------------------------
# grouped_agg
# ---------------------------------------------------------------------------

_SIGN_FLIP = 0x7FFFFFFFFFFFFFFF


def _order_keys(v: torch.Tensor) -> torch.Tensor:
    """float64 → int64 keys whose signed order is the doubles' order (NaN
    aside): the bits, with all but the sign flipped for a negative double.
    Its own inverse on the bits (:func:`_from_order_keys`)."""
    b = v.view(torch.int64)
    return torch.where(b >= 0, b, b ^ _SIGN_FLIP)


def _from_order_keys(k: torch.Tensor) -> torch.Tensor:
    return torch.where(k >= 0, k, k ^ _SIGN_FLIP).view(torch.float64)


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


def grouped_agg(x, y, bins, offs, gid, rowid, vals, base: int, true_n: int, boxes, times,
                n_groups: int, capacity: int = EDGE_CAPACITY):
    """Q bbox+time GROUP BY queries over one column slice, one pass.

    ``x, y, bins, offs`` and the payloads as :func:`batched_count`; ``gid``
    (N,) int32 group ids in ``[0, n_groups)`` (a row outside folds nowhere);
    ``rowid`` (N,) int32 each row's original row index; ``vals`` (V, N)
    float64 value columns, NaN for nulls. Returns the reference's eight
    outputs with one shard (``make_grouped_agg_step``,
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

    On the card: the ``grouped_agg`` kernel, whose f64 sums are folded with
    atomics in no fixed order; on the CPU: :func:`grouped_agg_plain`.
    """
    _check_count_args(x, y, bins, offs, boxes, times)
    _check_agg_args(x, gid, rowid, vals, n_groups, capacity)
    if int(base) + x.shape[0] > _I32_MAX:
        raise ValueError("base + rows must stay below 2^31: positions are int32")
    if x.device.type == "cpu":
        return grouped_agg_plain(x, y, bins, offs, gid, rowid, vals, base, true_n, boxes,
                                 times, n_groups, capacity)
    if x.device.type != "cuda":
        raise ValueError(f"grouped_agg runs on cuda or cpu, not {x.device}")
    q, nv, g, dev = boxes.shape[0], vals.shape[0], int(n_groups), x.device
    cnt = torch.zeros((q, g), dtype=torch.int32, device=dev)
    first = torch.full((q, g), _I32_MAX, dtype=torch.int32, device=dev)
    vcnt = torch.zeros((q, nv, g), dtype=torch.int32, device=dev)
    vsum = torch.zeros((q, nv, g), dtype=torch.float64, device=dev)
    inf = torch.tensor([float("inf")], dtype=torch.float64, device=dev)
    vmin = _order_keys(inf).expand(q, nv, g).contiguous()
    vmax = _order_keys(-inf).expand(q, nv, g).contiguous()
    hits = torch.zeros(q, dtype=torch.int32, device=dev)
    pos = torch.full((q, capacity), -1, dtype=torch.int32, device=dev)
    _launch("grouped_agg", x, y, bins, offs, base, true_n, boxes, times, gid, rowid, vals,
            cnt, first, vcnt, vsum, vmin, vmax, hits, pos, ints=(nv, g, int(capacity)))
    return (cnt, first, vcnt, vsum, _from_order_keys(vmin), _from_order_keys(vmax),
            _sorted_lanes(pos)[:, None, :], hits[:, None])


def grouped_agg_attrs() -> tuple[int, int]:
    """The ``grouped_agg`` kernel's registers and local-memory (spill)
    bytes per thread, as compiled for the card."""
    out = (ctypes.c_int * 2)()
    rc = _fn("geomesa_grouped_agg_attrs")(ctypes.addressof(out))
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
    q, nv, g, dev = boxes.shape[0], vals.shape[0], int(n_groups), x.device
    cnt = torch.zeros(q * g, dtype=torch.int64, device=dev)
    first = torch.full((q * g,), _I32_MAX, dtype=torch.int64, device=dev)
    vcnt = torch.zeros(q * nv * g, dtype=torch.int64, device=dev)
    vsum = torch.zeros(q * nv * g, dtype=torch.float64, device=dev)
    vmin = torch.full((q * nv * g,), float("inf"), dtype=torch.float64, device=dev)
    vmax = torch.full((q * nv * g,), float("-inf"), dtype=torch.float64, device=dev)
    hits = torch.zeros(q, dtype=torch.int64, device=dev)
    pos = torch.full((q, capacity), -1, dtype=torch.int32, device=dev)
    for s, e, m, edge in _plain_masks(x, y, bins, offs, base, true_n, boxes, times, chunk,
                                      edges=True):
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


def _check_pair_args(x, y, bins, offs, pair_q, pair_blk, boxes, times):
    _check_count_args(x, y, bins, offs, boxes, times)
    if x.shape[0] % JOIN_BLOCK:
        raise ValueError(f"residency not block-aligned: {x.shape[0]} % {JOIN_BLOCK}")
    for name, t in (("pair_q", pair_q), ("pair_blk", pair_blk)):
        if not isinstance(t, torch.Tensor) or t.dtype != torch.int32 or t.dim() != 1:
            raise TypeError(f"{name} must be a 1-D int32 tensor")
        if not t.is_contiguous() or t.device != x.device:
            raise ValueError(f"{name} must be contiguous and on {x.device}")
    if pair_q.shape != pair_blk.shape:
        raise ValueError("pair_q and pair_blk must have one length")


def planned_gather(x, y, bins, offs, true_n: int, pair_q, pair_blk, boxes, times):
    """Batched row retrieval over planned (query, block) pairs, one shard.

    ``x, y, bins, offs``: the (N,) int32 resident columns, N a multiple of
    ``JOIN_BLOCK``; ``true_n``: the true row count (rows at it or past it
    never match); ``pair_q``/``pair_blk``: (P,) int32 pair lists on the
    columns' device, each query in ``[0, Q)`` and each block in ``[0, N /
    JOIN_BLOCK)`` (the caller checks the ranges; the kernel counts a pair
    out of range as 0); ``boxes`` (Q, B, 4) / ``times`` (Q, T, 4) int32
    payloads. Returns ``(positions (H,) int64, pair_hits (P,) int64)``: the
    global positions of each pair's block rows that pass its query, in pair
    order and each pair's in row order, and each pair's count.

    On the card: a count pass, one ``torch.cumsum`` of the counts into
    offsets, one device-to-host read of the total, and a write pass
    (``csrc/planned_gather.cu``); an empty pair list launches nothing. On
    the CPU: :func:`planned_gather_plain`.
    """
    _check_pair_args(x, y, bins, offs, pair_q, pair_blk, boxes, times)
    if x.device.type == "cpu":
        return planned_gather_plain(x, y, bins, offs, true_n, pair_q, pair_blk, boxes, times)
    if x.device.type != "cuda":
        raise ValueError(f"planned_gather runs on cuda or cpu, not {x.device}")
    n_pairs = pair_q.shape[0]
    empty = torch.empty(0, dtype=torch.int64, device=x.device)
    if n_pairs == 0:
        return empty, empty
    for name, t in zip(("x", "y", "bins", "offs", "boxes", "times"),
                       (x, y, bins, offs, boxes, times)):
        if t.data_ptr() % 16:
            raise ValueError(f"planned_gather: {name} must start on a 16-byte boundary "
                             "(the kernel loads 16-byte vectors)")
    fn = _fn("geomesa_planned_gather")
    head = (x.data_ptr(), y.data_ptr(), bins.data_ptr(), offs.data_ptr(), x.shape[0],
            int(true_n), pair_q.data_ptr(), pair_blk.data_ptr(), n_pairs, boxes.data_ptr(),
            times.data_ptr(), boxes.shape[0], boxes.shape[1], times.shape[1])
    hits = torch.zeros(n_pairs, dtype=torch.int64, device=x.device)
    with torch.cuda.device(x.device):
        rc = fn(*head, hits.data_ptr(), None, None, _stream_of(x))
        if rc != 0:
            raise RuntimeError(f"planned_gather count pass failed: cudaError {rc}")
        ends = torch.cumsum(hits, dim=0)
        total = int(ends[-1])  # the one device-to-host read: the output's size
        positions = torch.empty(total, dtype=torch.int64, device=x.device)
        if total:
            offsets = ends - hits
            rc = fn(*head, hits.data_ptr(), offsets.data_ptr(), positions.data_ptr(),
                    _stream_of(x))
            if rc != 0:
                raise RuntimeError(f"planned_gather write pass failed: cudaError {rc}")
    launches["planned_gather"] += 1
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
    empty = torch.empty(0, dtype=torch.int64, device=x.device)
    if pair_q.shape[0] == 0:
        return empty, empty
    blocks = [c.view(-1, JOIN_BLOCK) for c in (x, y, bins, offs)]
    pq, pb = pair_q.long(), pair_blk.long()
    lrow = torch.arange(JOIN_BLOCK, device=x.device)
    step = max(1, PLANNED_CHUNK_ROWS // JOIN_BLOCK)
    positions, hits = [], []
    for s in range(0, pq.shape[0], step):
        q, b = pq[s:s + step], pb[s:s + step]
        m, _ = row_masks(*(c.index_select(0, b) for c in blocks),
                         boxes.index_select(0, q), times.index_select(0, q))
        gpos = b[:, None] * JOIN_BLOCK + lrow[None, :]
        m &= gpos < int(true_n)
        hits.append(m.sum(dim=1))
        positions.append(gpos[m])
    return torch.cat(positions), torch.cat(hits)


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
