"""Z-range decomposition: cover an axis-aligned query box with curve intervals.

Port copy of :mod:`geomesa_tpu.curve.zranges`. A BFS over the implicit
quad/oct tree of Morton prefix cells classifies each cell against the box as
contained (emit exact), disjoint (drop) or overlapping (split — or emit
loosely once the range budget or depth floor is hit), then sorts and merges
adjacent intervals. Loose ranges only widen the candidate superset; the
device refine and the exact residual remove the extra rows.

:func:`zranges` runs the BFS in C++ (``csrc/zranges.cpp``, a copy of the
reference's ``geomesa_tpu/native/zranges.cpp``), built with ``g++ -O2
-shared -fPIC`` into the git-ignored ``_build/`` at first use and bound with
``ctypes``; :func:`zranges_plain` is the same BFS in Python, bit-identical,
kept for the tests. Unlike the reference, which falls back to Python in
silence, a failed build or an output buffer that overflows twice raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from collections import deque
from pathlib import Path

import numpy as np

from geomesa_tpu_torch.curve import zorder

__all__ = ["zranges", "zranges_plain", "merge_ranges"]


def merge_ranges(ranges: list[tuple[int, int]]) -> np.ndarray:
    """Sort (lo, hi) inclusive intervals and coalesce overlapping/adjacent ones."""
    if not ranges:
        return np.empty((0, 2), dtype=np.uint64)
    ranges.sort()
    merged = [list(ranges[0])]
    for lo, hi in ranges[1:]:
        if lo <= merged[-1][1] + 1:
            merged[-1][1] = max(merged[-1][1], hi)
        else:
            merged.append([lo, hi])
    return np.array(merged, dtype=np.uint64)


SRC = Path(__file__).resolve().parent.parent / "csrc" / "zranges.cpp"
BUILD = SRC.parent.parent / "_build"
CXX_FLAGS = ["-O2", "-shared", "-fPIC"]

_LIB: list = []  # the bound library, once built
_LOCK = threading.Lock()


def _cxx() -> str:
    for cand in (os.environ.get("CXX"), shutil.which("g++"), "/usr/bin/g++"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("g++ not found: set CXX or put g++ on PATH to build the z-range planner")


def build_library(src: Path = SRC, build: Path = BUILD, cxx: str | None = None) -> Path:
    """Compile ``src`` into ``build/libzranges-<digest>.so`` unless it is
    there already; the digest covers the source and the flags. Raises on a
    failed build."""
    digest = hashlib.sha256(src.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:12]
    lib = build / f"lib{src.stem}-{digest}.so"
    if lib.exists():
        return lib
    build.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx or _cxx(), *CXX_FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {src.name} (rc {proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def _fn():
    """The bound ``geomesa_zranges``, its library built at first use."""
    with _LOCK:
        if not _LIB:
            fn = ctypes.CDLL(str(build_library())).geomesa_zranges
            u64p = ctypes.POINTER(ctypes.c_uint64)
            fn.argtypes = [ctypes.c_int, u64p, u64p, ctypes.c_int, ctypes.c_long,
                           ctypes.c_long, u64p, ctypes.c_long]
            fn.restype = ctypes.c_long
            _LIB.append(fn)
        return _LIB[0]


def _capacities(max_ranges: int) -> tuple[int, int]:
    """Output pairs of the first call and of its one retry. The BFS emits
    at most ``max_ranges`` plus one cell's children, so the retry always
    holds it."""
    first = max(int(max_ranges) * 4 + 64, 256)
    return first, max(first * 8, int(max_ranges) * 4 + 64)


def zranges(
    lows: tuple[int, ...],
    highs: tuple[int, ...],
    precision: int,
    max_ranges: int = 2000,
    max_recurse: int = 32,
) -> np.ndarray:
    """Cover the box ``[lows, highs]`` (inclusive, normalized ints) with z
    intervals: ``(R, 2) uint64`` inclusive ``[zlo, zhi]`` whose union is a
    superset of the z-codes of every point in the box. ``max_ranges`` is a
    soft budget on the number of intervals; ``max_recurse`` bounds depth.

    Runs the native BFS; equal to :func:`zranges_plain`."""
    dims = len(lows)
    if dims != len(highs):
        raise ValueError("lows and highs must have the same dimension")
    if dims not in (2, 3):
        raise ValueError(f"unsupported dims: {dims}")
    if not 1 <= precision <= 63 // dims:
        raise ValueError(f"precision {precision} does not fit {dims} x {precision} <= 63 bits")
    lows = [int(v) for v in lows]
    highs = [int(v) for v in highs]
    if any(h < l for l, h in zip(lows, highs)):
        return np.empty((0, 2), dtype=np.uint64)
    if min(lows) < 0 or max(highs) >= 1 << precision:
        raise ValueError(f"box bounds must lie in [0, 2^{precision})")
    fn = _fn()
    lo = (ctypes.c_uint64 * dims)(*lows)
    hi = (ctypes.c_uint64 * dims)(*highs)
    for cap in _capacities(max_ranges):
        out = np.empty((cap, 2), dtype=np.uint64)
        n = fn(dims, lo, hi, precision, int(max_ranges), int(max_recurse),
               out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), cap)
        if n >= 0:
            return out[:n].copy()
    raise RuntimeError(f"zranges: {cap} output ranges were too few for a budget of {max_ranges}")


def zranges_plain(
    lows: tuple[int, ...],
    highs: tuple[int, ...],
    precision: int,
    max_ranges: int = 2000,
    max_recurse: int = 32,
) -> np.ndarray:
    """The plain Python version of :func:`zranges`: the same BFS, the same
    output."""
    dims = len(lows)
    if dims != len(highs):
        raise ValueError("lows and highs must have the same dimension")
    if any(h < l for l, h in zip(lows, highs)):
        return np.empty((0, 2), dtype=np.uint64)
    if dims == 2:
        encode = lambda c: int(zorder.encode2(np.uint64(c[0]), np.uint64(c[1])))
    elif dims == 3:
        encode = lambda c: int(
            zorder.encode3(np.uint64(c[0]), np.uint64(c[1]), np.uint64(c[2]))
        )
    else:
        raise ValueError(f"unsupported dims: {dims}")

    lows = tuple(int(v) for v in lows)
    highs = tuple(int(v) for v in highs)

    full = (1 << precision) - 1
    if all(l == 0 for l in lows) and all(h == full for h in highs):
        return np.array([[0, (1 << (dims * precision)) - 1]], dtype=np.uint64)

    out: list[tuple[int, int]] = []
    # frontier cells: (per-dim prefix values, level); a cell at `level`
    # spans per-dim [v << s, (v << s) | ones(s)] with s = precision - level
    frontier: deque[tuple[tuple[int, ...], int]] = deque([((0,) * dims, 0)])
    max_level = min(precision, max_recurse)

    def cell_z_span(cell: tuple[int, ...], level: int) -> tuple[int, int]:
        s = precision - level
        zlo = encode(tuple(v << s for v in cell))
        return zlo, zlo | ((1 << (dims * s)) - 1)

    while frontier:
        # budget hit: emit the remaining non-disjoint frontier loosely
        if len(out) + len(frontier) >= max_ranges:
            while frontier:
                cell, level = frontier.popleft()
                s = precision - level
                if not any(
                    ((cell[d] << s) | ((1 << s) - 1)) < lows[d]
                    or (cell[d] << s) > highs[d]
                    for d in range(dims)
                ):
                    out.append(cell_z_span(cell, level))
            break

        cell, level = frontier.popleft()
        s = precision - level
        contained = True
        disjoint = False
        for d in range(dims):
            clo = cell[d] << s
            chi = clo | ((1 << s) - 1)
            if chi < lows[d] or clo > highs[d]:
                disjoint = True
                break
            if clo < lows[d] or chi > highs[d]:
                contained = False
        if disjoint:
            continue
        if contained or level >= max_level:
            out.append(cell_z_span(cell, level))
            continue
        for child_bits in range(1 << dims):
            child = tuple(
                (cell[d] << 1) | ((child_bits >> d) & 1) for d in range(dims)
            )
            frontier.append((child, level + 1))

    return merge_ranges(out)
