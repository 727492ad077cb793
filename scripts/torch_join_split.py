"""Split the time of the one-CTA-per-pair ``polygon_join`` kernel (the
design of ``csrc/polygon_join.cu`` before its block-major rewrite) at bench
config 4 on a CUDA card, and count the work a band walk would do there; or
time other sources of the kernel against each other there.

    python3 scripts/torch_join_split.py OLD_SOURCE [--out DIR]
    python3 scripts/torch_join_split.py --variants SOURCE [SOURCE ...] [--out DIR]

``OLD_SOURCE`` is that kernel's ``polygon_join.cu``, taken from a checkout
of the commit that has it (``git archive`` into an ignored directory). The
script builds three variants of it with ``nvcc`` into ``--out`` (default
``chiprun_out/join_split``), none of them kept in the repo:

- ``full``: the source as it is;
- ``no_edges``: the edge loop cut out: each pass loads its rows, tests
  them against the bbox and takes the warp's vote, and counts the rows
  inside the bbox instead of their parity;
- ``no_division``: the edge loop kept, each straddling edge's ``xint``
  computed without its division.

It builds config 4 as ``torch_count_ab.py`` does (100M points in z2 order,
10,000 polygons in four vertex buckets, 8192-row blocks), holds ``full`` to
the checkout's own ``polygon_join`` on every pair, and times the variants
with CUDA events (5 runs of the four launches each, in the turns full,
no_edges, no_division, full). Then it counts, from the data
(``kernels.polygon_join_work``): the 128-row warps whose rows the old
kernel tested and those that entered its edge loop (a row inside the bbox),
the rows inside a bbox, their (row, edge) tests over every edge, the
straddling ones, and the candidates of a band walk under the kernel's band
count and under 8, 16 and 32 bands.

With ``--variants``, each SOURCE is a ``polygon_join.cu`` with this
checkout's entry point (``ops/kernels.py``'s ``geomesa_polygon_join``
arguments), for example an earlier design kept out of the repo: each is
built with ``nvcc -Xptxas -v`` (its registers and spills are printed), held
to ``polygon_join_plain`` on every pair of config 4, and timed with CUDA
events (5 runs of each bucket's launch) in the order given and then in
reverse, with its time per vertex bucket.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, os.getcwd())
sys.path.insert(0, str(Path(__file__).resolve().parent))

from torch_count_ab import config4_inputs, cuda_ms, log  # noqa: E402

_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
# the one-CTA-per-pair kernel's entry: (x, y, n, true_n, pair_poly, pair_blk,
# pairs, verts, V, nverts, bbox, K, block, sms, counts, stream)
OLD_ARGS = [_P, _P, _LL, _LL, _P, _P, _LL, _P, _I, _P, _P, _I, _I, _I, _P, _P]
# this checkout's entry: the same without sms
NEW_ARGS = OLD_ARGS[:13] + OLD_ARGS[14:]
EDGE_LOOP = re.compile(r"      // bit r of above.*?      cnt \+= __popc\(odd & live\);\n", re.S)
DIVISION = re.compile(r"__fadd_rn\(a\.x, __fdiv_rn\(__fmul_rn\(__fsub_rn\(py\[r\], a\.y\), dx\), "
                      r"dy\)\)")


def variants(src: str) -> dict[str, str]:
    no_edges, hits = EDGE_LOOP.subn("      cnt += __popc(live);\n", src)
    no_div, hits2 = DIVISION.subn("__fadd_rn(a.x, __fmul_rn(__fsub_rn(py[r], a.y), dx))", src)
    if hits != 1 or hits2 != 1:
        raise SystemExit("OLD_SOURCE is not the one-CTA-per-pair kernel this script cuts")
    return {"full": src, "no_edges": no_edges, "no_division": no_div}


def build(name: str, src: str, out: Path, argtypes=OLD_ARGS):
    from geomesa_tpu_torch.ops import kernels

    cu, lib = out / f"{name}.cu", out / f"lib{name}.so"
    cu.write_text(src)
    res = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(lib),
                          str(cu)], capture_output=True, text=True, check=True)
    usage = [ln.split("info    :")[-1].strip() for ln in (res.stdout + res.stderr).splitlines()
             if "registers" in ln or "spill" in ln]
    log(f"{name}: " + "; ".join(usage[-2:]))
    fn = ctypes.CDLL(str(lib)).geomesa_polygon_join
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return fn


def time_variants(sources: list[str], out: Path) -> None:
    """Each source held to ``polygon_join_plain`` at config 4 and timed."""
    from geomesa_tpu_torch.ops import kernels

    names = [f"v{i}_{Path(src).stem}" for i, src in enumerate(sources)]
    fns = {name: build(name, Path(src).read_text(), out, NEW_ARGS)
           for name, src in zip(names, sources)}
    dev = torch.device("cuda")
    inp = config4_inputs(dev)
    x, y, n, block = inp["x"], inp["y"], inp["n"], inp["block"]
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launch(fn, pp, pb, verts, nverts, bbox):
        counts = torch.zeros(verts.shape[0], dtype=torch.int32, device=dev)
        rc = fn(x.data_ptr(), y.data_ptr(), x.shape[0], n, pp.data_ptr(), pb.data_ptr(),
                pp.shape[0], verts.data_ptr(), verts.shape[1], nverts.data_ptr(),
                bbox.data_ptr(), verts.shape[0], block, counts.data_ptr(), stream)
        if rc:
            raise SystemExit(f"launch failed: cudaError {rc}")
        return counts

    want = [kernels.polygon_join_plain(x, y, n, *a, block) for _, a, _, _ in inp["buckets"]]
    for name, src in zip(names + names[::-1], sources + sources[::-1]):
        if not all(torch.equal(launch(fns[name], *a), w)
                   for (_, a, _, _), w in zip(inp["buckets"], want)):
            raise SystemExit(f"{src} disagrees with polygon_join_plain at config 4")
        per = [cuda_ms(lambda a=a: launch(fns[name], *a)) for _, a, _, _ in inp["buckets"]]
        log(f"{src}: {sum(per):.4f} ms (CUDA events, 5 runs a bucket; buckets "
            f"{' / '.join(f'{t:.4f}' for t in per)} ms), equal to polygon_join_plain")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("old_source", nargs="?")
    ap.add_argument("--variants", nargs="+", default=[])
    ap.add_argument("--out", default="chiprun_out/join_split")
    args = ap.parse_args()
    if bool(args.old_source) == bool(args.variants):
        ap.error("give OLD_SOURCE or --variants")
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    from geomesa_tpu_torch.ops import kernels

    out = Path(args.out).resolve()
    out.mkdir(parents=True, exist_ok=True)
    log("card: " + subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    if args.variants:
        return time_variants(args.variants, out)
    fns = {name: build(name, src, out)
           for name, src in variants(Path(args.old_source).read_text()).items()}
    dev = torch.device("cuda")
    inp = config4_inputs(dev)
    x, y, n, block = inp["x"], inp["y"], inp["n"], inp["block"]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launch(fn, pp, pb, verts, nverts, bbox):
        counts = torch.zeros(verts.shape[0], dtype=torch.int32, device=dev)
        rc = fn(x.data_ptr(), y.data_ptr(), x.shape[0], n, pp.data_ptr(), pb.data_ptr(),
                pp.shape[0], verts.data_ptr(), verts.shape[1], nverts.data_ptr(),
                bbox.data_ptr(), verts.shape[0], block, sms, counts.data_ptr(), stream)
        if rc:
            raise SystemExit(f"launch failed: cudaError {rc}")
        return counts

    for _, a, _, _ in inp["buckets"]:
        if not torch.equal(launch(fns["full"], *a), kernels.polygon_join(x, y, n, *a, block)):
            raise SystemExit("the full variant disagrees with this checkout's polygon_join")
    times: dict[str, list[float]] = {}
    for name in ("full", "no_edges", "no_division", "full"):
        times.setdefault(name, []).append(cuda_ms(
            lambda: [launch(fns[name], *a) for _, a, _, _ in inp["buckets"]]))
    log("old polygon_join at config 4 (CUDA events, 5 runs of "
        f"{len(inp['buckets'])} launches): "
        + "; ".join(f"{k} {' / '.join(f'{t:.4f}' for t in v)} ms" for k, v in times.items()))
    nbs = (None, 8, 16, 32)
    work = {key: 0 for key in ("pairs", "tested_rows", "groups", "in_rows", "warps_any",
                               "edge_tests", "straddles")}
    cand = [0] * len(nbs)
    for _, a, _, _ in inp["buckets"]:
        w = kernels.polygon_join_work(x, y, n, *a, block, nbs=nbs, chunk=256)
        for key in work:
            work[key] += w[key]
        cand = [c + d for c, d in zip(cand, w["candidates"])]
    rows = max(work["in_rows"], 1)
    log(f"config 4 work: {work['pairs']} pairs, {work['tested_rows']} tested rows in "
        f"{work['groups']} 128-row warps, {work['warps_any']} of them with a row inside the bbox "
        f"(the old kernel's edge loop ran for each; {-(-work['in_rows'] // 128)} would hold "
        f"the {work['in_rows']} in-bbox rows compacted); (row, edge) tests over every edge "
        f"{work['edge_tests']} ({work['edge_tests'] / rows:.3f} a row), straddling "
        f"{work['straddles']} ({work['straddles'] / rows:.3f} a row); band-walk candidates "
        + ", ".join(f"{'kernel NB' if nb is None else f'NB={nb}'} {c} ({c / rows:.3f} a row)"
                    for nb, c in zip(nbs, cand)))


if __name__ == "__main__":
    main()
