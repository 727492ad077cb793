"""Show where the device memory of a bench config 2 write goes, for one or
more checkouts, on a CUDA card.

    python3 scripts/torch_write_memory.py ROOT [ROOT ...]

Each ROOT is a checkout of this repo: ``.``, or another commit unpacked with
``git archive`` into an ignored directory. Each runs in a fresh process of
its own that imports that root's ``geomesa_tpu_torch``, builds its kernels,
writes and compacts 50M GDELT-shaped points (seed 42) through ``DataStore``
(the z3 and z2 states resident) and prints ``memory_allocated`` and
``max_memory_allocated`` after the write, then every live device block: the
size the caching allocator handed out, the size the tensor asked for, the
size of the segment it lies in, and the frames of this repo that allocated
it (``torch.cuda.memory._record_memory_history``, Python stacks only).
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

N_ROWS = 50_000_000


def one_root() -> None:
    import numpy as np
    import torch

    from geomesa_tpu_torch.ops import kernels
    from geomesa_tpu_torch.schema.columnar import Column, FeatureTable, point_column
    from geomesa_tpu_torch.schema.sft import AttributeType
    from geomesa_tpu_torch.store.datastore import DataStore
    from geomesa_tpu_torch.workload import SPEC, synth_gdelt

    dev = torch.device("cuda")
    kernels.build_kernels()
    lon, lat, t = synth_gdelt(N_ROWS, seed=42)
    torch.cuda.memory._record_memory_history(max_entries=100_000, stacks="python")
    ds = DataStore(device=dev)
    sft = ds.create_schema("gdelt", SPEC)
    ds.write("gdelt", FeatureTable.from_columns(sft, np.arange(N_ROWS).astype("U9"), {
        "dtg": Column(AttributeType.DATE, t), "geom": point_column(lon, lat)}))
    ds.compact("gdelt")
    torch.cuda.synchronize()
    print(f"{os.getcwd()}: torch {torch.__version__}, memory_allocated "
          f"{torch.cuda.memory_allocated()} B after the write, max_memory_allocated "
          f"{torch.cuda.max_memory_allocated()} B during it", flush=True)
    for seg in torch.cuda.memory._snapshot()["segments"]:
        for blk in seg["blocks"]:
            if blk["state"] != "active_allocated":
                continue
            frames = [f"{Path(f['filename']).name}:{f['line']} {f['name']}"
                      for f in blk.get("frames") or [] if os.getcwd() in f["filename"]]
            print(f"  block {blk['size']} B handed out, {blk.get('requested_size')} B asked "
                  f"for, in a segment of {seg['total_size']} B; {' < '.join(frames[:4])}",
                  flush=True)
    torch.cuda.memory._record_memory_history(enabled=None)


def main() -> int:
    if len(sys.argv) > 1 and sys.argv[1] == "--one":
        sys.path.insert(0, os.getcwd())
        one_root()
        return 0
    roots = sys.argv[1:] or ["."]
    rc = 0
    for root in roots:
        rc |= subprocess.call([sys.executable, os.path.abspath(__file__), "--one"],
                              cwd=os.path.abspath(root))
    return rc


if __name__ == "__main__":
    sys.exit(main())
