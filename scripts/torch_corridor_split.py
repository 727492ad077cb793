"""Split a ``tube_select_many`` call of bench config 10 on a CUDA card into
its steps, for the two device routes on one store, in turns.

    python3 scripts/torch_corridor_split.py [--rows N] [--calls K]

It builds config 10's store (``workload.trajectory_workload``: 2M track
points, seed 15, 16 tube corridors) through ``DataStore`` and times K
calls of each route after a warm one, in the turns resident, table,
table, resident, ...:

- the resident route (the default: the gather form of ``corridor_masks``
  over the device select's positions);
- the table route (the row form over the candidate query's rows, forced by
  hiding the store's resident candidates, as a line or polygon store takes
  it).

For each it prints the p50 ms a call and of each step of the call's
``timings`` (plan, select, residual, kernel, refine, take). Then it splits
the device select itself, each step closed by
``torch.cuda.synchronize()``: the plan, the intervals' upload and
expansion on the card alone (``gather_indices``), the whole select
(``DeviceBackend.select_positions_device``: that expansion again, the
payloads' upload, the refine and the compaction of the passing
positions), and the positions' copy to the host (the resident route's one
copy of them).
Every line names the card and its power limit.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

KEYS = ("plan_ms", "select_ms", "residual_ms", "kernel_ms", "refine_ms", "take_ms")


def p50(v) -> float:
    return float(np.median(v))


def main() -> None:
    import torch

    from geomesa_tpu_torch.index.api import gather_indices
    from geomesa_tpu_torch.planning.planner import Query, QueryPlanner
    from geomesa_tpu_torch.schema.columnar import Column, FeatureTable, point_column
    from geomesa_tpu_torch.schema.sft import AttributeType, parse_spec
    from geomesa_tpu_torch.store.datastore import DataStore
    from geomesa_tpu_torch.trajectory.corridor import CorridorSpec, prune_filter, tube_select_many
    from geomesa_tpu_torch.workload import TRACK_SPEC, trajectory_workload

    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=2_000_000)
    ap.add_argument("--calls", type=int, default=6)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_corridor_split: no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    card = card.strip().splitlines()[0]
    dev = torch.device("cuda")
    n = args.rows
    lon, lat, t, tracks, _, corridors = trajectory_workload(n, 16)
    ds = DataStore(device=dev)
    sft = ds.create_schema(parse_spec("tracks", TRACK_SPEC))
    ds.write("tracks", FeatureTable.from_columns(sft, np.arange(n).astype(str), {
        "track": Column(AttributeType.STRING, tracks),
        "dtg": Column(AttributeType.DATE, t.astype(np.int64)), "geom": point_column(lon, lat)}))
    specs = [CorridorSpec.tube(*c) for c in corridors]

    def resident():
        tm = {}
        tube_select_many(ds, "tracks", specs, timings=tm)
        return tm

    def table():
        ds.resident_candidates = lambda *a, **k: None
        try:
            tm = {}
            tube_select_many(ds, "tracks", specs, timings=tm)
        finally:
            del ds.resident_candidates
        return tm

    runs = {"resident": [], "table": []}
    resident(), table()  # warm
    order = ["resident", "table", "table", "resident"]
    for i in range(args.calls * 2):
        name = order[i % 4]
        s = time.perf_counter()
        tm = resident() if name == "resident" else table()
        tm["call_ms"] = (time.perf_counter() - s) * 1e3
        runs[name].append(tm)
    for name, tms in runs.items():
        print(f"{card} | {name} route ({tms[0]['route']}): call p50 "
              f"{p50([x['call_ms'] for x in tms]):.3f} ms ({len(tms)} calls, "
              f"{p50([x['call_ms'] for x in tms]) / len(specs):.4f} ms a corridor); "
              + ", ".join(f"{k} {p50([x.get(k, 0.0) for x in tms]):.3f}" for k in KEYS)
              + f"; {tms[0]['candidates']} candidates, {tms[0]['band_rows']} band rows",
              flush=True)

    st = ds._state("tracks")
    q = Query(filter=prune_filter(sft, specs))
    steps = {k: [] for k in ("plan", "expand", "select", "copy")}
    for _ in range(args.calls):
        torch.cuda.synchronize()
        s0 = time.perf_counter()
        plan, _, info = QueryPlanner(st.sft, st.indices).plan(q)
        s1 = time.perf_counter()
        _, count = gather_indices(plan.intervals, dev)
        torch.cuda.synchronize()
        s2 = time.perf_counter()
        pos = ds.backend.select_positions_device(st.backend_state[info.scan_index], sft,
                                                 info.extraction, plan.intervals)
        torch.cuda.synchronize()
        s3 = time.perf_counter()
        pos.cpu().numpy()
        s4 = time.perf_counter()
        for k, a, b in (("plan", s0, s1), ("expand", s1, s2), ("select", s2, s3),
                        ("copy", s3, s4)):
            steps[k].append((b - a) * 1e3)
    print(f"{card} | device select split (p50 of {args.calls}, ms): "
          + ", ".join(f"{k} {p50(v):.3f}" for k, v in steps.items())
          + f"; {count} slots over {len(plan.intervals)} intervals, {pos.shape[0]} pass "
          f"the refine; index {info.scan_index}", flush=True)


if __name__ == "__main__":
    main()
