"""Chip smoke: build the port's kernels, hold each against its plain version,
and drive the point write + bbox(+time) query path (z3 and z2 indexes), the
standing-query stream, a date-less point schema, the grouped aggregation
(fused, and config 9's GeoBlocks pyramid and query cache), density and KNN,
the spatial join, bench config 5 with a line store on the xz3 and xz2
indexes (with its grouped aggregation, density and KNN), bench config 7's
resident count steps and bench config 10's corridor engine, interlink and
track statistics end to end on one CUDA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero, and no result line is printed):

1. build every kernel under ``geomesa_tpu_torch/csrc`` with nvcc (parallel);
2. ``batched_count`` against ``batched_count_plain`` on the card, exact, at
   ragged N, a base/true_n tail, Q in {1, 64, one past the shared-memory
   tile}, (B, T) in {(1, 1), (8, 16)}, and four payload modes: random
   multi-slot queries with sentinel padding and a disjoint query; one live
   box and window per query packed as ``DataStore`` packs them; and
   ``workload.edge_payload``'s single-slot and mixed payloads over
   ``edge_columns`` (dead slots before live ones, degenerate and int32-extreme
   boxes, negative offsets, the unconstrained window over bins = offs = 0,
   all-dead queries, tiles mixing single- and multi-slot queries); both row
   loops (single-slot and general) must have run;
2b. ``batched_count_hits`` against ``batched_count_hits_plain`` the same way
   (counts and lane positions), at N in {1,000,003, 1,000,064} and (B, T) in
   {(1, 1), (2, 2), (8, 16)};
2c. ``z3_encode`` and ``z2_encode`` against ``z3_encode_plain`` and
   ``z2_encode_plain`` on the card, exact, at N in {1, 1,000,003, 50M} with
   the edge values of each width and values above it; then their times
   (CUDA events, 5 launches) at 50M rows beside the plain versions' and
   the bound;
2d. ``batched_edge_gather`` against ``batched_edge_gather_plain`` on the
   card, exact, at N = 1,000,003 with and without a base/true_n tail, Q in
   {1, 64, one past the shared-memory tile}, (B, T) in {(1, 1), (8, 16)},
   and four payload modes: ``workload.grid_columns``/``grid_payload`` (rows
   on a few hundred values, boxes and windows on them, so that some
   queries' candidates overflow the lanes), ``edge_payload``'s single-slot
   and mixed payloads over ``edge_columns``, and city boxes packed as
   ``DataStore`` packs them over GDELT-shaped rows: counts equal the plain
   version's and ``batched_count``'s, hits are equal, lanes are equal where
   they hold every candidate and a subset of the candidates where they
   overflow; both row loops must have run; then its per-chunk cull on
   1,000,003 GDELT-shaped rows in z3 order (``z3_store``) under city boxes
   packed as ``DataStore`` packs them (most (chunk, query) pairs culled),
   several city slots and dead slots per query, windows after the data
   (every pair culled) and the whole world (none), at (B, T) in {(1, 1),
   (8, 16)}, Q in {64, one past the tile}, with and without a base/true_n
   tail, and the same rows shuffled (nothing culled; counts, hits and
   candidates equal the sorted run's), logging the share of pairs kept;
2e. ``planned_gather`` against ``planned_gather_plain`` on the card, exact,
   on an empty pair list (no launch), a pair on the last block with
   ``true_n`` inside it, one block shared by 65 queries, by 300 pairs
   (more than one staged tile) and four blocks by 400, one query over
   every block, ``edge_payload``'s and ``grid_payload``'s multi-slot and
   dead-slot payloads with random pairs, and the 64 city queries' planned
   pairs, logging the distinct blocks each reads;
3. the main path at bench config 2's size: 50M GDELT-shaped points (seed 42),
   ``DataStore()`` → ``create_schema`` → ``write`` (z3 and z2 keys built by
   one launch each of ``z3_encode`` and ``z2_encode``) → ``compact``, the 64
   city-box 2-7 day queries (seed 7) through ``count_many(loose=True)``
   against an int-domain numpy referee, all 64 through
   ``count_many(loose=False)`` (one ``batched_edge_gather`` launch),
   ``select_many`` and ``query()`` against an f64 numpy brute force (counts
   and row ids), and 8 of the city boxes with no time through ``query()``,
   planned on z2, against the f64 brute force (fid sets); then timings:
   the loose and exact batches, ``query()`` per query with its plan time,
   ``select_many`` per query; then 8 queries snapped onto rows they match
   (``snapped_queries``) through ``count_many(loose=False)``, so that the
   host re-test corrects every one of them, against both referees, timed
   beside the same 8 unsnapped; the z-range phase: every ``zranges`` call
   that planning the 64 queries (z3, 3-D) and the 8 spatial boxes (z2,
   2-D) makes, at the budgets ``Z3Index.plan`` and ``Z2SFC.ranges`` pass,
   held equal to ``zranges_plain`` and timed beside it, with the calls per
   query; the host split of ``query()`` (plan, device select, residual,
   take) and of ``select_many`` (plan, block pairs, planned gather, tail);
   then ``batched_count``, the edge gather
   (its bound over the (chunk, query) pairs its cull keeps, beside the
   full-scan bound) and ``planned_gather`` (at the 64 queries' planned
   pairs, beside ``planned_gather_plain``) alone, each against its plain
   version; then one ``select_many`` and one exact ``count_many`` each under
   ``torch.profiler`` (the device's busy share, its top five ops, the
   longest idle gap); ``select_many`` must have launched ``planned_gather``;
4. the standing-query stream at bench config 8's width (``bench.py:1280``):
   64 city boxes (seed 7) packed one slot each, one full-span time window,
   on a ``SubscriptionMatrix(box_slots=1, time_slots=1, topk=128)``; 17
   chunks of 60M rows (16 B/row) from config 8's generator, first through
   an untimed referee (``batched_count_hits_plain`` on the card), then timed
   through ``DeviceStreamScanner(chunk_rows=60M, max_pending_chunks=2)``
   fed by a producer thread; every delivered count and position must equal
   the referee's, with no scan or callback error; then a churn leg
   (unsubscribe, resubscribe, one more chunk) at unchanged capacity;
5. a date-less point schema (``*geom:Point:srid=4326``, the z2 index only):
   bench config 1's query shape (64 city boxes, no time) over config 2's
   50M GDELT-shaped points with the date dropped: ``write`` (one
   ``z2_encode`` launch) → ``count_many(loose=True)`` against an int-domain
   referee, then 8 of the boxes through ``count_many(loose=False)`` (the
   edge gather kernel; the unconstrained window's endpoints match no row)
   and ``query()`` against an f64 brute force.
6. bench config 9 (``bench.py:1588``) at full size, on the fused path
   (the default route; the query cache emptied before each call, so that
   none is a hit): 50M GDELT-shaped points
   (seed 42) with config 9's group ids (G = 1024) and values, schema
   ``cat:Integer,val:Double,dtg:Date,*geom:Point``, ``write`` → ``compact``,
   then ``aggregate_many(group_by=["cat"], value_cols=["val"])`` over the 64
   city-box 2-7 day queries of seed 7 (the fused step's set) and of seed 301
   (the product path's), first call and p50 of 5 each: no lane may be
   ``None``; every answer of seed 7 and 16 of seed 301 equal an f64 numpy
   fold over the original lon/lat/time (groups in order; counts, value
   counts, min and max exact; sums within a relative 1e-12); one call with
   the pyramid switched on (``GEOMESA_TPU_PYRAMID=1``), timed beside the
   fused p50: the 50M rows' O(N) share is past the pyramid's byte cap, so
   it must refuse before it prepares any input and the fused path answer;
   then
   ``grouped_agg`` against ``grouped_agg_plain`` on the same payloads, on
   grid rows whose boundary rows overflow some lanes, and on config 9's
   rows with group ids over G = 8192 (the fold's global mode), its time
   beside the plain version's and its bound, with its mode, registers,
   spills and shared and global atomics; ``agg_work_list`` against its
   plain version with its time, its device time behind a spin and its
   bound, beside the launch floor (one empty kernel's launch through the
   same ctypes path, ``kernels.launch_floor_ms``); and one
   ``aggregate_many`` under ``torch.profiler``, with every device op of
   the call by name and count.
6b. config 9's product path (``bench.py:1695-1811``) with the pyramid
   switched on (``GEOMESA_TPU_PYRAMID=1``), over the first 10M of phase 6's
   rows: ``write`` → ``compact``, seed 301's
   64 queries cold (the GeoBlocks pyramid built on the host, every query
   served by it), the pyramid's p50 a query over fresh sets (seeds 400 +
   round, ``max(3, ITERS // 2)`` rounds), the warm p50 over repeats of seed
   301 (the query cache; the first repeat refills what the LRU evicted);
   none of these calls launches a kernel; every cold answer equals the
   fused path's on the same store (the default route, cache emptied) and
   an f64 numpy fold, and every warm answer is byte for byte the cold one;
   logs the pyramid's build ms, levels, time bins and host bytes, the
   queries by tier, the boundary rows re-tested a query, and the cold,
   pyramid, warm and fused ms a query.
7. bench config 3 (``bench.py:510``), density heatmaps and batched KNN:
   7a, ``batched_density`` against ``batched_density_plain`` on the card,
   exact, at N = 1,000,003 over GDELT-shaped rows in z3 order (city boxes;
   the cull keeps few pairs) and the same rows shuffled, grid rows and edge
   rows, (B, T) in {(1, 1), (8, 16)}, Q in {1, 16, 64, one past the tile},
   256 x 256 and 37 x 100 grids, each query's own box or a degenerate bound
   (xlo == xhi) as grid bounds, with and without a base/true_n tail; and
   ``batched_knn`` against ``batched_knn_plain``, distances bit-equal and
   rows equal, at k in {1, 10, 64}, Q in {1, 64, 65}, over the z3 rows,
   grid rows with points on them (ties) and 5 rows (N < k), and at k in
   {10, 64} where the tile skip decides: a NaN query and a far one among
   the z3 rows' points, and grid rows ordered by small cells with ties at
   the k-th distance across tile edges (each logs the (tile, query) pairs
   its answer keeps). 7b, config 3 at
   full size: 100M GDELT-shaped points (seed 42) written through
   ``DataStore`` (both Morton kernels), the 16 city-box queries (seed 7)
   through ``batched_density_step`` at 256 x 256 with each query's own box
   as its grid bounds (each grid's mass equals its ``batched_count``, each
   grid a numpy replica of the f32 cell math on the query's matching
   rows), ``density_many`` over one shared viewport, loose (equal to the
   replica over the clipped boxes) and ``loose=False`` (equal to an f64
   ``histogram2d``), and ``knn_many`` of bench config 3's 64 points at k =
   10 (4 inside the bench's f64 band, all 64 equal to ``batched_knn_plain``
   on the card); then ``density_many`` p50 per query and ``knn_many`` p50
   per point with their host split, and each kernel's time beside its
   plain version's, its bound and, for KNN, a library call (the (Q, N) d2
   expression and one ``torch.topk`` over dim 1, in query slices; the
   earlier per-query form beside it), timed only, its device time behind
   a spin, its bound counted from the answer (``knn_work``: a test a (tile,
   query) pair, the distances of the rows of each tile whose bound is at
   most the query's final k-th d2, the cap's sample pairs; the all-pairs
   bound beside it) and its split by kernel (``knn_split``); no one torch call
   computes the density grids, so a ``torch.bincount`` of the matches'
   cells, gathered beforehand, is logged as a part of the work
   (``bincount_part_ms``); and one ``density_many`` and one ``knn_many`` under
   ``torch.profiler`` (the KNN kernels' device times in launch order: the
   sample's gather, select and merge, then the full select and merge).
8. bench config 4 (``bench.py:629``, ``bench_join``) at full size over phase
   7's 100M points: 10,000 polygons (``workload.join_polygons``, seed 5),
   the points z2-sorted on the card (``z2_encode`` and a sort) and held as
   f32 x and y in 8192-row blocks, each polygon's candidate blocks planned
   per vertex bucket (``polygon_block_plan``), then ``block_join_step`` per
   bucket (one ``polygon_join`` launch each): the first run and the p50 of 5
   by host clock, the tested and effective Gpairs/s, the plan's tested
   fraction and prune factor. Checks: (a) ``polygon_join`` equals
   ``polygon_join_plain`` on the card over the pruned pairs of 256
   polygons from every bucket; (b) the bench's parity: the first 8
   polygons' pruned counts equal the unpruned count over every point, plain
   and kernel; (c) their f32 rows against the f64 ``points_within_geom``
   near each bbox, every disagreement within 1e-5 degrees of an edge; (d)
   on phase 7's store, before it is freed, ``join_rows_device`` of 64
   polygons (row sets equal to an f64 referee; its ``planned_gather``
   equal to ``planned_gather_plain`` on the same pairs),
   ``join_within_device`` of 8 (equal to (b)'s plain counts) and
   ``join_counts_auto``'s route; (e) an adversarial set, ``polygon_join``
   equal to ``polygon_join_plain`` on the card: rows on the kernel's y-band
   boundaries, on vertex y's and on horizontal edges, rings of 8, 95 and 512
   vertices, a zero-height bbox, a vertex count of V, pairs duplicated, out
   of range and in random order, ``pair_poly = None``, blocks of 4096, 8192
   and 9216 rows (a tile and a part). Then the kernel's work at config 4
   (``polygon_join_work``: work items, tiles staged, groups skipped by
   extent, compacted rows, band candidates and straddling (row, edge)
   tests, bands per bucket), ``polygon_join``'s time beside its plain
   version's, its bound (``join_floor``: what the inputs need) and the
   earlier all-edges floor, and the join's ``planned_gather`` beside its
   plain version's and its bound.

9. bench config 5 (``bench.py:787``, ``bench_xz2``) and a line store:
   9a, ``batched_overlap`` (without time, (B, T) in {(1, 0), (8, 0)}, and
   with time, {(1, 1), (8, 16)}), ``batched_edge_gather_overlap`` (capacity
   512, 8, 1 and 0, so that some queries' lanes overflow; overflowed lanes
   distinct, sorted and candidates) against their plain
   versions on the card, exact, at N = 1,000,003 config-5 bboxes (seed 9) in
   xz2 order and shuffled, with 300 zero-size, 300 whole-world and 300
   stamped invalid rows, Q in {1, 64, one past the tile}, with and without a
   base/true_n tail, payloads with city boxes packed with the overlap pad,
   boxes on rows' opposing edges, zero-size and whole-world boxes, dead
   slots (both pads and inverted boxes), all-dead queries and live, dead
   and unconstrained windows; ``planned_gather_overlap`` against its plain
   version on an empty pair list, the last block with ``true_n`` inside it,
   a block shared by 65 and by 300 pairs, every block, 3,500 random,
   duplicated and out-of-order pairs, and pairs out of range (0 rows each).
   9b, config 5 as the bench runs it: 4M bboxes (seed 9), ``xz2_sfc(12)``
   codes sorted on the card, 31-bit columns, the 64 city boxes (seed 7)
   packed one overlap slot each, ``batched_overlap_step`` counts equal to
   the bench's int referee (f64 boundary rows logged), p50 of 20 batches by
   host clock as ``xz2_linestring_bbox_query_p50_latency`` (ms per query);
   the kernel beside its plain version and bound, and at 64M rows (the 4M
   repeated 16 times, 1 GB of columns). 9c,
   ``cat:Integer,val:Double,dtg:Date,*geom:LineString`` (day bins) with 4M
   line strings on config 5's boxes (``workload.box_linestrings``) dated as
   ``synth_gdelt`` dates, config 9's group ids (G = 1024) and values with a
   tenth of them null, written through ``DataStore`` (xz3 + xz2); the 64
   city-box 2-7 day queries, 8 boxes with no time (planned on xz2) and one
   box across the antimeridian: ``count_many`` loose against a numpy int
   referee, exact against an f64 referee, ``select_many`` of the 64 and
   ``query()`` of 17 against the f64 referee (rows, fid sets, the index
   planned); timings with their host split; then, with the launch counts
   zeroed before it, ``aggregate_many(group_by=["cat"],
   value_cols=["val"])`` of the 64 (the overlap fold: one
   ``grouped_agg_overlap`` and one ``agg_work_list`` launch a call), first
   call and p50 of 5, every answer equal to an f64 numpy fold over the f64
   referee's rows (``agg_referee``: groups in order, counts, value counts,
   min and max exact, sums within a relative 1e-12); ``density_many`` of
   the 4 queries with the fewest matches over the world viewport at 256 x
   256 and the ``density`` hint of one (the exact path, the host
   rasterization: each grid's mass equals its query's exact count); the
   three overlap kernels alone at the store's shapes with their bounds, and
   ``grouped_agg_overlap`` against ``grouped_agg_overlap_plain`` at the
   store's payloads, with dead and inverted slots, an all-dead query and
   ``true_n`` inside the last chunk, and at G = 8192 (the global mode), its
   time beside the plain version's and its bound (``agg_overlap_floor``);
   then ``knn`` of 8 points around the cities at k = 10 (the window loop
   over ``query()`` and the exact f64 distance; ms a point and windows a
   point) and ``knn_many`` of the same 8 (per point: no point state), held
   by an envelope referee (``xz_knn_leg``).
   Each overlap kernel's record carries ``device_ms`` beside ``ms``: the
   device work of a call, CUDA events around 10 calls enqueued behind a
   spin of the card (``device_ms``), so the host's share does not count.

10. bench config 7 (``bench.py:1055``, ``bench_resident``): 10a,
   ``planned_count`` against ``planned_count_plain`` on the card, exact, at
   1,000,003 GDELT-shaped rows (keys built on the card) and 1,000,003
   config-5 bboxes (the overlap form), blocks of 1024 and 4096 rows, 65
   queries of one city slot, of several slots (B = 8, T = 16, an all-dead
   query) or of the whole world (the overlap form: phase 9a's adversarial
   payloads), on random pairs with padding among them, one block shared by
   the 65 queries, the last block with ``true_n`` inside it, every pair
   padded and no pair (no launch), and ``planned_count_step`` at R = 1 and
   R = 3 with different pair counts. 10b, config 7 as the bench runs it:
   125M points (seed 42), the keys built on the card
   (``workload.resident_store``: ``z3_encode``, a sort by (bin, z), the
   sorted z and bins copied back), four int32 columns padded to whole
   4096-row blocks (a multiple of the bench's 1024); R = 12 batches of 64
   city queries (seeds 100..111); the full scan (``repeated_count_step``, a
   ``batched_count`` launch a batch) at R = 12 and R = 1, a pass's ms as
   (t(12) - t(1)) / 11 of host-clock p50s and by CUDA events, its GB/s
   against 3.35 TB/s and the dispatch; the plan (``plan_query_intervals``,
   1024-row pairs, padded to a multiple of 128), held to the bench's 2N +
   2^20 rule; the pruned scan (``planned_count_step``) the same way;
   checks: pruned == full scan for all 768 queries, both == a numpy int
   referee on 4 queries of batch 0, and a same-cover referee over batch 0's
   pairs; log lines "phase 10 full scan", "phase 10 plan", "phase 10
   checks", "phase 10 resident_125m_scan_device_time_per_query" (with the
   pruned pass, speed-up, cover fraction, GB gathered and effective GB/s);
   then ``planned_count`` alone at batch 0's pairs beside its plain version
   and its bound (``n_pairs x 1024 x 16`` B), and ``planned_gather``'s count
   entry on the same queries planned at 4096-row blocks.

11. bench config 10 (``bench.py:1829``, ``bench_trajectory``): 11a, both
   forms of ``corridor_masks`` against their plain versions on the card,
   word for word (cand and sure): the gather form on rows staged as
   resident int32 columns among others in a shuffled order and read
   through their positions, the row form on the same rows' dequantized f32
   coordinates, so one plain call holds both; in the four variants,
   Q in {1, 16, 65}, N in {1, 1,000,003}: rows on segments' buffer
   distances, end points and zero-length segments and on the edges of the
   kernel's reach boxes, NaN and infinite headings, the >= 360 sentinel,
   padded segments and a padded corridor, the unconstrained quad; and the
   two tiling loops (600 corridors over the same N; a corridor of 1,499
   segments over 100,003 rows). 11b: 2M points on drifting tracks (seed 15,
   ``track:String,dtg:Date,*geom:Point``) through ``DataStore``; the
   bench's 16 tube corridors through ``tube_select_many(route="device")``,
   one warm call and 5 timed ("phase 11 tube_select_corridor_p50_latency",
   ms a corridor, beside the host ``tube_select``'s p50 a corridor, and
   "phase 11 route split"), fid sets equal on all 16, one
   ``corridor_masks_gather`` launch a call; a heading leg (20,000 rows with
   NaN and null headings, a mixed batch of uni- and bidirectional route
   corridors: two gather launches, each corridor == ``route_search``); a
   line leg (100,000 two-vertex line strings: the row form, one launch,
   fid sets == the host route); the interlink leg (L 1,500 points, seed 31;
   R 3,000, seed 32): 2D ``dwithin 0.4`` by the default route (the block
   route: ``planned_gather``, timed as ``interlink_ms``), time-lifted (the
   XZ3 pairing) and by the forced XZ pairing, each == ``interlink_referee``;
   after the main path's launches are read, the row
   form's route over the same store ("phase 11 table route", the route
   every store took before the gather form), the candidates of both
   routes; then both forms alone beside their plain versions and their
   bounds (counted from the pairs that reach each test): each at its main
   path's shape, the record (the row form at the line leg's candidates, the
   gather form at the device select's), the row form at the point
   candidate query's rows, and both at every row x 16 and x 64 corridors.
   11d, track statistics over 11b's store (with the launch counts zeroed
   before it): ``build_track_state`` with its split (scan, lexsort and
   offsets, sorted table and columns, staging), ``track_stats`` cold (the
   state built) and warm (the cached state, p50 of 5; one ``track_stats``
   launch a call), equal to ``track_stats_host`` (labels, rows and times
   exact, the sums within the reference's rtol 5e-3 + atol 1e-3); then the
   kernel against ``track_stats_plain`` on the card (rtol 1e-4 + atol 1e-3)
   at config 10's shape, no row, one-row entities, one entity holding half
   of 1,000,003 rows, parked runs (dwell), a row count that is not a
   multiple of 32, and layouts around the kernel's tiles of ``TRACK_TILE``
   rows (entities and empty entities on tile edges, zero-length steps and
   turns across tile edges, a single entity, fewer rows than a tile); two
   calls equal bit for bit (each sum's order is fixed by the layout); its
   time beside the plain version's, its bound (``track_floor``) and
   ``torch.segment_reduce`` of the four precomputed term columns, a part of
   the work.

Each store is freed before the next phase (phase 7's after phase 8).

The last lines are the kernel records (JSON), the card's name and power
limit as nvidia-smi reports them, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np

# torch.profiler tears CUPTI down after each window and sets it up again at
# the next; after phase 3's windows, phase 6's lost its kernel records (the
# parent's full run held them with phase 3's windows skipped). Keeping CUPTI
# subscribed between windows is what this script needs.
os.environ.setdefault("TEARDOWN_CUPTI", "0")

N_ROWS = 50_000_000
N_QUERIES = 64
N_EXACT = 8
ITERS = 10
STREAM_ROWS = 60_000_000  # bench config 8's chunk on an accelerator
STREAM_CHUNKS = 17  # 1.02B rows, config 8's accelerator total
STREAM_TOPK = 128
DAY_MS = 86_400_000
AGG_GROUPS = 1024  # bench config 9's G
AGG_SEEDS = (7, 301)  # the fused step's query set, the product path's
AGG_CHECKED = {7: 64, 301: 16}  # queries of each set held to the f64 fold
AGG_RTOL = 1e-12  # f64 sums: atomics fold in no fixed order
CONFIG3_ROWS = 100_000_000  # bench config 3 (bench.py:510), nothing cut
CONFIG3_DENSITY_QUERIES = 16  # min(Q, 16) city-box 2-7 day queries, 256 x 256 grids
CONFIG3_POINTS = 64  # knn_batch_points
CONFIG3_K = 10  # GEOMESA_BENCH_K's default
KNN_LIBRARY_SLICE = 8  # queries a slice of the library call's (Q, N) d2
MEM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
# Integer instruction rates by pipe. The data sheet's 67 TFLOP/s float32
# (non-tensor) counts an FMA as 2 ops on 128 lanes per SM. An SM issues 4
# warp-instructions (128 lanes) per clock; compares, logic and shifts run
# only on the ALU pipe, 64 lanes per SM; an int32 add or subtract may also
# run on the FMA pipe as IMAD.IADD (64 lanes), where nvcc puts the box
# test's subtracts. So an instruction mix takes at least the larger of its
# ALU-only instructions at the ALU rate and all its instructions at the
# issue rate.
ALU_OPS_PER_S = 67e12 / 4
ISSUE_OPS_PER_S = 67e12 / 2
# least int32 instructions per (row, live slot), as (ALU-only, all): a box
# slot is two subtracts (either pipe) and two unsigned compares (ISETP,
# each folding its AND into the predicate); a time slot is two 64-bit
# compares of the biased key built once per row, each a 32-bit compare
# chained into a second one (four ISETP)
BOX_SLOT_OPS = (2, 4)
TIME_SLOT_OPS = (4, 4)
# the edge gather's extra compares per matched (row, query) and live slot,
# all on the ALU pipe: a box slot's inside test and its four edge compares
# folded into predicates, a window's two endpoint compares of 64-bit keys
EDGE_BOX_SLOT_OPS = 4
EDGE_TIME_SLOT_OPS = 4
EDGE_MODES = ("grid", "single", "mixed", "city")
# the edge gather's cull per loaded row, all on the ALU pipe: min and max of
# x and of y (four IMNMX) and of the 64-bit time key (a min or a max is at
# least one 32-bit compare chained into a second: four ISETP)
EXTENT_OPS_PER_ROW = 8
# phase 2d's payloads over GDELT-shaped rows in z3 order: DataStore-packed
# city boxes (most pairs culled), several city slots and dead slots per
# query, windows after the data (every pair culled), the whole world (none)
CULL_MODES = ("city", "multi", "late", "world")
# least int32 instructions per row of the Morton encodes' magic-mask spreads
# (curve/zorder.py): a spread step is a 64-bit shift (two 32-bit funnel
# shifts; none for the 32-bit shift, a register move) and an OR-then-AND per
# 32-bit half (one LOP3 each). z3: per dimension 1 mask + 2 (the 32-bit step)
# + 4 steps x 4 = 19, x 3, plus the y and t shifts (2 + 2) and one three-way
# OR per half (2) = 63. z2: per dimension 5 steps x 4 = 20, x 2, plus the y
# shift (2) and the OR (2) = 44. Bytes: each input read once (4 B per
# column), the int64 code written once.
MORTON_OPS_PER_ROW = {"z3_encode": 63, "z2_encode": 44}
MORTON_BYTES_PER_ROW = {"z3_encode": 3 * 4 + 8, "z2_encode": 2 * 4 + 8}
MORTON_EDGES = {  # each width's 0, 1, largest, then values above it
    "z3_encode": [0, 1, 2**21 - 1, 2**21, 2**21 + 5, 2**30, 2**31 - 1, -1, -(2**31)],
    "z2_encode": [0, 1, 2**31 - 1, 2**30, -1, -(2**31), -12345],
}


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_name_power() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    import torch

    fn()  # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, calls: int = 10) -> float | None:
    """Device time of one call of ``fn``: CUDA events around ``calls`` calls
    enqueued behind a spin of the card (``torch.cuda._sleep``), so that the
    host's share of each call runs while the card spins and the events time
    the calls' device work back to back (the kernels and any device op of
    the wrapper, without the host's gaps). ``fn`` must not synchronise. The
    spin doubles until the host has enqueued every call before the card
    reaches the first event; None (logged as not measured) if it never
    does. This replaces ``torch.profiler`` here: late in a full run its
    traces lose kernel records (phases 6 and 7)."""
    import torch

    fn()  # warm-up
    torch.cuda.synchronize()
    spin = 1 << 24
    for _ in range(6):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        hidden = not start.query()  # the card had not reached the first event yet
        torch.cuda.synchronize()
        if hidden:
            return start.elapsed_time(end) / calls
        spin *= 2
    return None


def fmt_ms(v: float | None) -> str:
    return "not measured" if v is None else f"{v:.4f} ms"


PAYLOAD_MODES = ("random", "packed", "single", "mixed")


def random_payload(rng, q: int, nb: int, nt: int, n_bins: int, mode: str = "random",
                   edge_cols=None):
    """Boxes/windows as (q, nb, 4)/(q, nt, 4) int32. ``random``: 1..nb boxes
    and 1..nt windows per query with sentinel padding, the last query fully
    unsatisfiable; ``packed``: the same with one box and one window each,
    as ``DataStore`` packs a city-box query; ``single``/``mixed``:
    ``workload.edge_payload`` around the rows ``edge_cols``."""
    from geomesa_tpu_torch.ops.refine import pack_boxes, pack_times, unsat_rows
    from geomesa_tpu_torch.workload import edge_payload

    if mode in ("single", "mixed"):
        return edge_payload(edge_cols, q, nb, nt, seed=int(rng.integers(2**31)),
                            single=mode == "single")
    boxes, times = [], []
    for i in range(q):
        kb = 1 if mode == "packed" else int(rng.integers(1, nb + 1))
        kt = 1 if mode == "packed" else int(rng.integers(1, nt + 1))
        bx = np.sort(rng.integers(0, 2**31 - 1, (kb, 2, 2)), axis=2)
        boxes.append(pack_boxes(bx.reshape(kb, 4).astype(np.int32), slots=nb))
        tb = np.sort(rng.integers(0, n_bins, (kt, 2)), axis=1)
        to = rng.integers(0, DAY_MS, (kt, 2))
        tq = np.stack([tb[:, 0], to[:, 0], tb[:, 1], to[:, 1]], axis=1)
        times.append(pack_times(tq.astype(np.int32), slots=nt))
    ub, ut = unsat_rows(nb, nt)
    boxes[-1], times[-1] = ub, ut
    return (np.ascontiguousarray(np.stack(boxes)),
            np.ascontiguousarray(np.stack(times)))


def check_shapes(device, name: str, ns, slot_pairs, seed: int) -> int:
    """Phases 2 and 2b: kernel ``name`` vs its plain version, exact, at each
    N in ``ns``, (B, T) in ``slot_pairs``, Q in {1, 64, one past the
    kernel's shared-memory tile}, each payload mode of
    :func:`random_payload`, with and without a base/true_n tail; both row
    loops must have run. Returns max |difference| over every output."""
    import torch

    from geomesa_tpu_torch.ops import kernels
    from geomesa_tpu_torch.workload import edge_columns

    kernel, plain = getattr(kernels, name), getattr(kernels, name + "_plain")
    rng = np.random.default_rng(seed)
    n_bins = 40
    worst = 0
    kernels.path_blocks(name)  # zero the row-loop counters
    for n in ns:
        random_cols = [
            rng.integers(0, 2**31 - 1, n).astype(np.int32),
            rng.integers(0, 2**31 - 1, n).astype(np.int32),
            rng.integers(0, n_bins, n).astype(np.int32),
            rng.integers(0, DAY_MS, n).astype(np.int32),
        ]
        edge_cols = edge_columns(n, seed=seed + n)
        for mode in PAYLOAD_MODES:
            host_cols = edge_cols if mode in ("single", "mixed") else random_cols
            cols = [torch.from_numpy(c).to(device) for c in host_cols]
            for nb, nt in slot_pairs:
                for q in (1, 64, kernels.q_tile_for(nb, nt, kernel=name) + 1):
                    for base, true_n in ((0, n), (3 * 4096, 3 * 4096 + n - 777)):
                        b, t = random_payload(rng, q, nb, nt, n_bins, mode, edge_cols)
                        boxes = torch.from_numpy(b).to(device)
                        times = torch.from_numpy(t).to(device)
                        got = kernel(*cols, base, true_n, boxes, times)
                        want = plain(*cols, base, true_n, boxes, times)
                        torch.cuda.synchronize()
                        if isinstance(got, torch.Tensor):
                            got, want = (got,), (want,)
                        err = max(int((g.long() - w.long()).abs().max())
                                  for g, w in zip(got, want))
                        worst = max(worst, err)
                        log(f"  {name} {mode} N={n} Q={q} B={nb} T={nt} base={base} "
                            f"true_n={true_n}: max_abs_err={err} "
                            f"(matches {int(want[0].long().sum())})")
                        if err != 0:
                            raise AssertionError(f"{name} disagrees with plain at {mode} "
                                                 f"N={n} Q={q} B={nb} T={nt}")
    single, general = kernels.path_blocks(name)
    log(f"  {name} row loops: {single} blocks single-slot, {general} blocks general")
    if not (single and general):
        raise AssertionError(f"{name}: both row loops must run in this phase")
    return worst


def predicate_floor_ops(x, y, bins, offs, boxes, times, chunks=None):
    """The least int32 instructions ``batched_count`` needs on these inputs,
    as (ALU-only, all) counts (:data:`BOX_SLOT_OPS`, :data:`TIME_SLOT_OPS`).

    A padding sentinel (lo > hi) matches nothing and is known so per query,
    so only live slots count. Per query, the cheaper order of the two tests:
    every row's box test plus the time test of rows inside a live box, or
    every row's time test plus the box test of rows inside a live window;
    each count takes its own cheaper order, so the pair stays a floor.
    ``chunks``, a (chunks, Q) bool mask of 4096-row chunks
    (``kernels.chunk_query_pairs``), limits each query's tests to the rows
    of its chunks. Returns ((alu, all), in-box row-queries, in-time
    row-queries, matches), matches over those rows; the caller holds
    ``matches`` to the kernel's total, which checks that the dropped slots
    (and chunks) held no match."""
    import torch

    from geomesa_tpu_torch.ops.kernels import JOIN_BLOCK

    n = x.shape[0]
    alu = total = in_box_total = in_time_total = matches = 0
    key = bins.long() * 2**32 + offs.long()  # lexicographic (bin, off) order
    for qi in range(boxes.shape[0]):
        keep = None if chunks is None else chunks[:, qi].repeat_interleave(JOIN_BLOCK)[:n]
        live_b = [b for b in boxes[qi].tolist() if b[0] <= b[1] and b[2] <= b[3]]
        live_t = [(blo * 2**32 + olo, bhi * 2**32 + ohi)
                  for blo, olo, bhi, ohi in times[qi].tolist()
                  if (blo, olo) <= (bhi, ohi)]
        in_box = torch.zeros(n, dtype=torch.bool, device=x.device)
        for xlo, xhi, ylo, yhi in live_b:
            in_box |= (x >= xlo) & (x <= xhi) & (y >= ylo) & (y <= yhi)
        in_time = torch.zeros(n, dtype=torch.bool, device=x.device)
        for lo, hi in live_t:
            in_time |= (key >= lo) & (key <= hi)
        rows = n
        if keep is not None:
            in_box &= keep
            in_time &= keep
            rows = int(keep.sum())
        nbox, ntime = int(in_box.sum()), int(in_time.sum())
        alu_q, total_q = (
            min(rows * BOX_SLOT_OPS[i] * len(live_b) + nbox * TIME_SLOT_OPS[i] * len(live_t),
                rows * TIME_SLOT_OPS[i] * len(live_t) + ntime * BOX_SLOT_OPS[i] * len(live_b))
            for i in (0, 1))
        alu += alu_q
        total += total_q
        in_box_total += nbox
        in_time_total += ntime
        matches += int((in_box & in_time).sum())
    return (alu, total), in_box_total, in_time_total, matches


def hits_floor(x, y, bins, offs, boxes, times):
    """The least work of ``batched_count_hits`` on these inputs: the
    predicate's (:func:`predicate_floor_ops`) plus one compare (ALU) per
    matched (row, query) for the lane maximum; bytes are the columns, the
    payload, and the (Q, 128) lane scoreboard read and written once. Returns
    ((alu, all), bytes, in-box row-queries, matches)."""
    (alu, total), in_box, _, matches = predicate_floor_ops(x, y, bins, offs, boxes, times)
    q = boxes.shape[0]
    nbytes = 16 * x.shape[0] + 4 * (boxes.numel() + times.numel()) + 2 * q * 128 * 4 + 4 * q
    return (alu + matches, total + matches), nbytes, in_box, matches


def bound_fields(ops: tuple[int, int], nbytes: int) -> dict:
    """``bound_ms``/``bound_by`` of a kernel record from its least work:
    ``ops`` = (ALU-only, all) int32 instructions, ``nbytes`` moved."""
    ops_ms = max(ops[0] / ALU_OPS_PER_S, ops[1] / ISSUE_OPS_PER_S) * 1e3
    bytes_ms = nbytes / MEM_BYTES_PER_S * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def morton_inputs(dev, name: str, n: int, seed: int):
    """Seeded in-width int32 columns for ``name`` made on the card, with the
    width's edge and out-of-width values spliced in at the front."""
    import torch

    dims, bits = (3, 21) if name == "z3_encode" else (2, 31)
    gen = torch.Generator(device=dev).manual_seed(seed)
    cols = [torch.randint(0, 2**bits, (n,), generator=gen, device=dev, dtype=torch.int32)
            for _ in range(dims)]
    edges = MORTON_EDGES[name]
    for d, c in enumerate(cols):
        vals = np.roll(np.array(edges, np.int32), d)[: min(n, len(edges))]
        c[: len(vals)] = torch.from_numpy(vals).to(dev)
    return cols


def check_morton(dev, big_n: int) -> dict:
    """Phase 2c: ``z3_encode``/``z2_encode`` against their plain versions,
    exact, at N in {1, 1,000,003, ``big_n``}; then kernel and plain times at
    ``big_n`` and the bound. Returns {name: partial kernel record}."""
    import torch

    from geomesa_tpu_torch.ops import kernels

    out = {}
    for name in ("z3_encode", "z2_encode"):
        kernel, plain = getattr(kernels, name), getattr(kernels, name + "_plain")
        worst = 0
        for n in (1, 1_000_003, big_n):
            cols = morton_inputs(dev, name, n, seed=n % 1000 + 5)
            got, want = kernel(*cols), plain(*cols)
            torch.cuda.synchronize()
            err = int((got != want).sum())  # codes differ: count them
            log(f"  {name} N={n}: {err} codes differ from plain "
                f"(first {got[:3].tolist()}, max {int(got.max())})")
            if err or got.dtype != torch.int64 or got.shape != (n,):
                raise AssertionError(f"{name} disagrees with plain at N={n}")
            worst = max(worst, int((got - want).abs().max()))
        kernel_ms = cuda_ms(lambda: kernel(*cols), 5)
        plain_ms = cuda_ms(lambda: plain(*cols), 1)
        ops = MORTON_OPS_PER_ROW[name] * big_n  # logic and shifts: ALU-only
        rec = {"max_abs_err": worst, "ms": kernel_ms, "plain_ms": plain_ms,
               **bound_fields((ops, ops), MORTON_BYTES_PER_ROW[name] * big_n)}
        log(f"phase {name} timing: {kernel_ms:.4f} ms at N={big_n}; plain {plain_ms:.4f} ms; "
            f"bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}: "
            f"{ops} int32 ops; "
            f"{MORTON_BYTES_PER_ROW[name] * big_n} bytes)")
        out[name] = rec
        del cols, got, want
    return out


def edge_inputs(rng, mode: str, q: int, nb: int, nt: int, cols):
    """Phase 2d's (boxes, times) for ``mode`` over the host rows ``cols``."""
    from geomesa_tpu_torch.filter.bounds import extract
    from geomesa_tpu_torch.filter.cql import parse
    from geomesa_tpu_torch.schema.sft import parse_spec
    from geomesa_tpu_torch.store.backends import DeviceBackend
    from geomesa_tpu_torch.workload import (
        SPEC, bbox_time_cql, edge_payload, grid_payload, make_queries)

    seed = int(rng.integers(2**31))
    if mode == "grid":
        return grid_payload(cols, q, nb, nt, seed)
    if mode in ("single", "mixed"):
        return edge_payload(cols, q, nb, nt, seed, single=mode == "single")
    # city boxes and windows packed as DataStore packs them, live slots first
    sft = parse_spec("gdelt", SPEC)
    packed = [DeviceBackend(None).payload(sft, extract(parse(bbox_time_cql(b, w)), "geom", "dtg"))
              for b, w in zip(*make_queries(q, seed=seed))]
    return (np.ascontiguousarray(np.stack([p[0][:nb] for p in packed])),
            np.ascontiguousarray(np.stack([p[1][:nt] for p in packed])))


def edge_host_columns(mode: str, n: int, seed: int):
    """Phase 2d's host rows for ``mode``: grid rows, ``edge_columns``, or
    GDELT-shaped points normalized as ``DeviceBackend.load`` does."""
    from geomesa_tpu_torch.schema.columnar import Column, FeatureTable, point_column
    from geomesa_tpu_torch.schema.sft import AttributeType, parse_spec
    from geomesa_tpu_torch.store.backends import device_columns
    from geomesa_tpu_torch.workload import SPEC, edge_columns, grid_columns, synth_gdelt

    if mode == "grid":
        return grid_columns(n, seed)
    if mode in ("single", "mixed"):
        return edge_columns(n, seed)
    lon, lat, t = synth_gdelt(n, seed=seed)
    sft = parse_spec("gdelt", SPEC)
    table = FeatureTable.from_columns(sft, np.arange(n).astype("U9"), {
        "dtg": Column(AttributeType.DATE, t), "geom": point_column(lon, lat)})
    c = device_columns(sft, table)
    return c["x"], c["y"], c["bins"], c["offs"]


def check_edge_gather(dev, n: int, seed: int) -> int:
    """Phase 2d: ``batched_edge_gather`` against its plain version and
    ``batched_count`` on the card, exact (see the module docstring). Returns
    max |difference| over counts, hits and lanes."""
    import torch

    from geomesa_tpu_torch.ops import kernels
    from geomesa_tpu_torch.ops.kernels import (
        EDGE_CAPACITY, batched_count, batched_edge_gather, batched_edge_gather_plain)

    rng = np.random.default_rng(seed)
    worst = overflowed = fitted = 0
    kernels.path_blocks("batched_edge_gather")  # zero the row-loop counters
    for mode in EDGE_MODES:
        host_cols = edge_host_columns(mode, n, seed)
        cols = [torch.from_numpy(c).to(dev) for c in host_cols]
        for nb, nt in ((1, 1), (8, 16)):
            for q in (1, 64, kernels.q_tile_for(nb, nt, kernel="batched_edge_gather") + 1):
                for base, true_n in ((0, n), (3 * 4096, 3 * 4096 + n - 777)):
                    b, t = edge_inputs(rng, mode, q, nb, nt, host_cols)
                    boxes, times = torch.from_numpy(b).to(dev), torch.from_numpy(t).to(dev)
                    args = (*cols, base, true_n, boxes, times)
                    counts, pos, hits = batched_edge_gather(*args)
                    want_c, want_p, want_h = batched_edge_gather_plain(*args)
                    plain_count = batched_count(*args)
                    torch.cuda.synchronize()
                    err = max(int((counts.long() - want_c.long()).abs().max()),
                              int((counts.long() - plain_count.long()).abs().max()),
                              int((hits.long() - want_h.long()).abs().max()))
                    h = hits[:, 0].cpu().numpy()
                    fits = h <= EDGE_CAPACITY
                    lanes = pos[:, 0].cpu().numpy()
                    err = max(err, int(np.abs(lanes[fits] - want_p[:, 0].cpu().numpy()[fits])
                                       .max(initial=0)))
                    if (~fits).any():
                        # every lane of an overflowed query is one of its candidates, sorted
                        _, all_p, _ = batched_edge_gather_plain(*args, capacity=int(h.max()))
                        all_p = all_p[:, 0].cpu().numpy()
                        for k in np.nonzero(~fits)[0]:
                            cand = all_p[k, : h[k]]
                            got = lanes[k]
                            if (got < 0).any() or len(np.unique(got)) != len(got) \
                                    or (np.diff(got) <= 0).any() or not np.isin(got, cand).all():
                                err = max(err, 1)
                    overflowed += int((~fits).sum())
                    fitted += int(fits.sum())
                    worst = max(worst, err)
                    log(f"  batched_edge_gather {mode} N={n} Q={q} B={nb} T={nt} base={base} "
                        f"true_n={true_n}: max_abs_err={err} (matches {int(want_c.long().sum())}, "
                        f"candidates {int(h.sum())}, {int((~fits).sum())} queries overflowed)")
                    if err != 0:
                        raise AssertionError(f"batched_edge_gather disagrees with plain at {mode} "
                                             f"N={n} Q={q} B={nb} T={nt}")
    single, general = kernels.path_blocks("batched_edge_gather")
    log(f"  batched_edge_gather row loops: {single} blocks single-slot, {general} blocks general; "
        f"{fitted} queries held every candidate, {overflowed} overflowed {EDGE_CAPACITY} lanes")
    if not (single and general and overflowed and fitted):
        raise AssertionError("batched_edge_gather: both row loops, and queries that fit and "
                             "that overflow their lanes, must occur in this phase")
    return worst


def z3_store(dev, n: int, seed: int):
    """A ``DataStore`` of ``n`` GDELT-shaped points (seed ``seed``) on
    ``dev``; returns (store, schema, resident z3 state): rows in z3 order,
    padded to a multiple of 4096."""
    from geomesa_tpu_torch.schema.columnar import Column, FeatureTable, point_column
    from geomesa_tpu_torch.schema.sft import AttributeType
    from geomesa_tpu_torch.store.datastore import DataStore
    from geomesa_tpu_torch.workload import SPEC, synth_gdelt

    lon, lat, t = synth_gdelt(n, seed=seed)
    ds = DataStore(device=dev)
    sft = ds.create_schema("gdelt", SPEC)
    ds.write("gdelt", FeatureTable.from_columns(sft, np.arange(n).astype("U9"), {
        "dtg": Column(AttributeType.DATE, t), "geom": point_column(lon, lat)}))
    ds.compact("gdelt")
    return ds, sft, ds._state("gdelt").backend_state["z3"]


def city_payloads(ds, sft, q: int, seed: int, late: bool = False):
    """``q`` city-box 2-7 day queries (``make_queries``) packed as
    ``DataStore`` packs them, as host (q, 8, 4) / (q, 16, 4) arrays; with
    ``late`` every window moves 40 days on, past the data's 30."""
    from geomesa_tpu_torch.filter.bounds import extract
    from geomesa_tpu_torch.filter.cql import parse
    from geomesa_tpu_torch.workload import bbox_time_cql, make_queries

    boxes_f64, windows = make_queries(q, seed=seed)
    if late:
        windows = [(lo + 40 * DAY_MS, hi + 40 * DAY_MS) for lo, hi in windows]
    pays = [ds.backend.payload(sft, extract(parse(bbox_time_cql(b, w)), "geom", "dtg"))
            for b, w in zip(boxes_f64, windows)]
    return (np.ascontiguousarray(np.stack([p[0] for p in pays])),
            np.ascontiguousarray(np.stack([p[1] for p in pays])))


def cull_payload(ds, sft, mode: str, q: int, nb: int, nt: int, seed: int):
    """Phase 2d's (boxes, times) for cull ``mode`` (:data:`CULL_MODES`),
    cut to ``nb`` box and ``nt`` time slots."""
    from geomesa_tpu_torch.ops.refine import pack_boxes, pack_times

    rng = np.random.default_rng(seed)
    if mode == "world":
        b, t = pack_boxes(None, slots=nb), pack_times(None, slots=nt)
        return (np.ascontiguousarray(np.repeat(b[None], q, 0)),
                np.ascontiguousarray(np.repeat(t[None], q, 0)))
    boxes, times = city_payloads(ds, sft, q, seed, late=mode == "late")
    boxes, times = boxes[:, :nb].copy(), times[:, :nt].copy()
    if mode == "multi":
        # each query takes live slots of several city queries at random
        # slots; the rest are dead (padding sentinels and inverted bounds)
        dead_b = np.array([[1, 0, 1, 0], [5, 4, 0, 2**31 - 1]], np.int32)
        dead_t = np.array([[1, 0, 0, -1], [3, 5, 3, 4]], np.int32)
        src_b, src_t = boxes[:, 0].copy(), times[:, 0].copy()
        for qi in range(q):
            boxes[qi] = dead_b[rng.integers(2, size=nb)]
            times[qi] = dead_t[rng.integers(2, size=nt)]
            kb, kt = int(rng.integers(1, nb + 1)), int(rng.integers(1, nt + 1))
            boxes[qi, rng.choice(nb, kb, replace=False)] = src_b[rng.choice(q, kb)]
            times[qi, rng.choice(nt, kt, replace=False)] = src_t[rng.choice(q, kt)]
    return np.ascontiguousarray(boxes), np.ascontiguousarray(times)


def check_edge_cull(dev, store, seed: int) -> int:
    """Phase 2d, the cull: ``batched_edge_gather`` against its plain
    version and ``batched_count`` on GDELT-shaped rows in z3 order, for
    each of :data:`CULL_MODES` at (B, T) in {(1, 1), (8, 16)}, Q in {64,
    one past the tile}, with and without a base/true_n tail; then the same
    rows in a seeded random order (nothing culled): counts and hits equal
    the sorted run's and the candidates are the same rows. Logs the share
    of (chunk, query) pairs the cull keeps. Returns max |difference|."""
    import torch

    from geomesa_tpu_torch.ops import kernels
    from geomesa_tpu_torch.ops.kernels import (
        EDGE_CAPACITY, batched_count, batched_edge_gather, batched_edge_gather_plain,
        chunk_query_pairs)

    ds, sft, state = store
    n, cols = state.n, state.spatial_cols()
    perm = torch.randperm(n, generator=torch.Generator().manual_seed(seed)).to(dev)
    shuffled = [torch.cat([c[:n][perm], c[n:]]) for c in cols]
    worst = 0
    for mode in CULL_MODES:
        for nb, nt in ((1, 1), (8, 16)):
            for q in (64, kernels.q_tile_for(nb, nt, kernel="batched_edge_gather") + 1):
                b, t = cull_payload(ds, sft, mode, q, nb, nt, seed + q + nb)
                boxes, times = torch.from_numpy(b).to(dev), torch.from_numpy(t).to(dev)
                for base, true_n in ((0, n), (3 * 4096, 3 * 4096 + n - 777)):
                    args = (*cols, base, true_n, boxes, times)
                    counts, pos, hits = batched_edge_gather(*args)
                    want_c, want_p, want_h = batched_edge_gather_plain(*args)
                    full = batched_count(*args)
                    kept = float(chunk_query_pairs(*args).float().mean())
                    torch.cuda.synchronize()
                    fits = want_h[:, 0] <= EDGE_CAPACITY
                    err = max(int((counts.long() - want_c.long()).abs().max()),
                              int((counts.long() - full.long()).abs().max()),
                              int((hits.long() - want_h.long()).abs().max()),
                              int((pos.long() - want_p.long())[fits].abs().sum()))
                    note = ""
                    if base == 0 and true_n == n:  # every row valid: order-free answers
                        s_counts, s_pos, s_hits = batched_edge_gather(*shuffled, 0, n,
                                                                      boxes, times)
                        # the shuffled run's candidates, mapped back to sorted positions
                        g = s_pos[fits][:, 0].long()
                        back = torch.where(g >= 0, perm[g.clamp(min=0)], 2**31 - 1)
                        back = back.sort(dim=1).values
                        back[back == 2**31 - 1] = -1
                        if not (torch.equal(s_counts, counts) and torch.equal(s_hits, hits)
                                and torch.equal(back.int(), pos[fits][:, 0])):
                            err = max(err, 1)
                        note = "; the same rows shuffled (nothing culled) agree"
                    worst = max(worst, err)
                    log(f"  batched_edge_gather cull {mode} N={n} Q={q} B={nb} T={nt} "
                        f"base={base} true_n={true_n}: max_abs_err={err} (matches "
                        f"{int(want_c.long().sum())}, candidates {int(want_h.sum())}; kept "
                        f"{kept:.6f} of (chunk, query) pairs{note})")
                    if err != 0:
                        raise AssertionError(f"batched_edge_gather disagrees at cull {mode} "
                                             f"Q={q} B={nb} T={nt} base={base}")
    return worst


def check_planned_gather(dev, store, seed: int) -> int:
    """Phase 2e: ``planned_gather`` against ``planned_gather_plain`` on the
    card, exact (positions and per-pair counts), on: an empty pair list (no
    launch); a pair on the last block, whose rows end at ``true_n`` inside
    it; one block shared by several queries; one query covering every
    block; ``edge_payload``'s multi-slot and dead-slot payloads and
    ``grid_payload``'s over their rows with random pairs and a ``true_n``
    tail; one block under 300 pairs (more than the count pass stages at
    once) and four blocks under 400; and the 64 city queries' planned
    pairs. Returns max |difference|."""
    import torch

    from geomesa_tpu_torch.ops import kernels
    from geomesa_tpu_torch.ops.kernels import planned_gather, planned_gather_plain
    from geomesa_tpu_torch.ops.refine import pack_boxes, pack_times
    from geomesa_tpu_torch.parallel.query import intervals_to_block_pairs
    from geomesa_tpu_torch.parallel.residency import JOIN_BLOCK
    from geomesa_tpu_torch.planning.planner import Query, QueryPlanner
    from geomesa_tpu_torch.workload import (
        bbox_time_cql, edge_columns, edge_payload, grid_columns, grid_payload, make_queries)

    rng = np.random.default_rng(seed)
    ds, sft, state = store
    n, cols = state.n, state.spatial_cols()
    n_blocks = cols[0].shape[0] // JOIN_BLOCK
    b, t = city_payloads(ds, sft, 64, seed=7)
    world_b, world_t = pack_boxes(None)[None], pack_times(None)[None]
    boxes = np.ascontiguousarray(np.concatenate([b, world_b]))  # query 64: everything
    times = np.ascontiguousarray(np.concatenate([t, world_t]))
    planner = QueryPlanner(sft, ds._state("gdelt").indices)
    plans = [planner.plan(Query(bbox_time_cql(bx, w))) for bx, w in zip(*make_queries(64, 7))]
    plan_q, plan_b = intervals_to_block_pairs([pl.intervals for pl, _, _ in plans], JOIN_BLOCK)
    shared = int(plan_b[0])
    cases = [
        ("empty", cols, n, [], [], boxes, times),
        ("last block", cols, n, [64, 3], [n_blocks - 1] * 2, boxes, times),
        ("shared block", cols, n, range(65), [shared] * 65, boxes, times),
        # more pairs on one block than the count pass stages at once
        ("shared block x300", cols, n, [i % 65 for i in range(300)], [shared] * 300, boxes,
         times),
        ("shared blocks", cols, n, [i % 65 for i in range(400)],
         [shared + (i % 4) for i in range(400)], boxes, times),
        ("every block", cols, n, [64] * n_blocks, range(n_blocks), boxes, times),
        ("planned city", cols, n, plan_q, plan_b, boxes, times),
    ]
    rows = 64 * JOIN_BLOCK
    for name, make_cols, make_pay in (
            ("mixed slots", edge_columns, lambda c: edge_payload(c, 24, 8, 16, seed, single=False)),
            ("grid slots", grid_columns, lambda c: grid_payload(c, 24, 8, 16, seed))):
        host = make_cols(rows, seed)
        pb, pt = make_pay(host)
        pairs_q, pairs_b = rng.integers(0, 24, 500), rng.integers(0, 64, 500)
        cases.append((name, [torch.from_numpy(c).to(dev) for c in host], rows - 1000,
                      pairs_q, pairs_b, pb, pt))
    worst = 0
    for name, c, true_n, pq, pbk, bx, tm in cases:
        pq_t = torch.tensor(np.asarray(list(pq), np.int32), dtype=torch.int32, device=dev)
        pb_t = torch.tensor(np.asarray(list(pbk), np.int32), dtype=torch.int32, device=dev)
        bx_t, tm_t = torch.from_numpy(np.ascontiguousarray(bx)).to(dev), \
            torch.from_numpy(np.ascontiguousarray(tm)).to(dev)
        before = kernels.launches["planned_gather"]
        got_p, got_h = planned_gather(*c, true_n, pq_t, pb_t, bx_t, tm_t)
        want_p, want_h = planned_gather_plain(*c, true_n, pq_t, pb_t, bx_t, tm_t)
        torch.cuda.synchronize()
        launched = kernels.launches["planned_gather"] - before
        same = (got_p.dtype == torch.int32 and got_h.dtype == torch.int64
                and torch.equal(got_p, want_p) and torch.equal(got_h, want_h))
        err = 0 if same else 1
        if same and len(got_p):
            err = int((got_p.long() - want_p.long()).abs().max())
        worst = max(worst, err)
        runs = np.unique(pb_t.cpu().numpy(), return_counts=True)[1]
        log(f"  planned_gather {name}: {len(pq_t)} pairs over {len(runs)} distinct blocks "
            f"(each read once; longest run {int(runs.max()) if len(runs) else 0} pairs), "
            f"{int(want_h.sum())} rows, true_n={true_n}, {launched} launch(es): "
            f"max_abs_err={err}")
        if not same or launched != (1 if len(pq_t) and dev.type == "cuda" else 0):
            raise AssertionError(f"planned_gather disagrees with plain at {name}")
        if name == "last block" and not (0 < int(want_h[0]) < JOIN_BLOCK):
            raise AssertionError("the last block's pair must hold rows up to true_n")
    return worst


def edge_floor(x, y, bins, offs, boxes, times, counts, hits, capacity: int,
               chunks=None, loaded_rows: int | None = None):
    """The least work of ``batched_edge_gather`` on these inputs: the
    predicate's (:func:`predicate_floor_ops`) on the rows of the (chunk,
    query) pairs ``chunks`` that the cull keeps (every pair when None: the
    full-scan count), plus, with ``chunks``, the cull's extent min/max of
    every loaded row (:data:`EXTENT_OPS_PER_ROW`), plus the edge compares
    per matched (row, query) and live slot (:data:`EDGE_BOX_SLOT_OPS`,
    :data:`EDGE_TIME_SLOT_OPS`); bytes are the columns and payload read
    once, the counts and hits written once and 4 B per written candidate.
    ``x, y, bins, offs`` are the valid rows; ``loaded_rows`` (default their
    count) the rows the kernel reads, resident padding included. Returns
    ((alu, all), bytes, matches)."""
    loaded = x.shape[0] if loaded_rows is None else loaded_rows
    (alu, total), _, _, matches = predicate_floor_ops(x, y, bins, offs, boxes, times, chunks)
    edge = 0
    for qi, (b, t) in enumerate(zip(boxes.tolist(), times.tolist())):
        live_b = sum(1 for xlo, xhi, ylo, yhi in b if xlo <= xhi and ylo <= yhi)
        live_t = sum(1 for blo, olo, bhi, ohi in t if (blo, olo) <= (bhi, ohi))
        edge += int(counts[qi]) * (EDGE_BOX_SLOT_OPS * live_b + EDGE_TIME_SLOT_OPS * live_t)
    extent = 0 if chunks is None else EXTENT_OPS_PER_ROW * loaded
    written = int(hits.clamp(max=capacity).long().sum())
    nbytes = (16 * loaded + 4 * (boxes.numel() + times.numel())
              + 8 * boxes.shape[0] + 4 * written)
    return (alu + edge + extent, total + edge + extent), nbytes, matches


def gather_floor(cols, true_n: int, pair_q, pair_blk, boxes, times, hits, pos_bytes: int):
    """The least work of ``planned_gather`` (or, over six bbox columns, of
    ``planned_gather_overlap``) on these pairs: per pair, the predicate of
    :func:`predicate_floor_ops` (the overlap test's
    :data:`OVERLAP_SLOT_OPS`) on its block's valid rows (the cheaper test
    order, live slots only); bytes are each distinct block's four (six)
    columns read once, the pair lists read (4 + 4 B a pair) and the
    pair counts written (8 B), the payload read once and ``pos_bytes`` per
    written position (the positions' element size). Returns ((alu, all),
    bytes)."""
    import torch

    from geomesa_tpu_torch.parallel.residency import JOIN_BLOCK

    from geomesa_tpu_torch.ops.kernels import overlap_masks

    overlap = len(cols) == 6  # a bbox layout: the overlap form
    box_ops = OVERLAP_SLOT_OPS if overlap else BOX_SLOT_OPS
    live = [(sum(1 for xlo, xhi, ylo, yhi in b if xlo <= xhi and ylo <= yhi),
             sum(1 for blo, olo, bhi, ohi in t if (blo, olo) <= (bhi, ohi)))
            for b, t in zip(boxes.tolist(), times.tolist())]
    blocks = [c.view(-1, JOIN_BLOCK) for c in cols]
    lrow = torch.arange(JOIN_BLOCK, device=cols[0].device)
    alu = total = 0
    for s in range(0, len(pair_q), 1024):
        pq, pb = pair_q[s:s + 1024].long(), pair_blk[s:s + 1024].long()
        sel = [c.index_select(0, pb) for c in blocks]
        bins, offs = sel[-2:]
        valid = (pb[:, None] * JOIN_BLOCK + lrow[None, :]) < int(true_n)
        bx, tm = boxes.index_select(0, pq), times.index_select(0, pq)
        if overlap:
            in_box, _ = overlap_masks(*sel[:4], None, None, bx, None)
        else:
            x, y = sel[:2]
            in_box = torch.zeros_like(valid)
            for k in range(bx.shape[1]):  # a dead slot holds no row
                b = bx[:, k, :, None]
                in_box |= (x >= b[:, 0]) & (x <= b[:, 1]) & (y >= b[:, 2]) & (y <= b[:, 3])
        key = bins.long() * 2**32 + offs.long()
        in_time = torch.zeros_like(valid)
        for k in range(tm.shape[1]):
            t = tm[:, k, :, None].long()
            in_time |= (key >= t[:, 0] * 2**32 + t[:, 1]) & (key <= t[:, 2] * 2**32 + t[:, 3])
        rows = valid.sum(dim=1).tolist()
        nbox = (in_box & valid).sum(dim=1).tolist()
        ntime = (in_time & valid).sum(dim=1).tolist()
        for qi, r, nb_, nt_ in zip(pq.tolist(), rows, nbox, ntime):
            lb, lt = live[qi]
            alu_p, total_p = (min(r * box_ops[i] * lb + nb_ * TIME_SLOT_OPS[i] * lt,
                                  r * TIME_SLOT_OPS[i] * lt + nt_ * box_ops[i] * lb)
                              for i in (0, 1))
            alu += alu_p
            total += total_p
    distinct = int(torch.unique(pair_blk).numel())
    nbytes = (4 * len(cols) * JOIN_BLOCK * distinct + 16 * len(pair_q)
              + 4 * (boxes.numel() + times.numel()) + pos_bytes * int(hits.sum()))
    return (alu, total), nbytes


def profile_window(label: str, fn, expect: str | None = None, kernels_in_order: bool = False,
                   all_ops: bool = False) -> None:
    """Runs ``fn`` once under ``torch.profiler`` (CPU and CUDA) and logs the
    device's busy share of the window (the union of its kernels and copies
    over the span of every recorded event), the five device ops that took
    the most time, and the longest stretch with nothing on the device; with
    ``kernels_in_order``, also every kernel's device time in launch order;
    with ``all_ops``, every device op of the window by name (kernels,
    memsets and copies, in the order each name first ran) with its count.
    Logs "not measured" where the profiler saw no device activity. With
    ``expect``, a kernel name that ``fn`` launches: a trace that holds no
    record of it is taken once more, and logged as incomplete if the
    second holds none either; a missing record is logged with where the
    recorded device events lie against the CPU events. The script keeps
    CUPTI subscribed across windows (``TEARDOWN_CUPTI=0``, set at import)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for attempt in (1, 2):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = list(prof.events())
        device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
                  and e.time_range.end > e.time_range.start]
        if expect is None or any(expect in e.name for e in device):
            break
        cpu = [e for e in events if e.device_type != torch.autograd.DeviceType.CUDA]
        if cpu and device:
            c0 = min(e.time_range.start for e in cpu)
            log(f"phase profile {label}: trace {attempt}'s {len(device)} device events lie at "
                f"{(min(e.time_range.start for e in device) - c0) / 1e3:.3f} .. "
                f"{(max(e.time_range.end for e in device) - c0) / 1e3:.3f} ms from its first "
                f"CPU event; its CPU events end at "
                f"{(max(e.time_range.end for e in cpu) - c0) / 1e3:.3f} ms")
        log(f"phase profile {label}: trace {attempt} holds no record of {expect}"
            + ("; taking it once more" if attempt == 1 else "; this window is incomplete"))
    if not device:
        log(f"phase profile {label}: device time not measured (the profiler recorded "
            f"{len(events)} events, none on the device)")
        return
    w0 = min(e.time_range.start for e in events)
    w1 = max(e.time_range.end for e in events)
    busy, gap, cursor = 0.0, 0.0, w0
    for start, end in sorted((e.time_range.start, e.time_range.end) for e in device):
        gap = max(gap, start - cursor)
        busy += max(0.0, end - max(start, cursor))
        cursor = max(cursor, end)
    gap = max(gap, w1 - cursor)
    by_name: dict[str, list] = {}
    for e in device:
        acc = by_name.setdefault(e.name, [0.0, 0])
        acc[0] += e.time_range.end - e.time_range.start
        acc[1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:5]
    log(f"phase profile {label}: window {(w1 - w0) / 1e3:.3f} ms, device busy "
        f"{busy / 1e3:.3f} ms ({busy / (w1 - w0):.6f} of the window) over {len(device)} device "
        f"ops; longest idle gap {gap / 1e3:.3f} ms; top device ops: " + "; ".join(
            f"{name[:60]} {t / 1e3:.4f} ms x{k}" for name, (t, k) in top))
    if all_ops:
        seen: dict[str, int] = {}
        for e in sorted(device, key=lambda e: e.time_range.start):
            name = e.name.replace("void ", "").replace("(anonymous namespace)::", "")
            name = name.split("(")[0].split("<")[0][:48]
            seen[name] = seen.get(name, 0) + 1
        log(f"phase profile {label}: device ops ({len(device)}): "
            + ", ".join(f"{name} x{k}" for name, k in seen.items()))
    if kernels_in_order:
        launched = sorted((e for e in device if "emcpy" not in e.name and "emset" not in e.name),
                          key=lambda e: e.time_range.start)
        log(f"phase profile {label}: kernels in launch order: " + "; ".join(
            f"{e.name.split('(')[0][-40:]} {(e.time_range.end - e.time_range.start) / 1e3:.4f} ms"
            for e in launched))


def requested_bytes() -> int:
    """Bytes the live device tensors asked for: ``memory_allocated`` less
    what the caching allocator adds when it hands a cached block out whole
    (it does when a split would leave less than 1 MiB)."""
    import torch

    return sum(b.get("requested_size", b["size"]) for s in torch.cuda.memory_snapshot()
               for b in s["blocks"] if b["state"] == "active_allocated")


def free_card() -> None:
    """Drop the previous phase's objects and cached device blocks."""
    gc.collect()
    import torch

    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def log_rebuild(rb: dict) -> None:
    log(f"phase index build: {rb['index_build']:.3f} s "
        f"({' + '.join(rb['indices'])}: normalize, stage, encode, sort, copy back)")
    for name, ph in rb["indices"].items():
        log(f"phase index build {name}: " + ", ".join(
            f"{k} {v * 1e3:.3f} ms" for k, v in ph.items()))
    log(f"phase load: {rb['load']:.3f} s (normalize + stage)")


def norm31(v, lo: float, hi: float):
    """Independent 31-bit fixed point of the device columns (int64)."""
    s = np.floor((np.asarray(v, np.float64) - lo) * (2**31 / (hi - lo)))
    return np.clip(s, 0, 2**31 - 1).astype(np.int64)


def spatial_checks(ds, type_name, lon, lat, fids, boxes_f64, want_index: str) -> list[int]:
    """``query()`` of each box with no time: planned on ``want_index``, and
    counts and fid sets equal to an f64 brute force. Returns the counts."""
    from geomesa_tpu_torch.workload import bbox_cql

    counts = []
    for i, box in enumerate(boxes_f64):
        res = ds.query(type_name, bbox_cql(box))
        if res.plan_info.index_name != want_index:
            raise AssertionError(f"box {i} planned on {res.plan_info.index_name}, "
                                 f"not {want_index}")
        x1, y1, x2, y2 = box
        rows = np.nonzero((lon >= x1) & (lon <= x2) & (lat >= y1) & (lat <= y2))[0]
        if res.count != len(rows) or set(res.table.fids.tolist()) != set(fids[rows].tolist()):
            raise AssertionError(f"spatial query {i}: {res.count} rows, brute force "
                                 f"{len(rows)}, or the fid sets differ")
        counts.append(res.count)
    return counts


def day_slabs(bins: np.ndarray, *cols):
    """Group row ids by day: (order, starts, sorted cols) with rows of day d
    at order[starts[d]:starts[d+1]] and each of ``cols`` in that order, so
    that a day range of a column is one slice."""
    order = np.argsort(bins, kind="stable")
    starts = np.searchsorted(bins[order], np.arange(bins.max() + 2))
    return order, starts, [c[order] for c in cols]


def int_referee(lon, lat, t, boxes_f64, windows_ms):
    """Loose counts by an independent numpy int-domain evaluation: 31-bit
    normalized coordinates, (day, ms-of-day) instants, DURING's exclusive
    ends taken as [lo + 1, hi - 1]."""
    norm = norm31
    xi, yi = norm(lon, -180.0, 180.0), norm(lat, -90.0, 90.0)
    day, off = t // DAY_MS, t % DAY_MS
    _, starts, by_day = day_slabs(day, xi, yi, day, off)
    out = []
    for (x1, y1, x2, y2), (lo, hi) in zip(boxes_f64, windows_ms):
        (blo, olo), (bhi, ohi) = divmod(lo + 1, DAY_MS), divmod(hi - 1, DAY_MS)
        x, y, b, o = (c[starts[blo]:starts[bhi + 1]] for c in by_day)
        m = ((x >= norm(x1, -180.0, 180.0)) & (x <= norm(x2, -180.0, 180.0))
             & (y >= norm(y1, -90.0, 90.0)) & (y <= norm(y2, -90.0, 90.0))
             & ((b > blo) | ((b == blo) & (o >= olo)))
             & ((b < bhi) | ((b == bhi) & (o <= ohi))))
        out.append(int(m.sum()))
    return out


def f64_referee(lon, lat, t, box, window, slabs):
    """Exact rows of ``BBOX AND DURING`` by f64 brute force (row ids), over
    the days the window spans; ``slabs`` from :func:`day_slabs` of the days
    of ``t``, with ``lon, lat, t`` in its day order when it carries them."""
    (x1, y1, x2, y2), (lo, hi) = box, window
    order, starts, by_day = slabs
    a, b = starts[lo // DAY_MS], starts[hi // DAY_MS + 1]
    if by_day:
        lon_d, lat_d, t_d = (c[a:b] for c in by_day)
    else:
        rows = order[a:b]
        lon_d, lat_d, t_d = lon[rows], lat[rows], t[rows]
    m = ((lon_d >= x1) & (lon_d <= x2) & (lat_d >= y1) & (lat_d <= y2)
         & (t_d > lo) & (t_d < hi))
    return order[a:b][m]


def snapped_queries(lon, lat, t, boxes_f64, windows_ms, slabs, seed: int):
    """The queries moved onto rows they match, so that the exact count's
    host re-test has work at full size: the north edge onto one matching
    row's latitude and the window's end one millisecond past its instant
    (that row is an edge candidate in both, and passes), then the west edge
    one f64 step past a second matching row's longitude inside the same
    31-bit bucket (an edge candidate that the f64 filter rejects, so each
    exact count is at least one below its int count). Returns (boxes,
    windows)."""
    rng = np.random.default_rng(seed)
    boxes, windows = [], []
    for (x1, y1, x2, y2), (lo, hi) in zip(boxes_f64, windows_ms):
        rows = f64_referee(lon, lat, t, (x1, y1, x2, y2), (lo, hi), slabs)
        s = rows[rng.integers(len(rows))]
        y2, hi = float(lat[s]), int(t[s]) + 1
        rows = f64_referee(lon, lat, t, (x1, y1, x2, y2), (lo, hi), slabs)
        west = rows[lon[rows] < lon[s]]
        nudged = np.nextafter(lon[west], np.inf)
        same = norm31(nudged, -180.0, 180.0) == norm31(lon[west], -180.0, 180.0)
        if not same.any():
            raise AssertionError("no matching row to snap the west edge onto")
        boxes.append((float(nudged[np.argmax(same)]), y1, x2, y2))
        windows.append((lo, hi))
    return boxes, windows


def p50(values) -> float:
    return float(np.percentile(values, 50))


def check_zranges(ds, type_name: str, cqls, spatial_cqls) -> None:
    """The z-range phase: records every ``zranges`` call that planning
    ``cqls`` (z3: 3-D boxes, the budget split over the day windows) and
    ``spatial_cqls`` (z2: 2-D) makes, holds each output equal to
    ``zranges_plain`` on the same arguments, and logs calls per query and
    ms per call of both (host clock)."""
    from geomesa_tpu_torch.curve import sfc
    from geomesa_tpu_torch.curve import zranges as zr
    from geomesa_tpu_torch.planning.planner import Query, QueryPlanner

    calls = []

    def recording(*args):
        t0 = time.perf_counter()
        out = zr.zranges(*args)
        calls.append((args, time.perf_counter() - t0, out))
        return out

    st = ds._state(type_name)
    planner = QueryPlanner(st.sft, st.indices)
    spans = {}
    sfc.zranges = recording  # sfc.ranges calls the name it imported
    try:
        for label, qs in (("z3", cqls), ("z2", spatial_cqls)):
            start = len(calls)
            for c in qs:
                planner.plan(Query(c))
            spans[label] = (start, len(calls), len(qs))
    finally:
        sfc.zranges = zr.zranges
    for label, (a, b, nq) in spans.items():
        if b == a:
            raise AssertionError(f"planning the {label} queries made no zranges call")
        native_s = sum(c[1] for c in calls[a:b])
        t0 = time.perf_counter()
        for args, _, out in calls[a:b]:
            want = zr.zranges_plain(*args)
            if want.dtype != out.dtype or not np.array_equal(want, out):
                raise AssertionError(f"zranges differs from zranges_plain at {args}")
        plain_s = time.perf_counter() - t0
        log(f"phase zranges {label}: {b - a} calls for {nq} queries ({(b - a) / nq:.2f} per "
            f"query), {len(calls[a][0][0])}-D at budgets "
            f"{sorted({args[3] for args, _, _ in calls[a:b]})}: native "
            f"{native_s * 1e3 / (b - a):.4f} ms per call, plain {plain_s * 1e3 / (b - a):.4f} ms "
            f"per call; {sum(len(o) for _, _, o in calls[a:b])} ranges, every output equal")


def z3_path(dev, max_err: int, n_rows: int, n_queries: int, n_exact: int,
            iters: int) -> tuple[list[dict], dict]:
    """Phase 3: the point write (z3 + z2) and bbox+time main path; returns
    the batched_count and batched_edge_gather records and the main path's
    launches."""
    import torch

    from geomesa_tpu_torch.filter.bounds import extract
    from geomesa_tpu_torch.filter.cql import parse
    from geomesa_tpu_torch.ops import kernels
    from geomesa_tpu_torch.ops.kernels import (
        EDGE_CAPACITY, batched_count, batched_count_plain, batched_edge_gather,
        batched_edge_gather_plain, chunk_query_pairs, planned_gather, planned_gather_plain)
    from geomesa_tpu_torch.parallel.query import intervals_to_block_pairs, planned_gather_step
    from geomesa_tpu_torch.parallel.residency import JOIN_BLOCK
    from geomesa_tpu_torch.planning.planner import Query, QueryPlanner
    from geomesa_tpu_torch.schema.columnar import Column, FeatureTable, point_column
    from geomesa_tpu_torch.schema.sft import AttributeType
    from geomesa_tpu_torch.store.datastore import DataStore
    from geomesa_tpu_torch.workload import (
        SPEC, bbox_cql, bbox_time_cql, make_queries, synth_gdelt)

    on_card = dev.type == "cuda"
    t0 = time.perf_counter()
    lon, lat, t = synth_gdelt(n_rows, seed=42)
    fids = np.arange(n_rows).astype("U9")
    boxes_f64, windows_ms = make_queries(n_queries, seed=7)
    cqls = [bbox_time_cql(b, w) for b, w in zip(boxes_f64, windows_ms)]
    log(f"phase synth: {time.perf_counter() - t0:.3f} s ({n_rows} rows, {n_queries} queries)")

    if on_card:
        torch.cuda.reset_peak_memory_stats()
        kernels.path_blocks("batched_count")
        kernels.path_blocks("batched_edge_gather")
    for k in kernels.launches:
        kernels.launches[k] = 0
    ds = DataStore(device=dev)
    sft = ds.create_schema("gdelt", SPEC)
    table = FeatureTable.from_columns(sft, fids, {
        "dtg": Column(AttributeType.DATE, t), "geom": point_column(lon, lat)})
    t0 = time.perf_counter()
    ds.write("gdelt", table)
    ds.compact("gdelt")
    write_s = time.perf_counter() - t0
    if on_card:
        log(f"phase write memory: memory_allocated {torch.cuda.memory_allocated()} bytes "
            f"resident after the write (two point states; {requested_bytes()} bytes "
            f"requested), max_memory_allocated {torch.cuda.max_memory_allocated()} bytes "
            f"during it")
    t0 = time.perf_counter()
    loose = ds.count_many("gdelt", cqls, loose=True)
    first_batch_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    exact = ds.count_many("gdelt", cqls, loose=False)
    first_exact_s = time.perf_counter() - t0
    fallbacks = ds.exact_fallbacks
    t0 = time.perf_counter()
    many = ds.select_many("gdelt", cqls)
    first_many_s = time.perf_counter() - t0
    selected, query_ms = [], []
    for c in cqls:
        s = time.perf_counter()
        selected.append(ds.query("gdelt", c))
        query_ms.append((time.perf_counter() - s) * 1e3)
    t0 = time.perf_counter()
    spatial = spatial_checks(ds, "gdelt", lon, lat, fids, boxes_f64[:n_exact], "z2")
    spatial_s = time.perf_counter() - t0
    launched = dict(kernels.launches)
    log(f"phase main-path launches: {launched}")
    if on_card:
        for name in ("batched_count", "batched_edge_gather"):
            log(f"phase main-path {name} row loops (blocks single-slot, general): "
                f"{kernels.path_blocks(name)}")
    if on_card and launched["batched_count"] < 1:
        raise AssertionError("count_many did not launch the batched_count kernel")
    if on_card and launched["batched_edge_gather"] < 1:
        raise AssertionError("count_many(loose=False) did not launch batched_edge_gather")
    if on_card and launched["planned_gather"] < 1:
        raise AssertionError("select_many did not launch the planned_gather kernel")
    if on_card and (launched["z3_encode"], launched["z2_encode"]) != (1, 1):
        raise AssertionError("the write did not launch z3_encode and z2_encode once each")
    log(f"phase spatial queries: {n_exact} city boxes with no time planned on z2, equal to "
        f"the f64 brute force ({spatial} rows) in {spatial_s:.3f} s with the checks")

    states = ds._state("gdelt").backend_state
    if set(states) != {"z3", "z2"}:
        raise AssertionError(f"resident states {sorted(states)}, not z3 and z2")
    for st_name, st in states.items():
        for name, col in st.cols.items():
            if col.device.type != dev.type or col.dtype != torch.int32:
                raise AssertionError(f"resident column {st_name}.{name} is {col.dtype} "
                                     f"on {col.device}")
    state = states["z3"]
    log(f"phase write: {write_s:.3f} s (write + compact of {n_rows} rows)")
    log_rebuild(ds.last_rebuild("gdelt"))
    for st_name, st in states.items():
        log(f"phase h2d staging {st_name}: {st.h2d_s:.3f} s for {st.h2d_bytes} bytes "
            f"on {st.cols['x'].device}; chunk extents {st.extents_s:.6f} s for "
            f"{st.extents.nbytes} bytes ({st.extents.shape[0]} chunks x 32 B)")

    # -- checks against the numpy referees --------------------------------------
    t0 = time.perf_counter()
    want_loose = int_referee(lon, lat, t, boxes_f64, windows_ms)
    if loose != want_loose:
        raise AssertionError(f"count_many(loose) != int referee: {loose} vs {want_loose}")
    slabs = day_slabs(t // DAY_MS, lon, lat, t)
    for i in range(n_queries):
        rows = np.sort(f64_referee(lon, lat, t, boxes_f64[i], windows_ms[i], slabs))
        if exact[i] != len(rows):
            raise AssertionError(f"count_many(exact)[{i}] = {exact[i]} != {len(rows)}")
        for how, res in (("select_many", many[i]), ("query()", selected[i])):
            if not np.array_equal(res.row_ids, rows) or res.count != len(rows):
                raise AssertionError(f"{how} row ids {i} differ from the f64 brute force")
    log(f"phase checks: ok in {time.perf_counter() - t0:.3f} s (loose counts {sum(loose)} "
        f"rows over {n_queries}; exact counts, select_many and query() row ids of all "
        f"{n_queries} equal the f64 brute force: {sum(exact)} rows; "
        f"{fallbacks} exact count(s) fell back to query())")

    # -- timings ----------------------------------------------------------------
    for what, loose_mode, first_s in (("count_many batch", True, first_batch_s),
                                      ("count_many exact batch", False, first_exact_s)):
        batch = []
        for _ in range(iters):
            s = time.perf_counter()
            ds.count_many("gdelt", cqls, loose=loose_mode)
            batch.append((time.perf_counter() - s) * 1e3)
        log(f"phase {what}: first {first_s * 1e3:.3f} ms, p50 {p50(batch):.3f} ms over "
            f"{iters} (min {min(batch):.3f}, max {max(batch):.3f}; {n_queries} queries per "
            f"batch)")
    many_ms, many_split = [], []
    for _ in range(3):
        s = time.perf_counter()
        ds.select_many("gdelt", cqls)
        many_ms.append((time.perf_counter() - s) * 1e3 / n_queries)
        many_split.append(dict(ds.last_select_many))
    plan_ms = [r.plan_info.plan_ms for r in selected]
    log(f"phase query(): p50 {p50(query_ms):.3f} ms per query over {n_queries} (mean "
        f"{np.mean(query_ms):.3f}, min {min(query_ms):.3f}, max {max(query_ms):.3f}), "
        f"plan_ms p50 {p50(plan_ms):.3f}; {sum(r.count for r in selected)} rows")
    log("phase query() split: p50 ms per query over " + f"{n_queries} (host clock): " + ", ".join(
        f"{k} {p50([r.timings[k] for r in selected]):.3f}"
        for k in ("plan_ms", "select_ms", "residual_ms", "take_ms")))
    log(f"phase select_many: p50 {p50(many_ms):.3f} ms per query over 3 calls of "
        f"{n_queries} queries (first call {first_many_s * 1e3 / n_queries:.3f} ms per query)")
    log("phase select_many split: p50 over 3 calls, ms per query (host clock): " + ", ".join(
        f"{k} {p50([sp[k] / n_queries for sp in many_split]):.3f}"
        for k in ("plan_ms", "pairs_ms", "gather_ms", "tail_ms")))
    check_zranges(ds, "gdelt", cqls, [bbox_cql(b) for b in boxes_f64[:n_exact]])

    # -- the exact correction at full size: n_exact queries snapped onto rows --
    snap_boxes, snap_windows = snapped_queries(lon, lat, t, boxes_f64[:n_exact],
                                               windows_ms[:n_exact], slabs, seed=8)
    snap_cqls = [bbox_time_cql(b, w) for b, w in zip(snap_boxes, snap_windows)]
    before = ds.exact_fallbacks
    snap_exact = ds.count_many("gdelt", snap_cqls, loose=False)
    snap_fallbacks = ds.exact_fallbacks - before
    snap_int = ds.count_many("gdelt", snap_cqls, loose=True)
    if snap_int != int_referee(lon, lat, t, snap_boxes, snap_windows):
        raise AssertionError("snapped count_many(loose) != int referee")
    for i in range(n_exact):
        want = len(f64_referee(lon, lat, t, snap_boxes[i], snap_windows[i], slabs))
        if snap_exact[i] != want or snap_int[i] - want < 1:
            raise AssertionError(f"snapped query {i}: exact {snap_exact[i]}, int "
                                 f"{snap_int[i]}, f64 brute force {want}")
    snap_payloads = [ds.backend.payload(sft, extract(parse(c), "geom", "dtg"))
                     for c in snap_cqls]
    _, _, snap_hits = batched_edge_gather(
        *state.spatial_cols(), 0, state.n,
        *(torch.from_numpy(np.stack([p[k] for p in snap_payloads])).to(dev) for k in (0, 1)))
    snap_hits = snap_hits[:, 0].cpu().numpy()
    timed = {}
    for what, batch_cqls in (("snapped", snap_cqls), ("unsnapped", cqls[:n_exact])):
        ms = []
        for _ in range(iters):
            s = time.perf_counter()
            ds.count_many("gdelt", batch_cqls, loose=False)
            ms.append((time.perf_counter() - s) * 1e3)
        timed[what] = p50(ms)
    log(f"phase exact correction: {n_exact} queries snapped onto rows, exact counts equal the "
        f"f64 brute force ({sum(snap_exact)} rows) and each is below its int count (corrections "
        f"{[a - b for a, b in zip(snap_int, snap_exact)]}); edge candidates per query "
        f"{snap_hits.tolist()}; {snap_fallbacks} fell back to query(); count_many(loose=False) "
        f"p50 {timed['snapped']:.3f} ms for the {n_exact} snapped, {timed['unsnapped']:.3f} ms "
        f"for the same {n_exact} unsnapped, over {iters} each")

    t0 = time.perf_counter()
    payloads = [ds.backend.payload(sft, extract(parse(c), "geom", "dtg")) for c in cqls]
    log(f"phase count_many host part: {(time.perf_counter() - t0) * 1e3:.3f} ms to parse, "
        f"extract and pack the {n_queries} queries' payloads (host clock, once)")
    boxes = torch.from_numpy(np.ascontiguousarray(np.stack([p[0] for p in payloads]))).to(dev)
    times = torch.from_numpy(np.ascontiguousarray(np.stack([p[1] for p in payloads]))).to(dev)
    cols = state.spatial_cols()
    q, nb, nt = boxes.shape[0], boxes.shape[1], times.shape[1]
    n = state.n
    plain = batched_count_plain(*cols, 0, n, boxes, times)
    record = {"name": "batched_count", "route": "cuda",
              "source": "geomesa_tpu_torch/csrc/batched_count.cu",
              "replaces": "geomesa_tpu/ops/pallas_kernels.py:150",
              "launches": launched["batched_count"], "library_ms": None}
    edge_record = {"name": "batched_edge_gather", "route": "cuda",
                   "source": "geomesa_tpu_torch/csrc/batched_edge_gather.cu",
                   "replaces": "geomesa_tpu/parallel/query.py:342",
                   "launches": launched["batched_edge_gather"], "library_ms": None}
    gather_record = {"name": "planned_gather", "route": "cuda",
                     "source": "geomesa_tpu_torch/csrc/planned_gather.cu",
                     "replaces": "geomesa_tpu/parallel/query.py:820",
                     "launches": launched["planned_gather"], "library_ms": None}
    if on_card:
        got = batched_count(*cols, 0, n, boxes, times)
        torch.cuda.synchronize()
        err = int((got.long() - plain.long()).abs().max())
        if err != 0:
            raise AssertionError("batched_count disagrees with plain at the main-path shape")
        max_err = max(max_err, err)
        kernel_ms = cuda_ms(lambda: batched_count(*cols, 0, n, boxes, times), 5)
        plain_ms = cuda_ms(lambda: batched_count_plain(*cols, 0, n, boxes, times), 1)
        ops, in_box, in_time, matches = predicate_floor_ops(
            cols[0][:n], cols[1][:n], cols[2][:n], cols[3][:n], boxes, times)
        if matches != int(plain.long().sum()):
            raise AssertionError("live-slot count of the bound disagrees with the plain version")
        nbytes = 16 * n + 4 * boxes.numel() + 4 * times.numel() + 4 * q
        record.update(max_abs_err=max_err, ms=kernel_ms, plain_ms=plain_ms,
                      **bound_fields(ops, nbytes))
        log(f"phase kernel timing: {kernel_ms:.4f} ms at N={n} Q={q} B={nb} T={nt}; "
            f"plain {plain_ms:.4f} ms; bound {record['bound_ms']:.4f} ms "
            f"({record['bound_by']}: {ops[0]} ALU-only of {ops[1]} int32 ops; {in_box} "
            f"in-box and {in_time} "
            f"in-time row-queries; {nbytes} bytes)")

        # the edge gather kernel alone, at the exact batch's shape
        args = (*cols, 0, n, boxes, times)
        got_c, got_p, got_h = batched_edge_gather(*args)
        want_c, want_p, want_h = batched_edge_gather_plain(*args)
        torch.cuda.synchronize()
        fits = (got_h[:, 0] <= EDGE_CAPACITY)[:, None]
        edge_err = max(int((got_c.long() - want_c.long()).abs().max()),
                       int((got_c.long() - plain.long()).abs().max()),
                       int((got_h.long() - want_h.long()).abs().max()),
                       int(((got_p.long() - want_p.long()) * fits[:, :, None]).abs().max()))
        if edge_err != 0:
            raise AssertionError("batched_edge_gather disagrees with plain at the main-path shape")
        edge_ms = cuda_ms(lambda: batched_edge_gather(*args), 5)
        edge_plain_ms = cuda_ms(lambda: batched_edge_gather_plain(*args), 1)
        kept = chunk_query_pairs(*args)
        true_rows = (cols[0][:n], cols[1][:n], cols[2][:n], cols[3][:n])
        e_ops, e_bytes, e_matches = edge_floor(*true_rows, boxes, times, want_c, want_h,
                                               EDGE_CAPACITY, chunks=kept,
                                               loaded_rows=cols[0].shape[0])
        f_ops, f_bytes, f_matches = edge_floor(*true_rows, boxes, times, want_c, want_h,
                                               EDGE_CAPACITY)
        if e_matches != int(want_c.long().sum()) or f_matches != e_matches:
            raise AssertionError("the edge bound's live-slot count over the kept chunks "
                                 "disagrees with the plain version")
        edge_record.update(max_abs_err=edge_err, ms=edge_ms, plain_ms=edge_plain_ms,
                           **bound_fields(e_ops, e_bytes))
        full = bound_fields(f_ops, f_bytes)
        share = edge_record["bound_ms"] / edge_ms
        h = got_h[:, 0].cpu().numpy()
        log(f"phase edge gather timing: {edge_ms:.4f} ms at N={n} Q={q} B={nb} T={nt}; "
            f"plain {edge_plain_ms:.4f} ms; bound {edge_record['bound_ms']:.4f} ms "
            f"({edge_record['bound_by']}: {e_ops[0]} ALU-only of {e_ops[1]} int32 ops over "
            f"{int(kept.sum())} kept of {kept.numel()} (chunk, query) pairs, "
            f"{float(kept.float().mean()):.6f}; {e_bytes} bytes), {share:.4f} of it; the "
            f"full-scan bound {full['bound_ms']:.4f} ms ({full['bound_by']}: {f_ops[0]} "
            f"ALU-only of {f_ops[1]} int32 ops); edge candidates per query max "
            f"{int(h.max())}, total {int(h.sum())}, {int((h > EDGE_CAPACITY).sum())} over "
            f"{EDGE_CAPACITY} lanes")
        if share > 1:
            raise AssertionError(f"batched_edge_gather reads {share:.4f} of its bound: the "
                                 "bound's count is wrong")

        # the planned gather of select_many alone (all 64 plan on z3)
        planner = QueryPlanner(sft, ds._state("gdelt").indices)
        plans = [planner.plan(Query(c)) for c in cqls]
        if {info.scan_index for _, _, info in plans} != {"z3"}:
            raise AssertionError("the bbox+time queries must plan on z3")
        pair_q, pair_blk = intervals_to_block_pairs([pl.intervals for pl, _, _ in plans],
                                                    JOIN_BLOCK)
        pq = torch.from_numpy(pair_q.astype(np.int32)).to(dev)
        pb = torch.from_numpy(pair_blk.astype(np.int32)).to(dev)
        gargs = (*cols, n, pq, pb, boxes, times)
        # the block-major plan as planned_gather_step uploads it with the pair lists
        gplan = torch.from_numpy(np.concatenate(kernels.block_runs(pair_q, pair_blk))).to(dev)
        got_p, got_h = planned_gather(*gargs, plan=gplan)
        want_p, want_h = planned_gather_plain(*gargs)
        torch.cuda.synchronize()
        if not (torch.equal(got_p, want_p) and torch.equal(got_h, want_h)):
            raise AssertionError("planned_gather disagrees with plain at the main-path pairs")
        gather_ms = cuda_ms(lambda: planned_gather(*gargs, plan=gplan), 5)
        gather_plain_ms = cuda_ms(lambda: planned_gather_plain(*gargs), 1)
        step_ms = cuda_ms(lambda: planned_gather_step(cols, n, pair_q, pair_blk, boxes, times),
                          3)
        g_ops, g_bytes = gather_floor(cols, n, pq, pb, boxes, times, want_h,
                                      got_p.element_size())
        gather_record.update(max_abs_err=0, ms=gather_ms, plain_ms=gather_plain_ms,
                             **bound_fields(g_ops, g_bytes))
        g_share = gather_record["bound_ms"] / gather_ms
        gathered = len(pair_q) * JOIN_BLOCK
        runs = np.unique(pair_blk, return_counts=True)[1]
        log(f"phase planned gather: {gather_ms:.4f} ms (CUDA events, 5 calls of planned_gather: "
            f"count pass over the distinct blocks, cumsum, one read of the total, write pass "
            f"over the masks) for {len(pair_q)} (query, block) pairs of {JOIN_BLOCK} rows over "
            f"{len(runs)} distinct blocks (each read once: {len(runs) * JOIN_BLOCK * 16} bytes "
            f"of columns; pairs per block p50 {p50(runs):.1f}, max {int(runs.max())}): "
            f"{gathered} gathered rows, {gathered / (n * q):.6f} of N x Q, "
            f"{int(want_h.sum())} rows out; plain {gather_plain_ms:.4f} ms; bound "
            f"{gather_record['bound_ms']:.4f} ms ({gather_record['bound_by']}: {g_ops[0]} "
            f"ALU-only of {g_ops[1]} int32 ops; {g_bytes} bytes), {g_share:.4f} of it; "
            f"planned_gather_step with the pair lists' upload {step_ms:.4f} ms; "
            f"batched_count's full scan {kernel_ms:.4f} ms")
        if g_share > 1:
            raise AssertionError(f"planned_gather reads {g_share:.4f} of its bound: the "
                                 "bound's count is wrong")
        profile_window("select_many", lambda: ds.select_many("gdelt", cqls),
                       "planned_count_kernel")
        profile_window("count_many exact batch",
                       lambda: ds.count_many("gdelt", cqls, loose=False), "batched_edge_gather")
        log(f"phase memory: max_memory_allocated {torch.cuda.max_memory_allocated()} bytes "
            f"over the whole phase")
    return [record, edge_record, gather_record], launched


def dateless_path(dev, n_rows: int, n_queries: int, n_exact: int) -> dict:
    """Phase 5: a date-less point schema (z2 only) at config 2's 50M points
    and config 1's query shape (city boxes, no time); returns its launches."""
    import torch

    from geomesa_tpu_torch.filter.bounds import extract
    from geomesa_tpu_torch.filter.cql import parse
    from geomesa_tpu_torch.ops import kernels
    from geomesa_tpu_torch.ops.kernels import batched_edge_gather
    from geomesa_tpu_torch.schema.columnar import FeatureTable, point_column
    from geomesa_tpu_torch.store.datastore import DataStore
    from geomesa_tpu_torch.workload import bbox_cql, make_queries, synth_gdelt

    on_card = dev.type == "cuda"
    t0 = time.perf_counter()
    lon, lat, _ = synth_gdelt(n_rows, seed=42)
    fids = np.arange(n_rows).astype("U9")
    boxes_f64, _ = make_queries(n_queries, seed=7)
    cqls = [bbox_cql(b) for b in boxes_f64]
    log(f"phase 5 synth: {time.perf_counter() - t0:.3f} s ({n_rows} rows, {n_queries} boxes)")

    if on_card:
        torch.cuda.reset_peak_memory_stats()
    for k in kernels.launches:
        kernels.launches[k] = 0
    ds = DataStore(device=dev)
    sft = ds.create_schema("points", "*geom:Point:srid=4326")
    table = FeatureTable.from_columns(sft, fids, {"geom": point_column(lon, lat)})
    t0 = time.perf_counter()
    ds.write("points", table)
    ds.compact("points")
    write_s = time.perf_counter() - t0
    if on_card:
        log(f"phase 5 write memory: memory_allocated {torch.cuda.memory_allocated()} bytes "
            f"resident after the write (one z2 state; {requested_bytes()} bytes requested), "
            f"max_memory_allocated {torch.cuda.max_memory_allocated()} bytes during it")
    t0 = time.perf_counter()
    loose = ds.count_many("points", cqls, loose=True)
    loose_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    exact = ds.count_many("points", cqls[:n_exact], loose=False)
    exact_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    spatial = spatial_checks(ds, "points", lon, lat, fids, boxes_f64[:n_exact], "z2")
    spatial_s = time.perf_counter() - t0
    launched = dict(kernels.launches)
    log(f"phase 5 launches: {launched}")
    if on_card and (launched["z2_encode"], launched["z3_encode"]) != (1, 0):
        raise AssertionError("the date-less write did not launch z2_encode exactly once")
    if on_card and launched["batched_count"] < 1:
        raise AssertionError("count_many did not launch the batched_count kernel")
    if on_card and launched["batched_edge_gather"] < 1:
        raise AssertionError("count_many(loose=False) did not launch batched_edge_gather")
    if ds.exact_fallbacks:
        raise AssertionError(f"{ds.exact_fallbacks} date-less exact counts fell back to query()")
    states = ds._state("points").backend_state
    if set(states) != {"z2"} or bool(states["z2"].cols["bins"].any()):
        raise AssertionError("the date-less store must hold one z2 state with zero bins")
    log(f"phase 5 write: {write_s:.3f} s (write + compact of {n_rows} rows)")
    log_rebuild(ds.last_rebuild("points"))

    t0 = time.perf_counter()
    xi, yi = norm31(lon, -180.0, 180.0), norm31(lat, -90.0, 90.0)
    want_loose = []
    for x1, y1, x2, y2 in boxes_f64:
        want_loose.append(int(((xi >= norm31(x1, -180.0, 180.0)) & (xi <= norm31(x2, -180.0, 180.0))
                               & (yi >= norm31(y1, -90.0, 90.0))
                               & (yi <= norm31(y2, -90.0, 90.0))).sum()))
    if loose != want_loose:
        raise AssertionError(f"date-less count_many(loose) != int referee: {loose} vs {want_loose}")
    if exact != spatial:
        raise AssertionError(f"date-less count_many(exact) {exact} != query() {spatial}")
    # the unconstrained window's endpoints, (0, -1) and (2^31 - 1, 2^31 - 1),
    # match no row of bins = offs = 0: every candidate is a box edge's
    payloads = [ds.backend.payload(sft, extract(parse(c), "geom", None)) for c in cqls[:n_exact]]
    windows = np.concatenate([p[1] for p in payloads])
    windows = windows[[(b0, o0) <= (b1, o1) for b0, o0, b1, o1 in windows.tolist()]]
    z2 = states["z2"]
    bins, offs = z2.cols["bins"][: z2.n], z2.cols["offs"][: z2.n]
    time_edges = sum(int(((bins == b) & (offs == o)).sum())
                     for b0, o0, b1, o1 in windows.tolist() for b, o in ((b0, o0), (b1, o1)))
    _, _, hits = batched_edge_gather(
        *z2.spatial_cols(), 0, z2.n,
        *(torch.from_numpy(np.ascontiguousarray(np.stack([p[k] for p in payloads]))).to(dev)
          for k in (0, 1)))
    if time_edges:
        raise AssertionError(f"{time_edges} date-less rows sit at a window endpoint")
    log(f"phase 5 checks: ok in {time.perf_counter() - t0:.3f} s (loose counts {sum(loose)} "
        f"rows over {n_queries} boxes in {loose_s * 1e3:.3f} ms, first call; exact {exact} in "
        f"{exact_s * 1e3:.3f} ms, first call, with {int(hits.sum())} edge candidates, "
        f"{time_edges} of them at a window endpoint; query() and its f64 checks "
        f"{spatial_s:.3f} s)")
    if on_card:
        log(f"phase 5 memory: max_memory_allocated {torch.cuda.max_memory_allocated()} bytes")
    return launched


def agg_referee(rows, gid, vals, n_groups: int):
    """The f64 numpy fold of one query's matching ``rows`` (row ids): group
    keys in first-occurrence row order, counts, value counts, sums, min and
    max per group, in that order; a group whose values are all NaN (null)
    has NaN min and max, as ``aggregate_many`` answers."""
    rows = np.sort(rows)
    g, v = gid[rows], vals[rows]
    keys, first = np.unique(g, return_index=True)
    keys = keys[np.argsort(first, kind="stable")]
    ok = ~np.isnan(v)
    vmin = np.full(n_groups, np.inf)
    vmax = np.full(n_groups, -np.inf)
    np.minimum.at(vmin, g[ok], v[ok])
    np.maximum.at(vmax, g[ok], v[ok])
    vcnt = np.bincount(g[ok], minlength=n_groups)[keys]
    empty = vcnt == 0
    return (keys, np.bincount(g, minlength=n_groups)[keys], vcnt,
            np.bincount(g[ok], weights=v[ok], minlength=n_groups)[keys],
            np.where(empty, np.nan, vmin[keys]), np.where(empty, np.nan, vmax[keys]))


def check_agg_answer(res, want, label: str) -> None:
    """One ``aggregate_many`` answer against :func:`agg_referee`'s fold."""
    keys, cnt, vcnt, vsum, vmin, vmax = want
    if res is None:
        raise AssertionError(f"aggregate_many {label}: the device path declined it")
    col = res["cols"]["val"]
    if [int(k[0]) for k in res["groups"]] != keys.tolist():
        raise AssertionError(f"aggregate_many {label}: groups or their order differ")
    for name, got, w in (("count", res["count"], cnt), ("value count", col["count"], vcnt),
                         ("min", col["min"], vmin), ("max", col["max"], vmax)):
        if not np.array_equal(got, w, equal_nan=True):
            raise AssertionError(f"aggregate_many {label}: {name} differs from the f64 fold")
    err = np.abs(col["sum"] - vsum)
    if not (err <= AGG_RTOL * np.abs(vsum)).all():
        raise AssertionError(f"aggregate_many {label}: sums differ by up to {err.max()}")


def check_grouped_kernel(dev, args: tuple, label: str, extents=None,
                         overlap: bool = False) -> tuple[int, float]:
    """``grouped_agg`` (given the columns' ``extents``, as the store gives
    them) against ``grouped_agg_plain`` on the card, or with ``overlap``
    ``grouped_agg_overlap`` against ``grouped_agg_overlap_plain``: integer
    outputs, min and max exact, lanes exact where they hold every boundary
    row and a subset of them where they overflow, sums within a relative
    1e-12; logs the fold's mode. Returns (max |difference| of the exact
    outputs, the sums' largest relative difference)."""
    import torch

    from geomesa_tpu_torch.ops import kernels

    grouped_agg = kernels.grouped_agg_overlap if overlap else kernels.grouped_agg
    grouped_agg_plain = (kernels.grouped_agg_overlap_plain if overlap
                         else kernels.grouped_agg_plain)

    def worst(t) -> float:
        return float(t.abs().max()) if t.numel() else 0.0

    from geomesa_tpu_torch.ops.kernels import grouped_agg_last_work

    got = grouped_agg(*args, extents=extents)
    want = grouped_agg_plain(*args)
    torch.cuda.synchronize()
    work = grouped_agg_last_work()
    err = 0
    for i in (0, 1, 2, 7):
        err = max(err, int(worst(got[i].long() - want[i].long())))
    for i in (4, 5):
        err = max(err, int((got[i] != want[i]).sum()))
    rel = worst((got[3] - want[3]) / want[3].abs().clamp(min=1e-300))
    hits = want[7][:, 0]
    fits = hits <= args[-1]
    err = max(err, int(worst(got[6][fits].long() - want[6][fits].long())))
    if (~fits).any():  # every lane of an overflowed query is one of its boundary rows
        full = grouped_agg_plain(*args[:-1], int(hits.max()))[6][:, 0].cpu().numpy()
        lanes = got[6][:, 0].cpu().numpy()
        for k in np.nonzero((~fits).cpu().numpy())[0]:
            cand = full[k, : int(hits[k])]
            if (lanes[k] < 0).any() or len(np.unique(lanes[k])) != len(lanes[k]) \
                    or not np.isin(lanes[k], cand).all():
                err = max(err, 1)
    log(f"  grouped_agg {label} ({work['mode']} mode, {work['runs']} runs of up to "
        f"{work['run_len']} chunks over {work['pairs']} kept (chunk, query) pairs): "
        f"max_abs_err={err}, sums' max relative difference {rel:.3e} "
        f"({int(want[0].long().sum())} folded rows, boundary rows per query max "
        f"{int(hits.max())}, total {int(hits.sum())}, {int((~fits).sum())} queries over "
        f"{args[-1]} lanes)")
    if err or not rel <= AGG_RTOL:
        raise AssertionError(f"grouped_agg disagrees with plain at {label}")
    return err, rel


def agg_floor(cols, n: int, loaded: int, boxes, times, n_vals: int, cnt, vcnt, hits,
              capacity: int, n_groups: int):
    """The least work of ``grouped_agg`` on these inputs: operations are the
    edge gather's (:func:`edge_floor`) over the (chunk, query) pairs its
    cull keeps; bytes are the four columns of every loaded row read once
    (16 B a row), ``gid``, ``rowid`` and the ``n_vals`` values of each row
    that folds in some query read once (8 + 8 V B), the payload read once and
    the outputs written once. Returns ((alu, all), bytes, distinct folded
    rows, atomics): 2 + 4 V per folded (row, query) and non-NaN value."""
    import torch

    from geomesa_tpu_torch.ops import kernels

    true_rows = tuple(c[:n] for c in cols)
    args = (*cols, 0, n, boxes, times)
    kept = kernels.chunk_query_pairs(*args)
    counts = cnt.long().sum(dim=1) + hits[:, 0].long()
    ops, _, _ = edge_floor(*true_rows, boxes, times, counts, hits, capacity, chunks=kept,
                           loaded_rows=loaded)
    folded = torch.zeros(cols[0].shape[0], dtype=torch.bool, device=cols[0].device)
    for s, e, m, edge in kernels._plain_masks(*args, 1 << 20, edges=True):
        folded[s:e] |= (m & ~edge).any(dim=0)
    distinct = int(folded.sum())
    q = boxes.shape[0]
    out_bytes = q * n_groups * 8 + q * n_vals * n_groups * 28 + q * capacity * 4 + q * 4
    nbytes = (16 * loaded + distinct * (8 + 8 * n_vals)
              + 4 * (boxes.numel() + times.numel()) + out_bytes)
    atomics = 2 * int(cnt.long().sum()) + 4 * int(vcnt.long().sum())
    return ops, nbytes, distinct, atomics


AGG_WIDE_GROUPS = 8192  # G x V above the shared-memory fold's budget: the global mode


def work_list_floor(extents, boxes, times, kept, runs: int):
    """The least work of ``agg_work_list``: per chunk and query with a live
    box and window, the extent test of the live slots (4 compares a box, 2 a
    window, until the first hit at best: counted as one of each); bytes are
    the extents (32 B a chunk) and the payload read once, and the lists (4 B
    a kept pair), counts and runs (12 B a run) written once. Returns
    ((alu, all), bytes)."""
    active = sum(1 for b, t in zip(boxes.tolist(), times.tolist())
                 if any(xlo <= xhi and ylo <= yhi for xlo, xhi, ylo, yhi in b)
                 and any((blo, olo) <= (bhi, ohi) for blo, olo, bhi, ohi in t))
    ops = active * extents.shape[0] * (4 + 2)
    nbytes = (extents.nbytes + 4 * (boxes.numel() + times.numel()) + 4 * int(kept.sum())
              + 4 * kept.numel() + 12 * runs)
    return (ops, ops), nbytes


@contextlib.contextmanager
def pyramid_switch(value: str):
    """``GEOMESA_TPU_PYRAMID`` set to ``value`` for the block, restored
    after."""
    from geomesa_tpu_torch.ops.geoblocks import PYRAMID_ENV

    before = os.environ.get(PYRAMID_ENV)
    os.environ[PYRAMID_ENV] = value
    try:
        yield
    finally:
        if before is None:
            del os.environ[PYRAMID_ENV]
        else:
            os.environ[PYRAMID_ENV] = before


def agg_path(dev, n_rows: int, n_queries: int) -> tuple[dict, dict, tuple]:
    """Phase 6: bench config 9 at full size, on the fused path (the default
    route, the query cache emptied before each call); returns the
    grouped_agg and agg_work_list records and phase 6b's inputs (the rows'
    lon, lat, time, group ids and values)."""
    import torch

    from geomesa_tpu_torch.ops import kernels
    from geomesa_tpu_torch.ops.geoblocks import DEFAULT_PYRAMID_BYTES, base_bytes, base_over_cap
    from geomesa_tpu_torch.ops.kernels import EDGE_CAPACITY, grouped_agg
    from geomesa_tpu_torch.planning.planner import Query
    from geomesa_tpu_torch.schema.columnar import Column, FeatureTable, point_column
    from geomesa_tpu_torch.schema.sft import AttributeType
    from geomesa_tpu_torch.store.datastore import DataStore
    from geomesa_tpu_torch.workload import (
        AGG_SPEC, bbox_time_cql, grid_columns, grid_payload, grouped_columns, make_queries,
        synth_gdelt)

    on_card = dev.type == "cuda"
    t0 = time.perf_counter()
    lon, lat, t = synth_gdelt(n_rows, seed=42)
    gid, vals = grouped_columns(n_rows, AGG_GROUPS)
    sets = {seed: make_queries(n_queries, seed=seed) for seed in AGG_SEEDS}
    cqls = {seed: [bbox_time_cql(b, w) for b, w in zip(*q)] for seed, q in sets.items()}
    log(f"phase 6 synth: {time.perf_counter() - t0:.3f} s ({n_rows} rows, {AGG_GROUPS} groups, "
        f"{n_queries} queries of each seed {AGG_SEEDS})")

    if on_card:
        torch.cuda.reset_peak_memory_stats()
    for k in kernels.launches:
        kernels.launches[k] = 0
    ds = DataStore(device=dev)
    sft = ds.create_schema("gagg", AGG_SPEC)
    table = FeatureTable.from_columns(sft, np.arange(n_rows).astype("U9"), {
        "cat": Column(AttributeType.INT, gid.copy()), "val": Column(AttributeType.DOUBLE, vals),
        "dtg": Column(AttributeType.DATE, t), "geom": point_column(lon, lat)})
    t0 = time.perf_counter()
    ds.write("gagg", table)
    ds.compact("gagg")
    write_s = time.perf_counter() - t0
    answers, timed = {}, {}
    for seed in AGG_SEEDS:
        ds.agg_cache.invalidate("gagg")  # each call below folds on the card, none is a hit
        s = time.perf_counter()
        answers[seed] = ds.aggregate_many("gagg", cqls[seed], group_by=["cat"],
                                          value_cols=["val"])
        first_ms = (time.perf_counter() - s) * 1e3
        if ds.last_aggregate_many["fused"] != n_queries:
            raise AssertionError(f"the default route's queries by tier: "
                                 f"{ds.last_aggregate_many}")
        ms = []
        for _ in range(5):
            ds.agg_cache.invalidate("gagg")
            s = time.perf_counter()
            ds.aggregate_many("gagg", cqls[seed], group_by=["cat"], value_cols=["val"])
            ms.append((time.perf_counter() - s) * 1e3)
        timed[seed] = (first_ms, ms)
    launched = dict(kernels.launches)
    log(f"phase 6 launches: {launched}")
    if on_card and launched["grouped_agg"] != 6 * len(AGG_SEEDS):
        raise AssertionError("each aggregate_many call must launch grouped_agg once")
    if on_card and launched["agg_work_list"] != launched["grouped_agg"]:
        raise AssertionError("each grouped_agg launch must follow one agg_work_list launch")
    if on_card and (launched["z3_encode"], launched["z2_encode"]) != (1, 1):
        raise AssertionError("the write did not launch z3_encode and z2_encode once each")
    log(f"phase 6 write: {write_s:.3f} s (write + compact of {n_rows} rows)")
    log_rebuild(ds.last_rebuild("gagg"))
    # the pyramid switched on: at 50M rows its byte cap refuses before any
    # input is prepared, and the fused path answers
    seed = AGG_SEEDS[-1]
    over = base_over_cap(n_rows, 1)
    with pyramid_switch("1"):
        ds.agg_cache.invalidate("gagg")
        s = time.perf_counter()
        forced = ds.aggregate_many("gagg", cqls[seed], group_by=["cat"], value_cols=["val"])
        forced_ms = (time.perf_counter() - s) * 1e3
    tally = ds.last_aggregate_many
    remembered = list(ds._state("gagg").pyramids.values())
    if over and ((tally["pyramid"], tally["fused"]) != (0, n_queries)
                 or remembered != [(None, ds._state("gagg").epoch)]):
        raise AssertionError(f"the pyramid switched on at {n_rows} rows: {tally}")
    if not over and tally["pyramid"] != n_queries:
        raise AssertionError(f"the pyramid switched on at {n_rows} rows: {tally}")
    for i, (a, b) in enumerate(zip(forced, answers[seed])):
        check_agg_answer(a, as_fold(b), f"phase 6 query {i} with the pyramid switched on")
    verdict = "refused by its byte cap" if over else "served by the pyramid, under its byte cap"
    log(f"phase 6 pyramid switched on: {verdict} at {n_rows} rows (their O(N) "
        f"share alone {base_bytes(n_rows, 1)} bytes of a {DEFAULT_PYRAMID_BYTES}-byte cap); "
        f"the call {forced_ms:.3f} ms, the fused p50 {p50(timed[seed][1]):.3f} ms for the same "
        f"{n_queries} queries of seed {seed}; answers equal the default route's")
    for seed in AGG_SEEDS:
        first_ms, ms = timed[seed]
        declined = sum(a is None for a in answers[seed])
        staged = " (the group-id, row-id and value staging included)" if seed == AGG_SEEDS[0] \
            else ""
        log(f"phase 6 aggregate_many seed {seed}: first call {first_ms:.3f} ms{staged}, p50 "
            f"{p50(ms):.3f} ms over 5 (min "
            f"{min(ms):.3f}, max {max(ms):.3f}) for {n_queries} queries, "
            f"{p50(ms) / n_queries:.3f} ms per query; {declined} lanes None; "
            f"{sum(int(a['count'].sum()) for a in answers[seed] if a)} rows in "
            f"{sum(len(a['groups']) for a in answers[seed] if a)} groups")
        if declined:
            raise AssertionError(f"aggregate_many seed {seed}: {declined} lanes declined")

    # -- the f64 fold over the original columns --------------------------------
    t0 = time.perf_counter()
    slabs = day_slabs(t // DAY_MS, lon, lat, t)
    for seed in AGG_SEEDS:
        checked = range(min(AGG_CHECKED[seed], n_queries))
        for i in checked:
            box, window = sets[seed][0][i], sets[seed][1][i]
            want = agg_referee(f64_referee(lon, lat, t, box, window, slabs), gid, vals,
                               AGG_GROUPS)
            check_agg_answer(answers[seed][i], want, f"seed {seed} query {i}")
        log(f"phase 6 checks seed {seed}: queries {checked.start}..{checked.stop - 1} equal the "
            f"f64 numpy fold (groups in order; counts, value counts, min, max exact; sums "
            f"within {AGG_RTOL})")
    log(f"phase 6 checks: ok in {time.perf_counter() - t0:.3f} s")

    record = {"name": "grouped_agg", "route": "cuda",
              "source": "geomesa_tpu_torch/csrc/grouped_agg.cu",
              "replaces": "geomesa_tpu/parallel/query.py:1498",
              "launches": launched["grouped_agg"], "library_ms": None}
    wl_record = {"name": "agg_work_list", "route": "cuda",
                 "source": "geomesa_tpu_torch/csrc/grouped_agg.cu",
                 "replaces": "geomesa_tpu/parallel/query.py:1498",
                 "launches": launched["agg_work_list"], "library_ms": None}
    st = ds._state("gagg")
    state, name = st.backend_state["z3"], "z3"
    (dgid, _, keys), drowid, dvals, _ = ds._agg_residency(state, st.table, st.indices[name].perm,
                                                         ["cat"], ["val"])
    g_pad = 1 << max(0, (len(keys) - 1).bit_length())
    pend = ds._batch_payloads(st, [Query(c) for c in cqls[AGG_SEEDS[0]]])
    boxes = torch.from_numpy(np.stack([p[0] for _, p, _ in pend])).to(dev)
    times = torch.from_numpy(np.stack([p[1] for _, p, _ in pend])).to(dev)
    cols = state.spatial_cols()
    main_args = (*cols, dgid, drowid, dvals, 0, state.n, boxes, times, g_pad, EDGE_CAPACITY)
    ext = state.extents
    if on_card:
        nb, nt = boxes.shape[1], times.shape[1]
        mode = kernels.grouped_agg_mode(nb, nt, 1, g_pad)
        record["mode"] = mode
        err, rel = check_grouped_kernel(dev, main_args, f"config 9 N={state.n} Q={n_queries}",
                                        ext)
        # the work list alone, against its plain version
        target = kernels.grouped_agg_target_runs(nb, nt, 1, g_pad, dev)
        wl_args = (ext, cols[0].shape[0], 0, state.n, boxes, times, target)
        got_wl = kernels.agg_work_list(*wl_args)
        want_wl = kernels.agg_work_list_plain(*wl_args)
        torch.cuda.synchronize()
        if not all(torch.equal(g, w) for g, w in zip(got_wl, want_wl)):
            raise AssertionError("agg_work_list disagrees with its plain version at config 9")
        wl_ms = cuda_ms(lambda: kernels.agg_work_list(*wl_args), 5)
        wl_dev = device_ms(lambda: kernels.agg_work_list(*wl_args))
        wl_plain_ms = cuda_ms(lambda: kernels.agg_work_list_plain(*wl_args), 1)
        floor_ms = kernels.launch_floor_ms(dev)
        n_runs = int(want_wl[3][kernels.W_RUNS])
        wl_ops, wl_bytes = work_list_floor(ext, boxes, times, want_wl[1], n_runs)
        wl_record.update(max_abs_err=0, ms=wl_ms, device_ms=wl_dev, plain_ms=wl_plain_ms,
                         launch_floor_ms=floor_ms, **bound_fields(wl_ops, wl_bytes))
        log(f"phase agg_work_list timing: {wl_ms:.4f} ms (CUDA events, 5 launches), device "
            f"{fmt_ms(wl_dev)} (10 calls behind a spin) over {ext.shape[0]} chunks x "
            f"{n_queries} queries: {int(want_wl[1].sum())} kept pairs in {n_runs} runs of up to "
            f"{int(want_wl[3][kernels.W_RUN_LEN])} chunks (target {target}); equal to plain "
            f"({wl_plain_ms:.4f} ms); bound {wl_record['bound_ms']:.6f} ms "
            f"({wl_record['bound_by']}: {wl_ops[0]} ops; {wl_bytes} bytes), "
            f"{wl_record['bound_ms'] / wl_ms:.4f} of it; launch floor {floor_ms:.4f} ms (one "
            f"empty kernel's launch through the same ctypes path, CUDA events over 20)")
        rng = np.random.default_rng(23)
        grid = [torch.from_numpy(c).to(dev) for c in grid_columns(1_000_003, seed=23)]
        gb, gt = (torch.from_numpy(a).to(dev)
                  for a in grid_payload([c.cpu().numpy() for c in grid], 64, 8, 16, seed=24))
        ggid = torch.from_numpy(rng.integers(0, AGG_GROUPS, 1_000_003).astype(np.int32)).to(dev)
        grow = torch.randperm(1_000_003, generator=torch.Generator().manual_seed(5)).int().to(dev)
        gv = rng.normal(50.0, 20.0, (2, 1_000_003))
        gv[rng.random(gv.shape) < 0.1] = np.nan
        gv = torch.from_numpy(gv).to(dev)
        e2, r2 = check_grouped_kernel(dev, (*grid, ggid, grow, gv, 0, 1_000_003, gb, gt,
                                            AGG_GROUPS, EDGE_CAPACITY), "grid N=1000003 Q=64 V=2")
        # the second mode: config 9's rows and payloads with group ids over a G
        # whose partials do not fit a block's shared memory
        wide_gid = torch.from_numpy(np.random.default_rng(29).integers(
            0, AGG_WIDE_GROUPS, cols[0].shape[0]).astype(np.int32)).to(dev)
        wide_args = (*cols, wide_gid, drowid, dvals, 0, state.n, boxes, times,
                     AGG_WIDE_GROUPS, EDGE_CAPACITY)
        wide_mode = kernels.grouped_agg_mode(nb, nt, 1, AGG_WIDE_GROUPS)
        if wide_mode != "global":
            raise AssertionError(f"G={AGG_WIDE_GROUPS} V=1 must take the global mode")
        e3, r3 = check_grouped_kernel(dev, wide_args, f"config 9 N={state.n} Q={n_queries} "
                                      f"G={AGG_WIDE_GROUPS}", ext)
        wide_ms = cuda_ms(lambda: grouped_agg(*wide_args, extents=ext), 3)
        kernel_ms = cuda_ms(lambda: grouped_agg(*main_args, extents=ext), 5)
        plain_ms = cuda_ms(lambda: kernels.grouped_agg_plain(*main_args), 1)
        # the same culled scan without the fold: what the fold adds
        scan_ms = cuda_ms(lambda: kernels.batched_edge_gather(*cols, 0, state.n, boxes, times),
                          5)
        out = grouped_agg(*main_args, extents=ext)
        torch.cuda.synchronize()
        work = kernels.grouped_agg_last_work()
        ops, nbytes, distinct, atomics = agg_floor(
            cols, state.n, cols[0].shape[0], boxes, times, 1, out[0], out[2], out[7],
            EDGE_CAPACITY, g_pad)
        record.update(max_abs_err=max(err, e2, e3), ms=kernel_ms, plain_ms=plain_ms,
                      **bound_fields(ops, nbytes))
        attrs = {m: kernels.grouped_agg_attrs(m) for m in ("shared", "global")}
        share = record["bound_ms"] / kernel_ms
        hits = out[7][:, 0].cpu().numpy()
        in_shared = atomics if mode == "shared" else 0
        log(f"phase grouped_agg timing: {kernel_ms:.4f} ms (CUDA events, 5 launches: work "
            f"list and fold) at N={state.n} Q={n_queries} G={g_pad} V=1, {mode} mode; plain "
            f"{plain_ms:.4f} ms; bound {record['bound_ms']:.4f} ms ({record['bound_by']}: "
            f"{ops[0]} ALU-only of {ops[1]} int32 ops; {nbytes} bytes, {distinct} distinct "
            f"folded rows), {share:.4f} of it; {in_shared} shared-memory atomics and "
            f"{work['flush_atomics'] if mode == 'shared' else atomics} global atomics "
            f"({int(out[0].long().sum())} folded row-queries; {work['runs']} runs of up to "
            f"{work['run_len']} chunks over {work['pairs']} kept pairs; the edge gather's scan "
            f"of the same payloads {scan_ms:.4f} ms); registers and local-memory bytes a "
            f"thread: shared mode {attrs['shared']}, global mode {attrs['global']}; "
            f"G={AGG_WIDE_GROUPS} ({wide_mode} mode) {wide_ms:.4f} ms; boundary rows per query "
            f"min {int(hits.min())}, p50 {p50(hits):.1f}, max {int(hits.max())}, total "
            f"{int(hits.sum())}; sums' max relative difference {max(rel, r2, r3):.3e}")
        if share > 1:
            raise AssertionError(f"grouped_agg reads {share:.4f} of its bound: the bound's "
                                 "count is wrong")
        def fused_call():
            ds.agg_cache.invalidate("gagg")
            ds.aggregate_many("gagg", cqls[AGG_SEEDS[0]], group_by=["cat"], value_cols=["val"])

        profile_window("aggregate_many", fused_call, "grouped_agg_kernel", all_ops=True)
        log(f"phase 6 memory: max_memory_allocated {torch.cuda.max_memory_allocated()} bytes")
    return record, wl_record, (lon, lat, t, gid, vals)


# -- phase 6b: bench config 9's product path, the GeoBlocks pyramid and query cache ----

PYRAMID_ROWS = 10_000_000  # the bench's n2 = min(N, 10M) (bench.py:1697)
PYRAMID_SEED = 301  # the product path's cold and warm set
PYRAMID_FRESH_SEED = 400  # + round: the pyramid's fresh sets (never a cache hit)


def same_bytes(a: dict, b: dict) -> bool:
    """Two ``aggregate_many`` answers byte for byte: groups, and every array's
    dtype and bytes."""
    arrays = [(a["count"], b["count"])] + [(a["cols"][c][k], b["cols"][c][k])
                                          for c in a["cols"] for k in a["cols"][c]]
    return a["groups"] == b["groups"] and a["cols"].keys() == b["cols"].keys() and all(
        x.dtype == y.dtype and x.shape == y.shape and x.tobytes() == y.tobytes()
        for x, y in arrays)


def as_fold(res) -> tuple:
    """An ``aggregate_many`` answer in :func:`agg_referee`'s form, so that
    :func:`check_agg_answer` holds one answer to another."""
    col = res["cols"]["val"]
    return (np.array([int(k[0]) for k in res["groups"]]), res["count"], col["count"],
            col["sum"], col["min"], col["max"])


def pyramid_path(dev, arrays: tuple, n_queries: int, iters: int) -> None:
    """Phase 6b: bench config 9's product path (``bench.py:1695-1811``) over
    the first ``PYRAMID_ROWS`` of phase 6's rows, with the pyramid switched
    on (``GEOMESA_TPU_PYRAMID=1``): write and compact, seed 301's queries
    cold (the pyramid built, every query served by it), the pyramid's p50
    over fresh sets of seeds 400 + round, and the warm p50 over repeats of
    seed 301 (every query a cache hit, byte for byte the cold answer). Held: every cold answer equals the fused
    path's on the same store (the default route, the cache emptied) and an f64
    numpy fold over the original columns; none of the pyramid's or the
    cache's calls launches a kernel."""
    from geomesa_tpu_torch.schema.columnar import Column, FeatureTable, point_column
    from geomesa_tpu_torch.schema.sft import AttributeType
    from geomesa_tpu_torch.store.datastore import DataStore
    from geomesa_tpu_torch.workload import AGG_SPEC, bbox_time_cql, make_queries

    lon, lat, t, gid, vals = (a[:PYRAMID_ROWS] for a in arrays)
    n = len(lon)
    rounds = max(3, iters // 2)
    sets = {seed: make_queries(n_queries, seed=seed)
            for seed in (PYRAMID_SEED, *range(PYRAMID_FRESH_SEED, PYRAMID_FRESH_SEED + rounds))}
    cqls = {seed: [bbox_time_cql(b, w) for b, w in zip(*q)] for seed, q in sets.items()}
    ds = DataStore(device=dev)
    sft = ds.create_schema("gagg", AGG_SPEC)
    table = FeatureTable.from_columns(sft, np.arange(n).astype("U9"), {
        "cat": Column(AttributeType.INT, gid.copy()), "val": Column(AttributeType.DOUBLE, vals),
        "dtg": Column(AttributeType.DATE, t), "geom": point_column(lon, lat)})
    t0 = time.perf_counter()
    ds.write("gagg", table)
    ds.compact("gagg")
    log(f"phase 6b write: {time.perf_counter() - t0:.3f} s (write + compact of {n} rows)")

    def call(seed):
        s = time.perf_counter()
        out = ds.aggregate_many("gagg", cqls[seed], group_by=["cat"], value_cols=["val"])
        return out, (time.perf_counter() - s) * 1e3 / n_queries, dict(ds.last_aggregate_many)

    with pyramid_switch("1"):
        cold, cold_ms, cold_tally, pyr_ms, pyr_tallies, warm_ms, warm_hits = _pyramid_calls(
            call, n_queries, rounds)
    ds.agg_cache.invalidate("gagg")
    s = time.perf_counter()
    fused, _, fused_tally = call(PYRAMID_SEED)
    fused_first_ms = (time.perf_counter() - s) * 1e3
    fused_ms = []
    for _ in range(rounds):
        ds.agg_cache.invalidate("gagg")
        fused_ms.append(call(PYRAMID_SEED)[1])
    if fused_tally["fused"] != n_queries:
        raise AssertionError(f"the fused call's queries by tier: {fused_tally}")
    t0 = time.perf_counter()
    slabs = day_slabs(t // DAY_MS, lon, lat, t)
    for i in range(n_queries):
        check_agg_answer(cold[i], as_fold(fused[i]), f"phase 6b query {i} against the fused path")
        box, window = sets[PYRAMID_SEED][0][i], sets[PYRAMID_SEED][1][i]
        check_agg_answer(cold[i], agg_referee(f64_referee(lon, lat, t, box, window, slabs), gid,
                                              vals, AGG_GROUPS), f"phase 6b query {i}")
    check_s = time.perf_counter() - t0
    pyr = ds._state("gagg").pyramids[(("cat",), ("val",))][0]
    brows = cold_tally["pyramid_boundary_rows"] + [
        b for tally in pyr_tallies for b in tally["pyramid_boundary_rows"]]
    log(f"phase 6b pyramid: built in {pyr.build_ms:.3f} ms at the cold call over {n} rows; "
        f"levels k {[lv.k for lv in pyr.levels]} (finest {pyr.levels[-1].k}: "
        f"{pyr.levels[-1].nx} x {pyr.levels[-1].nx} cells), {len(pyr.bins_present)} time bins, "
        f"{pyr.nbytes} host bytes")
    log(f"phase 6b served: cold {cold_tally['pyramid']} by the pyramid, {cold_tally['cache']} "
        f"by the cache, {cold_tally['declined']} declined; fresh sets "
        f"{sum(t_['pyramid'] for t_ in pyr_tallies)} by the pyramid over {rounds} calls; warm "
        f"calls' cache hits {warm_hits} of {n_queries} a call (any other by the pyramid, once "
        f"the LRU of {ds.agg_cache.max_entries} entries evicted it; cache "
        f"{ds.agg_cache.snapshot()});"
        f" boundary rows re-tested a query p50 {p50(brows):.1f}, "
        f"max {max(brows)} over {len(brows)} queries; launches of the pyramid's and the cache's "
        f"calls: none")
    log(f"phase 6b grouped_agg_p50_latency (mode geoblocks-pyramid): pyramid {p50(pyr_ms):.4f} "
        f"ms a query (p50 of {rounds} calls of {n_queries} fresh queries, seeds "
        f"{PYRAMID_FRESH_SEED}..{PYRAMID_FRESH_SEED + rounds - 1}); cold {cold_ms:.4f} ms a query "
        f"(the pyramid's build included); warm {p50(warm_ms):.4f} ms a query (p50 of {rounds} "
        f"calls: {[round(m, 4) for m in warm_ms]}); the fused path (the default route) on the "
        f"same store {p50(fused_ms):.4f} "
        f"ms a query (p50 of {rounds} calls, the cache emptied before each; its first call "
        f"{fused_first_ms:.3f} ms with the group-id, row-id and value staging)")
    log(f"phase 6b checks: ok in {check_s:.3f} s (all {n_queries} cold answers equal the fused "
        f"path's and the f64 numpy fold: groups in order; counts, value counts, min, max exact; "
        f"sums within {AGG_RTOL}; the warm answers byte for byte the cold ones)")


def _pyramid_calls(call, n_queries: int, rounds: int) -> tuple:
    """Phase 6b's calls with the pyramid switched on: seed 301 cold, the
    fresh sets, and the warm repeats; none may launch a kernel."""
    from geomesa_tpu_torch.ops import kernels

    for k in kernels.launches:
        kernels.launches[k] = 0
    cold, cold_ms, cold_tally = call(PYRAMID_SEED)
    if cold_tally["pyramid"] != n_queries:
        raise AssertionError(f"the cold call's queries by tier: {cold_tally}")
    pyr_ms, pyr_tallies = [], []
    for r in range(rounds):
        _, ms, tally = call(PYRAMID_FRESH_SEED + r)
        pyr_ms.append(ms)
        pyr_tallies.append(tally)
    # the fresh sets' answers fill the cache past its 256 entries, so the LRU
    # has evicted seed 301's by now: the first warm call fills it again (as
    # the bench's warm loop does), the later ones are hits
    warm_ms, warm_hits = [], []
    for _ in range(rounds):
        warm, ms, warm_tally = call(PYRAMID_SEED)
        warm_ms.append(ms)
        warm_hits.append(warm_tally["cache"])
        if warm_tally["cache"] + warm_tally["pyramid"] != n_queries:
            raise AssertionError(f"a warm call's queries by tier: {warm_tally}")
        if not all(same_bytes(a, b) for a, b in zip(cold, warm)):
            raise AssertionError("a warm answer differs from its cold answer")
    launched = {k: v for k, v in kernels.launches.items() if v}
    if any(tally["pyramid"] != n_queries for tally in pyr_tallies) or warm_hits[-1] != n_queries:
        raise AssertionError(f"the fresh sets' queries by tier: {pyr_tallies}; warm cache hits "
                             f"{warm_hits}")
    if launched:
        raise AssertionError(f"the pyramid's and the cache's calls launched {launched}")
    return cold, cold_ms, cold_tally, pyr_ms, pyr_tallies, warm_ms, warm_hits


# -- phase 7: bench config 3, density heatmaps and batched KNN ---------------------

DENSITY_GRIDS = ((256, 256), (37, 100))  # bench config 3's grid, and one not square
# the cell of a match: for each axis a convert, a subtract, a multiply, two
# float clamps, the truncation and two integer clamps; then the flat index
# (a multiply-add) and the atomic: ~10 per axis, as (ALU-only, all)
DENSITY_CELL_OPS = (8, 20)
# the KNN select per (row, query) of a tile it cannot skip: two subtracts,
# two multiplies, an add (the FMA pipe) and the running minimum (ALU), as
# (ALU-only, all); per (tile, query) pair the skip's test: four subtracts,
# two maxima and two clamps (ALU), two multiplies, an add and the compare;
# and per row the decode, two conversions, two multiplies and two subtracts
KNN_PAIR_OPS = (1, 6)
KNN_TILE_OPS = (5, 12)
KNN_ROW_OPS = 6
# phase 7b's shared density_many viewport: London, Paris, Moscow,
# Johannesburg, Delhi and Cairo inside, New York, Mexico City, Beijing and
# Tokyo clipped away
DENSITY_VIEWPORT = (-20.0, -40.0, 90.0, 70.0)


def density_gb(boxes: np.ndarray, kind: str) -> np.ndarray:
    """(Q, 4) grid bounds for phase 7a: each query's first box slot (bench
    config 3's bounds; a dead slot gives inverted bounds), or a degenerate
    x range (xlo == xhi) whose products overflow int32 far from it."""
    if kind == "own":
        return np.ascontiguousarray(boxes[:, 0, :])
    q = boxes.shape[0]
    return np.ascontiguousarray(np.tile(np.array([2**30, 2**30, 0, 2**31 - 1], np.int32), (q, 1)))


def check_density_kernel(dev, store, seed: int) -> int:
    """Phase 7a, density: ``batched_density`` against ``batched_density_plain``
    on the card, exact, at N = 1,000,003, over GDELT-shaped rows in z3 order
    under city boxes packed as ``DataStore`` packs them (the cull keeps few
    pairs), the same rows shuffled (it keeps nearly all), grid rows under
    ``grid_payload`` and edge rows under ``edge_payload``; at (B, T) in
    {(1, 1), (8, 16)} and Q in {1, 16, 64, one past the shared tile}; each
    row set meets every combination of a 256 x 256 or a 37 x 100 grid,
    each query's own box or a degenerate bound as grid bounds, and a
    base/true_n tail or none. Returns max |difference| over the grids."""
    import torch

    from geomesa_tpu_torch.ops import kernels
    from geomesa_tpu_torch.ops.kernels import batched_density, batched_density_plain

    ds, sft, state = store
    n, cols = state.n, [c[: state.n].contiguous() for c in state.spatial_cols()]
    perm = torch.randperm(n, generator=torch.Generator().manual_seed(seed)).to(dev)
    rng = np.random.default_rng(seed)
    rows = {"city": cols, "shuffled": [c[perm].contiguous() for c in cols]}
    for mode in ("grid", "mixed"):
        rows[mode] = [torch.from_numpy(c).to(dev) for c in edge_host_columns(mode, n, seed)]
    worst = i = 0
    for name, rcols in rows.items():
        host = [c.cpu().numpy() for c in rcols] if name in ("grid", "mixed") else None
        for nb, nt in ((1, 1), (8, 16)):
            for q in (1, 16, 64, kernels.q_tile_for(nb, nt, kernel="batched_density") + 1):
                if host is None:
                    b, t = cull_payload(ds, sft, "city", q, nb, nt, seed + q + nb)
                else:
                    b, t = edge_inputs(rng, name, q, nb, nt, host)
                width, height = DENSITY_GRIDS[i % 2]
                kind = ("own", "degenerate")[(i // 2) % 2]
                base, true_n = ((0, n), (3 * 4096, 3 * 4096 + n - 777))[(i // 4) % 2]
                i += 1
                gb = density_gb(b, kind)
                args = (*rcols, base, true_n, *(torch.from_numpy(a).to(dev) for a in (b, t, gb)),
                        width, height)
                got = batched_density(*args)
                want = batched_density_plain(*args)
                torch.cuda.synchronize()
                err = int((got - want).abs().max())
                worst = max(worst, err)
                log(f"  batched_density {name} N={n} Q={q} B={nb} T={nt} {width}x{height} "
                    f"bounds={kind} base={base} true_n={true_n}: max_abs_err={err} (mass "
                    f"{float(want.double().sum()):.0f})")
                if err != 0:
                    raise AssertionError(f"batched_density disagrees with plain at {name} "
                                         f"Q={q} B={nb} T={nt}")
    return worst


def knn_cell_rows(n: int, seed: int, values: int = 300):
    """``workload.grid_columns`` rows (``values`` coordinates per axis, many
    rows on each) ordered by 64 x 64 cells and then by x, so that a 256-row
    tile lies in one small cell and the tile skip decides: (x, y) int32."""
    from geomesa_tpu_torch.workload import grid_columns

    x, y, _, _ = grid_columns(n, seed, values=values)
    order = np.lexsort((y, x, (x >> 25) * 64 + (y >> 25)))
    return np.ascontiguousarray(x[order]), np.ascontiguousarray(y[order])


def check_knn_kernel(dev, store, seed: int) -> int:
    """Phase 7a, KNN: ``batched_knn`` against ``batched_knn_plain`` on the
    card, distances bit-equal and rows equal, at k in {1, 10, 64} and Q in
    {1, 64, 65}, over the GDELT-shaped rows in z3 order with a true_n
    tail (bench config 3's points), grid rows with points on them (full of
    ties), and 5 rows (N < k: the inf slots); then, at k in {10, 64} and Q =
    64, cases where the tile skip decides: the z3 rows with a NaN query and
    a query far from every row among bench config 3's points, and grid rows
    ordered by small cells (``knn_cell_rows``) under points on them, whose
    k-th distance ties with rows across tile edges; each logs the (tile,
    query) pairs its answer keeps (``knn_work``). Returns 0 or raises."""
    import torch

    from geomesa_tpu_torch.ops.kernels import batched_knn, batched_knn_plain, knn_degrees
    from geomesa_tpu_torch.workload import grid_columns, knn_points

    _, _, state = store
    n = state.n
    x, y = state.spatial_cols()[:2]
    gx, gy, _, _ = (torch.from_numpy(c).to(dev) for c in grid_columns(n, seed, values=40))
    pts = torch.from_numpy(knn_points(65).astype(np.float32)).to(dev)
    gxf, gyf = knn_degrees(gx, gy)
    on_rows = torch.randint(0, n, (65,), generator=torch.Generator().manual_seed(seed)).to(dev)
    cx, cy = (torch.from_numpy(c).to(dev) for c in knn_cell_rows(n, seed))
    cxf, cyf = knn_degrees(cx, cy)
    odd = pts[:64].clone()
    odd[0] = float("nan")
    odd[1] = torch.tensor([400.0, -300.0])  # far outside every row
    cases = [("z3 rows", x, y, n - 777, pts[:, 0], pts[:, 1], (1, 10, 64), (1, 64, 65)),
             ("grid rows", gx, gy, n, gxf[on_rows], gyf[on_rows], (1, 10, 64), (1, 64, 65)),
             ("5 rows", x[:5].contiguous(), y[:5].contiguous(), 5, pts[:, 0], pts[:, 1],
              (1, 10, 64), (1, 64, 65)),
             ("z3 rows, a NaN and a far query", x, y, n - 777, odd[:, 0], odd[:, 1], (10, 64),
              (64,)),
             ("cell rows", cx, cy, n, cxf[on_rows], cyf[on_rows], (10, 64), (64,))]
    for name, rx, ry, true_n, qx, qy, ks, qs in cases:
        for k in ks:
            for q in qs:
                args = (rx, ry, 0, true_n, qx[:q].contiguous(), qy[:q].contiguous(), k)
                got_d, got_r = batched_knn(*args)
                want_d, want_r = batched_knn_plain(*args)
                torch.cuda.synchronize()
                same = (torch.equal(got_d.view(torch.int32), want_d.view(torch.int32))
                        and torch.equal(got_r, want_r))
                ties = int((want_d[:, 1:] == want_d[:, :-1]).sum())
                kept = ""
                if len(qs) == 1:  # the skip's cases: the pairs their answer keeps
                    w = knn_work(rx, ry, true_n, args[4], args[5],
                                 knn_kth_d2(rx, ry, args[4], args[5], want_d, want_r))
                    kept = f", kept (tile, query) pairs {w['kept_pairs']} of {w['tile_pairs']}"
                log(f"  batched_knn {name} N={rx.shape[0]} true_n={true_n} Q={q} k={k}: "
                    f"{'bit-equal' if same else 'DIFFERENT'} (tied neighbours {ties}, inf slots "
                    f"{int(torch.isinf(want_d).sum())}{kept})")
                if not same:
                    raise AssertionError(f"batched_knn disagrees with plain at {name} Q={q} k={k}")
    return 0


def density_replica(xs, ys, gb, width: int, height: int) -> np.ndarray:
    """numpy f32 replica of the density step's grid of one query: its
    matching rows' int-domain coordinates ``xs, ys`` under the grid bounds
    ``gb`` [xlo, xhi, ylo, yhi], the reference's f32 cell math (each step
    rounded alone, the product clamped into [-1, cells] before the
    truncation) and a bincount. Returns a (height, width) float64 grid."""
    f32 = np.float32

    def cells(v, lo, hi, size):
        lo_f, hi_f = f32(lo), f32(hi)
        s = f32(size) / (hi_f - lo_f + f32(1.0))
        f = (v.astype(f32) - lo_f) * s
        f = np.clip(np.nan_to_num(f, nan=0.0), f32(-1.0), f32(size))
        return np.clip(f.astype(np.int64), 0, size - 1)

    cx = cells(xs, gb[0], gb[1], width)
    cy = cells(ys, gb[2], gb[3], height)
    return (np.bincount(cy * width + cx, minlength=width * height)
            .reshape(height, width).astype(np.float64))


def int_matches(slabs, boxes_f64, windows_ms, viewport=None):
    """Per query, the int-domain coordinates (xs, ys) of its matching rows
    in a day-sliced store, the boxes clipped to ``viewport`` first where
    one is given (None when clipped to nothing)."""
    _, starts, (x, y, b, o) = slabs
    out = []
    for (x1, y1, x2, y2), (lo, hi) in zip(boxes_f64, windows_ms):
        if viewport is not None:
            x1, y1 = max(x1, viewport[0]), max(y1, viewport[1])
            x2, y2 = min(x2, viewport[2]), min(y2, viewport[3])
            if x1 > x2 or y1 > y2:
                out.append(None)
                continue
        (blo, olo), (bhi, ohi) = divmod(lo + 1, DAY_MS), divmod(hi - 1, DAY_MS)
        s, e = starts[blo], starts[bhi + 1]
        xs, ys, bs, os_ = x[s:e], y[s:e], b[s:e], o[s:e]
        m = ((xs >= norm31(x1, -180.0, 180.0)) & (xs <= norm31(x2, -180.0, 180.0))
             & (ys >= norm31(y1, -90.0, 90.0)) & (ys <= norm31(y2, -90.0, 90.0))
             & ((bs > blo) | ((bs == blo) & (os_ >= olo)))
             & ((bs < bhi) | ((bs == bhi) & (os_ <= ohi))))
        out.append((xs[m], ys[m]))
    return out


def density_floor(cols, n: int, loaded: int, boxes, times, gb, width: int, height: int,
                  matches: int, chunks):
    """The least work of ``batched_density`` on these inputs: the
    predicate's (:func:`predicate_floor_ops`) on the (chunk, query) pairs
    the cull keeps, the cull's extent of every loaded row, and a cell per
    match (:data:`DENSITY_CELL_OPS`); bytes are the columns (16 B a loaded
    row), the payloads and grid bounds read once and the grids written once.
    Returns ((alu, all), bytes)."""
    (alu, total), _, _, m = predicate_floor_ops(*(c[:n] for c in cols), boxes, times, chunks)
    if m != matches:
        raise AssertionError("the density bound's match count disagrees with the plain version")
    extent = EXTENT_OPS_PER_ROW * loaded
    q = boxes.shape[0]
    nbytes = (16 * loaded + 4 * (boxes.numel() + times.numel() + gb.numel())
              + 4 * q * width * height)
    return ((alu + extent + DENSITY_CELL_OPS[0] * m, total + extent + DENSITY_CELL_OPS[1] * m),
            nbytes)


def knn_kth_d2(x, y, qx, qy, dist, rows):
    """Each query's final k-th d2 from ``batched_knn``'s answer: the d2 of
    the row in its last slot, each step rounded as the kernel rounds it;
    +inf where that slot is empty (fewer than k eligible rows)."""
    import torch

    from geomesa_tpu_torch.ops.kernels import knn_degrees

    last = rows[:, -1].long()
    xf, yf = knn_degrees(x[last], y[last])
    dx, dy = xf - qx, yf - qy
    d2 = dx * dx + dy * dy
    return torch.where(torch.isinf(dist[:, -1]), torch.full_like(d2, float("inf")), d2)


def knn_work(x, y, true_n: int, qx, qy, kth_d2) -> dict:
    """What any exact select that skips 256-row tiles must do to answer
    ``q`` queries over the valid rows of ``x, y``, counted with torch ops
    on the columns' device: ``tile_pairs``, the (tile, query) pairs of the
    tiles that hold a valid row, each tested once; ``kept_rows``, the valid
    rows of each tile whose lower bound is at most that query's final k-th
    d2 ``kth_d2`` (their d2 must be computed: such a tile may hold a row of
    the answer); ``sample_pairs``, the cap pass's (sampled row, query)
    pairs (``kernels.knn_sample_rows``)."""
    import torch

    from geomesa_tpu_torch.ops.kernels import (
        KNN_TILE_ROWS, knn_sample_rows, knn_tile_extents_plain, knn_tile_keep_plain)

    n, q = x.shape[0], qx.shape[0]
    limit = max(0, min(n, int(true_n)))
    ext = knn_tile_extents_plain(x, y, 0, true_n)
    keep = knn_tile_keep_plain(ext, qx, qy, kth_d2)
    starts = torch.arange(ext.shape[0], device=x.device) * KNN_TILE_ROWS
    valid_rows = (limit - starts).clamp(0, KNN_TILE_ROWS)
    return {"tile_pairs": int((valid_rows > 0).sum()) * q,
            "kept_pairs": int(keep.sum()),
            "kept_rows": int((keep.long() * valid_rows[:, None]).sum()),
            "sample_pairs": knn_sample_rows(n, 0, true_n)[1] * q}


def knn_floor(n: int, q: int, k: int, work: dict):
    """The least work of an exact tile-skipping ``batched_knn`` at ``n``
    valid rows and ``q`` queries, from :func:`knn_work`'s counts of this
    answer (:data:`KNN_PAIR_OPS` a kept row and sampled pair,
    :data:`KNN_TILE_OPS` a tile pair, :data:`KNN_ROW_OPS` a row); bytes are
    x and y read once for all queries (8 B a row), the points read and
    (dist, row) written once. Returns ((alu, all), bytes)."""
    pairs = work["kept_rows"] + work["sample_pairs"]
    tiles = work["tile_pairs"]
    return ((KNN_PAIR_OPS[0] * pairs + KNN_TILE_OPS[0] * tiles,
             KNN_PAIR_OPS[1] * pairs + KNN_TILE_OPS[1] * tiles + KNN_ROW_OPS * n),
            8 * n + 8 * q + 8 * q * k)


def knn_floor_all_pairs(n: int, q: int, k: int):
    """The earlier bound, of a select that computes every (row, query) d2:
    ((alu, all), bytes)."""
    pairs = n * q
    return ((KNN_PAIR_OPS[0] * pairs, KNN_PAIR_OPS[1] * pairs + KNN_ROW_OPS * n),
            8 * n + 8 * q + 8 * q * k)


KNN_OPS = ("sample gather", "sample select", "sample merge", "full select", "full merge")


def knn_split(fn, calls: int = 10) -> dict | None:
    """Device ms of each kernel of one ``batched_knn`` call by
    ``torch.profiler``, by its place in the call (:data:`KNN_OPS`: the cap's
    sample pass, a gather of the sampled rows, a select and a merge, then
    the select over every row and its merge; a call with no sample pass has
    the last two), mean of ``calls`` calls. None where the trace holds no
    whole calls' kernel records."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    ev = sorted((e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                 and "knn_" in e.name), key=lambda e: e.time_range.start)
    if not ev or len(ev) % calls or len(ev) // calls not in (2, len(KNN_OPS)):
        return None
    names = KNN_OPS[-(len(ev) // calls):]
    out = dict.fromkeys(names, 0.0)
    for i, e in enumerate(ev):
        out[names[i % len(names)]] += (e.time_range.end - e.time_range.start) / 1e3 / calls
    return out


def config3_path(dev, n_rows: int, n_density: int, n_knn: int, k: int, iters: int,
                 max_err: dict):
    """Phase 7b: bench config 3 (``bench.py:510``) at full size; returns the
    batched_density and batched_knn records, and the store with its points
    (lon, lat) for phase 8."""
    import torch

    from geomesa_tpu_torch.ops import kernels
    from geomesa_tpu_torch.ops.kernels import (
        batched_count, batched_density, batched_density_plain, batched_knn, batched_knn_plain,
        chunk_query_pairs, density_cells, density_scale, knn_degrees)
    from geomesa_tpu_torch.parallel.query import batched_density_step, batched_knn_step
    from geomesa_tpu_torch.planning.planner import Query
    from geomesa_tpu_torch.process.knn import knn_many
    from geomesa_tpu_torch.schema.columnar import Column, FeatureTable, Point, point_column
    from geomesa_tpu_torch.schema.sft import AttributeType
    from geomesa_tpu_torch.store.datastore import DataStore
    from geomesa_tpu_torch.workload import (
        SPEC, bbox_time_cql, knn_points, make_queries, synth_gdelt)

    on_card = dev.type == "cuda"
    t0 = time.perf_counter()
    lon, lat, t = synth_gdelt(n_rows, seed=42)
    fids = np.arange(n_rows).astype("U9")
    boxes_f64, windows_ms = make_queries(n_density, seed=7)
    cqls = [bbox_time_cql(b, w) for b, w in zip(boxes_f64, windows_ms)]
    pts = knn_points(n_knn)
    points = [Point(*p) for p in pts]
    log(f"phase 7 synth: {time.perf_counter() - t0:.3f} s ({n_rows} rows, {n_density} density "
        f"queries, {n_knn} KNN points, k={k})")

    if on_card:
        torch.cuda.reset_peak_memory_stats()
    for name in kernels.launches:
        kernels.launches[name] = 0
    ds = DataStore(device=dev)
    sft = ds.create_schema("cfg3", SPEC)
    table = FeatureTable.from_columns(sft, fids, {
        "dtg": Column(AttributeType.DATE, t), "geom": point_column(lon, lat)})
    t0 = time.perf_counter()
    ds.write("cfg3", table)
    ds.compact("cfg3")
    write_s = time.perf_counter() - t0
    st = ds._state("cfg3")
    state = st.backend_state["z3"]
    cols = state.spatial_cols()
    # the density step as the bench runs it: each query's own box its grid bounds
    t0 = time.perf_counter()
    pend = ds._batch_payloads(st, [Query(c) for c in cqls])
    payload_ms = (time.perf_counter() - t0) * 1e3
    boxes = torch.from_numpy(np.stack([p[0] for _, p, _ in pend])).to(dev)
    times = torch.from_numpy(np.stack([p[1] for _, p, _ in pend])).to(dev)
    gb = boxes[:, 0, :].contiguous()
    width, height = DENSITY_GRIDS[0]
    grids = batched_density_step(cols, state.n, boxes, times, gb, width, height).cpu()
    counts = batched_count(*cols, 0, state.n, boxes, times).cpu()
    loose = ds.density_many("cfg3", cqls, DENSITY_VIEWPORT, width, height)
    t0 = time.perf_counter()
    exact = ds.density_many("cfg3", cqls, DENSITY_VIEWPORT, width, height, loose=False)
    exact_s = time.perf_counter() - t0
    found = knn_many(ds, "cfg3", points, k=k)
    launched = dict(kernels.launches)
    log(f"phase 7 launches: {launched}")
    if on_card:
        want = {"z3_encode": 1, "z2_encode": 1, "batched_density": 2, "batched_count": 1,
                "batched_knn": 1}
        if any(launched[name] != v for name, v in want.items()):
            raise AssertionError(f"phase 7's main path must launch {want}")
        log(f"phase 7 write memory: memory_allocated {torch.cuda.memory_allocated()} bytes "
            f"resident, max_memory_allocated {torch.cuda.max_memory_allocated()} bytes")
    log(f"phase 7 write: {write_s:.3f} s (write + compact of {n_rows} rows)")
    log_rebuild(ds.last_rebuild("cfg3"))

    # -- checks: masses, the f32 cell replica, the f64 histogram, the referees --
    t0 = time.perf_counter()
    xi, yi = norm31(lon, -180.0, 180.0), norm31(lat, -90.0, 90.0)
    day, off = t // DAY_MS, t % DAY_MS
    order, starts, by_day = day_slabs(day, xi, yi, day, off)
    slabs = (order, starts, by_day)
    mass = grids.double().sum(dim=(1, 2))
    if not torch.equal(mass, counts.double()):
        raise AssertionError(f"grid masses {mass.tolist()} differ from batched_count's "
                             f"{counts.tolist()}")
    host_gb = gb.cpu().numpy()
    for qi, (xs, ys) in enumerate(int_matches(slabs, boxes_f64, windows_ms)):
        want_g = density_replica(xs, ys, host_gb[qi], width, height)
        if not np.array_equal(grids[qi].numpy().astype(np.float64), want_g):
            raise AssertionError(f"density query {qi}: the grid differs from the f32 replica")
    vp = DENSITY_VIEWPORT
    vgb = np.array([norm31(vp[0], -180.0, 180.0), norm31(vp[2], -180.0, 180.0),
                    norm31(vp[1], -90.0, 90.0), norm31(vp[3], -90.0, 90.0)])
    clipped = 0
    for qi, m in enumerate(int_matches(slabs, boxes_f64, windows_ms, viewport=vp)):
        if m is None:
            clipped += 1
            want_g = np.zeros((height, width))
        else:
            want_g = density_replica(*m, vgb, width, height)
        if not np.array_equal(loose[qi], want_g):
            raise AssertionError(f"density_many query {qi}: the loose grid differs from the "
                                 "f32 replica over the viewport")
    fslabs = day_slabs(day, lon, lat, t)
    for qi, (box, window) in enumerate(zip(boxes_f64, windows_ms)):
        rows = f64_referee(lon, lat, t, box, window, fslabs)
        want_g, _, _ = np.histogram2d(lat[rows], lon[rows], bins=[height, width],
                                      range=[[vp[1], vp[3]], [vp[0], vp[2]]])
        if not np.array_equal(exact[qi], want_g):
            raise AssertionError(f"density_many(loose=False) query {qi} differs from the f64 "
                                 "histogram")
    # KNN: 4 points against the bench's f64 brute force and its derived band
    for qi in range(min(4, n_knn)):
        d2 = (lon - pts[qi, 0]) ** 2 + (lat - pts[qi, 1]) ** 2
        kth = np.partition(d2, k - 1)[k - 1]
        tol = 2.0 * np.sqrt(kth) * 8e-5 + kth * 1e-4 + 1e-8
        if not (found[qi][1] ** 2 <= kth + tol).all() or len(found[qi][1]) != k:
            raise AssertionError(f"knn_many point {qi} lies outside the bench's band")
    # all of them against the plain version on the store's device
    qx = torch.from_numpy(pts[:, 0].astype(np.float32)).to(dev)
    qy = torch.from_numpy(pts[:, 1].astype(np.float32)).to(dev)
    pd, pr = batched_knn_plain(cols[0], cols[1], 0, state.n, qx, qy, k)
    perm = st.indices["z3"].perm
    pfids = fids[perm[pr.cpu().numpy().astype(np.int64)]]
    for qi, (tab, dist) in enumerate(found):
        if not (np.array_equal(dist.astype(np.float32), pd[qi].cpu().numpy())
                and np.array_equal(tab.fids, pfids[qi])):
            raise AssertionError(f"knn_many point {qi} differs from batched_knn_plain")
    log(f"phase 7 checks: ok in {time.perf_counter() - t0:.3f} s ({n_density} grid masses equal "
        f"batched_count's ({int(counts.sum())} rows); every grid equals the numpy f32 cell "
        f"replica; density_many over {DENSITY_VIEWPORT}: {clipped} queries clipped to nothing, "
        f"loose grids equal the replica, loose=False grids the f64 histogram2d "
        f"({exact_s:.3f} s for {n_density}); knn_many: {min(4, n_knn)} points inside the "
        f"bench's band, all {n_knn} equal to batched_knn_plain)")
    del fslabs, slabs, by_day, order, xi, yi

    # -- timings ---------------------------------------------------------------
    def host_ms(fn, reps):
        out = []
        for _ in range(reps):
            s = time.perf_counter()
            fn()
            out.append((time.perf_counter() - s) * 1e3)
        return out

    dm = host_ms(lambda: ds.density_many("cfg3", cqls, DENSITY_VIEWPORT, width, height), iters)
    vpend = [(i, p) for i, p, _ in ds._batch_payloads(st, [Query(c) for c in cqls],
                                                      viewport=DENSITY_VIEWPORT) if p is not None]
    vboxes = torch.from_numpy(np.stack([p[0] for _, p in vpend])).to(dev)
    vtimes = torch.from_numpy(np.stack([p[1] for _, p in vpend])).to(dev)
    vgbs = torch.from_numpy(np.tile(vgb.astype(np.int32), (len(vpend), 1))).to(dev)
    dstep = host_ms(lambda: batched_density_step(cols, state.n, vboxes, vtimes, vgbs, width,
                                                 height).cpu(), iters)
    dpay = host_ms(lambda: ds._batch_payloads(st, [Query(c) for c in cqls],
                                              viewport=DENSITY_VIEWPORT), iters)
    log(f"phase 7 density_many: p50 {p50(dm) / n_density:.4f} ms per query over {iters} calls "
        f"of {n_density} ({p50(dm):.3f} ms a call, min {min(dm):.3f}, max {max(dm):.3f}; host "
        f"clock); split p50 per call: payloads (parse, extract, clip, pack) {p50(dpay):.3f} ms, "
        f"the step with its uploads and the grids' copy {p50(dstep):.3f} ms, the rest "
        f"{p50(dm) - p50(dpay) - p50(dstep):.3f} ms; loose=False {exact_s * 1e3 / n_density:.3f}"
        f" ms per query once; bench's own-box payloads {payload_ms:.3f} ms once")
    kn = host_ms(lambda: knn_many(ds, "cfg3", points, k=k), iters)
    kstep = host_ms(lambda: [v.cpu() for v in batched_knn_step(
        cols, state.n, pts[:, 0], pts[:, 1], k)], iters)
    log(f"phase 7 knn_many: p50 {p50(kn) / n_knn:.4f} ms per point over {iters} calls of "
        f"{n_knn} ({p50(kn):.3f} ms a call, min {min(kn):.3f}, max {max(kn):.3f}; host clock); "
        f"split p50 per call: the step with its uploads and copies {p50(kstep):.3f} ms, the "
        f"host tail (permutation, take, order) {p50(kn) - p50(kstep):.3f} ms")

    d_record = {"name": "batched_density", "route": "cuda",
                "source": "geomesa_tpu_torch/csrc/batched_density.cu",
                "replaces": "geomesa_tpu/parallel/query.py:1193",
                "launches": launched["batched_density"], "library_ms": None}
    k_record = {"name": "batched_knn", "route": "cuda",
                "source": "geomesa_tpu_torch/csrc/batched_knn.cu",
                "replaces": "geomesa_tpu/parallel/query.py:1125",
                "launches": launched["batched_knn"], "library_ms": None}
    if on_card:
        dargs = (*cols, 0, state.n, boxes, times, gb, width, height)
        got = batched_density(*dargs)
        want = batched_density_plain(*dargs)
        torch.cuda.synchronize()
        d_err = int((got - want).abs().max())
        if d_err:
            raise AssertionError("batched_density disagrees with plain at config 3")
        d_ms = cuda_ms(lambda: batched_density(*dargs), 5)
        d_plain_ms = cuda_ms(lambda: batched_density_plain(*dargs), 1)
        # a part of the work: one bincount of the matching rows' flat cells,
        # gathered outside the timing
        xlo, xhi, ylo, yhi = (gb.float()[:, i, None] for i in range(4))
        sx, sy = density_scale(xlo, xhi, width), density_scale(ylo, yhi, height)
        at = torch.arange(boxes.shape[0], device=dev)[:, None] * (width * height)
        flat = []
        for s, e, m, _ in kernels._plain_masks(*cols, 0, state.n, boxes, times, 1 << 20):
            cx = density_cells(cols[0][s:e].float()[None, :], xlo, sx, width)
            cy = density_cells(cols[1][s:e].float()[None, :], ylo, sy, height)
            flat.append((at + cy * width + cx)[m])
        flat = torch.cat(flat)
        lib = torch.bincount(flat, minlength=boxes.shape[0] * width * height)
        if not torch.equal(lib.float().view_as(want), want):
            raise AssertionError("the bincount yardstick disagrees with the plain version")
        lib_ms = cuda_ms(lambda: torch.bincount(flat, minlength=boxes.shape[0] * width * height),
                         5)
        kept = chunk_query_pairs(*cols, 0, state.n, boxes, times)
        ops, nbytes = density_floor(cols, state.n, cols[0].shape[0], boxes, times, gb, width,
                                    height, int(flat.shape[0]), kept)
        # no one torch call computes the grids: the bincount of cells gathered
        # beforehand is a part of the work, kept under its own name
        d_record.update(max_abs_err=max(d_err, max_err["batched_density"]), ms=d_ms,
                        plain_ms=d_plain_ms, library_ms=None, bincount_part_ms=lib_ms,
                        **bound_fields(ops, nbytes))
        share = d_record["bound_ms"] / d_ms
        log(f"phase batched_density timing: {d_ms:.4f} ms (CUDA events, 5 launches) at "
            f"N={state.n} Q={boxes.shape[0]} B={boxes.shape[1]} T={times.shape[1]} "
            f"{width}x{height}; plain {d_plain_ms:.4f} ms; library call none "
            f"(bincount_part_ms: torch.bincount of the {flat.shape[0]} matches' cells "
            f"gathered beforehand, a part of the work, {lib_ms:.4f} ms); bound "
            f"{d_record['bound_ms']:.4f} ms ({d_record['bound_by']}: {ops[0]} ALU-only of "
            f"{ops[1]} ops over {int(kept.sum())} kept of {kept.numel()} (chunk, query) pairs; "
            f"{nbytes} bytes), "
            f"{share:.4f} of it")
        if share > 1:
            raise AssertionError(f"batched_density reads {share:.4f} of its bound: the bound's "
                                 "count is wrong")
        del flat, lib, got, want, kept
        kargs = (cols[0], cols[1], 0, state.n, qx, qy, k)
        k_ms = cuda_ms(lambda: batched_knn(*kargs), 5)
        k_dev_ms = device_ms(lambda: batched_knn(*kargs))
        k_plain_ms = cuda_ms(lambda: batched_knn_plain(*kargs), 1)
        xf, yf = knn_degrees(cols[0][: state.n], cols[1][: state.n])

        def library():  # one batched call: the (Q, N) d2 expression and one topk over dim 1
            for s in range(0, n_knn, KNN_LIBRARY_SLICE):  # (8, 100M) f32 is 3.2 GB a term
                dx = xf[None, :] - qx[s:s + KNN_LIBRARY_SLICE, None]
                dy = yf[None, :] - qy[s:s + KNN_LIBRARY_SLICE, None]
                torch.topk(dx * dx + dy * dy, k, dim=1, largest=False)

        def per_query():  # the earlier yardstick: the eager expression and topk, per query
            for qi in range(n_knn):
                dx, dy = xf - qx[qi], yf - qy[qi]
                torch.topk(dx * dx + dy * dy, k, largest=False)

        lib_k_ms = cuda_ms(library, 1)
        per_query_ms = cuda_ms(per_query, 1)
        del xf, yf
        got_d, got_r = batched_knn(*kargs)
        work = knn_work(cols[0], cols[1], state.n, qx, qy,
                        knn_kth_d2(cols[0], cols[1], qx, qy, got_d, got_r))
        ops, nbytes = knn_floor(state.n, n_knn, k, work)
        all_ops, _ = knn_floor_all_pairs(state.n, n_knn, k)
        all_pairs_ms = bound_fields(all_ops, nbytes)["bound_ms"]
        k_record.update(max_abs_err=max_err["batched_knn"], ms=k_ms, plain_ms=k_plain_ms,
                        library_ms=lib_k_ms, device_ms=k_dev_ms, per_query_library_ms=per_query_ms,
                        all_pairs_bound_ms=all_pairs_ms, **bound_fields(ops, nbytes))
        share = k_record["bound_ms"] / k_ms
        log(f"phase batched_knn timing: {k_ms:.4f} ms (CUDA events, 5 launches: sample and full "
            f"selects and merges), device {fmt_ms(k_dev_ms)} (10 calls behind a spin) at "
            f"N={state.n} Q={n_knn} k={k}; plain {k_plain_ms:.4f} ms; library call (the (Q, N) "
            f"d2 expression and one torch.topk over dim 1, {KNN_LIBRARY_SLICE} queries a slice) "
            f"{lib_k_ms:.4f} ms [per query {per_query_ms:.4f} ms]; bound "
            f"{k_record['bound_ms']:.4f} ms ({k_record['bound_by']}: {ops[0]} ALU-only of "
            f"{ops[1]} ops over {work['tile_pairs']} (tile, query) tests, {work['kept_pairs']} "
            f"kept pairs of {work['kept_rows']} rows against the answer's k-th d2 and "
            f"{work['sample_pairs']} sample pairs; {nbytes} bytes), {share:.4f} of it "
            f"[all-pairs bound {all_pairs_ms:.4f} ms, {all_pairs_ms / k_ms:.4f} of it]")
        if share > 1:
            raise AssertionError(f"batched_knn reads {share:.4f} of its bound: the bound's "
                                 "count is wrong")
        split = knn_split(lambda: batched_knn(*kargs))
        log("phase batched_knn split (torch.profiler, mean of 10 calls): " + (
            "not measured (no kernel records)" if split is None else
            "; ".join(f"{name} {t:.4f} ms" for name, t in split.items())))
        profile_window("density_many", lambda: ds.density_many(
            "cfg3", cqls, DENSITY_VIEWPORT, width, height), "batched_density_kernel")
        profile_window("knn_many", lambda: knn_many(ds, "cfg3", points, k=k), "knn_select_kernel",
                       kernels_in_order=True)
        log(f"phase 7 memory: max_memory_allocated {torch.cuda.max_memory_allocated()} bytes")
    return [d_record, k_record], (ds, lon, lat)


# -- phase 8: bench config 4, the spatial join -------------------------------------

JOIN_POLYGONS = 10_000  # bench config 4's K (GEOMESA_BENCH_K's default)
JOIN_BENCH_BLOCK = 8192  # bench.py:689
JOIN_CHECKED = 256  # (a): polygons held to the plain version, over every vertex bucket
JOIN_PARITY = 8  # (b), (c): bench.py:746's n_par
JOIN_STORE = 64  # (d): polygons through join_rows_device on phase 7's store
JOIN_EDGE_TOL = 1e-5  # degrees: the f32 kernel's documented edge band (ops/join.py:9-14)
# least instructions of polygon_join on what its inputs need, as (ALU-only,
# all), whatever implements it: each row inside a bbox has its parity taken
# (one add), and each (in-bbox row, edge) whose edge straddles the row's
# horizontal line has the reference's xint and compare: y - y1, the
# product, the division, the sum, the compare and the parity's XOR, six
# single-rounded operations (an edge's x2 - x1 and y2 - y1 are shared by
# its rows and left out). The division alone issues several instructions
# in the kernel's SASS (a reciprocal and its Newton steps), so 6 is a
# floor. Rows outside every bbox and edges that straddle no row need no
# work: extents and y-bands skip them. No split by pipe is claimed.
JOIN_ROW_OPS = (0, 1)
JOIN_STRADDLE_OPS = (0, 6)
# the earlier floor, kept beside it as join_floor_all_edges: 6 instructions
# a tested row (its bbox test and the 64-bit row bound) and 4 a (row
# inside the bbox, edge) over every edge of the ring, from the SASS of the
# one-CTA-per-pair kernel (its edge loop's compare and bit per row)
JOIN_ALL_ROW_OPS = (0, 6)
JOIN_ALL_EDGE_OPS = (0, 4)
# (e): the adversarial set's block sizes (9216: a full tile and a part)
JOIN_ADVERSARIAL_BLOCKS = (4096, 8192, 9216)


def join_work(x, y, true_n: int, buckets, block: int) -> tuple[dict, int, list]:
    """The work of one config-4 run of ``polygon_join`` over ``buckets``
    (per bucket its arguments ``(pair_poly, pair_blk, verts, nverts,
    bbox)`` on the card), counted from the data: ``polygon_join_work``
    summed over the buckets; the bytes any implementation moves: every
    distinct block's x and y read once (8 B a row), the pair lists (8 B a
    pair), the rings, bboxes and vertex counts read and the counts written
    once; and per bucket its bands per polygon as {bands: polygons}.
    Returns (work, bytes, bands)."""
    import collections

    import torch

    from geomesa_tpu_torch.ops.kernels import polygon_band_count, polygon_join_work

    work: dict = {}
    blocks, nbytes, bands = [], 0, []
    for pp, pb, verts, nverts, bbox in buckets:
        w = polygon_join_work(x, y, true_n, pp, pb, verts, nverts, bbox, block, chunk=256)
        for key, val in w.items():
            work[key] = work.get(key, 0) + (val[0] if key == "candidates" else val)
        blocks.append(pb)
        nbytes += 8 * pp.shape[0] + bbox.shape[0] * (16 + 4 + 4) + 8 * int(nverts.sum())
        bands.append((verts.shape[1], dict(sorted(collections.Counter(
            polygon_band_count(int(c)) for c in nverts.tolist()).items()))))
    distinct = int(torch.unique(torch.cat(blocks)).numel())
    nbytes += 8 * block * distinct
    work["distinct_blocks"] = distinct
    return work, nbytes, bands


def join_floor(work: dict) -> tuple[int, int]:
    """The least instructions of ``polygon_join`` on the counted ``work``
    (:data:`JOIN_ROW_OPS` a row inside a bbox, :data:`JOIN_STRADDLE_OPS` a
    straddling (row, edge)), as (ALU-only, all)."""
    return tuple(JOIN_ROW_OPS[i] * work["in_rows"] + JOIN_STRADDLE_OPS[i] * work["straddles"]
                 for i in (0, 1))


def join_floor_all_edges(work: dict) -> tuple[int, int]:
    """The earlier floor on the same work: :data:`JOIN_ALL_ROW_OPS` a
    tested row and :data:`JOIN_ALL_EDGE_OPS` a (row inside the bbox, edge)
    over every edge."""
    return tuple(JOIN_ALL_ROW_OPS[i] * work["tested_rows"]
                 + JOIN_ALL_EDGE_OPS[i] * work["edge_tests"] for i in (0, 1))


def check_join_adversarial(dev, seed: int) -> tuple[int, int]:
    """(e): ``polygon_join`` against ``polygon_join_plain`` on the card over
    adversarial inputs, for each block size of
    :data:`JOIN_ADVERSARIAL_BLOCKS`: rings of 8, 95 and 512 vertices (each
    also with its y snapped to 5 levels: horizontal edges), one with a
    zero-height bbox, one with a vertex count of V (its padding counted),
    one of 3 vertices; rows on each ring's y-band boundaries (the f32 of
    ``ymin + j / inv`` and two ulps either side), on every vertex y, a few
    NaN, the rest uniform over the rings, in random order; pairs as every
    (polygon, block) with a tenth duplicated and four out of range, once in
    random order and once ordered by block, and ``pair_poly = None``.
    Returns (max abs error, cases)."""
    import torch

    from geomesa_tpu_torch.ops.kernels import (
        band_grid, polygon_band_count, polygon_join, polygon_join_plain)
    from geomesa_tpu_torch.workload import star_ring

    rng = np.random.default_rng(seed)
    v = 512
    rings = [star_ring(rng, nv, rng.uniform(-0.2, 0.2), rng.uniform(-0.2, 0.2), 1.0, 0.8,
                       levels) for nv in (8, 95, 512) for levels in (0, 5)]
    rings += [star_ring(rng, 95, 0.1, -0.1, 0.9, 0.9), star_ring(rng, 40, 0.0, 0.0, 1.1, 0.7),
              np.array([[-0.5, -0.5], [0.5, 0.2], [-0.5, -0.5]], np.float32)]
    k = len(rings)
    verts = np.zeros((k, v, 2), np.float32)
    nverts = np.zeros(k, np.int32)
    bbox = np.zeros((k, 4), np.float32)
    for i, r in enumerate(rings):
        verts[i, :len(r)], verts[i, len(r):] = r, r[-1]
        nverts[i] = len(r)
        bbox[i] = [r[:, 0].min(), r[:, 1].min(), r[:, 0].max(), r[:, 1].max()]
    nverts[6] = v  # any count from the real one to V gives the same answer
    bbox[7, 1] = bbox[7, 3] = rings[7][3, 1]  # zero height: one band
    special_y = [verts[:, :, 1].ravel()]
    for i in range(k):
        nb, inv = band_grid(torch.from_numpy(bbox[i]),
                            torch.tensor(polygon_band_count(int(nverts[i]))))
        for j in range(1, int(nb)):
            at = np.float32(np.float32(j) / np.float32(inv) + bbox[i, 1])
            near = [at]
            for step in (np.inf, -np.inf):
                u = at
                for _ in range(2):
                    u = np.nextafter(u, np.float32(step))
                    near.append(u)
            special_y.append(np.array(near, np.float32))
    special_y = np.concatenate(special_y).astype(np.float32)
    err = cases = 0
    for block in JOIN_ADVERSARIAL_BLOCKS:
        n = block * 12
        xs = rng.uniform(-1.3, 1.3, n).astype(np.float32)
        ys = rng.uniform(-1.0, 1.0, n).astype(np.float32)
        m = min(len(special_y), n // 2)
        ys[:m] = special_y[rng.permutation(len(special_y))[:m]]
        xs[n // 2:n // 2 + 8], ys[n // 2 + 8:n // 2 + 16] = np.nan, np.nan
        order = rng.permutation(n)
        x, y = (torch.from_numpy(np.ascontiguousarray(a[order])).to(dev) for a in (xs, ys))
        n_blocks = n // block
        pp = np.repeat(np.arange(k), n_blocks)
        pb = np.tile(np.arange(n_blocks), k)
        dup = rng.choice(len(pp), len(pp) // 10, replace=False)
        pp = np.concatenate([pp, pp[dup], [k, -1, 0, 0]])
        pb = np.concatenate([pb, pb[dup], [0, 0, n_blocks, -1]])
        shuffle = rng.permutation(len(pp))
        by_block = np.argsort(pb, kind="stable")
        dv, dn, db = (torch.from_numpy(a).to(dev) for a in (verts, nverts, bbox))
        true_n = n - 1000
        for pairs in ((pp[shuffle], pb[shuffle]), (pp[by_block], pb[by_block]), (None, None)):
            tp, tb = ((None, None) if pairs[0] is None else
                      (torch.from_numpy(a.astype(np.int32)).to(dev) for a in pairs))
            args = (x, y, true_n, tp, tb, dv, dn, db, block)
            got = polygon_join(*args)
            want = polygon_join_plain(*args)
            torch.cuda.synchronize()
            err = max(err, int((got.long() - want.long()).abs().max()))
            if int(want.sum()) == 0:
                raise AssertionError("the adversarial set counts no row: it tests nothing")
            cases += 1
    if err:
        raise AssertionError(f"polygon_join disagrees with polygon_join_plain on the "
                             f"adversarial set by {err}")
    return err, cases


def edge_distance(xs, ys, ring) -> np.ndarray:
    """f64 distance from each point to the nearest segment of a closed ring."""
    x1, y1 = ring[:-1, 0][None, :], ring[:-1, 1][None, :]
    dx, dy = ring[1:, 0][None, :] - x1, ring[1:, 1][None, :] - y1
    px, py = xs[:, None], ys[:, None]
    len2 = dx * dx + dy * dy
    t = np.clip(np.where(len2 > 0, ((px - x1) * dx + (py - y1) * dy) / np.where(
        len2 > 0, len2, 1.0), 0.0), 0.0, 1.0)
    return np.sqrt(((px - x1 - t * dx) ** 2 + (py - y1 - t * dy) ** 2).min(axis=1))


def config4_path(dev, lon, lat, ds, store_type: str, n_polys: int, iters: int) -> list[dict]:
    """Phase 8: bench config 4 (``bench.py:629``) at full size over phase
    7's points, and the store joins on phase 7's ``DataStore``; returns the
    polygon_join and the join's planned_gather records."""
    import torch

    from geomesa_tpu_torch.curve.sfc import Z2SFC
    from geomesa_tpu_torch.geometry.predicates import points_within_geom
    from geomesa_tpu_torch.ops import kernels
    from geomesa_tpu_torch.ops.join import (
        membership, pack_polygons, pack_polygons_bucketed, points_in_polygons_count,
        polygon_block_plan)
    from geomesa_tpu_torch.ops.kernels import (
        JOIN_BLOCK, planned_gather, planned_gather_plain, polygon_join, polygon_join_plain,
        z2_encode)
    from geomesa_tpu_torch.parallel.query import FULL_WINDOW, block_join_step, join_pairs
    from geomesa_tpu_torch.process.join import (
        join_counts_auto, join_rows_device, join_within_device)
    from geomesa_tpu_torch.store.backends import int_boxes
    from geomesa_tpu_torch.workload import join_polygons

    on_card = dev.type == "cuda"
    n, k, block = len(lon), n_polys, JOIN_BENCH_BLOCK
    t0 = time.perf_counter()
    polys = join_polygons(k, seed=5)
    log(f"phase 8 synth: {time.perf_counter() - t0:.3f} s ({k} polygons, seed 5; the {n} points "
        "are phase 7's)")
    if on_card:
        torch.cuda.reset_peak_memory_stats()

    # -- build: z2 keys on the card, sort, the f32 columns in z2 order ----------
    t0 = time.perf_counter()
    xi, yi = Z2SFC().normalized(lon, lat)
    z = z2_encode(torch.from_numpy(xi).to(dev), torch.from_numpy(yi).to(dev))
    del xi, yi
    zs, perm = torch.sort(z, stable=True)
    del z
    pad_n = -(-n // block) * block
    xs = torch.zeros(pad_n, dtype=torch.float32, device=dev)
    ys = torch.zeros(pad_n, dtype=torch.float32, device=dev)
    xs[:n] = torch.from_numpy(lon.astype(np.float32)).to(dev)[perm]
    ys[:n] = torch.from_numpy(lat.astype(np.float32)).to(dev)[perm]
    padz = np.concatenate([zs.cpu().numpy().view(np.uint64),
                           np.full(pad_n - n, 2**63, dtype=np.uint64)])
    del zs, perm
    if on_card:
        torch.cuda.synchronize()
    build_s = time.perf_counter() - t0

    # -- plan: per bucket, each polygon's candidate blocks ----------------------
    t0 = time.perf_counter()
    buckets = pack_polygons_bucketed(polys)
    plans = []
    pruned_pairs = 0
    for ids, verts, bbox, nverts in buckets:
        offsets, blocks = polygon_block_plan(padz, bbox.astype(np.float64), block, pad_n)
        plans.append((ids, verts, bbox, nverts, offsets, blocks,
                      join_pairs(offsets, blocks, dev)))
        pruned_pairs += len(blocks) * block
    plan_s = time.perf_counter() - t0
    log(f"phase 8 build: {build_s:.3f} s (z2 keys by z2_encode, sort, f32 x and y in z2 order "
        f"on the card: {2 * 4 * pad_n} bytes); plan: {plan_s:.3f} s for {k} polygons in "
        f"{len(plans)} vertex buckets ({[p[1].shape[1] for p in plans]})")

    def run():
        counts = np.zeros(k, dtype=np.int64)
        for ids, verts, bbox, nverts, _, _, pairs in plans:
            counts[ids] = block_join_step(xs, ys, n, pairs, verts, bbox, nverts,
                                          block).cpu().numpy()
        return counts

    for name in kernels.launches:
        kernels.launches[name] = 0
    t0 = time.perf_counter()
    counts = run()
    first_ms = (time.perf_counter() - t0) * 1e3
    launched = dict(kernels.launches)
    log(f"phase 8 launches: {launched}")
    if on_card and launched["polygon_join"] != len(plans):
        raise AssertionError(f"config 4's run must launch polygon_join once a bucket: {launched}")
    runs = []
    for _ in range(iters):
        t0 = time.perf_counter()
        again = run()
        runs.append((time.perf_counter() - t0) * 1e3)
        if not np.array_equal(again, counts):
            raise AssertionError("config 4's counts changed between runs")
    run_ms = p50(runs)
    log(f"phase 8 join: {pruned_pairs} tested pairs ({pruned_pairs // block} (polygon, block) "
        f"pairs of {block} rows), tested fraction {pruned_pairs / (n * k):.6f}, prune factor "
        f"{n * k / max(pruned_pairs, 1):.2f}; {int(counts.sum())} hits")
    log(f"phase 8 join run: first {first_ms:.3f} ms, p50 {run_ms:.3f} ms over {iters} runs (min "
        f"{min(runs):.3f}, max {max(runs):.3f}; host clock, each ending in the counts' copy); "
        f"tested {pruned_pairs / (run_ms / 1e3) / 1e9:.4f} Gpairs/s (bench config 4's metric), "
        f"effective {n * k / (run_ms / 1e3) / 1e9:.4f} Gpairs/s")

    # -- checks ---------------------------------------------------------------------
    t0 = time.perf_counter()
    # each bucket's polygon_join arguments after (x, y, true_n), before block
    dev_args = [(*pairs, *(torch.from_numpy(a).to(dev) for a in (verts, nverts, bbox)))
                for _, verts, bbox, nverts, _, _, pairs in plans]
    # (a) the kernel against its plain version over >= 256 polygons, every bucket
    take = [min(-(-JOIN_CHECKED // len(plans)), len(p[0])) for p in plans]
    for b, p in enumerate(plans):  # the small buckets' shortfall from the others
        take[b] += min(max(0, JOIN_CHECKED - sum(take)), len(p[0]) - take[b])
    checked = err = 0
    for (ids, verts, bbox, nverts, offsets, blocks, _), m in zip(plans, take):
        sub = join_pairs(offsets[:m + 1], blocks[:offsets[m]], dev)
        args = (xs, ys, n, *sub, *(torch.from_numpy(a[:m]).to(dev) for a in (verts, nverts,
                                                                           bbox)), block)
        want = polygon_join_plain(*args)
        if on_card:
            got = polygon_join(*args)
            torch.cuda.synchronize()
            err = max(err, int((got.long() - want.long()).abs().max()))
        if not np.array_equal(want.cpu().numpy(), counts[ids[:m]]):
            raise AssertionError("polygon_join_plain disagrees with config 4's counts")
        checked += m
    if err:
        raise AssertionError(f"polygon_join disagrees with polygon_join_plain by {err}")
    # (b) the bench's parity: pruned counts == the unpruned count over every point
    vb, bb, nvb = pack_polygons(polys[:JOIN_PARITY], max_vertices=128)
    dvb, dbb, dnvb = (torch.from_numpy(a).to(dev) for a in (vb, bb, nvb))
    full_plain = polygon_join_plain(xs, ys, n, None, None, dvb, dnvb, dbb, block).cpu().numpy()
    full_kernel = points_in_polygons_count(xs, ys, vb, bb, nvb, true_n=n).cpu().numpy()
    if not (np.array_equal(full_plain, counts[:JOIN_PARITY])
            and np.array_equal(full_kernel, counts[:JOIN_PARITY])):
        raise AssertionError(f"pruned counts {counts[:JOIN_PARITY]} differ from the unpruned "
                             f"plain {full_plain} or kernel {full_kernel} counts")
    # (c) the f32 counts against the f64 predicate over the rows near each bbox
    disagree = []
    for i in range(JOIN_PARITY):
        g = polys[i]
        x1, y1, x2, y2 = g.bbox
        near = np.nonzero((lon >= x1 - 1e-4) & (lon <= x2 + 1e-4) & (lat >= y1 - 1e-4)
                          & (lat <= y2 + 1e-4))[0]
        f64 = points_within_geom(lon[near], lat[near], g)
        f32 = membership(*(torch.from_numpy(v[near].astype(np.float32)).to(dev)
                           for v in (lon, lat)), torch.from_numpy(vb[i]).to(dev),
                         torch.from_numpy(bb[i]).to(dev)).cpu().numpy()
        if int(f32.sum()) != counts[i]:
            raise AssertionError(f"polygon {i}: the f32 rows {int(f32.sum())} are not its "
                                 f"count {counts[i]}")
        diff = near[f32 != f64]
        far = edge_distance(lon[diff], lat[diff], g.shell) if len(diff) else np.zeros(0)
        if (far > JOIN_EDGE_TOL).any():
            raise AssertionError(f"polygon {i}: rows {diff[far > JOIN_EDGE_TOL].tolist()} "
                                 f"differ from the f64 predicate farther than {JOIN_EDGE_TOL} "
                                 "degrees from an edge")
        disagree.append((int(len(diff)), float(far.max()) if len(far) else 0.0))
    log(f"phase 8 checks: ok in {time.perf_counter() - t0:.3f} s ((a) polygon_join equals "
        f"polygon_join_plain on the pruned pairs of {checked} polygons over {len(plans)} "
        f"buckets, max_abs_err {err}; (b) the first {JOIN_PARITY} polygons' pruned counts equal "
        f"the unpruned plain and kernel counts over all {n} points; (c) f32 against the f64 "
        f"predicate: (disagreements, farthest from an edge in degrees) {disagree})")

    # -- (d) the store's joins on phase 7's 100M-row DataStore -----------------------
    t0 = time.perf_counter()
    store_polys = polys[:JOIN_STORE]
    for name in kernels.launches:
        kernels.launches[name] = 0
    t1 = time.perf_counter()
    _, found = join_rows_device(ds, store_type, store_polys)
    rows_ms = (time.perf_counter() - t1) * 1e3
    join_launched = dict(kernels.launches)
    log(f"phase 8 join_rows_device launches: {join_launched}")
    if on_card and join_launched["planned_gather"] < 1:
        raise AssertionError("join_rows_device must launch planned_gather")
    lon_d, lat_d = (torch.from_numpy(v).to(dev) for v in (lon, lat))
    found_rows = 0
    for (i, rows), g in zip(found, store_polys):
        x1, y1, x2, y2 = g.bbox
        cand = torch.nonzero((lon_d >= x1) & (lon_d <= x2) & (lat_d >= y1)
                             & (lat_d <= y2)).flatten().cpu().numpy()
        want = cand[points_within_geom(lon[cand], lat[cand], g)]
        if not np.array_equal(np.sort(rows), want):
            raise AssertionError(f"join_rows_device polygon {i}: {len(rows)} rows, the f64 "
                                 f"referee {len(want)}")
        found_rows += len(rows)
    del lon_d, lat_d
    st = ds._state(store_type)
    state, z2 = st.backend_state["z2"], st.indices["z2"]
    sbb = np.array([g.bbox for g in store_polys])
    s_off, s_blocks = polygon_block_plan(z2.zs, sbb, JOIN_BLOCK, state.rows_per_shard)
    pair_q = np.repeat(np.arange(JOIN_STORE, dtype=np.int32), np.diff(s_off))
    boxes = torch.from_numpy(int_boxes([tuple(b) for b in sbb]).reshape(-1, 1, 4)).to(dev)
    times = torch.from_numpy(np.tile(FULL_WINDOW, (JOIN_STORE, 1)).reshape(-1, 1, 4)).to(dev)
    pq, pb = (torch.from_numpy(a.astype(np.int32)).to(dev) for a in (pair_q, s_blocks))
    cols = state.spatial_cols()
    gargs = (*cols, state.n, pq, pb, boxes, times)
    g_pos, g_hits = planned_gather(*gargs)
    w_pos, w_hits = planned_gather_plain(*gargs)
    if not (torch.equal(g_pos, w_pos) and torch.equal(g_hits, w_hits)):
        raise AssertionError("planned_gather disagrees with plain on the join's pairs")
    within = join_within_device(ds, store_type, polys[:JOIN_PARITY], max_vertices=128)
    if not np.array_equal(within, full_plain):
        raise AssertionError(f"join_within_device {within} differs from the plain count "
                             f"{full_plain}")
    auto, route = join_counts_auto(ds, store_type, store_polys)
    if not np.array_equal(auto, [len(r) for _, r in found]) and route == "block":
        raise AssertionError("join_counts_auto's block counts differ from join_rows_device's")
    log(f"phase 8 store joins: ok in {time.perf_counter() - t0:.3f} s (join_rows_device of "
        f"{JOIN_STORE} polygons {rows_ms:.3f} ms, {found_rows} rows equal to the f64 referee; "
        f"{len(pair_q)} (polygon, {JOIN_BLOCK}-row block) pairs, planned_gather equals "
        f"planned_gather_plain ({int(w_hits.sum())} candidates); join_within_device of "
        f"{JOIN_PARITY} polygons equals the plain count; join_counts_auto took route "
        f"{route!r})")

    # -- (e) the adversarial set, on the card ---------------------------------------
    if on_card:
        t0 = time.perf_counter()
        adv_err, adv_cases = check_join_adversarial(dev, 43)
        err = max(err, adv_err)
        log(f"phase 8 adversarial: ok in {time.perf_counter() - t0:.3f} s ((e) polygon_join "
            f"equals polygon_join_plain in {adv_cases} cases: blocks "
            f"{JOIN_ADVERSARIAL_BLOCKS}, rings of 3, 8, 40, 95 and 512 vertices with and without "
            "horizontal edges, a zero-height bbox, nverts = V, rows on band boundaries, vertex "
            "y's and NaN, pairs duplicated, out of range, shuffled, by block and None)")

    p_record = {"name": "polygon_join", "route": "cuda",
                "source": "geomesa_tpu_torch/csrc/polygon_join.cu",
                "replaces": "geomesa_tpu/ops/join.py:357",
                "launches": launched["polygon_join"], "library_ms": None}
    g_record = {"name": "planned_gather_join", "route": "cuda",
                "source": "geomesa_tpu_torch/csrc/planned_gather.cu",
                "replaces": "geomesa_tpu/ops/join.py:300",
                "launches": join_launched["planned_gather"], "library_ms": None}
    if on_card:
        k_ms = cuda_ms(lambda: [polygon_join(xs, ys, n, *a, block) for a in dev_args], 5)
        k_plain_ms = cuda_ms(lambda: [polygon_join_plain(xs, ys, n, *a, block)
                                      for a in dev_args], 1)
        t0 = time.perf_counter()
        work, nbytes, bands = join_work(xs, ys, n, dev_args, block)
        if work["tested_rows"] > pruned_pairs:
            raise AssertionError("join_work counts more rows than the plan tests")
        log(f"phase 8 polygon_join work: {work['items']} work items of at most "
            f"{kernels.POLYGON_RUN} pairs over {work['pairs']} pairs, {work['stages']} tiles "
            f"staged ({work['distinct_blocks']} distinct blocks); {work['groups']} "
            f"{kernels.POLYGON_GROUP_ROWS}-row groups, {work['groups'] - work['groups_met']} "
            f"skipped by extent, {work['warps_any']} with a row inside the bbox; "
            f"{work['tested_rows']} tested rows, {work['in_rows']} compacted (inside a bbox); "
            f"(row, edge) tests: {work['edge_tests']} over every edge, {work['candidates']} band "
            f"candidates, {work['straddles']} straddling; bands per bucket (V, {{bands: "
            f"polygons}}) {bands}; counted in {time.perf_counter() - t0:.3f} s")
        ops = join_floor(work)
        ops_all = join_floor_all_edges(work)
        if ops[1] > ops_all[1]:
            raise AssertionError("join_floor is above the all-edges floor on the same data")
        p_record.update(max_abs_err=err, ms=k_ms, plain_ms=k_plain_ms,
                        **bound_fields(ops, nbytes))
        share = p_record["bound_ms"] / k_ms
        all_edges = bound_fields(ops_all, nbytes)
        p_record["bound_all_edges_ms"] = all_edges["bound_ms"]  # the earlier floor, kept beside
        log(f"phase polygon_join timing: {k_ms:.4f} ms (CUDA events, 5 runs of {len(plans)} "
            f"launches) at N={n} K={k} block={block}; plain {k_plain_ms:.4f} ms; bound "
            f"{p_record['bound_ms']:.4f} ms ({p_record['bound_by']}: {ops[1]} instructions over "
            f"{work['in_rows']} rows inside a bbox and {work['straddles']} straddling (row, "
            f"edge) tests; {nbytes} bytes), {share:.4f} of it")
        log(f"phase polygon_join join_floor_all_edges: {all_edges['bound_ms']:.4f} ms "
            f"({all_edges['bound_by']}: {ops_all[1]} instructions over {work['tested_rows']} "
            f"tested rows and {work['edge_tests']} (row inside a bbox, edge) tests over every "
            f"edge), {all_edges['bound_ms'] / k_ms:.4f} of the kernel's time")
        if share > 1:
            raise AssertionError(f"polygon_join reads {share:.4f} of its bound: the bound's "
                                 "count is wrong")
        g_ms = cuda_ms(lambda: planned_gather(*gargs), 5)
        g_plain_ms = cuda_ms(lambda: planned_gather_plain(*gargs), 1)
        g_ops, g_bytes = gather_floor(cols, state.n, pq, pb, boxes, times, w_hits,
                                      g_pos.element_size())
        g_record.update(max_abs_err=0, ms=g_ms, plain_ms=g_plain_ms,
                        **bound_fields(g_ops, g_bytes))
        g_share = g_record["bound_ms"] / g_ms
        log(f"phase planned gather (join): {g_ms:.4f} ms (CUDA events, 5 calls) for "
            f"{len(pair_q)} pairs over {len(np.unique(s_blocks))} distinct blocks, "
            f"{int(w_hits.sum())} candidates; plain {g_plain_ms:.4f} ms; bound "
            f"{g_record['bound_ms']:.4f} ms ({g_record['bound_by']}), {g_share:.4f} of it")
        if g_share > 1:
            raise AssertionError(f"planned_gather reads {g_share:.4f} of its bound on the join")
        log(f"phase 8 memory: max_memory_allocated {torch.cuda.max_memory_allocated()} bytes")
    return [p_record, g_record]


def stream_path(dev, max_err: int, n_rows: int, n_chunks: int, n_queries: int) -> dict:
    """Phase 4: the standing-query stream at bench config 8's width; returns
    the batched_count_hits record."""
    import torch

    from geomesa_tpu_torch.ops import kernels
    from geomesa_tpu_torch.ops.kernels import batched_count_hits, batched_count_hits_plain
    from geomesa_tpu_torch.stream.matrix import SubscriptionMatrix
    from geomesa_tpu_torch.stream.pipeline import DeviceStreamScanner
    from geomesa_tpu_torch.workload import (
        STREAM_MAX_OFF, make_queries, pack_query_boxes, stream_chunk)

    on_card = dev.type == "cuda"
    qboxes = pack_query_boxes(make_queries(n_queries)[0])
    full_window = np.array([[0, 0, n_chunks, STREAM_MAX_OFF]], np.int32)
    matrix = SubscriptionMatrix(device=dev, box_slots=1, time_slots=1, topk=STREAM_TOPK)
    delivered: dict[int, dict] = {}  # chunk seq → {query: (count, positions)}

    def on_hits(qi):
        def cb(batch):
            delivered.setdefault(batch.chunk, {})[qi] = (batch.count, batch.positions)
        return cb

    sids = [matrix.subscribe_packed(qboxes[i], full_window, on_hits(i))
            for i in range(n_queries)]
    snap = matrix.snapshot()
    slot_of = [snap.sids.index(sid) for sid in sids]

    # -- referee (untimed): the plain version on the card, every chunk ---------
    t0 = time.perf_counter()
    expected = []  # per chunk: (counts (Q,), newest-first positions per query)
    for c in range(n_chunks):
        cols = [torch.from_numpy(a).to(dev) for a in stream_chunk(c, n_rows)]
        counts, lane_pos = batched_count_hits_plain(
            *cols, 0, n_rows, snap.boxes_dev, snap.times_dev)
        counts, lane_pos = counts.cpu().numpy(), lane_pos.cpu().numpy()
        expected.append((
            [int(counts[s]) for s in slot_of],
            [np.sort(lane_pos[s][lane_pos[s] >= 0])[::-1].astype(np.int64) for s in slot_of],
        ))
    del cols
    log(f"phase stream referee: {time.perf_counter() - t0:.3f} s for {n_chunks} chunks "
        f"of {n_rows} rows ({sum(sum(e[0]) for e in expected)} matches)")

    def check_chunk(seq: int, c: int) -> int:
        """Deliveries of chunk ``seq`` (holding generator chunk ``c``) against
        the referee; a missing delivery counts as 0. Returns max |error|."""
        got = delivered.get(seq, {})
        want_counts, want_pos = expected[c]
        worst = 0
        for qi in range(n_queries):
            count, pos = got.get(qi, (0, np.empty(0, np.int64)))
            worst = max(worst, abs(count - want_counts[qi]))
            want = np.int64(seq) * n_rows + want_pos[qi]
            if len(pos) != len(want) or not np.array_equal(pos, want):
                raise AssertionError(f"stream chunk {seq} query {qi}: positions differ "
                                     "from the referee's top-k")
        if worst:
            raise AssertionError(f"stream chunk {seq}: counts differ from the referee by {worst}")
        return worst

    # -- the timed pipeline: producer thread → bounded queue → scanner ---------
    scanner = DeviceStreamScanner(matrix, chunk_rows=n_rows, max_pending_chunks=2,
                                  keep_tags=False)
    if scanner.chunk_rows != n_rows:
        raise AssertionError("stream chunk rows must be a multiple of 128")
    produced = {"busy_s": 0.0, "error": None}

    def producer():
        try:
            for c in range(n_chunks):
                t = time.perf_counter()
                cols = stream_chunk(c, n_rows)
                produced["busy_s"] += time.perf_counter() - t
                if not scanner.submit_chunk(*cols, block=True):
                    raise RuntimeError("scanner refused a chunk")
        except BaseException as e:  # re-raised on the main thread
            produced["error"] = e

    try:
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            kernels.path_blocks("batched_count_hits")
        for k in kernels.launches:
            kernels.launches[k] = 0
        prod = threading.Thread(target=producer, name="stream-producer", daemon=True)
        t_pipe = time.perf_counter()
        prod.start()
        prod.join(timeout=600.0)
        if prod.is_alive():
            raise AssertionError(f"the producer is still blocked after 600 s: "
                                 f"{scanner.stats()}\n{scanner.last_error}")
        drained = scanner.drain(timeout_s=300.0)
        pipeline_s = time.perf_counter() - t_pipe
        launched = dict(kernels.launches)
        stats = scanner.stats()
        if produced["error"] is not None:
            raise produced["error"]
        if not drained:
            raise AssertionError(f"stream drain timed out: {stats}\n{scanner.last_error}")
        if stats["scan_errors"] or stats["callback_errors"]:
            raise AssertionError(f"stream errors {stats}:\n{scanner.last_error}")
        log(f"phase stream launches: {launched}")
        if on_card:
            log("phase stream batched_count_hits row loops (blocks single-slot, general): "
                f"{kernels.path_blocks('batched_count_hits')}")
        if on_card and launched["batched_count_hits"] < n_chunks:
            raise AssertionError("the scanner did not launch batched_count_hits per chunk")
        worst = max(check_chunk(c, c) for c in range(n_chunks))
        total_rows = n_rows * n_chunks
        wait_s = stats["transfer_wait_s"]
        log(f"phase stream pipeline: {pipeline_s:.3f} s for {total_rows} rows x {n_queries} "
            f"queries: {total_rows / pipeline_s:.1f} rows/s, "
            f"{total_rows * n_queries / pipeline_s:.1f} row-queries/s end to end")
        log(f"phase stream transfer: transfer_wait_s {wait_s:.6f} "
            f"({wait_s / pipeline_s:.6f} of wall); h2d {stats['h2d_bytes']} bytes, "
            f"{stats['h2d_bytes'] / pipeline_s / 1e9:.3f} GB/s effective; scanner scan_s "
            f"{stats['scan_s']:.3f} over {stats['chunks']} chunks; producer busy "
            f"{produced['busy_s']:.3f} s; {stats['deliveries']} deliveries")
        if on_card:
            log(f"phase stream memory: max_memory_allocated "
                f"{torch.cuda.max_memory_allocated()} bytes")

        # -- churn (untimed): unsubscribe and resubscribe inside the bucket -----
        cap = matrix.capacity()
        matrix.unsubscribe(sids[-1])
        sids[-1] = matrix.subscribe_packed(qboxes[-1], full_window, on_hits(n_queries - 1))
        if matrix.capacity() != cap or matrix.snapshot().sids.index(sids[-1]) != slot_of[-1]:
            raise AssertionError("churn inside the bucket moved the capacity or the slot")
        cols = stream_chunk(0, n_rows)
        t0 = time.perf_counter()
        if not scanner.submit_chunk(*cols) or not scanner.drain(300.0):
            raise AssertionError("churn chunk was not scanned")
        churn_s = time.perf_counter() - t0
        stats = scanner.stats()
        if stats["scan_errors"] or stats["callback_errors"]:
            raise AssertionError(f"stream errors in the churn leg {stats}:\n{scanner.last_error}")
        worst = max(worst, check_chunk(n_chunks, 0))
        log(f"phase stream churn: ok, capacity {cap}, chunk {n_chunks} equals the referee; "
            f"submit to drain {churn_s:.3f} s for its {n_rows} rows, generation excluded")
    finally:
        scanner.close()

    record = {"name": "batched_count_hits", "route": "cuda",
              "source": "geomesa_tpu_torch/csrc/batched_count_hits.cu",
              "replaces": "geomesa_tpu/ops/pallas_kernels.py:217",
              "launches": launched["batched_count_hits"], "library_ms": None}
    if on_card:
        cols = [torch.from_numpy(a).to(dev) for a in stream_chunk(0, n_rows)]
        args = (*cols, 0, n_rows, snap.boxes_dev, snap.times_dev)
        got_c, got_p = batched_count_hits(*args)
        want_c, want_p = batched_count_hits_plain(*args)
        torch.cuda.synchronize()
        err = max(int((got_c.long() - want_c.long()).abs().max()),
                  int((got_p.long() - want_p.long()).abs().max()))
        if err != 0:
            raise AssertionError("batched_count_hits disagrees with plain at the stream shape")
        kernel_ms = cuda_ms(lambda: batched_count_hits(*args), 5)
        plain_ms = cuda_ms(lambda: batched_count_hits_plain(*args), 1)
        ops, nbytes, in_box, matches = hits_floor(*cols, snap.boxes_dev, snap.times_dev)
        if matches != int(want_c.long().sum()):
            raise AssertionError("live-slot count of the bound disagrees with the plain version")
        record.update(max_abs_err=max(max_err, worst, err), ms=kernel_ms, plain_ms=plain_ms,
                      **bound_fields(ops, nbytes))
        log(f"phase stream kernel timing: {kernel_ms:.4f} ms per chunk at N={n_rows} "
            f"Q={snap.capacity} B=1 T=1; plain {plain_ms:.4f} ms; bound "
            f"{record['bound_ms']:.4f} ms ({record['bound_by']}: {ops[0]} ALU-only of "
            f"{ops[1]} int32 ops; "
            f"{in_box} in-box row-queries; {matches} matches; {nbytes} bytes)")
    return record


# -- phase 9: bench config 5, line stores on the XZ indexes ----------------------

XZ_ROWS = 4_000_000  # bench config 5's M on an accelerator (bench.py:797)
XZ_TILES = 16  # K1 also timed at 16 x XZ_ROWS = 64M rows (1 GB of bbox columns)
XZ_CHECK_ROWS = 1_000_003  # phase 9a's rows
XZ_BATCHES = 20  # bench config 5's p50 batches (bench.py ITERS)
XZ_DATELINE = (130.0, 20.0, -90.0, 60.0)  # wraps the antimeridian: Tokyo and Mexico City
# least int32 instructions per (row, query, live box slot) of the overlap
# test: four signed compares (ISETP, each folding its AND into the
# predicate); the xhi/yhi sums are per slot, not per row
OVERLAP_SLOT_OPS = (4, 4)
# the overlap kernels' cull per loaded row: min of xmin and ymin, max of
# xmax and ymax (four IMNMX), plus with time the 64-bit key's min and max
# (four ISETP)
OVERLAP_EXTENT_OPS = {False: 4, True: 8}


def xz_int_columns(xmin, ymin, xmax, ymax):
    """Config 5's bounds normalized at 31 bits as bench.py:819-823 does
    (int32, by the port's normalizers)."""
    from geomesa_tpu_torch.curve.normalize import lat as norm_lat, lon as norm_lon

    nlon, nlat = norm_lon(31), norm_lat(31)
    return [nlon.normalize(xmin).astype(np.int32), nlat.normalize(ymin).astype(np.int32),
            nlon.normalize(xmax).astype(np.int32), nlat.normalize(ymax).astype(np.int32)]


def xz2_order(dev, xmin, ymin, xmax, ymax):
    """The xz2_sfc(12) codes of the boxes (host, as curve/xz.py computes
    them) sorted on the card (a stable torch.sort): the permutation."""
    import torch

    from geomesa_tpu_torch.curve.xz import xz2_sfc

    codes = xz2_sfc(12).index((xmin, ymin), (xmax, ymax))
    d = torch.from_numpy(codes.view(np.int64)).to(dev)
    return torch.sort(d, stable=True).indices.cpu().numpy()


def overlap_live(boxes, times):
    """Per query, its live box slots and live windows (the kernels' rule)."""
    lb = [sum(1 for xlo, xhi, ylo, yhi in b if xlo <= xhi and ylo <= yhi) for b in boxes.tolist()]
    if times is None:
        return [(n, 0) for n in lb]
    lt = [sum(1 for blo, olo, bhi, ohi in t if (blo, olo) <= (bhi, ohi)) for t in times.tolist()]
    return list(zip(lb, lt))


def overlap_floor(cols, n: int, boxes, times, keep, counts=None, hits=None,
                  capacity: int = 0):
    """The least work of the overlap kernels on these inputs, over the
    groups of rows their cull decides on: ``keep`` is the cull's kept
    (group, query) pairs, per 4096-row chunk (``overlap_chunk_pairs``: the
    floor as it stood before the kernels culled per warp) or per warp's 256
    rows (``overlap_warp_pairs``: the kernels' own unit). Bytes are each
    row of a group that some query keeps read once, 16 or 24 B, the payload
    read once and the counts written; operations are the kept (row, query)
    pairs' overlap and window compares (the cheaper order, live slots
    only), plus the extent pass's min/max over every loaded row
    (:data:`OVERLAP_EXTENT_OPS`). With ``counts`` and ``hits`` (the edge
    gather's form), the edge compares per matched (row, query) and live
    slot, per warp only where ``overlap_edge_possible`` lets the kernel run
    them, and 4 B per written candidate. ``cols`` are the (padded) resident
    columns, ``n`` the valid rows. Returns ((alu, all), bytes, matches)."""
    import torch

    from geomesa_tpu_torch.ops.kernels import (
        JOIN_BLOCK, OVERLAP_WARP_ROWS, overlap_edge_possible, overlap_masks, overlap_warp_rows)

    with_time = times is not None
    live = overlap_live(boxes, times)
    chunks = -(-cols[0].shape[0] // JOIN_BLOCK)
    padded = [torch.nn.functional.pad(c, (0, chunks * JOIN_BLOCK - c.shape[0])) for c in cols]
    dev = cols[0].device
    if keep.shape[0] == chunks:  # per chunk
        groups = torch.arange(chunks * JOIN_BLOCK, device=dev).view(chunks, JOIN_BLOCK)
    else:  # per warp
        groups = (torch.arange(chunks, device=dev)[:, None, None] * JOIN_BLOCK
                  + overlap_warp_rows().to(dev)[None]).view(-1, OVERLAP_WARP_ROWS)
    per_warp = keep.shape[0] != chunks
    ops = matches = 0
    for qi in range(boxes.shape[0]):
        g = torch.nonzero(keep[:, qi]).flatten()
        if g.numel() == 0:
            continue
        idx = groups.index_select(0, g)
        rows = [c[idx] for c in padded] + [None] * (6 - len(padded))
        valid = idx < n
        in_box, _ = overlap_masks(*rows[:4], None, None, boxes[qi:qi + 1], None)
        in_box = in_box.view(valid.shape) & valid
        r = int(valid.sum())
        lb, lt = live[qi]
        if with_time:
            key = rows[4].long() * 2**32 + rows[5].long()
            in_time = torch.zeros_like(valid)
            for t in times[qi].tolist():
                in_time |= (key >= t[0] * 2**32 + t[1]) & (key <= t[2] * 2**32 + t[3])
            in_time &= valid
            ops += min(r * OVERLAP_SLOT_OPS[0] * lb + int(in_box.sum()) * TIME_SLOT_OPS[0] * lt,
                       r * TIME_SLOT_OPS[0] * lt + int(in_time.sum()) * OVERLAP_SLOT_OPS[0] * lb)
            matched = (in_box & in_time).sum(dim=1)
        else:
            ops += r * OVERLAP_SLOT_OPS[0] * lb
            matched = in_box.sum(dim=1)
        matches += int(matched.sum())
        if counts is not None:  # the edge compares of the matched rows
            if per_warp:
                from geomesa_tpu_torch.ops.kernels import _time_keys

                possible = overlap_edge_possible(*rows[:4], _time_keys(rows[4], rows[5]),
                                                 boxes[qi:qi + 1], times[qi:qi + 1])[:, 0]
                matched = matched[possible]
            ops += int(matched.sum()) * (EDGE_BOX_SLOT_OPS * lb + EDGE_TIME_SLOT_OPS * lt)
    ops += OVERLAP_EXTENT_OPS[with_time] * cols[0].shape[0]
    kept_rows = int(keep.any(dim=1).sum()) * groups.shape[1]
    nbytes = (4 * len(cols) * kept_rows + 4 * boxes.numel()
              + (0 if times is None else 4 * times.numel()) + 4 * boxes.shape[0])
    if counts is not None:
        nbytes += 4 * boxes.shape[0] + 4 * int(hits.clamp(max=capacity).long().sum())
    return (ops, ops), nbytes, matches


def overlap_payload(rng, q: int, nb: int, nt: int, city_boxes, rows4, bins, offs):
    """(q, nb, 4) boxes and (q, nt, 4) windows for phase 9a: city boxes
    packed as a line store packs them (the overlap pad), boxes with an edge
    on a row's opposing bound (so that rows share an edge bucket with
    them), zero-size and whole-world boxes, live slots behind dead ones
    (both pads and inverted boxes), all-dead queries, and windows live,
    dead and unconstrained."""
    from geomesa_tpu_torch.ops.refine import pack_boxes, pack_times

    xmin, ymin, xmax, ymax = rows4
    top = 2**31 - 1
    dead = ([1, 0, 1, 0], [top, -1, top, -1], [top, 0, 0, top], [0, top, 5, 4])
    unconstrained = [0, -1, top, top]
    boxes = np.empty((q, nb, 4), np.int64)
    times = np.empty((q, nt, 4), np.int64)
    for qi in range(q):
        kind = qi % 7
        i = int(rng.integers(len(xmin)))
        x0, y0, x1, y1 = int(xmin[i]), int(ymin[i]), int(xmax[i]), int(ymax[i])
        if kind == 0:  # packed city boxes, the overlap pad behind them
            sel = city_boxes[rng.integers(len(city_boxes), size=int(rng.integers(1, nb + 1)))]
            boxes[qi] = pack_boxes(sel, slots=nb, overlap=True)
        else:
            boxes[qi] = [dead[int(rng.integers(len(dead)))] for _ in range(nb)]
            for s in rng.choice(nb, min(nb, int(rng.integers(1, 3))), replace=False):
                d = int(rng.integers(1, 2**24))
                if kind == 1:  # west edge on a row's xmax, south edge on its ymax
                    boxes[qi, s] = [x1, min(top, x1 + d), y1, min(top, y1 + d)]
                elif kind == 2:  # east edge on a row's xmin, north edge on its ymin
                    boxes[qi, s] = [max(0, x0 - d), x0, max(0, y0 - d), y0]
                elif kind == 3:  # zero-size, on a row's corner
                    boxes[qi, s] = [x0, x0, y1, y1]
                elif kind == 4:  # the whole world
                    boxes[qi, s] = [0, top, 0, top]
                elif kind == 6:  # zero width on the whole-world rows' xmax: all edge candidates
                    boxes[qi, s] = [top, top, 0, top]
                # kind 5: every slot dead
        ws = []
        for _ in range(nt):
            w, b = int(rng.integers(4)), int(bins[i])
            if w == 0:
                ws.append([1, 0, 0, -1])  # the pad
            elif w == 1:
                ws.append(unconstrained)
            elif w == 2:  # dead when it ends in its first bin before it starts
                ws.append([b, int(offs[i]), b + int(rng.integers(0, 3)),
                           int(rng.integers(0, DAY_MS))])
            else:
                ws.append([b - 1, int(rng.integers(0, DAY_MS)), b, int(offs[i])])
        if kind in (0, 6):  # packed: live windows first, the pad after
            live = [w for w in ws if (w[0], w[1]) <= (w[2], w[3])] or [unconstrained]
            times[qi] = pack_times(np.array(live if kind == 0 else [unconstrained], np.int32),
                                   slots=nt)
        else:
            times[qi] = ws
    return (np.ascontiguousarray(boxes.astype(np.int32)),
            np.ascontiguousarray(times.astype(np.int32)) if nt else None)


def overlap_rows(dev, n: int, seed: int):
    """Phase 9a's rows: ``n`` config-5 bboxes (seed 9) normalized, in xz2
    order, with adversarial rows spliced in: zero-size boxes, whole-world
    boxes and stamped invalid rows (xmin = ymin = INT32_MAX, xmax = ymax =
    -1); bins over 30 days and ms offsets. Returns (int columns (6,) in xz2
    order, their f64 city boxes as int boxes)."""
    from geomesa_tpu_torch.workload import xz_boxes

    rng = np.random.default_rng(seed)
    b = xz_boxes(n, 9)
    perm = xz2_order(dev, *b)
    cols = [c[perm] for c in xz_int_columns(*b)]
    top = 2**31 - 1
    spots = rng.choice(n, 3 * 300, replace=False).reshape(3, 300)
    for c in (0, 1):  # zero size: max = min
        cols[c + 2][spots[0]] = cols[c][spots[0]]
    for c in (0, 1):  # the whole world
        cols[c][spots[1]], cols[c + 2][spots[1]] = 0, top
    for c in (0, 1):  # stamped invalid
        cols[c][spots[2]], cols[c + 2][spots[2]] = top, -1
    bins = rng.integers(0, 30, n).astype(np.int32)
    offs = rng.integers(0, DAY_MS, n).astype(np.int32)
    return cols + [bins, offs]


def check_overlap_kernels(dev, n: int, seed: int) -> dict:
    """Phase 9a: ``batched_overlap`` (both forms), ``batched_edge_gather_overlap``
    and ``planned_gather_overlap`` against their plain versions on the card,
    exact, on config-5 rows in xz2 order and shuffled (see the module
    docstring). Returns max |difference| per kernel."""
    import torch

    from geomesa_tpu_torch.ops import kernels
    from geomesa_tpu_torch.ops.kernels import (
        EDGE_CAPACITY, JOIN_BLOCK, batched_edge_gather_overlap,
        batched_edge_gather_overlap_plain, batched_overlap, batched_overlap_plain,
        planned_gather_overlap, planned_gather_overlap_plain)
    from geomesa_tpu_torch.store.backends import int_boxes
    from geomesa_tpu_torch.workload import make_queries

    rng = np.random.default_rng(seed)
    host = overlap_rows(dev, n, seed)
    city = int_boxes(make_queries(256, 7)[0])
    worst = {"batched_overlap": 0, "batched_edge_gather_overlap": 0,
             "planned_gather_overlap": 0}
    overflowed = fitted = 0
    for order in ("xz2", "shuffled"):
        h = host
        if order == "shuffled":
            p = rng.permutation(n)
            h = [c[p] for c in host]
        cols = [torch.from_numpy(np.ascontiguousarray(c)).to(dev) for c in h]
        for nb, nt in ((1, 0), (8, 0), (1, 1), (8, 16)):
            for q in (1, 64, kernels.q_tile_for(nb, nt, kernel="batched_overlap") + 1):
                for base, true_n in ((0, n), (3 * 4096, 3 * 4096 + n - 777)):
                    bx, tm = overlap_payload(rng, q, nb, max(nt, 1), city, h[:4], h[4], h[5])
                    boxes = torch.from_numpy(bx).to(dev)
                    times = torch.from_numpy(tm).to(dev) if nt else None
                    c = cols if nt else cols[:4]
                    got = batched_overlap(c, base, true_n, boxes, times)
                    want = batched_overlap_plain(c, base, true_n, boxes, times)
                    torch.cuda.synchronize()
                    err = int((got.long() - want.long()).abs().max())
                    worst["batched_overlap"] = max(worst["batched_overlap"], err)
                    msg = (f"  batched_overlap {order} N={n} Q={q} B={nb} T={nt} base={base} "
                           f"true_n={true_n}: max_abs_err={err} (matches "
                           f"{int(want.long().sum())})")
                    if nt:  # the lanes' sort at several capacities, none at all included
                        for cap in (EDGE_CAPACITY, 8, 1, 0):
                            args = (cols, base, true_n, boxes, times, cap)
                            gc_, gp, gh = batched_edge_gather_overlap(*args)
                            wc, wp, wh = batched_edge_gather_overlap_plain(*args)
                            torch.cuda.synchronize()
                            e = max(int((gc_.long() - wc.long()).abs().max()),
                                    int((gc_.long() - want.long()).abs().max()),
                                    int((gh.long() - wh.long()).abs().max()))
                            hh = gh[:, 0].cpu().numpy()
                            fits = hh <= cap
                            lanes = gp[:, 0].cpu().numpy()
                            e = max(e, int(np.abs(lanes[fits] - wp[:, 0].cpu().numpy()[fits])
                                           .max(initial=0)))
                            if (~fits).any():
                                _, allp, _ = batched_edge_gather_overlap_plain(
                                    cols, base, true_n, boxes, times, int(hh.max()))
                                allp = allp[:, 0].cpu().numpy()
                                for k in np.nonzero(~fits)[0]:
                                    got_l = lanes[k]
                                    if (got_l < 0).any() or len(np.unique(got_l)) != cap \
                                            or (np.diff(got_l) <= 0).any() \
                                            or not np.isin(got_l, allp[k, :hh[k]]).all():
                                        e = max(e, 1)
                            overflowed += int((~fits).sum())
                            fitted += int(fits.sum())
                            worst["batched_edge_gather_overlap"] = max(
                                worst["batched_edge_gather_overlap"], e)
                            msg += (f"; edge gather cap={cap}: max_abs_err={e} (candidates "
                                    f"{int(hh.sum())}, {int((~fits).sum())} overflowed)")
                            err = max(err, e)
                    log(msg)
                    if err:
                        raise AssertionError(f"an overlap kernel disagrees with plain at {order} "
                                             f"N={n} Q={q} B={nb} T={nt} base={base}")
        # the planned gather's overlap form, on pair lists as select_many and worse make them
        padded = -(-n // JOIN_BLOCK) * JOIN_BLOCK
        pcols = [torch.from_numpy(np.concatenate([c, np.zeros(padded - n, np.int32)])).to(dev)
                 for c in h]
        n_blocks = padded // JOIN_BLOCK
        bx, tm = overlap_payload(rng, 65, 8, 16, city, h[:4], h[4], h[5])
        boxes, times = torch.from_numpy(bx).to(dev), torch.from_numpy(tm).to(dev)
        shared = int(rng.integers(n_blocks))
        rand_q = rng.integers(0, 65, 3000)
        rand_b = rng.integers(0, n_blocks, 3000)
        cases = [
            ("empty", [], [], n),
            ("last block", [64, 3], [n_blocks - 1] * 2, n - 100),
            ("shared block", list(range(65)), [shared] * 65, n),
            ("shared block x300", [i % 65 for i in range(300)], [shared] * 300, n),
            ("every block", [5] * n_blocks, list(range(n_blocks)), n),
            ("random, duplicated, out of order", list(rand_q) + list(rand_q[:500]),
             list(rand_b) + list(rand_b[:500]), n - 5000),
        ]
        for name, pq, pbk, true_n in cases:
            pq_t = torch.tensor(np.asarray(pq, np.int32), dtype=torch.int32, device=dev)
            pb_t = torch.tensor(np.asarray(pbk, np.int32), dtype=torch.int32, device=dev)
            before = kernels.launches["planned_gather_overlap"]
            got_p, got_h = planned_gather_overlap(pcols, true_n, pq_t, pb_t, boxes, times)
            want_p, want_h = planned_gather_overlap_plain(pcols, true_n, pq_t, pb_t, boxes, times)
            torch.cuda.synchronize()
            launched = kernels.launches["planned_gather_overlap"] - before
            same = torch.equal(got_p, want_p) and torch.equal(got_h, want_h)
            worst["planned_gather_overlap"] = max(worst["planned_gather_overlap"], 0 if same else 1)
            log(f"  planned_gather_overlap {order} {name}: {len(pq)} pairs over "
                f"{len(set(pbk))} distinct blocks, {int(want_h.sum())} rows, true_n={true_n}, "
                f"{launched} launch(es): {'equal' if same else 'DIFFERENT'}")
            if not same or launched != (1 if len(pq) else 0):
                raise AssertionError(f"planned_gather_overlap disagrees with plain at {name}")
        # pairs out of range count 0 and leave the in-range pairs' rows as they are
        oq = np.concatenate([rand_q[:200], [-1, 65, 70, 3, 4]]).astype(np.int32)
        ob = np.concatenate([rand_b[:200], [0, 1, 2, -1, n_blocks + 3]]).astype(np.int32)
        got_p, got_h = planned_gather_overlap(pcols, n, torch.from_numpy(oq).to(dev),
                                              torch.from_numpy(ob).to(dev), boxes, times)
        want_p, want_h = planned_gather_overlap_plain(
            pcols, n, torch.from_numpy(oq[:200]).to(dev), torch.from_numpy(ob[:200]).to(dev),
            boxes, times)
        torch.cuda.synchronize()
        same = (torch.equal(got_p, want_p) and torch.equal(got_h[:200], want_h)
                and int(got_h[200:].abs().sum()) == 0)
        log(f"  planned_gather_overlap {order} out of range: 5 pairs out of range among 205: "
            f"{'equal, 0 rows each' if same else 'DIFFERENT'}")
        if not same:
            raise AssertionError("planned_gather_overlap: pairs out of range must count 0")
    log(f"  overlap edge gather: {fitted} queries held every candidate, {overflowed} "
        f"overflowed their lanes")
    if not (overflowed and fitted):
        raise AssertionError("the overlap edge gather: queries that fit and that overflow "
                             "their lanes must both occur in phase 9a")
    return worst


def xz_int_referee(ib, boxes_f64, windows_ms=None, bins=None, offs=None):
    """Loose overlap counts by an independent numpy int-domain evaluation:
    ``ib`` the bounds normalized by :func:`norm31` (xmin, ymin, xmax, ymax,
    int64), each query box normalized the same way (a box that wraps the
    antimeridian as its two halves), and with ``windows_ms`` (day, ms of
    day) instants ``bins``/``offs`` with DURING's exclusive ends taken as
    [lo + 1, hi - 1]."""
    xmin, ymin, xmax, ymax = ib
    out = []
    for k, (x1, y1, x2, y2) in enumerate(boxes_f64):
        halves = [(x1, x2)] if x1 <= x2 else [(x1, 180.0), (-180.0, x2)]
        qy1, qy2 = norm31(y1, -90.0, 90.0), norm31(y2, -90.0, 90.0)
        m = np.zeros(len(xmin), bool)
        for a, b in halves:
            m |= ((xmin <= norm31(b, -180.0, 180.0)) & (xmax >= norm31(a, -180.0, 180.0))
                  & (ymin <= qy2) & (ymax >= qy1))
        if windows_ms is not None:
            lo, hi = windows_ms[k]
            (blo, olo), (bhi, ohi) = divmod(lo + 1, DAY_MS), divmod(hi - 1, DAY_MS)
            m &= (((bins > blo) | ((bins == blo) & (offs >= olo)))
                  & ((bins < bhi) | ((bins == bhi) & (offs <= ohi))))
        out.append(int(m.sum()))
    return out


def xz_f64_rows(b, box, window=None, t=None):
    """Exact rows of ``BBOX`` (its bbox-intersects semantics on each
    feature's f64 bounds ``b``, the antimeridian form included) ``AND
    DURING`` by brute force."""
    xmin, ymin, xmax, ymax = b
    x1, y1, x2, y2 = box
    if x1 > x2:
        mx = (xmax >= x1) | (xmin <= x2)
    else:
        mx = (xmax >= x1) & (xmin <= x2)
    m = mx & (ymax >= y1) & (ymin <= y2)
    if window is not None:
        m &= (t > window[0]) & (t < window[1])
    return np.nonzero(m)[0]


def config5_step(dev, m: int, tiles: int) -> tuple[dict, int]:
    """Phase 9b: bench config 5 as ``bench.py:787-860`` runs it. Returns
    the ``batched_overlap`` record's timing fields at config 5's shape and
    the kernel's launches by the bench's batches."""
    import torch

    from geomesa_tpu_torch.ops import kernels
    from geomesa_tpu_torch.ops.kernels import (
        batched_overlap, batched_overlap_plain, overlap_chunk_pairs, overlap_warp_pairs)
    from geomesa_tpu_torch.parallel.query import batched_overlap_step
    from geomesa_tpu_torch.parallel.residency import stage_columns
    from geomesa_tpu_torch.workload import make_queries, pack_query_boxes, xz_boxes

    t0 = time.perf_counter()
    b = xz_boxes(m, 9)
    synth_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    perm = xz2_order(dev, *b)
    host = {k: c[perm] for k, c in zip(("xmin", "ymin", "xmax", "ymax"), xz_int_columns(*b))}
    build_s = time.perf_counter() - t0
    cols, padded = stage_columns(host, dev)
    cols = [cols[k] for k in ("xmin", "ymin", "xmax", "ymax")]
    boxes_f64, _ = make_queries(N_QUERIES, 7)
    qboxes = pack_query_boxes(boxes_f64, overlap=True)
    dev_boxes = torch.from_numpy(qboxes).to(dev)
    q = len(boxes_f64)

    def run_batch():
        return batched_overlap_step(cols, m, dev_boxes).cpu().numpy()

    counts = run_batch()
    lat = []
    for _ in range(XZ_BATCHES):
        s = time.perf_counter()
        run_batch()
        lat.append((time.perf_counter() - s) * 1e3)
    launched = kernels.launches["batched_overlap"]
    per_query = p50(lat) / q
    # the bench's int-domain referee (bench.py:853-858) and its f64 boundary rows
    ix = [host[k] for k in ("xmin", "ymin", "xmax", "ymax")]
    cpu_int = [int(((ix[0] <= bq[1]) & (ix[2] >= bq[0]) & (ix[1] <= bq[3]) & (ix[3] >= bq[2]))
                   .sum()) for bq in qboxes[:, 0]]
    if counts.astype(np.int64).tolist() != cpu_int:
        raise AssertionError("config 5: batched_overlap_step counts != the bench's int referee")
    xmin, ymin, xmax, ymax = b
    cpu_f64 = [int(((xmin <= x2) & (xmax >= x1) & (ymin <= y2) & (ymax >= y1)).sum())
               for x1, y1, x2, y2 in boxes_f64]
    boundary = int(np.abs(np.array(cpu_int) - np.array(cpu_f64)).sum())
    log(f"phase 9b config 5: {m} trajectory bboxes (seed 9) in {synth_s:.3f} s, xz2_sfc(12) "
        f"codes and their sort on the card in {build_s:.3f} s; {q} city boxes (seed 7), one "
        f"overlap slot each; counts equal the bench's int referee ({sum(cpu_int)} matches), "
        f"f64 boundary rows {boundary}")
    log(f"phase 9b xz2_linestring_bbox_query_p50_latency: {per_query:.4f} ms per query "
        f"(p50 {p50(lat):.3f} ms a batch of {q} over {XZ_BATCHES} batches by host clock, "
        f"each ending in its counts' copy to the host; min {min(lat):.3f}, max "
        f"{max(lat):.3f})")

    if dev.type != "cuda":
        return {}, launched

    # the kernel alone, beside its plain version and its bound
    args = (cols, 0, m, dev_boxes)
    got = batched_overlap(*args)
    want = batched_overlap_plain(*args)
    torch.cuda.synchronize()
    err = int((got.long() - want.long()).abs().max())
    if err:
        raise AssertionError("batched_overlap disagrees with plain at config 5's shape")
    ms = cuda_ms(lambda: batched_overlap(*args), 10)
    dev_ms = device_ms(lambda: batched_overlap(*args))
    plain_ms = cuda_ms(lambda: batched_overlap_plain(*args), 1)
    keep = overlap_warp_pairs(*args)
    ops, nbytes, matches = overlap_floor(cols, m, dev_boxes, None, keep)
    c_ops, c_bytes, c_matches = overlap_floor(cols, m, dev_boxes, None, overlap_chunk_pairs(*args))
    if matches != int(want.long().sum()) or c_matches != matches:
        raise AssertionError("the overlap bound's count over the kept warps or chunks disagrees "
                             "with the plain version")
    chunk_floor = bound_fields(c_ops, c_bytes)
    rec = {"max_abs_err": err, "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
           **bound_fields(ops, nbytes)}
    share = rec["bound_ms"] / ms
    log(f"phase batched_overlap timing: {ms:.4f} ms (CUDA events, 10 launches), device "
        f"{fmt_ms(dev_ms)} (10 calls behind a spin: the kernel and the counts' zero fill) at "
        f"N={m} Q={q} "
        f"B=1, no time; plain {plain_ms:.4f} ms; bound {rec['bound_ms']:.6f} ms "
        f"({rec['bound_by']}: {ops[0]} int32 ops over {int(keep.sum())} kept of "
        f"{keep.numel()} (warp, query) pairs; {nbytes} bytes over "
        f"{int(keep.any(dim=1).sum())} of {keep.shape[0]} warps' rows), {share:.4f} of it; the "
        f"floor per chunk, as it stood before the per-warp cull, {chunk_floor['bound_ms']:.6f} ms "
        f"({chunk_floor['bound_by']}: {c_ops[0]} int32 ops; {c_bytes} bytes)")
    if share > 1:
        raise AssertionError(f"batched_overlap reads {share:.4f} of its bound")

    # the same rows repeated to 1 GB of columns
    big = [c[:m].repeat(tiles) for c in cols]
    del cols
    free_card()
    bn = m * tiles
    bargs = (big, 0, bn, dev_boxes)
    got = batched_overlap(*bargs)
    torch.cuda.synchronize()
    if got.long().tolist() != [tiles * v for v in cpu_int]:
        raise AssertionError(f"batched_overlap at {bn} rows != {tiles} x the config-5 counts")
    big_ms = cuda_ms(lambda: batched_overlap(*bargs), 5)
    big_dev = device_ms(lambda: batched_overlap(*bargs), 5)
    keep = overlap_warp_pairs(*bargs)
    b_ops, b_bytes, _ = overlap_floor(big, bn, dev_boxes, None, keep)
    big_rec = bound_fields(b_ops, b_bytes)
    big_chunk = bound_fields(*overlap_floor(big, bn, dev_boxes, None,
                                            overlap_chunk_pairs(*bargs))[:2])
    log(f"phase batched_overlap timing at {bn} rows (config 5's {m} rows in xz2 order, "
        f"repeated {tiles} times: {16 * bn} bytes of columns): {big_ms:.4f} ms (CUDA events, "
        f"5 launches), device {fmt_ms(big_dev)} (5 calls behind a spin); counts "
        f"{tiles} x config 5's; bound {big_rec['bound_ms']:.4f} ms "
        f"({big_rec['bound_by']}: {b_ops[0]} int32 ops over {int(keep.sum())} kept of "
        f"{keep.numel()} (warp, query) pairs; {b_bytes} bytes), "
        f"{big_rec['bound_ms'] / big_ms:.4f} of it; per chunk {big_chunk['bound_ms']:.4f} ms")
    if big_rec["bound_ms"] / big_ms > 1:
        raise AssertionError("batched_overlap at 64M rows reads more than its bound")
    del big
    free_card()
    return rec, launched


def planned_overlap_passes(cols, true_n: int, pair_q, pair_blk, boxes, times, plan):
    """``planned_gather_overlap``'s two passes as one call that does not
    synchronise, for :func:`device_ms`: its count and write entry points
    launched into outputs allocated here (the count pass's entry point
    writes the counts' prefix sum too), the positions' size (the wrapper's
    one read of the device) read once beforehand."""
    import torch

    from geomesa_tpu_torch.ops import kernels

    n_pairs = pair_q.shape[0]
    n_blocks = (plan.shape[0] - 2 * n_pairs - 1) // 2
    hits = torch.empty(n_pairs, dtype=torch.int64, device=plan.device)
    ends = torch.empty(n_pairs, dtype=torch.int64, device=plan.device)
    masks = torch.empty((n_pairs, kernels.JOIN_BLOCK // 16), dtype=torch.int16,
                        device=plan.device)
    stream = torch.cuda.current_stream(plan.device).cuda_stream
    count_fn = kernels._fn("geomesa_planned_gather_overlap_count")
    write_fn = kernels._fn("geomesa_planned_gather_write")
    count_args = ([c.data_ptr() for c in cols] + [cols[0].shape[0], int(true_n),
                  plan.data_ptr(), n_pairs, n_blocks, boxes.data_ptr(), times.data_ptr(),
                  boxes.shape[0], boxes.shape[1], times.shape[1], hits.data_ptr(),
                  ends.data_ptr(), masks.data_ptr(), stream])
    if count_fn(*count_args):
        raise RuntimeError("planned_gather_overlap's count pass failed")
    positions = torch.empty(int(ends[-1]), dtype=torch.int32, device=plan.device)
    write_args = (pair_blk.data_ptr(), n_pairs, hits.data_ptr(), ends.data_ptr(),
                  masks.data_ptr(), positions.data_ptr(), stream)

    def passes():
        if count_fn(*count_args) or (positions.numel() and write_fn(*write_args)):
            raise RuntimeError("planned_gather_overlap's passes failed")
    return passes


XZ_AGG_GROUPS = 1024  # phase 9c's group key: bench config 9's G
XZ_NULL_SHARE = 0.1  # phase 9c's value column: about a tenth of it null
XZ_DENSITY_QUERIES = 4  # density_many's queries on the line store: the host rasterization
XZ_WORLD = (-180.0, -90.0, 180.0, 90.0)  # the density viewport: every feature touches a cell


def agg_overlap_floor(cols, n: int, boxes, times, n_vals: int, cnt, hits, capacity: int,
                      n_groups: int):
    """The least work of ``grouped_agg_overlap`` on these inputs:
    operations are :func:`overlap_floor`'s over the (chunk, query) pairs
    the work list keeps (``overlap_chunk_pairs``), with the edge compares
    of every matched (row, query); bytes are :func:`agg_floor`'s at the
    bbox width: the six columns of every loaded row read once (24 B a row),
    ``gid``, ``rowid`` and the values of each row that folds in some query
    (8 + 8 V B), the payload read once and the outputs written once.
    Returns ((alu, all), bytes, distinct folded rows)."""
    import torch

    from geomesa_tpu_torch.ops import kernels

    keep = kernels.overlap_chunk_pairs(cols, 0, n, boxes, times)
    counts = cnt.long().sum(dim=1) + hits[:, 0].long()
    ops, _, _ = overlap_floor(cols, n, boxes, times, keep, counts, hits, capacity)
    folded = torch.zeros(cols[0].shape[0], dtype=torch.bool, device=cols[0].device)
    for s, e, m, edge in kernels._overlap_plain_masks(cols, 0, n, boxes, times, 1 << 20,
                                                      edges=True):
        folded[s:e] |= (m & ~edge).any(dim=0)
    distinct = int(folded.sum())
    q = boxes.shape[0]
    out_bytes = q * n_groups * 8 + q * n_vals * n_groups * 28 + q * capacity * 4 + q * 4
    nbytes = (24 * cols[0].shape[0] + distinct * (8 + 8 * n_vals)
              + 4 * (boxes.numel() + times.numel()) + out_bytes)
    return ops, nbytes, distinct


def xz_agg_leg(dev, ds, cqls, rows, gid, vals, exact) -> dict:
    """Phase 9c's aggregation and density legs on the line store ``ds``
    (type ``xz``): ``aggregate_many`` of the 64 city-box queries against
    :func:`agg_referee` over their f64 referee ``rows``, the overlap fold
    alone against its plain version, then ``density_many`` and the
    ``density`` hint. Returns the ``grouped_agg_overlap`` record's fields
    with its launches."""
    import torch

    from geomesa_tpu_torch.ops import kernels
    from geomesa_tpu_torch.ops.kernels import (
        EDGE_CAPACITY, grouped_agg_overlap, grouped_agg_overlap_plain)
    from geomesa_tpu_torch.planning.planner import Query

    on_card = dev.type == "cuda"
    for k in kernels.launches:
        kernels.launches[k] = 0
    s = time.perf_counter()
    answers = ds.aggregate_many("xz", cqls, group_by=["cat"], value_cols=["val"])
    first_ms = (time.perf_counter() - s) * 1e3
    ms = []
    for _ in range(5):
        ds.agg_cache.invalidate("xz")  # each call folds on the card, none is a cache hit
        s = time.perf_counter()
        ds.aggregate_many("xz", cqls, group_by=["cat"], value_cols=["val"])
        ms.append((time.perf_counter() - s) * 1e3)
    launched = dict(kernels.launches)
    if on_card and (launched["grouped_agg_overlap"], launched["agg_work_list"],
                    launched["grouped_agg"]) != (6, 6, 0):
        raise AssertionError(f"6 aggregate_many calls on the line store launched {launched}, not "
                             "6 overlap folds and 6 work lists")
    declined = sum(a is None for a in answers)
    t0 = time.perf_counter()
    for i, res in enumerate(answers):
        check_agg_answer(res, agg_referee(rows[i], gid, vals, XZ_AGG_GROUPS), f"line store {i}")
    log(f"phase 9c aggregate_many: first call {first_ms:.3f} ms (the group-id, row-id and value "
        f"staging included), p50 {p50(ms):.3f} ms over 5 (min {min(ms):.3f}, max {max(ms):.3f}) "
        f"for {len(cqls)} queries, {p50(ms) / len(cqls):.3f} ms per query; {declined} lanes None; "
        f"{sum(int(a['count'].sum()) for a in answers)} rows in "
        f"{sum(len(a['groups']) for a in answers)} groups; all {len(cqls)} equal the f64 numpy "
        f"fold over the referee's rows (groups in order; counts, value counts, min, max exact; "
        f"sums within {AGG_RTOL}) in {time.perf_counter() - t0:.3f} s; launches "
        f"{ {k: v for k, v in launched.items() if v} }")

    # -- density: the exact per-query path (the host rasterization) -----------------
    # the host rasterizes every matching line string in Python (the reference's
    # path): the queries with the fewest matches keep the leg inside the time limit
    order = [i for i in np.argsort(exact[:len(cqls)], kind="stable") if exact[i] > 0]
    picked = order[:XZ_DENSITY_QUERIES]
    dq = [cqls[i] for i in picked]
    exact = [exact[i] for i in picked]
    s = time.perf_counter()
    grids = ds.density_many("xz", dq, XZ_WORLD, 256, 256)
    dens_ms = (time.perf_counter() - s) * 1e3
    s = time.perf_counter()
    hint = ds.query("xz", Query(dq[0], hints={"density": {"bbox": XZ_WORLD, "width": 256,
                                                          "height": 256}}))
    hint_ms = (time.perf_counter() - s) * 1e3
    for i, g in enumerate(grids):
        if g.shape != (256, 256) or not np.isfinite(g).all() or (g < 0).any() \
                or abs(g.sum() - exact[i]) > 1e-6 * max(1, exact[i]):
            raise AssertionError(f"density_many query {i}: its grid's mass {g.sum()} is not the "
                                 f"query's {exact[i]} features")
    if not np.allclose(hint.density, grids[0], rtol=0, atol=1e-9):
        raise AssertionError("the density hint differs from density_many")
    log(f"phase 9c density_many: {dens_ms / len(dq):.3f} ms per query over {len(dq)} queries "
        f"(queries {picked}, the fewest matches of the {len(cqls)}; the exact path: query() and "
        f"the host rasterization of {sum(exact)} line strings at 256 x 256, "
        f"{dens_ms / max(1, sum(exact)):.4f} ms a line string), each grid's mass == its exact "
        f"count over the world viewport; the density hint {hint_ms:.3f} ms for query "
        f"{picked[0]}, == density_many's grid")
    record = {"launches": launched["grouped_agg_overlap"]}
    if not on_card:
        return record

    # -- the overlap fold alone at the store's shapes, then adversarial payloads ---------
    st = ds._state("xz")
    state = st.backend_state["xz3"]
    (dgid, _, keys), drowid, dvals, _ = ds._agg_residency(state, st.table, st.indices["xz3"].perm,
                                                         ["cat"], ["val"])
    g_pad = 1 << max(0, (len(keys) - 1).bit_length())
    pend = ds._batch_payloads(st, [Query(c) for c in cqls])
    boxes = torch.from_numpy(np.stack([p[0] for _, p, _ in pend])).to(dev)
    times = torch.from_numpy(np.stack([p[1] for _, p, _ in pend])).to(dev)
    cols = state.spatial_cols()
    ext = state.extents
    main_args = (cols, dgid, drowid, dvals, 0, state.n, boxes, times, g_pad, EDGE_CAPACITY)
    err, rel = check_grouped_kernel(dev, main_args, f"overlap, line store N={state.n} "
                                    f"Q={len(cqls)}", ext, overlap=True)
    adv = boxes.clone()
    adv[1, -1] = torch.tensor([500, 100, 500, 100], dtype=torch.int32)  # inverted: dead
    adv[2, :] = torch.tensor([7, 3, 7, 3], dtype=torch.int32)  # every slot dead
    adv_args = (cols, dgid, drowid, dvals, 0, state.n - 1234, adv, times, g_pad, EDGE_CAPACITY)
    e2, r2 = check_grouped_kernel(dev, adv_args, "overlap, dead and inverted slots, an all-dead "
                                  "query, true_n inside the last chunk", ext, overlap=True)
    wide_gid = torch.from_numpy(np.random.default_rng(37).integers(
        0, AGG_WIDE_GROUPS, cols[0].shape[0]).astype(np.int32)).to(dev)
    wide_args = (cols, wide_gid, drowid, dvals, 0, state.n, boxes, times, AGG_WIDE_GROUPS,
                 EDGE_CAPACITY)
    e3, r3 = check_grouped_kernel(dev, wide_args, f"overlap G={AGG_WIDE_GROUPS}", ext,
                                  overlap=True)
    kernel_ms = cuda_ms(lambda: grouped_agg_overlap(*main_args, extents=ext), 5)
    dms = device_ms(lambda: grouped_agg_overlap(*main_args, extents=ext))
    plain_ms = cuda_ms(lambda: grouped_agg_overlap_plain(*main_args), 1)
    out = grouped_agg_overlap(*main_args, extents=ext)
    torch.cuda.synchronize()
    work = kernels.grouped_agg_last_work()
    ops, nbytes, distinct = agg_overlap_floor(cols, state.n, boxes, times, 1, out[0], out[7],
                                              EDGE_CAPACITY, g_pad)
    record.update(max_abs_err=max(err, e2, e3), ms=kernel_ms, device_ms=dms, plain_ms=plain_ms,
                  mode=work["mode"], **bound_fields(ops, nbytes))
    attrs = {m: kernels.grouped_agg_attrs(m, overlap=True) for m in ("shared", "global")}
    log(f"phase grouped_agg_overlap timing: {kernel_ms:.4f} ms (CUDA events, 5 calls: work list, "
        f"fold, finish), device {fmt_ms(dms)} (10 calls behind a spin) at N={state.n} "
        f"Q={len(cqls)} G={g_pad} V=1, {work['mode']} mode ({work['runs']} window runs of up to "
        f"{work['run_len']} chunks over {work['pairs']} kept pairs, {work['fold_runs']} runs a "
        f"fold block at once, {work['flush_atomics']} flush atomics); plain {plain_ms:.4f} ms; "
        f"bound {record['bound_ms']:.6f} ms ({record['bound_by']}: {ops[0]} ops; {nbytes} bytes, "
        f"{distinct} distinct folded rows), {record['bound_ms'] / kernel_ms:.4f} of it by events, "
        f"{fmt_ms(None if dms is None else record['bound_ms'] / dms)} by device; registers and "
        f"local-memory bytes a thread: shared mode {attrs['shared']}, global mode "
        f"{attrs['global']}; sums' max relative difference {max(rel, r2, r3):.3e}")
    if record["bound_ms"] / kernel_ms > 1:
        raise AssertionError("grouped_agg_overlap beats its bound: the bound's count is wrong")
    return record


XZ_KNN_POINTS = 8  # phase 9c's KNN points, drawn around the cities of the line store
XZ_KNN_K = 10


def xz_knn_leg(ds, b, coords, offsets) -> None:
    """Phase 9c's KNN leg on the line store ``ds`` (type ``xz``, fid = row):
    ``knn`` of ``XZ_KNN_POINTS`` points at k = ``XZ_KNN_K`` (the window loop
    over ``query()``, counting its windows), then ``knn_many`` of the same
    points, held by a referee that cannot miss a nearer line: each row's f64
    envelope distance (``b``: the rows' bboxes) over the whole store, then
    the exact ``distance`` of the rows whose envelope distance is at most
    the answer's k-th distance (an exact distance is never below the
    envelope's); the k smallest of those must equal the answer's distances,
    and each answered row's exact distance its own."""
    from geomesa_tpu_torch.geometry import predicates as P
    from geomesa_tpu_torch.geometry.types import LineString, Point
    from geomesa_tpu_torch.process.knn import knn, knn_many
    from geomesa_tpu_torch.workload import CITIES

    rng = np.random.default_rng(53)
    pts = [Point(float(cx + rng.normal(0, 4.5)), float(cy + rng.normal(0, 3.0)))
           for cx, cy in CITIES[:XZ_KNN_POINTS]]
    windows = []
    query = ds.query

    def counted(*a, **k):
        windows[-1] += 1
        return query(*a, **k)

    ds.query = counted
    one_ms, answers = [], []
    for p in pts:
        windows.append(0)
        s = time.perf_counter()
        answers.append(knn(ds, "xz", p, k=XZ_KNN_K))
        one_ms.append((time.perf_counter() - s) * 1e3)
    many_windows = len(windows)
    windows.append(0)
    s = time.perf_counter()
    many = knn_many(ds, "xz", pts, k=XZ_KNN_K)
    many_ms = (time.perf_counter() - s) * 1e3
    del ds.query
    t0 = time.perf_counter()
    xmin, ymin, xmax, ymax = b
    refined = []
    for i, p in enumerate(pts):
        table, dist = answers[i]
        if len(dist) != XZ_KNN_K or not np.array_equal(many[i][1], dist) \
                or many[i][0].fids.tolist() != table.fids.tolist():
            raise AssertionError(f"knn point {i}: {len(dist)} answers, or knn_many differs")
        dx = np.maximum(np.maximum(xmin - p.x, p.x - xmax), 0.0)
        dy = np.maximum(np.maximum(ymin - p.y, p.y - ymax), 0.0)
        cand = np.nonzero(np.sqrt(dx * dx + dy * dy) <= dist[-1])[0]
        exact = {int(r): P.distance(p, LineString(coords[offsets[r]:offsets[r + 1]]))
                 for r in cand}
        refined.append(len(cand))
        want = np.sort(np.fromiter(exact.values(), dtype=np.float64))[:XZ_KNN_K]
        rows = [int(f) for f in table.fids.tolist()]
        if not np.array_equal(dist, want) or any(exact.get(r) != d for r, d in zip(rows, dist)):
            raise AssertionError(f"knn point {i}: the answer differs from the envelope referee")
    log(f"phase 9c knn: {p50(one_ms):.3f} ms a point (p50 over {len(pts)} points; "
        f"{[round(v, 1) for v in one_ms]}), windows a point {windows[:many_windows]}; knn_many "
        f"of the same {len(pts)}: {many_ms / len(pts):.3f} ms a point (per point through knn: no "
        f"point state on a line store), {windows[-1]} windows in all; k = {XZ_KNN_K}, every answer "
        f"== the envelope referee (rows refined exactly a point {refined}) in "
        f"{time.perf_counter() - t0:.3f} s; knn_many == knn")


def xz_store_path(dev, m: int, iters: int) -> tuple[dict, dict, dict, dict]:
    """Phase 9c: a line store at config 5's scale through ``DataStore``.
    Returns the records' timing fields of ``batched_edge_gather_overlap``
    and ``planned_gather_overlap``, the main path's launches and the
    ``grouped_agg_overlap`` record (:func:`xz_agg_leg`)."""
    import torch

    from geomesa_tpu_torch.ops import kernels
    from geomesa_tpu_torch.ops.kernels import (
        EDGE_CAPACITY, JOIN_BLOCK, batched_edge_gather_overlap,
        batched_edge_gather_overlap_plain, batched_overlap, batched_overlap_plain,
        overlap_chunk_pairs, overlap_warp_pairs, planned_gather_overlap,
        planned_gather_overlap_plain)
    from geomesa_tpu_torch.parallel.query import intervals_to_block_pairs
    from geomesa_tpu_torch.planning.planner import Query, QueryPlanner
    from geomesa_tpu_torch.schema.columnar import Column, FeatureTable, linestring_column
    from geomesa_tpu_torch.schema.sft import AttributeType
    from geomesa_tpu_torch.store.datastore import DataStore
    from geomesa_tpu_torch.workload import (
        XZ_AGG_SPEC, bbox_cql, bbox_time_cql, box_linestrings, grouped_columns, make_queries,
        synth_gdelt, xz_boxes)

    t0 = time.perf_counter()
    b = xz_boxes(m, 9)
    coords, offsets = box_linestrings(*b)
    t = synth_gdelt(m)[2]
    gid, vals = grouped_columns(m, XZ_AGG_GROUPS)
    valid = np.random.default_rng(19).random(m) >= XZ_NULL_SHARE
    fids = np.arange(m).astype("U9")
    boxes_f64, windows_ms = make_queries(N_QUERIES, 7)
    cqls = [bbox_time_cql(bx, w) for bx, w in zip(boxes_f64, windows_ms)]
    spatial = [bbox_cql(bx) for bx in boxes_f64[:N_EXACT]] + [bbox_cql(XZ_DATELINE)]
    log(f"phase 9c synth: {time.perf_counter() - t0:.3f} s ({m} line strings, "
        f"{len(coords)} vertices)")

    for k in kernels.launches:
        kernels.launches[k] = 0
    ds = DataStore(device=dev)
    sft = ds.create_schema("xz", XZ_AGG_SPEC)
    table = FeatureTable.from_columns(sft, fids, {
        "cat": Column(AttributeType.INT, gid.copy()),
        "val": Column(AttributeType.DOUBLE, vals.copy(), valid.copy()),
        "dtg": Column(AttributeType.DATE, t), "geom": linestring_column(coords, offsets)})
    t0 = time.perf_counter()
    ds.write("xz", table)
    ds.compact("xz")
    write_s = time.perf_counter() - t0
    states = ds._state("xz").backend_state
    if set(states) != {"xz3", "xz2"} or {s.kind for s in states.values()} != {"bboxes"}:
        raise AssertionError(f"resident states {sorted(states)}, not xz3 and xz2 bbox layouts")
    log(f"phase 9c write: {write_s:.3f} s (write + compact of {m} line strings); resident "
        f"{sum(s.h2d_bytes for s in states.values())} bytes in two bbox states "
        f"(memory_allocated {torch.cuda.memory_allocated() if dev.type == 'cuda' else 0})")
    log_rebuild(ds.last_rebuild("xz"))

    t0 = time.perf_counter()
    loose = ds.count_many("xz", cqls + spatial, loose=True)
    exact = ds.count_many("xz", cqls + spatial, loose=False)
    fallbacks = ds.exact_fallbacks
    many = ds.select_many("xz", cqls)
    singles = [ds.query("xz", c) for c in cqls[:N_EXACT] + spatial]
    launched = dict(kernels.launches)
    log(f"phase 9c launches: {launched} ({time.perf_counter() - t0:.3f} s for the first "
        f"count_many loose and exact, select_many and {len(singles)} query() calls)")
    for name in ("batched_overlap", "batched_edge_gather_overlap", "planned_gather_overlap"):
        if dev.type == "cuda" and launched[name] < 1:
            raise AssertionError(f"the line store's path did not launch {name}")

    # -- the referees ------------------------------------------------------------
    t0 = time.perf_counter()
    ib = [norm31(b[0], -180.0, 180.0), norm31(b[1], -90.0, 90.0),
          norm31(b[2], -180.0, 180.0), norm31(b[3], -90.0, 90.0)]
    day, off = t // DAY_MS, t % DAY_MS
    want_loose = (xz_int_referee(ib, boxes_f64, windows_ms, day, off)
                  + xz_int_referee(ib, boxes_f64[:N_EXACT] + [XZ_DATELINE]))
    if loose != want_loose:
        raise AssertionError(f"count_many(loose) on the line store != the int referee: "
                             f"{loose} vs {want_loose}")
    rows = ([xz_f64_rows(b, bx, w, t) for bx, w in zip(boxes_f64, windows_ms)]
            + [xz_f64_rows(b, bx) for bx in boxes_f64[:N_EXACT] + [XZ_DATELINE]])
    if exact != [len(r) for r in rows]:
        raise AssertionError(f"count_many(exact) on the line store != the f64 referee: "
                             f"{exact} vs {[len(r) for r in rows]}")
    for i, res in enumerate(many):
        if not np.array_equal(res.row_ids, rows[i]):
            raise AssertionError(f"select_many rows of query {i} differ from the f64 referee")
    for res, r in zip(singles, rows[:N_EXACT] + rows[N_QUERIES:]):
        if set(res.table.fids.tolist()) != set(fids[r].tolist()):
            raise AssertionError("query() fid sets differ from the f64 referee")
    plans = [res.plan_info.index_name for res in singles]
    if plans != ["xz3"] * N_EXACT + ["xz2"] * (N_EXACT + 1):
        raise AssertionError(f"the line store's queries planned on {plans}")
    log(f"phase 9c checks: ok in {time.perf_counter() - t0:.3f} s (loose counts equal the "
        f"int referee: {sum(loose)} matches over {len(loose)} queries, the {N_QUERIES} timed "
        f"ones on xz3 and {N_EXACT} boxes with no time and one across the antimeridian on "
        f"xz2; exact counts equal the f64 referee: {sum(exact)} rows, {fallbacks} fallback(s) "
        f"to query(); select_many rows of all {N_QUERIES} and query() fid sets of "
        f"{len(singles)} equal it)")

    # -- timings ------------------------------------------------------------------
    for what, mode in (("count_many batch", True), ("count_many exact batch", False)):
        lat = []
        for _ in range(iters):
            s = time.perf_counter()
            ds.count_many("xz", cqls, loose=mode)
            lat.append((time.perf_counter() - s) * 1e3)
        log(f"phase 9c {what}: p50 {p50(lat):.3f} ms over {iters} (min {min(lat):.3f}, max "
            f"{max(lat):.3f}; {N_QUERIES} queries per batch)")
    many_ms, split = [], []
    for _ in range(2):  # each plans all 64 on xz3 anew: seconds of the Python XZ BFS
        s = time.perf_counter()
        ds.select_many("xz", cqls)
        many_ms.append((time.perf_counter() - s) * 1e3 / N_QUERIES)
        split.append(dict(ds.last_select_many))
    q_ms, q_split = [], []
    for c in cqls[:N_EXACT]:
        s = time.perf_counter()
        res = ds.query("xz", c)
        q_ms.append((time.perf_counter() - s) * 1e3)
        q_split.append(res.timings)
    log(f"phase 9c select_many: p50 {p50(many_ms):.3f} ms per query over 2 calls of "
        f"{N_QUERIES}; split of the last (ms): "
        + ", ".join(f"{k} {v:.3f}" for k, v in split[-1].items()))
    log(f"phase 9c query(): p50 {p50(q_ms):.3f} ms per query over {N_EXACT}; split p50 (ms): "
        + ", ".join(f"{k} {p50([s[k] for s in q_split]):.3f}" for k in q_split[0]))

    t0 = time.perf_counter()
    agg = xz_agg_leg(dev, ds, cqls, rows, gid, np.where(valid, vals, np.nan), exact)
    log(f"phase 9c aggregation and density: {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    xz_knn_leg(ds, b, coords, offsets)
    log(f"phase 9c knn leg: {time.perf_counter() - t0:.3f} s")

    # -- the kernels alone at the store's shapes ----------------------------------
    if dev.type != "cuda":
        return {}, {}, launched, agg
    dev_state = states["xz3"]
    cols, n = dev_state.spatial_cols(), dev_state.n
    planner = QueryPlanner(sft, ds._state("xz").indices)
    plans = [planner.plan(Query(c)) for c in cqls]
    payloads = [ds.backend.payload(sft, info.extraction, overlap=True) for _, _, info in plans]
    boxes = torch.from_numpy(np.stack([p[0] for p in payloads])).to(dev)
    times = torch.from_numpy(np.stack([p[1] for p in payloads])).to(dev)
    args = (cols, 0, n, boxes, times)
    got = batched_overlap(*args)
    want = batched_overlap_plain(*args)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError("batched_overlap (with time) disagrees with plain at the store's "
                             "payloads")
    k1_ms = cuda_ms(lambda: batched_overlap(*args), 10)
    k1_dev = device_ms(lambda: batched_overlap(*args))
    keep = overlap_warp_pairs(*args)
    chunk_keep = overlap_chunk_pairs(*args)
    ops, nbytes, _ = overlap_floor(cols, n, boxes, times, keep)
    k1 = bound_fields(ops, nbytes)
    k1_chunk = bound_fields(*overlap_floor(cols, n, boxes, times, chunk_keep)[:2])
    log(f"phase batched_overlap timing with time: {k1_ms:.4f} ms (CUDA events), device "
        f"{fmt_ms(k1_dev)} (10 calls behind a spin) at the line store's N={n} "
        f"Q={N_QUERIES} B=8 T=16; bound {k1['bound_ms']:.6f} ms ({k1['bound_by']}: "
        f"{int(keep.sum())} kept of {keep.numel()} (warp, query) pairs; {nbytes} bytes), "
        f"{k1['bound_ms'] / k1_ms:.4f} of it; per chunk {k1_chunk['bound_ms']:.6f} ms")
    if k1["bound_ms"] / k1_ms > 1:
        raise AssertionError("batched_overlap with time reads more than its bound")
    eargs = args + (EDGE_CAPACITY,)
    gc_, gp, gh = batched_edge_gather_overlap(*eargs)
    wc, wp, wh = batched_edge_gather_overlap_plain(*eargs)
    torch.cuda.synchronize()
    fits = (gh[:, 0] <= EDGE_CAPACITY)[:, None, None]
    err = max(int((gc_.long() - wc.long()).abs().max()), int((gc_.long() - want.long()).abs().max()),
              int((gh.long() - wh.long()).abs().max()),
              int(((gp.long() - wp.long()) * fits).abs().max()))
    if err:
        raise AssertionError("batched_edge_gather_overlap disagrees with plain at the store's "
                             "payloads")
    e_ms = cuda_ms(lambda: batched_edge_gather_overlap(*eargs), 10)
    e_dev = device_ms(lambda: batched_edge_gather_overlap(*eargs))
    e_plain = cuda_ms(lambda: batched_edge_gather_overlap_plain(*eargs), 1)
    e_ops, e_bytes, _ = overlap_floor(cols, n, boxes, times, keep, wc, wh, EDGE_CAPACITY)
    e_chunk = bound_fields(*overlap_floor(cols, n, boxes, times, chunk_keep, wc, wh,
                                          EDGE_CAPACITY)[:2])
    edge = {"max_abs_err": err, "ms": e_ms, "device_ms": e_dev, "plain_ms": e_plain,
            **bound_fields(e_ops, e_bytes)}
    log(f"phase batched_edge_gather_overlap timing: {e_ms:.4f} ms (CUDA events), device "
        f"{fmt_ms(e_dev)} (its entry point's zero fills, scan and lanes' sort, 10 calls behind a "
        f"spin) at N={n} Q={N_QUERIES} B=8 T=16; plain {e_plain:.4f} ms; "
        f"bound {edge['bound_ms']:.6f} ms ({edge['bound_by']}: {e_ops[0]} int32 ops; "
        f"{e_bytes} bytes; per chunk, every matched row's edge compares counted, "
        f"{e_chunk['bound_ms']:.6f} ms), {edge['bound_ms'] / e_ms:.4f} of it; candidates "
        f"{int(wh.sum())}, "
        f"{int((wh > EDGE_CAPACITY).sum())} queries over {EDGE_CAPACITY} lanes; against "
        f"batched_overlap with time: {e_ms / k1_ms:.3f}x by CUDA events, "
        + (f"{e_dev / k1_dev:.3f}x by device time" if e_dev and k1_dev else "device not measured"))
    if edge["bound_ms"] / e_ms > 1:
        raise AssertionError("batched_edge_gather_overlap reads more than its bound")

    pair_q, pair_blk = intervals_to_block_pairs([pl.intervals for pl, _, _ in plans], JOIN_BLOCK)
    pq = torch.from_numpy(pair_q.astype(np.int32)).to(dev)
    pb = torch.from_numpy(pair_blk.astype(np.int32)).to(dev)
    gplan = torch.from_numpy(np.concatenate(kernels.block_runs(pair_q, pair_blk))).to(dev)
    gargs = (cols, n, pq, pb, boxes, times)
    got_p, got_h = planned_gather_overlap(*gargs, plan=gplan)
    want_p, want_h = planned_gather_overlap_plain(*gargs)
    torch.cuda.synchronize()
    if not (torch.equal(got_p, want_p) and torch.equal(got_h, want_h)):
        raise AssertionError("planned_gather_overlap disagrees with plain at the store's pairs")
    g_ms = cuda_ms(lambda: planned_gather_overlap(*gargs, plan=gplan), 10)
    g_dev = device_ms(planned_overlap_passes(cols, n, pq, pb, boxes, times, gplan))
    g_plain = cuda_ms(lambda: planned_gather_overlap_plain(*gargs), 1)
    g_ops, g_bytes = gather_floor(cols, n, pq, pb, boxes, times, want_h, got_p.element_size())
    gather = {"max_abs_err": 0, "ms": g_ms, "device_ms": g_dev, "plain_ms": g_plain,
              **bound_fields(g_ops, g_bytes)}
    distinct = len(np.unique(pair_blk))
    log(f"phase planned_gather_overlap timing: {g_ms:.4f} ms (CUDA events), device "
        f"{fmt_ms(g_dev)} (its count and write passes, 10 calls behind a spin) for "
        f"{len(pair_q)} (query, block) pairs over {distinct} distinct blocks, "
        f"{int(want_h.sum())} rows out; "
        f"plain {g_plain:.4f} ms; bound {gather['bound_ms']:.6f} ms ({gather['bound_by']}: "
        f"{g_ops[0]} ALU-only of {g_ops[1]} int32 ops; {g_bytes} bytes), "
        f"{gather['bound_ms'] / g_ms:.4f} of it")
    if gather["bound_ms"] / g_ms > 1:
        raise AssertionError("planned_gather_overlap reads more than its bound")
    return edge, gather, launched, agg


def xz_path(dev, m: int, tiles: int, iters: int) -> list[dict]:
    """Phase 9: 9a (on the card), 9b and 9c; the records of the three
    overlap kernels and of the grouped fold's overlap form."""
    from geomesa_tpu_torch.ops import kernels

    errs = dict.fromkeys(("batched_overlap", "batched_edge_gather_overlap",
                          "planned_gather_overlap"), 0)
    if dev.type == "cuda":
        t0 = time.perf_counter()
        errs = check_overlap_kernels(dev, XZ_CHECK_ROWS, 41)
        free_card()
        log(f"phase overlap-kernels-vs-plain: ok, max_abs_err={errs} "
            f"({time.perf_counter() - t0:.3f} s for phase 9a)")
    t0 = time.perf_counter()
    for k in kernels.launches:
        kernels.launches[k] = 0
    k1, k1_launches = config5_step(dev, m, tiles)
    log(f"phase 9b: {time.perf_counter() - t0:.3f} s in all")
    t0 = time.perf_counter()
    edge, gather, launched, agg = xz_store_path(dev, m, iters)
    free_card()
    log(f"phase 9c: {time.perf_counter() - t0:.3f} s in all")
    src = "geomesa_tpu_torch/csrc/"
    return [
        {"name": "batched_overlap", "route": "cuda", "source": src + "batched_overlap.cu",
         "replaces": "geomesa_tpu/parallel/query.py:914",
         "launches": k1_launches + launched["batched_overlap"], "library_ms": None,
         **k1, "max_abs_err": max(k1.get("max_abs_err", 0), errs["batched_overlap"])},
        {"name": "batched_edge_gather_overlap", "route": "cuda",
         "source": src + "batched_edge_gather.cu", "replaces": "geomesa_tpu/parallel/query.py:342",
         "launches": launched["batched_edge_gather_overlap"], "library_ms": None, **edge,
         "max_abs_err": max(edge.get("max_abs_err", 0), errs["batched_edge_gather_overlap"])},
        {"name": "planned_gather_overlap", "route": "cuda", "source": src + "planned_gather.cu",
         "replaces": "geomesa_tpu/parallel/query.py:820",
         "launches": launched["planned_gather_overlap"], "library_ms": None, **gather,
         "max_abs_err": max(gather.get("max_abs_err", 0), errs["planned_gather_overlap"])},
        {"name": "grouped_agg_overlap", "route": "cuda", "source": src + "grouped_agg.cu",
         "replaces": "geomesa_tpu/parallel/query.py:1498", "library_ms": None, **agg},
    ]


# -- phase 10: bench config 7, the 125M-row resident count steps -------------------

RESIDENT_ROWS = 125_000_000  # bench config 7's N (bench.py:1058), nothing cut
RESIDENT_R = 12  # query batches a run (bench.py:1069, GEOMESA_BENCH_R)
RESIDENT_PAIR_CHUNK = 128  # pad_block_pairs' multiple (bench.py:1129 chunkp)
RESIDENT_REFEREE = 4  # queries of batch 0 held to the numpy referees (bench.py n_ref)
PLANNED_CHECK_ROWS = 1_000_003  # phase 10a's rows


def multi_payload(rng, q: int, nb: int, nt: int, city_boxes, windows, binned):
    """(q, nb, 4) boxes and (q, nt, 4) windows packed with the packers'
    sentinels: 1..nb city boxes and 1..nt city windows a query, and the
    last query all dead."""
    from geomesa_tpu_torch.ops.refine import pack_boxes, pack_times, unsat_rows

    boxes, times = [], []
    for _ in range(q):
        kb, kt = int(rng.integers(1, nb + 1)), int(rng.integers(1, nt + 1))
        boxes.append(pack_boxes(city_boxes[rng.integers(len(city_boxes), size=kb)], slots=nb))
        quads = []
        for lo, hi in (windows[int(i)] for i in rng.integers(len(windows), size=kt)):
            (blo,), (olo,) = binned.to_bin_and_offset(np.array([lo]))
            (bhi,), (ohi,) = binned.to_bin_and_offset(np.array([hi]))
            quads.append([blo, olo, bhi, ohi])
        times.append(pack_times(np.array(quads, dtype=np.int32), slots=nt))
    boxes[-1], times[-1] = unsat_rows(nb, nt)
    return np.ascontiguousarray(np.stack(boxes)), np.ascontiguousarray(np.stack(times))


def pair_cases(rng, q: int, true_n: int, n_rows: int, block_rows: int):
    """Phase 10a's pair lists (name, pair_q, pair_blk) int32: random pairs
    with padding among them, one block shared by every query, pairs on the
    last block (``true_n`` inside it), every pair padded, and none."""
    n_blocks = n_rows // block_rows
    last = (true_n - 1) // block_rows
    k = 3000
    pq = rng.integers(0, q, k).astype(np.int32)
    pb = rng.integers(0, n_blocks, k).astype(np.int32)
    pq[rng.random(k) < 0.1] = -1
    shared = np.full(q, int(rng.integers(n_blocks)), np.int32)
    return [("random", pq, pb), ("shared", np.arange(q, dtype=np.int32), shared),
            ("last", np.arange(q, dtype=np.int32), np.full(q, last, np.int32)),
            ("padded", np.full(64, -1, np.int32), pb[:64]),
            ("empty", np.empty(0, np.int32), np.empty(0, np.int32))]


def check_planned_count(dev, seed: int) -> int:
    """Phase 10a: ``planned_count`` against ``planned_count_plain`` on the
    card, exact: GDELT-shaped rows in (bin, z3) order and config-5 bboxes
    (the overlap form), blocks of 1024 and 4096 rows, 65 queries of one
    packed city box and window, of several slots (B = 8, T = 16) or of the
    whole world and the unconstrained window (every row below ``true_n``
    matches, so the last block's count is its true rows), the
    pair lists of :func:`pair_cases`, and ``planned_count_step`` at R = 1
    and R = 3 with different pair counts. Returns the max |difference|."""
    import torch

    from geomesa_tpu_torch.curve.binned_time import BinnedTime
    from geomesa_tpu_torch.ops import kernels
    from geomesa_tpu_torch.ops.kernels import planned_count, planned_count_plain
    from geomesa_tpu_torch.parallel.query import pad_block_pairs, planned_count_step
    from geomesa_tpu_torch.store.backends import int_boxes
    from geomesa_tpu_torch.workload import (
        RESIDENT_PERIOD, make_queries, pack_query_boxes, pack_query_times, resident_store,
        synth_gdelt)

    rng = np.random.default_rng(seed)
    q = 65
    lon, lat, t = synth_gdelt(PLANNED_CHECK_ROWS, seed=seed)
    st = resident_store(lon, lat, t, dev, block_rows=4096)
    true_n = st["true_n"]
    bf, wm = make_queries(q, seed=seed + 1)
    city = int_boxes(bf)
    binned = BinnedTime(RESIDENT_PERIOD)
    host_b = overlap_rows(dev, PLANNED_CHECK_ROWS, seed + 2)
    pad = -PLANNED_CHECK_ROWS % 4096  # zero rows up to whole 4096-row blocks
    bcols = tuple(torch.from_numpy(np.concatenate([c, np.zeros(pad, np.int32)])).to(dev)
                  for c in host_b)
    top = 2**31 - 1
    world = (np.tile(np.array([0, top, 0, top], np.int32), (q, 1, 1)),
             np.tile(np.array([0, -1, top, top], np.int32), (q, 1, 1)))
    forms = {
        "point": (st["cols"], [
            ("city", pack_query_boxes(bf), pack_query_times(wm)),
            ("multi", *multi_payload(rng, q, 8, 16, city, wm, binned)),
            ("world", *world)]),
        "overlap": (bcols, [
            ("city", pack_query_boxes(bf, overlap=True), pack_query_times(wm)),
            ("adversarial", *overlap_payload(rng, q, 8, 16, city, host_b[:4], host_b[4],
                                             host_b[5]))]),
    }
    worst = 0
    for form, (cols, payloads) in forms.items():
        for pname, bx, tm in payloads:
            boxes = torch.from_numpy(np.ascontiguousarray(bx)).to(dev)
            times = torch.from_numpy(np.ascontiguousarray(tm)).to(dev)
            for block_rows in kernels.PLANNED_COUNT_BLOCKS:
                for cname, pq, pb in pair_cases(rng, q, true_n, cols[0].shape[0], block_rows):
                    pq_t = torch.from_numpy(pq).to(dev)
                    pb_t = torch.from_numpy(pb).to(dev)
                    before = kernels.launches["planned_count"]
                    got = planned_count(cols, true_n, pq_t, pb_t, boxes, times, block_rows)
                    want = planned_count_plain(cols, true_n, pq_t, pb_t, boxes, times,
                                               block_rows)
                    torch.cuda.synchronize()
                    err = int((got.long() - want.long()).abs().max())
                    worst = max(worst, err)
                    launched = kernels.launches["planned_count"] - before
                    if launched != (len(pq) > 0):
                        raise AssertionError(f"planned_count {cname}: {launched} launches")
                    log(f"  planned_count {form} {pname} block_rows={block_rows} {cname} "
                        f"({len(pq)} pairs): max_abs_err={err} (matches "
                        f"{int(want.long().sum())})")
                # R = 1 and R = 3, the batches' pair lists of different lengths
                for r in (1, 3):
                    lists = [pair_cases(rng, q, true_n, cols[0].shape[0], block_rows)[0][1:]
                             for _ in range(r)]
                    lists = [(a[:500 + 700 * i], b[:500 + 700 * i]) for i, (a, b) in
                             enumerate(lists)]
                    width = -(-max(len(a) for a, _ in lists) // RESIDENT_PAIR_CHUNK) \
                        * RESIDENT_PAIR_CHUNK
                    padded = [pad_block_pairs(a, b, width) for a, b in lists]
                    pq_r = np.stack([p[0] for p in padded])
                    pb_r = np.stack([p[1] for p in padded])
                    br, tr = boxes.expand(r, *boxes.shape), times.expand(r, *times.shape)
                    got = planned_count_step(cols, true_n, pq_r, pb_r, br, tr, block_rows)
                    want = torch.stack([planned_count_plain(
                        cols, true_n, torch.from_numpy(pq_r[i]).to(dev),
                        torch.from_numpy(pb_r[i]).to(dev), boxes, times, block_rows)
                        for i in range(r)])
                    torch.cuda.synchronize()
                    err = int((got.long() - want.long()).abs().max())
                    worst = max(worst, err)
                    log(f"  planned_count_step {form} {pname} block_rows={block_rows} R={r} "
                        f"({[len(a) for a, _ in lists]} pairs): max_abs_err={err}")
    if worst:
        raise AssertionError(f"planned_count disagrees with its plain version: {worst}")
    return worst


def planned_gather_count_ms(cols, true_n: int, pair_q, pair_blk, boxes, times):
    """The CUDA-event ms of ``planned_gather``'s count entry alone (its
    count pass and the scan of the counts, without the write pass) over
    4096-row pairs, and the per-pair counts it gives."""
    import torch

    from geomesa_tpu_torch.ops import kernels

    dev = cols[0].device
    p = len(pair_q)
    plan = torch.from_numpy(np.concatenate(kernels.block_runs(pair_q, pair_blk))).to(dev)
    n_blocks = (plan.shape[0] - 2 * p - 1) // 2
    hits = torch.empty(p, dtype=torch.int64, device=dev)
    scratch = torch.empty(p * (1 + kernels.JOIN_BLOCK // 64), dtype=torch.int64, device=dev)
    fn = kernels._fn("geomesa_planned_gather_count")
    stream = torch.cuda.current_stream(dev).cuda_stream

    def call():
        rc = fn(*(c.data_ptr() for c in cols), cols[0].shape[0], int(true_n), plan.data_ptr(),
                p, n_blocks, boxes.data_ptr(), times.data_ptr(), boxes.shape[0],
                boxes.shape[1], times.shape[1], hits.data_ptr(), scratch.data_ptr(),
                scratch.data_ptr() + 8 * p, stream)
        if rc:
            raise RuntimeError(f"planned_gather count entry failed: cudaError {rc}")

    return cuda_ms(call, 10), hits


def host_p50_ms(fn, iters: int) -> float:
    """p50 host-clock ms of ``fn`` after a synchronisation, each call ended
    by one."""
    import torch

    out = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return p50(out)


def resident_path(dev, n_rows: int, r_batches: int, n_queries: int,
                  iters: int) -> tuple[dict, dict]:
    """Phase 10b: bench config 7 at ``n_rows`` (see the module docstring).
    Returns ``planned_count``'s record and the main path's launches."""
    import torch

    from geomesa_tpu_torch.ops import kernels
    from geomesa_tpu_torch.ops.kernels import JOIN_BLOCK, planned_count, planned_count_plain
    from geomesa_tpu_torch.parallel.query import (
        intervals_to_block_pairs, pad_block_pairs, planned_count_step, repeated_count_step)
    from geomesa_tpu_torch.workload import (
        RESIDENT_BLOCK, bin_spans, make_queries, pack_query_boxes, pack_query_times,
        plan_query_intervals, resident_store, synth_gdelt)

    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    t0 = time.perf_counter()
    lon, lat, t = synth_gdelt(n_rows, seed=42)
    log(f"phase 10 synth: {time.perf_counter() - t0:.3f} s ({n_rows} points, seed 42)")
    for k in kernels.launches:
        kernels.launches[k] = 0
    t0 = time.perf_counter()
    # padded to whole 4096-row blocks (a multiple of config 7's 1024) so that
    # planned_gather's count entry can be timed on the same columns below
    st = resident_store(lon, lat, t, dev, block_rows=JOIN_BLOCK)
    build_s = time.perf_counter() - t0
    del lon, lat, t
    cols, true_n = st["cols"], st["true_n"]
    resident = sum(c.numel() * c.element_size() for c in cols)
    log(f"phase 10 build: {build_s:.3f} s (" + ", ".join(
        f"{k} {v:.3f} s" for k, v in st["seconds"].items()) + f"); resident {resident} bytes "
        f"({cols[0].shape[0]} rows x 4 int32 columns, true_n {true_n})")
    raw, boxes_r, times_r = [], [], []
    for r in range(r_batches):
        bf, wm = make_queries(n_queries, seed=100 + r)
        raw.append((bf, wm))
        boxes_r.append(pack_query_boxes(bf))
        times_r.append(pack_query_times(wm))
    boxes_r = torch.from_numpy(np.ascontiguousarray(np.stack(boxes_r))).to(dev)
    times_r = torch.from_numpy(np.ascontiguousarray(np.stack(times_r))).to(dev)

    # -- the full scan: R passes of batched_count -----------------------------------
    def run(r):
        return repeated_count_step(cols, true_n, boxes_r[:r], times_r[:r])

    counts_r = run(r_batches).cpu().numpy()
    run(1)
    reps = max(5, iters // 2)
    t_big = host_p50_ms(lambda: run(r_batches), reps) if on_card else 0.0
    t_one = host_p50_ms(lambda: run(1), reps) if on_card else 0.0
    pass_ms = max((t_big - t_one) / (r_batches - 1), 1e-6)
    ev_pass = cuda_ms(lambda: run(r_batches), 3) / r_batches if on_card else 0.0
    gbps = true_n * 16 / (pass_ms / 1e3) / 1e9
    log(f"phase 10 full scan: pass {pass_ms:.4f} ms by host clock ((t({r_batches}) "
        f"{t_big:.3f} - t(1) {t_one:.3f}) / {r_batches - 1}, p50 of {reps}), "
        f"{ev_pass:.4f} ms a pass by CUDA events over {r_batches} launches; "
        f"{gbps:.1f} GB/s of {true_n * 16} bytes ({gbps / (MEM_BYTES_PER_S / 1e9):.4f} of "
        f"3.35 TB/s); dispatch {max(t_one - pass_ms, 0.0):.3f} ms; "
        f"{pass_ms / n_queries:.5f} ms a query")

    # -- the plan: per-query z3 intervals → 1024-row (query, block) pairs ----------------
    t0 = time.perf_counter()
    spans = bin_spans(st["bins_sorted"])
    ivs_r = [plan_query_intervals(bf, wm, st["binned"], st["sfc"], st["z_sorted"], spans)
             for bf, wm in raw]
    per_batch = [intervals_to_block_pairs(ivs, RESIDENT_BLOCK) for ivs in ivs_r]
    totals = [len(pq) for pq, _ in per_batch]
    n_pairs = -(-max(totals) // RESIDENT_PAIR_CHUNK) * RESIDENT_PAIR_CHUNK
    plan_s = time.perf_counter() - t0
    log(f"phase 10 plan: {plan_s:.3f} s for {r_batches} x {n_queries} queries; pairs a batch "
        f"max {max(totals)}, mean {np.mean(totals):.1f}; padded to {n_pairs}")
    rule = n_pairs * RESIDENT_BLOCK <= 2 * true_n + (1 << 20)
    if on_card and not rule:
        raise AssertionError("config 7's cover is wider than two full passes (the bench's "
                             "2N + 2^20 rule): the bench would report the full scan only")
    padded = [pad_block_pairs(pq, pb, n_pairs) for pq, pb in per_batch]
    pq_r = torch.from_numpy(np.stack([p[0] for p in padded])).to(dev)
    pb_r = torch.from_numpy(np.stack([p[1] for p in padded])).to(dev)

    def prun(r):
        return planned_count_step(cols, true_n, pq_r[:r], pb_r[:r], boxes_r[:r], times_r[:r],
                                  RESIDENT_BLOCK)

    pcounts_r = prun(r_batches).cpu().numpy()
    prun(1)
    pt_big = host_p50_ms(lambda: prun(r_batches), reps) if on_card else 0.0
    pt_one = host_p50_ms(lambda: prun(1), reps) if on_card else 0.0
    p_pass_ms = max((pt_big - pt_one) / (r_batches - 1), 1e-6)
    p_ev = cuda_ms(lambda: prun(r_batches), 3) / r_batches if on_card else 0.0
    launched = dict(kernels.launches)
    log(f"phase 10 launches: {launched}")
    if on_card and (launched["batched_count"] == 0 or launched["planned_count"] == 0
                    or launched["z3_encode"] != 1):
        raise AssertionError("phase 10's main path must launch z3_encode, batched_count and "
                             "planned_count")

    # -- checks ------------------------------------------------------------------------
    t0 = time.perf_counter()
    if not np.array_equal(pcounts_r, counts_r):
        raise AssertionError("config 7's pruned counts differ from the full scan's")
    x, y, bins, offs = st["host"]
    for qi in range(RESIDENT_REFEREE):
        b = boxes_r[0, qi, 0].cpu().numpy()
        w = times_r[0, qi, 0].cpu().numpy()
        m = (x >= b[0]) & (x <= b[1]) & (y >= b[2]) & (y <= b[3])
        after = (bins > w[0]) | ((bins == w[0]) & (offs >= w[1]))
        before = (bins < w[2]) | ((bins == w[2]) & (offs <= w[3]))
        if int((m & after & before).sum()) != int(counts_r[0, qi]):
            raise AssertionError(f"config 7 query {qi}: the full scan differs from the int "
                                 "referee")
    ref_s = time.perf_counter() - t0
    pq0, pb0 = per_batch[0]
    t0 = time.perf_counter()
    for qi in range(RESIDENT_REFEREE):
        blks = pb0[pq0 == qi].astype(np.int64)
        rows = (blks[:, None] * RESIDENT_BLOCK + np.arange(RESIDENT_BLOCK)).ravel()
        rows = torch.from_numpy(rows[rows < true_n]).to(dev)
        xs, ys, bb, oo = (c[rows].cpu().numpy() for c in cols)
        b = boxes_r[0, qi, 0].cpu().numpy()
        w = times_r[0, qi, 0].cpu().numpy()
        m = (xs >= b[0]) & (xs <= b[1]) & (ys >= b[2]) & (ys <= b[3])
        after = (bb > w[0]) | ((bb == w[0]) & (oo >= w[1]))
        before = (bb < w[2]) | ((bb == w[2]) & (oo <= w[3]))
        if int((m & after & before).sum()) != int(pcounts_r[0, qi]):
            raise AssertionError(f"config 7 query {qi}: the pruned count differs from the "
                                 "same-cover referee")
    cover_ms = (time.perf_counter() - t0) * 1e3 / RESIDENT_REFEREE
    log(f"phase 10 checks: ok (pruned == full scan for all {r_batches} x {n_queries} queries; "
        f"both == the int referee on {RESIDENT_REFEREE} queries of batch 0 in {ref_s:.3f} s; "
        f"the same-cover referee agrees, {cover_ms:.3f} ms a query with its rows gathered "
        "from the card)")
    gathered = n_pairs * RESIDENT_BLOCK * 16
    head = p_pass_ms / n_queries
    if not rule:
        head = pass_ms / n_queries
    log(f"phase 10 resident_125m_scan_device_time_per_query: {head:.6f} ms (the "
        + ("pruned scan ran and matched" if rule else "full scan: the cover breaks the 2N + "
           "2^20 rule") + f"); pruned pass {p_pass_ms:.4f} ms by host clock ((t({r_batches}) "
        f"{pt_big:.3f} - t(1) {pt_one:.3f}) / {r_batches - 1}), {p_ev:.4f} ms by CUDA events; "
        f"full scan {pass_ms / n_queries:.6f} ms a query; speed-up {pass_ms / p_pass_ms:.2f}x; "
        f"cover fraction {n_pairs * RESIDENT_BLOCK / (true_n * n_queries):.6f}; gathered "
        f"{gathered / 1e9:.4f} GB a pass, {gathered / (p_pass_ms / 1e3) / 1e9:.1f} GB/s "
        f"effective")

    # -- planned_count alone at the real pairs, and planned_gather's count entry -----------
    pq0_t = torch.from_numpy(pq0).to(dev)
    pb0_t = torch.from_numpy(pb0).to(dev)
    args = (cols, true_n, pq0_t, pb0_t, boxes_r[0], times_r[0], RESIDENT_BLOCK)
    got = planned_count(*args)
    want = planned_count_plain(*args)
    err = int((got.long() - want.long()).abs().max())
    if err:
        raise AssertionError("planned_count disagrees with its plain version at config 7")
    # the least the function must read: each distinct block's columns once, however many
    # of the batch's queries cover it (the kernel reads a block once a pair)
    n_blocks = len(np.unique(pb0))
    nbytes = n_blocks * RESIDENT_BLOCK * 16
    record = {"max_abs_err": err, "bound_ms": nbytes / MEM_BYTES_PER_S * 1e3,
              "bound_by": "bytes"}
    if not on_card:
        return record, launched
    record["ms"] = cuda_ms(lambda: planned_count(*args), 10)
    record["device_ms"] = device_ms(lambda: planned_count(*args))
    record["plain_ms"] = cuda_ms(lambda: planned_count_plain(*args), 1)
    log(f"phase planned_count timing: {record['ms']:.4f} ms (CUDA events), device "
        f"{fmt_ms(record['device_ms'])} for batch 0's {len(pq0)} (query, 1024-row block) "
        f"pairs over {n_blocks} distinct blocks ({len(pq0) / max(n_blocks, 1):.3f} pairs a "
        f"block); plain {record['plain_ms']:.4f} ms; bound {record['bound_ms']:.6f} ms (bytes: "
        f"{nbytes}, each distinct block once, at 3.35 TB/s), "
        f"{record['bound_ms'] / record['ms']:.4f} of it")
    if record["bound_ms"] / record["ms"] > 1:
        raise AssertionError("planned_count reads more than its bound")
    gq, gb = intervals_to_block_pairs(ivs_r[0], JOIN_BLOCK)
    g_ms, g_hits = planned_gather_count_ms(cols, true_n, gq, gb, boxes_r[0], times_r[0])
    per_q = np.bincount(gq, weights=g_hits.cpu().numpy(), minlength=n_queries)
    if not np.array_equal(per_q.astype(np.int64), counts_r[0].astype(np.int64)):
        raise AssertionError("planned_gather's count pass disagrees with config 7's counts")
    g_bytes = len(np.unique(gb)) * JOIN_BLOCK * 16
    log(f"phase 10 planned_gather count entry (for the reader): {g_ms:.4f} ms (CUDA events) "
        f"for batch 0 planned at 4096-row blocks, {len(gq)} pairs over {len(np.unique(gb))} "
        f"distinct blocks (bound {g_bytes / MEM_BYTES_PER_S * 1e3:.6f} ms by bytes); "
        f"planned_count over the same queries at 1024-row blocks {record['ms']:.4f} ms")
    return record, launched


# -- phase 11: bench config 10, the corridor engine and interlink -------------------

TRAJECTORY_ROWS = 2_000_000  # bench config 10's N on an accelerator (bench.py:1840)
TRAJECTORY_CORRIDORS = 16  # min(Q, 16)
CORRIDOR_CHECK_ROWS = 1_000_003  # phase 11a's rows
# corridor_masks stages at most 40 KB of corridors a tile, 56 B a segment and
# 16 B a corridor: at most 170 corridors of 4 segments, and one corridor of at
# most 731 segments. Phase 11a drives both tiling loops past those.
CORRIDOR_TILED_Q = 600
CORRIDOR_LONG_PTS = 1500  # 1499 segments: three segment tiles
CORRIDOR_LONG_ROWS = 100_003  # the plain version's (S, N) intermediates stay ~0.6 GB
HEADING_ROWS = 20_000  # the heading leg's store
LINE_ROWS = 100_000  # the line leg's store: the row form on the main path
LINE_SEED = 33
LINK_ROWS = (1500, 3000)  # the interlink leg's L and R stores (bench.py:1933-1934)
LINK_SEEDS = (31, 32)
LINK_DISTANCE = 0.4
LINK_TIME_BUFFER_MS = 3_600_000
# Instructions of one (row, segment) pair of corridor_masks, as the kernel
# runs it. Every pair takes the time test, two 64-bit compares of the row's
# biased key (TIME_SLOT_OPS: four ISETP, ALU-only); a pair inside the
# segment's time quad the reach box's four f32 compares (four FSETP, counted
# at the issue rate only: their pipe is not assumed); only a pair
# inside the box too runs the distance test, f32 operations each at least
# one instruction: two subtracts, a dot of two products and a sum, a
# division, a clamp of two, x1 + tp * dx and its difference per axis, two
# squares and a sum (17) and the two band compares; the heading adds a
# subtract, an add, the remainder (counted as one), its fix-up add, a
# subtract, an abs and two compares (8), and the bidirectional minimum two
# more.
CORRIDOR_BOX_OPS = 4
CORRIDOR_SEG_FLOPS = 19
CORRIDOR_HEADING_FLOPS = 8
CORRIDOR_BIDIR_FLOPS = 2


def corridor_pairs(cx, cy, bins, offs, segs, tq, buf2_hi) -> tuple[int, int]:
    """The (row, segment) pairs of one corridor_masks call that pass the
    kernel's time test, and of those the pairs inside the segment's reach
    box too, whose distance test the kernel runs (the others it skips):
    the kernel's skip condition on the plain reach boxes
    (``kernels.corridor_reach_boxes``), one corridor at a time. ``cx, cy``
    are the f32 coordinates the kernel tests (the gather form's
    dequantized ones)."""
    from geomesa_tpu_torch.ops.kernels import _time_keys, corridor_reach_boxes

    key = _time_keys(bins, offs)[None, :]
    boxes = corridor_reach_boxes(segs, buf2_hi)
    lo, hi = _time_keys(tq[..., 0], tq[..., 1]), _time_keys(tq[..., 2], tq[..., 3])
    in_time = tested = 0
    for qi in range(segs.shape[0]):
        t = ~((key < lo[qi][:, None]) | (key > hi[qi][:, None]))
        b = boxes[qi]
        out = ((cx[None, :] < b[:, 0:1]) | (cx[None, :] > b[:, 1:2])
               | (cy[None, :] < b[:, 2:3]) | (cy[None, :] > b[:, 3:4]))
        in_time += int(t.sum())
        tested += int((t & ~out).sum())
    return in_time, tested


def corridor_floor(n: int, q: int, s: int, heading: bool, bidirectional: bool,
                   in_time: int, tested: int, gather: bool = False) -> dict:
    """``bound_ms``/``bound_by`` of one corridor_masks call over ``n`` rows
    (the row form) or ``n`` candidates (``gather``), ``in_time`` and
    ``tested`` its pairs from :func:`corridor_pairs`. Bytes: 16 B read a
    row, 20 with the heading (the only variants that read it), and the
    gather form's 4 B of position more; 2 bits written a (corridor, row),
    as the two masks' (Q, ceil(n / 32)) 4-B words. Operations (the
    constants above): the time test of all Q x S x N pairs (ALU-only), the
    box test of the ``in_time`` ones and the distance test of the
    ``tested`` ones; the ALU-only instructions at the ALU rate, all of
    them at the issue rate (:func:`bound_fields`)."""
    flops = tested * (CORRIDOR_SEG_FLOPS + (CORRIDOR_HEADING_FLOPS if heading else 0)
                      + (CORRIDOR_BIDIR_FLOPS if bidirectional else 0))
    alu = q * s * n * TIME_SLOT_OPS[0]
    ops = alu + in_time * CORRIDOR_BOX_OPS + flops
    nbytes = n * (16 + 4 * heading + 4 * gather) + 2 * q * ((n + 31) // 32) * 4
    return {**bound_fields((alu, ops), nbytes), "alu": alu, "ops": ops, "flops": flops,
            "bytes": nbytes, "pairs": q * s * n, "in_time": in_time, "tested": tested}


def corridor_case(rng, q: int, n: int, heading: bool, bidirectional: bool, sft,
                  long_pts: int = 0):
    """Phase 11a's inputs: ``q`` corridors of 2-5 waypoints (so the shorter
    ones carry padded segments; with ``long_pts`` the first corridor has
    that many, so that its segments span several of the kernel's
    shared-memory tiles), tubes and routes (the unconstrained quad),
    one with a zero-length segment, headings constrained or not (the >= 360
    sentinel), the last corridor padded (negative buf2); ``n`` rows, the
    first on segments' buffer distances, end points and just past them, and
    on and around the edges of the kernel's reach boxes, the rest scattered,
    with NaN and infinite headings and times at and around the quads.
    Returns the row tensors' host arrays and the packed payloads."""
    from geomesa_tpu_torch.curve.binned_time import BinnedTime
    from geomesa_tpu_torch.trajectory.corridor import CorridorSpec, _pack

    t0 = 1_600_000_000_000
    specs = []
    for qi in range(q):
        npts = long_pts if long_pts and qi == 0 else int(rng.integers(2, 6))
        pts = [(float(a), float(b)) for a, b in zip(np.sort(rng.uniform(-8, 8, npts)),
                                                    rng.uniform(-4, 4, npts))]
        if qi % 5 == 2:
            pts[1] = pts[0]
        buf = float(rng.uniform(0.05, 1.5))
        tol = float(rng.uniform(5, 90)) if heading and qi % 4 else None
        bi = bidirectional and tol is not None
        ts = ([t0 + int(v) for v in np.sort(rng.integers(0, 3 * DAY_MS, npts))]
              if qi % 2 else None)
        specs.append(CorridorSpec(tuple(pts), None if ts is None else tuple(ts), buf,
                                  int(rng.integers(0, 10)) * 3_600_000, tol, bi))
    segs, tq, brg, *bands = _pack(specs, sft)
    if q > 1:
        bands[0][-1] = bands[1][-1] = -1.0  # a padded corridor
    xs, ys = [], []
    for spec in specs:
        x1, y1, x2, y2, _, _ = spec.segments()
        for k in range(len(x1)):
            dx, dy = x2[k] - x1[k], y2[k] - y1[k]
            norm = np.hypot(dx, dy) or 1.0
            for u in (0.0, 0.5, 1.0):
                for off in (spec.buffer_deg, -spec.buffer_deg, spec.buffer_deg * (1 + 1e-7)):
                    xs.append(x1[k] + u * dx - off * dy / norm)
                    ys.append(y1[k] + u * dy + off * dx / norm)
            for r in (spec.buffer_deg * 1.001 + 1e-3 + e for e in (-1e-6, 0.0, 1e-6)):
                for ex, ey in ((r, 0.0), (-r, 0.0), (0.0, r), (0.0, -r)):  # the reach box's edges
                    xs.append(x2[k] + ex)
                    ys.append(y2[k] + ey)
    xs = np.concatenate([xs, rng.uniform(-10, 10, max(n - len(xs), 0))])[:n]
    ys = np.concatenate([ys, rng.uniform(-6, 6, max(n - len(ys), 0))])[:n]
    tms = t0 + rng.integers(-DAY_MS, 4 * DAY_MS, n)
    tms[::3] = t0
    hdg = rng.uniform(0, 360, n)
    hdg[::7] = np.nan
    hdg[3::11] = np.inf
    bins, offs = BinnedTime(sft.z3_interval).to_bin_and_offset(tms)
    rows = (xs.astype(np.float32), ys.astype(np.float32), bins.astype(np.int32),
            offs.astype(np.int32), hdg.astype(np.float32))
    return rows, (segs, tq, brg, *bands)


def gather_case(rng, rows, dev, extra: int = 4099):
    """The gather form's inputs for :func:`corridor_case`'s rows: their
    coordinates normalized at 31 bits among ``extra`` other rows in a
    shuffled resident order, as a point state stages them, and each row's
    position, so candidate i is row i. Returns ``(cols, pos, hdg)`` on
    ``dev``."""
    import torch

    from geomesa_tpu_torch.curve.normalize import lat, lon

    xs, ys, bins, offs, hdg = rows
    n = len(xs)
    order = rng.permutation(n + extra)  # resident position -> row
    allx = np.concatenate([xs.astype(np.float64), rng.uniform(-180, 180, extra)])
    ally = np.concatenate([ys.astype(np.float64), rng.uniform(-90, 90, extra)])
    allb = np.concatenate([bins, rng.integers(0, 3000, extra)])
    allo = np.concatenate([offs, rng.integers(0, 604_800, extra)])
    cols = [lon(31).normalize(allx[order]), lat(31).normalize(ally[order]), allb[order],
            allo[order]]
    cols = [torch.from_numpy(np.ascontiguousarray(c, dtype=np.int32)).to(dev) for c in cols]
    pos = torch.from_numpy(np.argsort(order)[:n].astype(np.int32)).to(dev)
    return cols, pos, torch.from_numpy(hdg).to(dev)


_POPCOUNT = np.array([bin(i).count("1") for i in range(256)], dtype=np.uint8)


def popcount(words) -> int:
    """Set bits of a tensor of mask words (a byte table on the host)."""
    return int(_POPCOUNT[words.cpu().numpy().view(np.uint8)].sum(dtype=np.int64))


def words_differing(got, want) -> int:
    """Words of the two (cand, sure) mask pairs that differ."""
    return int((got[0] != want[0]).sum()) + int((got[1] != want[1]).sum())


def check_corridor_kernel(dev, seed: int) -> tuple[int, int]:
    """Phase 11a: both forms of ``corridor_masks`` against their plain
    versions on the card, word for word (cand and sure), in the four
    variants, Q in {1, 16, 65} and N in {1, 1,000,003}, on
    :func:`corridor_case`'s rows in :func:`gather_case`'s resident layout;
    and the kernel's two tiling loops: Q = CORRIDOR_TILED_Q corridors, more
    than one shared-memory tile holds (N in {1, 1,000,003}), and a corridor
    of CORRIDOR_LONG_PTS waypoints, whose segments span two tiles (N in {1,
    CORRIDOR_LONG_ROWS}). The row form takes the candidates' dequantized
    coordinates (``corridor_dequantize``, the gather form's own), so one
    call of ``corridor_masks_plain`` on them is both forms' referee: it is
    what ``corridor_masks_gather_plain`` computes. Returns the differing
    words of the row and the gather form (0, 0)."""
    import torch

    from geomesa_tpu_torch.ops.kernels import (
        corridor_dequantize, corridor_masks, corridor_masks_gather, corridor_masks_plain)
    from geomesa_tpu_torch.schema.sft import parse_spec

    rng = np.random.default_rng(seed)
    sft = parse_spec("c", "heading:Double,dtg:Date,*geom:Point:srid=4326")
    worst = [0, 0]
    cases = ([(q, n, 0) for q in (1, 16, 65, CORRIDOR_TILED_Q) for n in (1, CORRIDOR_CHECK_ROWS)]
             + [(3, n, CORRIDOR_LONG_PTS) for n in (1, CORRIDOR_LONG_ROWS)])
    for heading, bidir in ((False, False), (True, False), (True, True), (False, True)):
        for q, n, long_pts in cases:
            rows, payload = corridor_case(rng, q, n, heading, bidir, sft, long_pts)
            pay = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in payload]
            cols, pos, hdg = gather_case(rng, rows, dev)
            p = pos.long()
            args = [*corridor_dequantize(cols[0][p], cols[1][p]), cols[2][p], cols[3][p], hdg]
            want = corridor_masks_plain(*args, *pay, heading, bidir)
            got = corridor_masks(*args, *pay, heading, bidir)
            ggot = corridor_masks_gather(*cols, pos, hdg if heading else None, *pay, heading,
                                         bidir)
            torch.cuda.synchronize()
            diff = (words_differing(got, want), words_differing(ggot, want))
            worst = [max(w, d) for w, d in zip(worst, diff)]
            bits = [popcount(w) for w in want]
            log(f"  corridor_masks heading={heading} bidirectional={bidir} Q={q} "
                f"S={payload[0].shape[1]} N={n}: {diff[0]} differing words (row form), "
                f"{diff[1]} (gather form); cand bits {bits[0]}, sure bits {bits[1]}")
    if any(worst):
        raise AssertionError(f"corridor_masks disagrees with its plain versions: {worst} words")
    return worst[0], worst[1]


def link_store(dev, name: str, n: int, seed: int):
    from geomesa_tpu_torch.schema.columnar import Column, FeatureTable, point_column
    from geomesa_tpu_torch.schema.sft import AttributeType, parse_spec
    from geomesa_tpu_torch.store.datastore import DataStore
    from geomesa_tpu_torch.workload import LINK_SPEC, link_points

    t, x, y = link_points(n, seed)
    ds = DataStore(device=dev)
    sft = ds.create_schema(parse_spec(name, LINK_SPEC))
    ds.write(name, FeatureTable.from_columns(sft, np.arange(n).astype(str), {
        "dtg": Column(AttributeType.DATE, t), "geom": point_column(x, y)}))
    ds.compact(name)
    return ds


def heading_leg(dev, seed: int) -> int:
    """A small store with a ``heading:Double`` column holding NaNs and
    nulls, and a mixed batch of route corridors (unconstrained,
    unidirectional and bidirectional): the device route's two launches
    against ``route_search`` by fid sets. Returns the corridors checked."""
    from geomesa_tpu_torch.ops import kernels
    from geomesa_tpu_torch.process.tracks import route_search
    from geomesa_tpu_torch.schema.columnar import Column, FeatureTable, point_column
    from geomesa_tpu_torch.schema.sft import AttributeType, parse_spec
    from geomesa_tpu_torch.store.datastore import DataStore
    from geomesa_tpu_torch.trajectory.corridor import CorridorSpec, tube_select_many
    from geomesa_tpu_torch.workload import T0

    rng = np.random.default_rng(seed)
    n = HEADING_ROWS
    hdg = rng.uniform(-30, 400, n)
    hdg[::17] = np.nan
    valid = np.ones(n, dtype=bool)
    valid[::13] = False
    ds = DataStore(device=dev)
    sft = ds.create_schema(parse_spec("hd", "heading:Double,dtg:Date,*geom:Point"))
    ds.write("hd", FeatureTable.from_columns(sft, np.arange(n).astype(str), {
        "heading": Column(AttributeType.DOUBLE, hdg, valid),
        "dtg": Column(AttributeType.DATE, T0 + rng.integers(0, DAY_MS, n)),
        "geom": point_column(rng.uniform(-12, 12, n), rng.uniform(-6, 6, n))}))
    kinds = [(None, False), (40.0, False), (60.0, True), (25.0, False), (75.0, True),
             (90.0, True)]
    specs = []
    for tol, bi in kinds:
        pts = [(float(a), float(b)) for a, b in zip(np.sort(rng.uniform(-10, 10, 3)),
                                                    rng.uniform(-4, 4, 3))]
        specs.append(CorridorSpec.route(pts, float(rng.uniform(0.3, 1.5)), tol, bi))
    before = kernels.launches["corridor_masks_gather"]
    tm = {}
    got = tube_select_many(ds, "hd", specs, heading_field="heading", route="device", timings=tm)
    launched = kernels.launches["corridor_masks_gather"] - before
    if tm["route"] != "device:resident" or (dev.type == "cuda" and launched != 2):
        raise AssertionError(f"a mixed uni/bidirectional batch took {tm['route']} and launched "
                             f"the gather form {launched} times, not 2")
    for spec, g in zip(specs, got):
        want = route_search(ds, "hd", list(spec.pts), spec.buffer_deg,
                            heading_field="heading" if spec.heading_tolerance_deg else None,
                            heading_tolerance_deg=spec.heading_tolerance_deg or 45.0,
                            bidirectional=spec.bidirectional)
        if sorted(map(str, g.fids)) != sorted(map(str, want.fids)):
            raise AssertionError("the heading leg differs from route_search")
    log(f"phase 11 heading leg: {len(specs)} route corridors (unconstrained, uni- and "
        f"bidirectional) on {n} rows with NaN and null headings == route_search by fid sets "
        f"({[len(g) for g in got]} rows); {launched} corridor_masks_gather launches")
    return len(specs)


def table_rows(ds, name: str, specs, dev) -> list:
    """The row form's inputs as the table route uploads them
    (``trajectory.corridor._TableRows``): the rows of the candidate query
    (``prune_filter``) as f32 ``representative_xy``, int32 (bin, offset),
    and zero headings."""
    import torch

    from geomesa_tpu_torch.curve.binned_time import BinnedTime
    from geomesa_tpu_torch.planning.planner import Query
    from geomesa_tpu_torch.schema.columnar import representative_xy
    from geomesa_tpu_torch.trajectory.corridor import prune_filter

    sft = ds.get_schema(name)
    cand = ds.query(name, Query(filter=prune_filter(sft, specs))).table
    xs, ys = representative_xy(cand)
    bins, offs = BinnedTime(sft.z3_interval).to_bin_and_offset(cand.dtg_millis())
    return [torch.from_numpy(np.ascontiguousarray(a, dtype=d)).to(dev) for a, d in
            ((xs, np.float32), (ys, np.float32), (bins, np.int32), (offs, np.int32),
             (np.zeros(len(xs)), np.float32))]


def line_leg(dev, lon, lat, t, specs) -> tuple[int, list]:
    """The row form on the main path: a line-string store (LINE_ROWS
    two-vertex tracks from config 10's first points, on xz3 + xz2, so its
    plan reads a bbox state) through ``tube_select_many(route="device")``,
    one ``corridor_masks`` launch, fid sets == the host route's. Returns the
    rows matched and the rows that launch tested (:func:`table_rows`)."""
    from geomesa_tpu_torch.ops import kernels
    from geomesa_tpu_torch.schema.columnar import Column, FeatureTable, linestring_column
    from geomesa_tpu_torch.schema.sft import AttributeType, parse_spec
    from geomesa_tpu_torch.store.datastore import DataStore
    from geomesa_tpu_torch.trajectory.corridor import tube_select_many

    m = min(LINE_ROWS, len(lon))
    rng = np.random.default_rng(LINE_SEED)
    coords = np.empty((2 * m, 2))
    coords[0::2, 0], coords[0::2, 1] = lon[:m], lat[:m]
    coords[1::2, 0] = np.clip(lon[:m] + rng.uniform(-0.3, 0.3, m), -179.9, 179.9)
    coords[1::2, 1] = np.clip(lat[:m] + rng.uniform(-0.2, 0.2, m), -89.9, 89.9)
    ds = DataStore(device=dev)
    sft = ds.create_schema(parse_spec("lines", "dtg:Date,*geom:LineString"))
    ds.write("lines", FeatureTable.from_columns(sft, np.arange(m).astype(str), {
        "dtg": Column(AttributeType.DATE, t[:m].astype(np.int64)),
        "geom": linestring_column(coords, np.arange(0, 2 * m + 1, 2))}))
    before = kernels.launches["corridor_masks"]
    tm = {}
    got = tube_select_many(ds, "lines", specs, route="device", timings=tm)
    launched = kernels.launches["corridor_masks"] - before
    if tm["route"] != "device:table" or (dev.type == "cuda" and launched != 1):
        raise AssertionError(f"the line store took {tm['route']} and launched the row form "
                             f"{launched} times, not once")
    host = tube_select_many(ds, "lines", specs, route="host")
    for i, (g, h) in enumerate(zip(got, host)):
        if sorted(map(str, g.fids)) != sorted(map(str, h.fids)):
            raise AssertionError(f"line corridor {i}: the row form's route differs from the host")
    rows = sum(len(g) for g in got)
    tested = table_rows(ds, "lines", specs, dev)
    if tested[0].shape[0] != tm["candidates"]:
        raise AssertionError("the line leg's rows rebuilt differ from those it tested")
    log(f"phase 11 line leg: {m} line strings, {len(specs)} corridors, route {tm['route']}, "
        f"{tm['candidates']} candidates, {rows} rows == the host route; {launched} "
        f"corridor_masks launch (row form)")
    return rows, tested


# -- phase 11d: track statistics over phase 11b's store -------------------------------

TRACK_CHECK_ROWS = 1_000_003  # the kernel alone: one entity holds half of them
TRACK_RTOL, TRACK_ATOL = 5e-3, 1e-3  # f32 sums against the f64 referee (tests/test_trajectory.py:176)
# the kernel against its plain version: the sums' order (the card's atomics,
# index_add_'s) and atan2f's last bit; every decision (dist > 0, dist <= eps)
# is taken on the same correctly rounded f32 distance
TRACK_KERNEL_RTOL, TRACK_KERNEL_ATOL = 1e-4, 1e-3
# f32 operations a row at least: dx, dy, two squares, their sum, the root,
# atan2 (counted as one), the degrees, the bearing difference, + 180, the
# remainder, - 180, the absolute value, and the four sums' adds
TRACK_ROW_FLOPS = 17
F32_OPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores
TRACK_LAYOUTS = ("empty", "singles", "giant", "dwell", "odd", "edges", "steps", "one", "small")


def track_layout(kind: str, seed: int, n: int):
    """(offsets int64, dt f32, x f32, y f32) of a track layout of about
    ``n`` rows: no row (``empty``), one row an entity (``singles``), one
    entity holding half the rows (``giant``), parked runs of repeated
    positions (``dwell``), a row count that is not a multiple of 32
    (``odd``), or around the card kernel's tiles of ``TRACK_TILE`` rows T:
    entities that end and empty entities that sit on tile edges and between
    entities inside a tile (``edges``: a cycle of sizes 0, T, 0, 0, T / 3,
    0, 2T - T / 3, T - 5, 5, 0), entities of 3T + 7 rows with a zero-length
    step into the first row of even tiles and a 90-degree turn across the
    edge into odd ones (``steps``), a single entity of n / 4 rows (``one``)
    or fewer rows than a tile (``small``)."""
    from geomesa_tpu_torch.ops.kernels import TRACK_TILE

    rng = np.random.default_rng(seed)
    t = TRACK_TILE
    if kind == "edges":
        cycle = [0, t, 0, 0, t // 3, 0, 2 * t - t // 3, t - 5, 5, 0]
        sizes = np.array(cycle * (n // (4 * t)) + [n % (4 * t)], dtype=np.int64)
    elif kind == "steps":
        sizes = np.full(n // (3 * t + 7), 3 * t + 7, dtype=np.int64)
    elif kind == "one":  # a quarter of n: the plain version's f32 sum of one entity drifts
        sizes = np.array([n // 4], dtype=np.int64)
    elif kind == "small":
        sizes = np.array([1, t // 4 + 1, 0, t // 4 + 1], dtype=np.int64)
    elif kind == "empty":
        sizes = np.zeros(0, dtype=np.int64)
    elif kind == "singles":
        sizes = np.ones(n, dtype=np.int64)
    elif kind == "giant":
        side = rng.integers(1, 400, 2 * (n // 2) // 400)
        side = side[np.cumsum(side) <= n - n // 2]
        sizes = np.r_[side[: len(side) // 2], n // 2, side[len(side) // 2:]]
        sizes[-1] += n - sizes.sum()
    elif kind == "dwell":
        sizes = rng.integers(2, 300, n // 150)
    else:
        sizes = rng.integers(1, 300, n // 150)
        sizes[-1] += sizes.sum() % 32 == 0
    offsets = np.r_[0, np.cumsum(sizes)].astype(np.int64)
    m = int(offsets[-1])
    x = rng.uniform(-30, 30, m).astype(np.float32)
    y = rng.uniform(-20, 20, m).astype(np.float32)
    if kind == "dwell":
        for k in range(0, max(m - 4, 0), 7):
            x[k + 1:k + 4], y[k + 1:k + 4] = x[k], y[k]
    if kind == "steps":
        for j, e in enumerate(range(t, m, t)):
            if j % 2:  # a turn whose middle row ends a tile
                x[e - 2:e + 1], y[e - 2:e + 1] = [1.0, 2.0, 2.0], [1.0, 1.0, 2.0]
            else:  # a zero-length step into a tile's first row
                x[e], y[e] = x[e - 1], y[e - 1]
    dt = rng.integers(0, 90, m).astype(np.float32)
    dt[offsets[:-1][sizes > 0]] = 0
    return offsets, dt, x, y


def track_floor(n: int, e: int) -> dict:
    """``track_stats``' least work: bytes are the three f32 columns read
    once (12 B a row), the offsets (8 B an entity, and one) and the four
    f32 sums written once (16 B an entity); operations
    :data:`TRACK_ROW_FLOPS` a row at the f32 rate."""
    nbytes = 12 * n + 8 * (e + 1) + 16 * e
    bytes_ms = nbytes / MEM_BYTES_PER_S * 1e3
    ops_ms = TRACK_ROW_FLOPS * n / F32_OPS_PER_S * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations", "bytes": nbytes}


def track_kernel_err(got, want) -> tuple[float, float]:
    """(largest |kernel - plain| over the four sums, the largest of it over
    the tolerance rtol |plain| + atol: above 1 fails)."""
    err = ratio = 0.0
    for g, w in zip(got, want):
        if g.numel():
            d = (g.double() - w.double()).abs()
            err = max(err, float(d.max()))
            lim = TRACK_KERNEL_RTOL * w.double().abs() + TRACK_KERNEL_ATOL
            ratio = max(ratio, float((d / lim).max()))
    return err, ratio


def track_stats_leg(dev, ds, n_rows: int) -> tuple[dict, dict]:
    """Phase 11d: track statistics over phase 11b's store (``ds``, type
    ``tracks``). Returns the ``track_stats`` record's fields and the main
    path's launches."""
    import torch

    from geomesa_tpu_torch.ops import kernels
    from geomesa_tpu_torch.ops.kernels import track_stats, track_stats_plain, track_terms
    from geomesa_tpu_torch.trajectory import state as tstate

    on_card = dev.type == "cuda"
    tstate.invalidate(ds)
    for k in kernels.launches:
        kernels.launches[k] = 0
    tm = {}
    t0 = time.perf_counter()
    st = tstate.build_track_state(ds, "tracks", "track", timings=tm)
    build_s = time.perf_counter() - t0
    cols = st.device_columns(dev)
    log(f"phase 11d build_track_state: {build_s:.3f} s (scan {tm['scan_s']:.3f}, lexsort and "
        f"offsets {tm['sort_s']:.3f}, sorted table and columns {tm['take_s']:.3f}); staging "
        f"{st.stage_s:.3f} s ({st.nbytes} device bytes); {st.n} rows, {st.n_entities} "
        f"entities, validate {st.validate() or 'clean'}")
    if st.validate():
        raise AssertionError("the track state breaks its CSR invariants")
    tstate.invalidate(ds)
    s = time.perf_counter()
    got = tstate.track_stats(ds, "tracks", "track")
    cold_ms = (time.perf_counter() - s) * 1e3
    warm = []
    for _ in range(5):
        s = time.perf_counter()
        got = tstate.track_stats(ds, "tracks", "track")
        warm.append((time.perf_counter() - s) * 1e3)
    launched = dict(kernels.launches)
    if on_card and launched["track_stats"] != 6:
        raise AssertionError(f"6 track_stats calls launched the kernel {launched['track_stats']} "
                             "times")
    st = tstate.get_track_state(ds, "tracks", "track")
    host = tstate.track_stats_host(st)
    for k in ("track", "rows", "first_ms", "last_ms", "last_x", "last_y", "last_fid"):
        if list(got[k]) != list(host[k]):
            raise AssertionError(f"track_stats {k} differs from track_stats_host")
    worst = 0.0
    for k in ("length_deg", "duration_s", "avg_speed_deg_s", "heading_change_deg", "dwell_s"):
        d = np.abs(got[k] - host[k])
        if not (d <= TRACK_RTOL * np.abs(host[k]) + TRACK_ATOL).all():
            raise AssertionError(f"track_stats {k} differs from track_stats_host by {d.max()}")
        worst = max(worst, float((d / (TRACK_RTOL * np.abs(host[k]) + TRACK_ATOL)).max()))
    log(f"phase 11d track_stats: cold {cold_ms:.3f} ms (the state built, staged and the kernel), "
        f"warm p50 {p50(warm):.3f} ms over 5 (the cached state) for {st.n_entities} entities; "
        f"== track_stats_host (labels, rows and times exact; the sums within rtol "
        f"{TRACK_RTOL} + atol {TRACK_ATOL}, worst {worst:.4f} of it; dwell total "
        f"{got['dwell_s'].sum():.1f} s); launches {launched['track_stats']}")
    record = {}
    if not on_card:
        return record, launched

    # -- the kernel alone: config 10's shape, then the adversarial shapes -----------------
    eps = tstate.DEFAULT_DWELL_EPS_DEG
    args = (*cols, eps)
    got = track_stats(*args)
    err, ratio = track_kernel_err(got, track_stats_plain(*args))
    repeats = all(torch.equal(a, b) for a, b in zip(got, track_stats(*args)))
    shapes = [f"config 10 (N={st.n}, E={st.n_entities}) {err:.3e}"]
    for i, kind in enumerate(TRACK_LAYOUTS):
        off, dt, x, y = track_layout(kind, 61 + i, TRACK_CHECK_ROWS)
        a = [torch.from_numpy(v).to(dev) for v in (x, y, dt, off)]
        got = track_stats(*a, eps)
        e, r = track_kernel_err(got, track_stats_plain(*a, eps))
        repeats = repeats and all(torch.equal(u, v) for u, v in zip(got, track_stats(*a, eps)))
        empty = torch.from_numpy(np.diff(off) == 0).to(dev)
        if any(bool(g[empty].any()) for g in got):
            raise AssertionError(f"track_stats gives an empty entity non-zero sums ({kind})")
        err, ratio = max(err, e), max(ratio, r)
        shapes.append(f"{kind} (N={len(x)}, E={len(off) - 1}) {e:.3e}")
    torch.cuda.synchronize()
    if ratio > 1:
        raise AssertionError(f"track_stats disagrees with its plain version: {ratio:.3f} of the "
                             "tolerance")
    if not repeats:
        raise AssertionError("two track_stats calls on the same inputs differ")
    log(f"phase 11d kernel-vs-plain: ok within rtol {TRACK_KERNEL_RTOL} + atol "
        f"{TRACK_KERNEL_ATOL} (worst {ratio:.4f} of it; empty entities 0; two calls on each "
        f"layout equal bit for bit); largest |difference|: " + "; ".join(shapes))
    ms = cuda_ms(lambda: track_stats(*args), 20)
    dms = device_ms(lambda: track_stats(*args))
    plain = cuda_ms(lambda: track_stats_plain(*args), 3)
    terms = torch.stack(track_terms(*cols, eps)[1:], dim=1).contiguous()
    lengths = cols[3][1:] - cols[3][:-1]
    seg = torch.segment_reduce(terms, "sum", lengths=lengths, axis=0)
    _, seg_ratio = track_kernel_err(track_stats(*args), tuple(seg.T))
    seg_ms = cuda_ms(lambda: torch.segment_reduce(terms, "sum", lengths=lengths, axis=0), 20)
    fl = track_floor(st.n, st.n_entities)
    record.update(max_abs_err=err, ms=ms, device_ms=dms, plain_ms=plain,
                  bound_ms=fl["bound_ms"], bound_by=fl["bound_by"],
                  segment_reduce_part_ms=seg_ms)
    log(f"phase track_stats timing: {ms:.4f} ms (CUDA events, 20 launches), device "
        f"{fmt_ms(dms)} (10 calls behind a spin) at N={st.n} E={st.n_entities}; plain "
        f"{plain:.4f} ms; bound {fl['bound_ms']:.6f} ms ({fl['bound_by']}: {fl['bytes']} bytes, "
        f"{TRACK_ROW_FLOPS} f32 ops a row), {fl['bound_ms'] / ms:.4f} of it by events, "
        f"{fmt_ms(None if dms is None else fl['bound_ms'] / dms)} by device; a part of the work: "
        f"torch.segment_reduce of the four precomputed term columns {seg_ms:.4f} ms (its sums "
        f"{seg_ratio:.4f} of the tolerance from the kernel's); launch floor "
        f"{kernels.launch_floor_ms(dev):.4f} ms")
    if fl["bound_ms"] / ms > 1 or (dms is not None and fl["bound_ms"] / dms > 1):
        raise AssertionError("track_stats beats its bound")
    return record, launched


def trajectory_path(dev, n_rows: int) -> tuple[dict, dict, dict, dict]:
    """Phase 11b: bench config 10 at ``n_rows`` (see the module docstring),
    with phase 11d over its store. Returns the records of
    ``corridor_masks``' row form and gather form, the main path's launches
    and the ``track_stats`` record."""
    import torch

    from geomesa_tpu_torch.curve.binned_time import BinnedTime
    from geomesa_tpu_torch.ops import kernels
    from geomesa_tpu_torch.ops.kernels import (
        corridor_dequantize, corridor_masks, corridor_masks_gather, corridor_masks_gather_plain,
        corridor_masks_plain)
    from geomesa_tpu_torch.planning.planner import Query
    from geomesa_tpu_torch.process.processes import tube_select
    from geomesa_tpu_torch.schema.columnar import Column, FeatureTable, point_column
    from geomesa_tpu_torch.schema.sft import AttributeType, parse_spec
    from geomesa_tpu_torch.store.datastore import DataStore
    from geomesa_tpu_torch.trajectory.corridor import (
        CorridorSpec, _pack, prune_filter, tube_select_many)
    from geomesa_tpu_torch.trajectory.interlink import interlink, interlink_referee
    from geomesa_tpu_torch.workload import TRACK_SPEC, trajectory_workload

    on_card = dev.type == "cuda"
    t0 = time.perf_counter()
    lon, lat, t, tracks, n_tracks, corridors = trajectory_workload(
        n_rows, TRAJECTORY_CORRIDORS)
    log(f"phase 11 synth: {time.perf_counter() - t0:.3f} s ({n_rows} points on {n_tracks} "
        f"tracks, {len(corridors)} corridors, seed 15)")
    for k in kernels.launches:
        kernels.launches[k] = 0
    ds = DataStore(device=dev)
    sft = ds.create_schema(parse_spec("tracks", TRACK_SPEC))
    table = FeatureTable.from_columns(sft, np.arange(n_rows).astype(str), {
        "track": Column(AttributeType.STRING, tracks),
        "dtg": Column(AttributeType.DATE, t.astype(np.int64)), "geom": point_column(lon, lat)})
    t0 = time.perf_counter()
    ds.write("tracks", table)
    ds.compact("tracks")
    log(f"phase 11 write: {time.perf_counter() - t0:.3f} s (write + compact of {n_rows} rows)")
    specs = [CorridorSpec.tube(*c) for c in corridors]
    q = len(specs)

    # -- tube_select_many: one warm call, then the timed ones -------------------------
    before = dict(kernels.launches)
    tm = {}
    dev_res = tube_select_many(ds, "tracks", specs, route="device", timings=tm)
    per_call = {k: kernels.launches[k] - before[k]
                for k in ("corridor_masks_gather", "corridor_masks")}
    if tm["route"] != "device:resident" or (on_card and per_call != {
            "corridor_masks_gather": 1, "corridor_masks": 0}):
        raise AssertionError(f"tube_select_many took {tm['route']} with launches {per_call}")
    dt, splits = [], []
    for _ in range(5):
        tm = {}
        s = time.perf_counter()
        dev_res = tube_select_many(ds, "tracks", specs, route="device", timings=tm)
        dt.append((time.perf_counter() - s) * 1e3 / q)
        splits.append(tm)
    dev_p50 = p50(dt)
    ht, host_res = [], []
    for spec in specs:
        track = [(x, y, tt) for (x, y), tt in zip(spec.pts, spec.ts)]
        s = time.perf_counter()
        host_res.append(tube_select(ds, "tracks", track, spec.buffer_deg, spec.time_buffer_ms))
        ht.append((time.perf_counter() - s) * 1e3)
    host_p50 = p50(ht)
    for i, (d, h) in enumerate(zip(dev_res, host_res)):
        if sorted(map(str, d.fids)) != sorted(map(str, h.fids)):
            raise AssertionError(f"corridor {i}: tube_select_many differs from tube_select")
    log(f"phase 11 tube_select_corridor_p50_latency: {dev_p50:.4f} ms a corridor (p50 of 5 "
        f"calls of {q} corridors after a warm call); host tube_select p50 {host_p50:.3f} ms a "
        f"corridor, {host_p50 / dev_p50:.2f}x the device route; fid sets equal on all {q}; "
        f"launches a call: {per_call}")
    keys = ("plan_ms", "select_ms", "kernel_ms", "refine_ms", "residual_ms", "take_ms")
    log(f"phase 11 route split (p50 of 5 calls, ms; route {splits[0]['route']}): "
        + ", ".join(f"{k} {p50([sp[k] for sp in splits]):.3f}" for k in keys)
        + f"; {splits[0]['candidates']} candidates, {splits[0]['band_rows']} band rows refined "
        f"in f64, {splits[0]['residual_rows']} rows given to a residual, "
        f"{sum(len(d) for d in dev_res)} rows returned")
    heading_leg(dev, 19)
    _, line_rows = line_leg(dev, lon, lat, t, specs)

    # -- the interlink leg -----------------------------------------------------------
    lds = link_store(dev, "L", LINK_ROWS[0], LINK_SEEDS[0])
    rds = link_store(dev, "R", LINK_ROWS[1], LINK_SEEDS[1])
    lt, rt = lds.query("L", Query()).table, rds.query("R", Query()).table
    before = kernels.launches["planned_gather"]
    s = time.perf_counter()
    link2d = interlink(lds, "L", rds, "R", pred="dwithin", distance=LINK_DISTANCE)
    link_ms = (time.perf_counter() - s) * 1e3
    block_launches = kernels.launches["planned_gather"] - before
    s = time.perf_counter()
    link3d = interlink(lds, "L", rds, "R", pred="dwithin", distance=LINK_DISTANCE,
                       time_buffer_ms=LINK_TIME_BUFFER_MS)
    link3d_ms = (time.perf_counter() - s) * 1e3
    s = time.perf_counter()
    link_xz = interlink(lds, "L", rds, "R", pred="dwithin", distance=LINK_DISTANCE, route="xz")
    xz_ms = (time.perf_counter() - s) * 1e3
    want2d = interlink_referee(lt, rt, "dwithin", LINK_DISTANCE)
    want3d = interlink_referee(lt, rt, "dwithin", LINK_DISTANCE, LINK_TIME_BUFFER_MS)
    if link2d != want2d or link_xz != want2d or link3d != want3d:
        raise AssertionError("an interlink leg differs from interlink_referee")
    if on_card and block_launches == 0:
        raise AssertionError("the default interlink (the block route) launched no planned_gather")
    log(f"phase 11 interlink: interlink_ms {link_ms:.2f} (the default route, block: 2D dwithin "
        f"{LINK_DISTANCE}, {len(link2d)} pairs, {block_launches} planned_gather launches), "
        f"time-lifted {link3d_ms:.2f} ms (the XZ3 pairing: {len(link3d)} pairs), forced XZ "
        f"pairing {xz_ms:.2f} ms (2D, {len(link_xz)} pairs); all == interlink_referee")
    launched = dict(kernels.launches)
    log(f"phase 11 launches: {launched}")
    if on_card and any(launched[k] == 0 for k in ("z3_encode", "z2_encode", "corridor_masks",
                                                    "corridor_masks_gather",
                                                    "planned_gather")):
        raise AssertionError("phase 11's main path must launch z3_encode, z2_encode, both "
                             "forms of corridor_masks and planned_gather")

    # -- the table route on the same store (outside the run above) -------------------------
    # The row form over the candidate query's rows, the route every store took before the
    # gather form: the candidate query's residual and take, the rows' upload.
    ds.resident_candidates = lambda *a, **k: None
    tt, tsplits = [], []
    for _ in range(4):
        tm = {}
        s = time.perf_counter()
        table_res = tube_select_many(ds, "tracks", specs, route="device", timings=tm)
        tt.append((time.perf_counter() - s) * 1e3 / q)
        tsplits.append(tm)
    del ds.resident_candidates
    for i, (a, b) in enumerate(zip(table_res, dev_res)):
        if sorted(map(str, a.fids)) != sorted(map(str, b.fids)):
            raise AssertionError(f"corridor {i}: the table route differs from the resident one")
    log(f"phase 11 table route (row form over the candidate query's rows, route "
        f"{tsplits[0]['route']}): p50 {p50(tt[1:]):.4f} ms a corridor of 3 calls after a warm "
        "one; split (ms) " + ", ".join(f"{k} {p50([sp[k] for sp in tsplits[1:]]):.3f}"
                                       for k in keys)
        + f"; {tsplits[0]['candidates']} candidates, {tsplits[0]['band_rows']} band rows")
    t1 = time.perf_counter()
    track_record, track_launched = track_stats_leg(dev, ds, n_rows)
    track_record["launches"] = track_launched["track_stats"]
    log(f"phase 11d: {time.perf_counter() - t1:.3f} s in all")
    record, grecord = {}, {}
    if not on_card:
        return record, grecord, launched, track_record

    # -- both forms alone: each at its main-path shape (the record), and at the point
    # store's candidate query's rows and every row x 16 and x 64 -----------------------------
    res = ds.resident_candidates("tracks", Query(filter=prune_filter(sft, specs)))
    rows = table_rows(ds, "tracks", specs, dev)
    all_specs = [CorridorSpec.tube(*c) for c in trajectory_workload(n_rows, 64)[5]]
    bins, offs = BinnedTime(sft.z3_interval).to_bin_and_offset(t)
    all_rows = [torch.from_numpy(np.ascontiguousarray(a, dtype=d)).to(dev) for a, d in
                ((lon, np.float32), (lat, np.float32), (bins, np.int32), (offs, np.int32),
                 (np.zeros(n_rows), np.float32))]
    cols = res.state.spatial_cols()
    every = torch.arange(n_rows, dtype=torch.int32, device=dev)
    log(f"phase 11 corridors: {rows[0].shape[0]} candidate rows of {n_rows} by the candidate "
        f"query, {res.positions.shape[0]} positions by the device select (a superset, no "
        f"residual); the line leg's row form tested {line_rows[0].shape[0]} rows")
    err = [0, 0]
    # (label, gather form?, rows, positions, corridors, the form's record?)
    for label, gather, rws, pos, sp, main in (
            ("line leg's candidates", False, line_rows, None, specs, True),
            ("candidates", True, None, res.positions, specs, True),
            ("point candidate query's rows", False, rows, None, specs, False),
            ("all rows", False, all_rows, None, specs, False),
            ("all rows", True, None, every, specs, False),
            ("all rows x 64", False, all_rows, None, all_specs, False),
            ("all rows x 64", True, None, every, all_specs, False)):
        pay = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in _pack(sp, sft)]
        s_ = pay[0].shape[1]
        if gather:
            args = (*cols, pos, None, *pay, False, False)
            fn, plain_fn, n = corridor_masks_gather, corridor_masks_gather_plain, pos.shape[0]
            p = pos.long()
            tested = (*corridor_dequantize(cols[0][p], cols[1][p]), cols[2][p], cols[3][p])
        else:
            args = (*rws, *pay, False, False)
            fn, plain_fn, n = corridor_masks, corridor_masks_plain, rws[0].shape[0]
            tested = rws[:4]
        got, want = fn(*args), plain_fn(*args)
        torch.cuda.synchronize()
        diff = words_differing(got, want)
        err[gather] = max(err[gather], diff)
        ms = cuda_ms(lambda: fn(*args), 10)
        dms = device_ms(lambda: fn(*args))
        plain = cuda_ms(lambda: plain_fn(*args), 1)
        fl = corridor_floor(n, len(sp), s_, False, False,
                            *corridor_pairs(*tested, pay[0], pay[1], pay[4]), gather=gather)
        name = "corridor_masks_gather" if gather else "corridor_masks"
        log(f"phase {name} timing {label}: {ms:.4f} ms (CUDA events), device "
            f"{fmt_ms(dms)} at N={n} Q={len(sp)} S={s_}; plain {plain:.4f} ms; bound "
            f"{fl['bound_ms']:.6f} ms ({fl['bound_by']}: {fl['pairs']} pairs, {fl['in_time']} "
            f"in time, {fl['tested']} in the reach box; {fl['alu']} ALU-only of {fl['ops']} "
            f"instructions, {fl['flops']} of them f32 ops; {fl['bytes']} bytes), "
            f"{fl['bound_ms'] / ms:.4f} of it by "
            f"events, {fmt_ms(None if dms is None else fl['bound_ms'] / dms)} by device; "
            f"{diff} differing words{' (the record)' if main else ''}")
        if fl["bound_ms"] / ms > 1 or (dms is not None and fl["bound_ms"] / dms > 1):
            raise AssertionError(f"{name} beats its bound")
        if main:
            (grecord if gather else record).update({
                "ms": ms, "device_ms": dms, "plain_ms": plain, "bound_ms": fl["bound_ms"],
                "bound_by": fl["bound_by"]})
    if any(err):
        raise AssertionError(f"corridor_masks disagrees with its plain versions at config 10: "
                             f"{err} words")
    record["max_abs_err"], grecord["max_abs_err"] = err
    return record, grecord, launched, track_record


def main(device=None, n_rows: int = N_ROWS, n_queries: int = N_QUERIES,
         n_exact: int = N_EXACT, iters: int = ITERS, stream_rows: int = STREAM_ROWS,
         stream_chunks: int = STREAM_CHUNKS, config3_rows: int = CONFIG3_ROWS,
         join_polygons: int = JOIN_POLYGONS, xz_rows: int = XZ_ROWS,
         xz_tiles: int = XZ_TILES, resident_rows: int = RESIDENT_ROWS,
         trajectory_rows: int = TRAJECTORY_ROWS) -> list[dict]:
    """Run every phase; returns the kernel records. ``device=None`` is the
    card; a rehearsal may pass ``"cpu"`` (phases needing the card skip)."""
    from geomesa_tpu_torch.device import resolve_device
    from geomesa_tpu_torch.ops import kernels

    dev = resolve_device(device)
    on_card = dev.type == "cuda"

    # -- phase 1: build ---------------------------------------------------------
    if on_card:
        t0 = time.perf_counter()
        built = kernels.build_kernels()
        log(f"phase build: {time.perf_counter() - t0:.3f} s for {sorted(built)}")
        log(f"card: {gpu_name_power()}")

    # -- phases 2 and 2b: kernels vs plain at the listed shapes ------------------
    count_err = hits_err = 0
    if on_card:
        t0 = time.perf_counter()
        count_err = check_shapes(dev, "batched_count", (1_000_003,), ((1, 1), (8, 16)), 11)
        log(f"phase kernel-vs-plain: ok, max_abs_err={count_err}")
        hits_err = check_shapes(dev, "batched_count_hits", (1_000_003, 1_000_064),
                                ((1, 1), (2, 2), (8, 16)), 12)
        log(f"phase hits-vs-plain: ok, max_abs_err={hits_err} "
            f"({time.perf_counter() - t0:.3f} s for phases 2 and 2b)")

    # -- phase 2c: the Morton encodes vs plain, and their times ------------------
    morton = {}
    if on_card:
        t0 = time.perf_counter()
        morton = check_morton(dev, n_rows)
        log(f"phase morton-vs-plain: ok ({time.perf_counter() - t0:.3f} s for phase 2c)")

    # -- phase 2d: the edge gather vs plain; phase 2e: the planned gather ---------
    edge_err = gather_err = 0
    if on_card:
        t0 = time.perf_counter()
        edge_err = check_edge_gather(dev, 1_000_003, 13)
        store = z3_store(dev, 1_000_003, seed=21)
        edge_err = max(edge_err, check_edge_cull(dev, store, 17))
        log(f"phase edge-gather-vs-plain: ok, max_abs_err={edge_err} "
            f"({time.perf_counter() - t0:.3f} s for phase 2d)")
        t0 = time.perf_counter()
        gather_err = check_planned_gather(dev, store, 19)
        del store
        free_card()
        log(f"phase planned-gather-vs-plain: ok, max_abs_err={gather_err} "
            f"({time.perf_counter() - t0:.3f} s for phase 2e)")

    # -- phase 3: the main path; phase 4: the stream; phase 5: date-less ---------
    t0 = time.perf_counter()
    (count_record, edge_record, gather_record), launched = z3_path(
        dev, count_err, n_rows, n_queries, n_exact, iters)
    if on_card:
        edge_record["max_abs_err"] = max(edge_record["max_abs_err"], edge_err)
        gather_record["max_abs_err"] = max(gather_record["max_abs_err"], gather_err)
    free_card()
    log(f"phase main path: {time.perf_counter() - t0:.3f} s in all")
    records = [count_record]
    for name, line in (("z3_encode", 380), ("z2_encode", 393)):
        records.append({"name": name, "route": "cuda",
                        "source": "geomesa_tpu_torch/csrc/morton_encode.cu",
                        "replaces": f"geomesa_tpu/ops/pallas_kernels.py:{line}",
                        "launches": launched[name], "library_ms": None, **morton.get(name, {})})
    t0 = time.perf_counter()
    records.append(stream_path(dev, hits_err, stream_rows, stream_chunks, n_queries))
    free_card()
    log(f"phase stream: {time.perf_counter() - t0:.3f} s in all")
    t0 = time.perf_counter()
    dateless_path(dev, n_rows, n_queries, n_exact)
    free_card()
    log(f"phase date-less: {time.perf_counter() - t0:.3f} s in all")
    t0 = time.perf_counter()
    agg_record, work_list_record, agg_rows = agg_path(dev, n_rows, n_queries)
    free_card()
    log(f"phase grouped aggregation: {time.perf_counter() - t0:.3f} s in all")
    t0 = time.perf_counter()
    pyramid_path(dev, agg_rows, n_queries, iters)
    del agg_rows
    free_card()
    log(f"phase 6b: {time.perf_counter() - t0:.3f} s in all")

    # -- phase 7: bench config 3, density heatmaps and batched KNN ---------------
    t0 = time.perf_counter()
    max_err = {"batched_density": 0, "batched_knn": 0}
    if on_card:
        store = z3_store(dev, 1_000_003, seed=31)
        max_err["batched_density"] = check_density_kernel(dev, store, 33)
        max_err["batched_knn"] = check_knn_kernel(dev, store, 35)
        del store
        free_card()
        log(f"phase density-and-knn-vs-plain: ok, max_abs_err={max_err} "
            f"({time.perf_counter() - t0:.3f} s for phase 7a)")
    t0 = time.perf_counter()
    config3_records, (ds3, lon3, lat3) = config3_path(
        dev, config3_rows, CONFIG3_DENSITY_QUERIES, CONFIG3_POINTS, CONFIG3_K, max(5, iters // 2),
        max_err)
    log(f"phase density and KNN: {time.perf_counter() - t0:.3f} s in all")

    # -- phase 8: bench config 4, the spatial join, over phase 7's points ----------
    t0 = time.perf_counter()
    join_records = config4_path(dev, lon3, lat3, ds3, "cfg3", join_polygons, 5)
    del ds3, lon3, lat3
    free_card()
    log(f"phase join: {time.perf_counter() - t0:.3f} s in all")

    # -- phase 9: bench config 5 and a line store on the XZ indexes ---------------
    t0 = time.perf_counter()
    xz_records = xz_path(dev, xz_rows, xz_tiles, iters)
    log(f"phase xz: {time.perf_counter() - t0:.3f} s in all")

    # -- phase 10: bench config 7, the resident count steps at 125M rows ------------------
    t0 = time.perf_counter()
    planned_err = 0
    if on_card:
        planned_err = check_planned_count(dev, 43)
        free_card()
        log(f"phase planned-count-vs-plain: ok, max_abs_err={planned_err} "
            f"({time.perf_counter() - t0:.3f} s for phase 10a)")
    t1 = time.perf_counter()
    planned_record, launched10 = resident_path(dev, resident_rows, RESIDENT_R, n_queries, iters)
    free_card()
    log(f"phase 10b: {time.perf_counter() - t1:.3f} s; phase 10: "
        f"{time.perf_counter() - t0:.3f} s in all")

    # -- phase 11: bench config 10, the corridor engine and interlink ---------------------
    t0 = time.perf_counter()
    corridor_err = (0, 0)
    if on_card:
        corridor_err = check_corridor_kernel(dev, 47)
        free_card()
        log(f"phase corridor-masks-vs-plain: ok, differing words (row form, gather form) "
            f"{corridor_err} ({time.perf_counter() - t0:.3f} s for phase 11a)")
    t1 = time.perf_counter()
    corridor_record, corridor_gather_record, launched11, track_record = trajectory_path(
        dev, trajectory_rows)
    free_card()
    log(f"phase 11b: {time.perf_counter() - t1:.3f} s; phase 11: "
        f"{time.perf_counter() - t0:.3f} s in all")

    # the later paths' launches of the earlier kernels
    count_record["launches"] += launched10["batched_count"]
    for r in records:
        if r["name"] in ("z3_encode", "z2_encode"):
            r["launches"] += launched10[r["name"]] + launched11[r["name"]]
    for r in join_records:
        if r["name"] == "planned_gather_join":
            r["launches"] += launched11["planned_gather"]
    src = "geomesa_tpu_torch/csrc/"
    new_records = [
        {"name": "track_stats", "route": "cuda", "source": src + "track_stats.cu",
         "replaces": "geomesa_tpu/trajectory/state.py:364", "library_ms": None,
         **track_record},
        {"name": "planned_count", "route": "cuda", "source": src + "planned_count.cu",
         "replaces": "geomesa_tpu/parallel/query.py:716", "library_ms": None,
         **planned_record, "launches": launched10["planned_count"],
         "max_abs_err": max(planned_record.get("max_abs_err", 0), planned_err)},
        {"name": "corridor_masks", "route": "cuda", "source": src + "corridor_masks.cu",
         "replaces": "geomesa_tpu/parallel/query.py:1371", "library_ms": None,
         **corridor_record, "launches": launched11["corridor_masks"],
         "max_abs_err": max(corridor_record.get("max_abs_err", 0), corridor_err[0])},
        {"name": "corridor_masks_gather", "route": "cuda", "source": src + "corridor_masks.cu",
         "replaces": "geomesa_tpu/parallel/query.py:1371", "library_ms": None,
         **corridor_gather_record, "launches": launched11["corridor_masks_gather"],
         "max_abs_err": max(corridor_gather_record.get("max_abs_err", 0), corridor_err[1])},
    ]
    return (records + [edge_record, gather_record, agg_record, work_list_record]
            + config3_records + join_records + xz_records + new_records)


if __name__ == "__main__":
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        sys.exit(2)
    kernel_records = main()
    print(json.dumps({"kernels": kernel_records}))
    print(gpu_name_power())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
