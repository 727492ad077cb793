"""The port's batched_count, batched_count_hits, batched_edge_gather,
z3_encode, z2_encode and refine against the reference, on the CPU.

``batched_count_plain`` and ``batched_count_hits_plain`` (what the port's
wrappers run for CPU tensors) must equal the Pallas ``batched_count`` and
``batched_count_hits`` in interpret mode, and the jnp
``make_batched_count_step`` on the CPU mesh; ``z3_encode_plain`` and
``z2_encode_plain`` must equal the Pallas ``z3_encode``/``z2_encode`` in
interpret mode (``hi << 32 | lo``) and ``curve/zorder.encode3/encode2``;
``batched_edge_gather_plain`` must equal ``make_batched_edge_gather_step``
on the CPU mesh (counts, summed hits, and lane sets where nothing
truncated); ``refine_points`` and the one-mask select over it must equal
the reference refine. The CUDA kernels
themselves run only on a card: the ``cuda``-marked tests skip elsewhere
(``chip_smoke.py`` holds both on the H100). What the count kernels compute
differently is held here through ``_staged_mirror``, a torch model of their
staged predicate (``csrc/count_predicate.cuh``: live-slot compaction, the
unsigned-width box test modulo 2^32, the biased 64-bit time key, the
single-slot row loop per tile), equal to the Pallas kernels and the plain
versions on random payloads and on ``workload.edge_payload``'s. The kernel
build is checked here only for what needs no ``nvcc``: a library's name
follows its source and every shared header.

Tolerance: none — counts and masks are integers/booleans, compared exactly.
"""

import numpy as np
import pytest
import torch

import geomesa_tpu  # noqa: F401  (x64 on)
import jax.numpy as jnp
from geomesa_tpu.ops.pallas_kernels import batched_count as ref_batched_count
from geomesa_tpu.ops.pallas_kernels import batched_count_hits as ref_batched_count_hits
from geomesa_tpu.ops.pallas_kernels import z2_encode as ref_z2_encode
from geomesa_tpu.ops.pallas_kernels import z3_encode as ref_z3_encode
from geomesa_tpu.curve import zorder as ref_zorder
from geomesa_tpu.ops.refine import refine_points as ref_refine_points
from geomesa_tpu.parallel.mesh import default_mesh, pad_query_axis, shard_columns
from geomesa_tpu.parallel.query import make_batched_count_step, make_batched_edge_gather_step

from geomesa_tpu_torch.ops import kernels
from geomesa_tpu_torch.ops.kernels import (
    batched_count,
    batched_count_hits,
    batched_count_hits_plain,
    batched_count_plain,
    batched_edge_gather,
    batched_edge_gather_plain,
    chunk_query_pairs,
    z2_encode,
    z2_encode_plain,
    z3_encode,
    z3_encode_plain,
)
from geomesa_tpu_torch.ops.refine import pack_boxes, pack_times, refine_points, unsat_rows
from geomesa_tpu_torch.parallel.residency import stage_columns
from geomesa_tpu_torch.workload import edge_columns, edge_payload, grid_columns, grid_payload

DAY_MS = 86_400_000
N_BINS = 30


def _cols(n, seed=1):
    rng = np.random.default_rng(seed)
    return (
        rng.integers(0, 2**31 - 1, n).astype(np.int32),
        rng.integers(0, 2**31 - 1, n).astype(np.int32),
        rng.integers(0, N_BINS, n).astype(np.int32),
        rng.integers(0, DAY_MS, n).astype(np.int32),
    )


def _payload(q, nb, nt, seed=2):
    """Multi-slot payloads with sentinel padding; the last query is the
    fully unsatisfiable one from ``unsat_rows``."""
    rng = np.random.default_rng(seed)
    boxes, times = [], []
    for _ in range(q):
        kb, kt = int(rng.integers(1, nb + 1)), int(rng.integers(1, nt + 1))
        bx = np.sort(rng.integers(0, 2**31 - 1, (kb, 2, 2)), axis=2).reshape(kb, 4)
        boxes.append(pack_boxes(bx.astype(np.int32), slots=nb))
        tb = np.sort(rng.integers(0, N_BINS, (kt, 2)), axis=1)
        to = rng.integers(0, DAY_MS, (kt, 2))
        tq = np.stack([tb[:, 0], to[:, 0], tb[:, 1], to[:, 1]], axis=1).astype(np.int32)
        times.append(pack_times(tq, slots=nt))
    if q > 1:
        boxes[-1], times[-1] = unsat_rows(nb, nt)
    return np.ascontiguousarray(np.stack(boxes)), np.ascontiguousarray(np.stack(times))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


SHAPES = [(n, q, nb, nt) for n in (777, 10_001) for q in (1, 5, 64)
          for nb, nt in ((1, 1), (8, 16))]
# edge payloads: "single" has one live box and window per live query (the
# single-slot row loop), "mixed" puts multi-slot queries beside them
EDGE_SHAPES = [(n, q, nb, nt, mode) for n in (777, 10_001) for q in (7, 64)
               for mode, slots in (("single", ((1, 1), (8, 16))),
                                   ("mixed", ((1, 1), (2, 3), (8, 16))))
               for nb, nt in slots]


def _cases(shapes):
    """The random-payload cases under their earlier ids, then the edge ones."""
    return ([pytest.param(*s, "random", id="-".join(map(str, s))) for s in shapes]
            + [pytest.param(*s, id="-".join(map(str, s))) for s in EDGE_SHAPES])


def _inputs(n, q, nb, nt, mode, col_seed, pay_seed):
    if mode == "random":
        return _cols(n, seed=col_seed), _payload(q, nb, nt, seed=pay_seed)
    if mode == "grid":
        cols = grid_columns(n, seed=col_seed)
        return cols, grid_payload(cols, q, nb, nt, seed=pay_seed)
    cols = edge_columns(n, seed=col_seed)
    return cols, edge_payload(cols, q, nb, nt, seed=pay_seed, single=mode == "single")


M32 = 0xFFFFFFFF


def _time_key(b, o):
    """The kernels' biased 64-bit key ``b << 32 | (uint32)(o ^ 0x80000000)``."""
    return b.long() * 2**32 + ((o.long() ^ 0x80000000) & M32)


def _staged_mirror(x, y, bins, offs, base, true_n, boxes, times, q_tile):
    """Torch model of the count kernels' staged predicate, tile by tile:
    keep the live slots of each query (live box: xlo <= xhi and ylo <= yhi;
    live window: lo key <= hi key), stage boxes as (xlo, (xhi - xlo) mod
    2^32, ylo, (yhi - ylo) mod 2^32) and windows as key pairs, list the
    queries with a live box and a live window, and run the single-slot loop
    (slot 0 alone) on a tile whose active queries have one of each.
    Returns (counts, lane_pos, [single-slot loop? per tile with an active
    query])."""
    n, q = x.shape[0], boxes.shape[0]
    xs, ys, key = x.long(), y.long(), _time_key(bins, offs)
    lpos = torch.arange(n)
    valid = int(base) + lpos < int(true_n)
    counts = torch.zeros(q, dtype=torch.int64)
    lane_pos = torch.full((q, 128), -1, dtype=torch.int64)
    paths = []
    for q0 in range(0, q, q_tile):
        staged = []
        for qi in range(q0, min(q, q0 + q_tile)):
            b, t = boxes[qi].long(), times[qi].long()
            b = b[(b[:, 0] <= b[:, 1]) & (b[:, 2] <= b[:, 3])]
            sb = torch.stack([b[:, 0], (b[:, 1] - b[:, 0]) & M32,
                              b[:, 2], (b[:, 3] - b[:, 2]) & M32], dim=1)
            lo, hi = _time_key(t[:, 0], t[:, 1]), _time_key(t[:, 2], t[:, 3])
            sw = torch.stack([lo, hi], dim=1)[lo <= hi]
            if len(sb) and len(sw):
                staged.append((qi, sb, sw))
        if not staged:
            continue
        single = all(len(sb) == 1 and len(sw) == 1 for _, sb, sw in staged)
        paths.append(single)
        for qi, sb, sw in staged:
            in_box = torch.zeros(n, dtype=torch.bool)
            for xlo, xw, ylo, yw in sb[:1].tolist() if single else sb.tolist():
                in_box |= (((xs - xlo) & M32) <= xw) & (((ys - ylo) & M32) <= yw)
            in_time = torch.zeros(n, dtype=torch.bool)
            for klo, khi in sw[:1].tolist() if single else sw.tolist():
                in_time |= (key >= klo) & (key <= khi)
            m = in_box & in_time & valid
            counts[qi] = int(m.sum())
            lane_pos[qi].scatter_reduce_(0, lpos[m] & 127, int(base) + lpos[m], "amax")
    return counts.to(torch.int32), lane_pos.to(torch.int32), paths


@pytest.mark.parametrize("n,q,nb,nt,mode", _cases(SHAPES))
def test_plain_equals_pallas_interpret(n, q, nb, nt, mode):
    cols, (boxes, times) = _inputs(n, q, nb, nt, mode, n, q * 100 + nb)
    for base, true_n in ((0, n), (4096, 4096 + n - 100)):
        want = np.asarray(ref_batched_count(
            *(jnp.asarray(c) for c in cols), jnp.int32(base), jnp.int32(true_n),
            jnp.asarray(boxes), jnp.asarray(times), interpret=True))
        got = batched_count(*(_t(c) for c in cols), base, true_n, _t(boxes), _t(times))
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), want)
        assert np.array_equal(
            batched_count_plain(*(_t(c) for c in cols), base, true_n, _t(boxes), _t(times),
                                chunk=1000).numpy(), want)
        for q_tile in (3, q):  # tiles that mix the two loops, and one tile
            mirror, _, _ = _staged_mirror(*(_t(c) for c in cols), base, true_n,
                                          _t(boxes), _t(times), q_tile)
            assert np.array_equal(mirror.numpy(), want)


def test_staged_mirror_paths_and_edges():
    """The edge payloads hold what they claim, the mirror picks the
    single-slot loop exactly for tiles whose active queries have one live
    box and one live window, and the offset bias is what makes the
    unconstrained window match a date-less store's rows."""
    cols = edge_columns(2000, seed=5)
    tc = [_t(c) for c in cols]
    b, t = edge_payload(cols, 64, 8, 16, seed=6, single=False)
    live_b = (b[..., 0] <= b[..., 1]) & (b[..., 2] <= b[..., 3])
    lo, hi = _time_key(_t(t[..., 0]), _t(t[..., 1])), _time_key(_t(t[..., 2]), _t(t[..., 3]))
    live_t = (lo <= hi).numpy()
    first_live = np.argmax(live_b, axis=1)
    assert (first_live[live_b.any(axis=1)] > 0).any()  # dead slots before live ones
    assert (~live_b.any(axis=1) & ~live_t.any(axis=1)).any()  # an all-dead query
    assert ((live_b.sum(axis=1) > 1) | (live_t.sum(axis=1) > 1)).any()
    assert (b[live_b][:, 0] == b[live_b][:, 1]).any()  # degenerate boxes
    assert (b[live_b] == -(2**31)).any() and (b[live_b] == 2**31 - 1).any()
    assert (t[live_t][:, [1, 3]] < 0).any()  # negative offsets
    assert (t[live_t] == [0, -1, 2**31 - 1, 2**31 - 1]).all(axis=1).any()
    assert ((cols[2] == 0) & (cols[3] == 0)).any() and (cols[3] < 0).any()
    args = (*tc, 0, 2000, _t(b), _t(t))
    assert _staged_mirror(*args, q_tile=64)[2] == [False]
    assert set(_staged_mirror(*args, q_tile=3)[2]) == {True, False}
    sb, st = edge_payload(cols, 64, 8, 16, seed=7, single=True)
    assert _staged_mirror(*tc, 0, 2000, _t(sb), _t(st), q_tile=64)[2] == [True]
    # the unconstrained window over bins = offs = 0: every such row with the
    # bias, none with an unbiased key ((0, -1) would sort after (0, 0))
    zero = torch.zeros(4, dtype=torch.int32)
    wide = torch.tensor([[[-(2**31), 2**31 - 1, -(2**31), 2**31 - 1]]], dtype=torch.int32)
    open_t = torch.tensor([[[0, -1, 2**31 - 1, 2**31 - 1]]], dtype=torch.int32)
    assert _staged_mirror(zero, zero, zero, zero, 0, 4, wide, open_t, 1)[0].tolist() == [4]
    assert int(batched_count_plain(zero, zero, zero, zero, 0, 4, wide, open_t)[0]) == 4
    def unbiased(b, o):
        return b.long() * 2**32 + (o.long() & M32)

    assert (unbiased(zero, zero) < unbiased(open_t[0, 0, 0], open_t[0, 0, 1])).all()


@pytest.mark.parametrize("n,q,nb,nt", [(4096 * 3, 64, 8, 16), (10_001, 5, 1, 1)])
def test_plain_equals_jnp_step(n, q, nb, nt):
    """The port's single-shard step against the reference's sharded jnp
    step on the 8-device CPU mesh: the same padded columns, true_n masks
    the tail."""
    cols = dict(zip(("x", "y", "bins", "offs"), _cols(n, seed=3)))
    boxes, times = _payload(q, nb, nt, seed=4)
    mesh = default_mesh()
    sharded, _, _ = shard_columns(mesh, cols, multiple=4096)
    want = np.asarray(make_batched_count_step(mesh, impl="jnp")(
        sharded["x"], sharded["y"], sharded["bins"], sharded["offs"],
        jnp.int32(n), jnp.asarray(boxes), jnp.asarray(times)))
    staged, padded = stage_columns(cols, torch.device("cpu"))
    assert padded % 4096 == 0
    got = batched_count(staged["x"], staged["y"], staged["bins"], staged["offs"],
                        0, n, _t(boxes), _t(times))
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("nb,nt", [(1, 1), (8, 16)])
def test_refine_points_and_select_steps(nb, nt):
    n = 9000
    cols = _cols(n, seed=9)
    rng = np.random.default_rng(10)
    boxes, times = _payload(1, nb, nt, seed=11)
    boxes, times = boxes[0], times[0]
    idx = rng.integers(0, n, 3000).astype(np.int32)
    count = 2500
    want = np.asarray(ref_refine_points(
        *(jnp.asarray(c) for c in cols), jnp.asarray(idx), jnp.int32(count),
        jnp.asarray(boxes), jnp.asarray(times)))
    tcols = [_t(c) for c in cols]
    got = refine_points(*tcols, _t(idx).long(), count, _t(boxes), _t(times))
    assert np.array_equal(got.numpy(), want)
    # the one-mask select (DeviceBackend.select_positions): the matching
    # slots' positions, in slot order
    pos = _t(idx).long()[got]
    assert pos.dtype == torch.int64
    assert np.array_equal(pos.numpy(), idx[want])


EDGE_CASES = [(nb, nt, mode) for nb, nt in ((1, 1), (8, 16))
              for mode in ("random", "grid", "single", "mixed")]
_EDGE_STEPS: dict = {}


def _ref_edge_gather(cols, n, boxes, times, capacity, true_n=None):
    """The reference step on the 8-device CPU mesh (4096-row aligned
    shards), the query axis padded as its ``count_many`` pads it; rows at
    ``true_n`` (default ``n``) or past it are invalid."""
    mesh = default_mesh()
    step = _EDGE_STEPS.get(capacity)
    if step is None:
        step = _EDGE_STEPS[capacity] = make_batched_edge_gather_step(mesh, capacity)
    sharded, _, _ = shard_columns(mesh, dict(zip(("x", "y", "bins", "offs"), cols)),
                                  multiple=4096)
    (boxes_p, times_p), q = pad_query_axis(mesh, boxes, times)
    counts, pos, hits = step(sharded["x"], sharded["y"], sharded["bins"], sharded["offs"],
                             jnp.int32(n if true_n is None else true_n), jnp.asarray(boxes_p),
                             jnp.asarray(times_p))
    return np.asarray(counts)[:q], np.asarray(pos)[:q], np.asarray(hits)[:q]


@pytest.mark.parametrize("nb,nt,mode", EDGE_CASES)
def test_edge_gather_plain_equals_jnp_step(nb, nt, mode):
    """Counts equal the reference's and ``batched_count``'s; the port's hits
    are the sum of the reference's per-shard hits; where no reference shard
    and not the port truncated, the port's lanes are the union of the
    reference's. Capacity 16 makes some ``grid`` queries truncate."""
    n, q = 40_000, 7
    cols, (boxes, times) = _inputs(n, q, nb, nt, mode, 31 + nb, 33 + nt)
    staged, _ = stage_columns(dict(zip(("x", "y", "bins", "offs"), cols)), torch.device("cpu"))
    args = (staged["x"], staged["y"], staged["bins"], staged["offs"], 0, n, _t(boxes), _t(times))
    truncated = fitted = 0
    for capacity in (16, 512):
        want_c, want_p, want_h = _ref_edge_gather(cols, n, boxes, times, capacity)
        for got_c, got_p, got_h in (batched_edge_gather(*args, capacity=capacity),
                                    batched_edge_gather_plain(*args, capacity=capacity,
                                                              chunk=4096)):
            assert got_c.dtype == got_p.dtype == got_h.dtype == torch.int32
            assert got_p.shape == (q, 1, capacity) and got_h.shape == (q, 1)
            assert np.array_equal(got_c.numpy(), want_c)
            assert np.array_equal(got_h[:, 0].numpy(), want_h.sum(axis=1))
            for k in range(q):
                h = int(got_h[k, 0])
                lanes = got_p[k, 0].numpy()
                if h > capacity or (want_h[k] > capacity).any():
                    truncated += 1
                    assert (lanes >= 0).all()
                    continue
                fitted += 1
                union = np.sort(np.concatenate([want_p[k, d, : want_h[k, d]]
                                                for d in range(want_p.shape[1])]))
                assert np.array_equal(lanes[:h], union) and (lanes[h:] == -1).all()
        assert np.array_equal(want_c, batched_count(*args).numpy())
    assert fitted
    if mode == "grid":
        assert truncated


def test_edge_gather_lanes_keep_row_order_under_truncation():
    """Past the capacity the plain version keeps the first candidates in row
    order, as the reference's prefix sum does on one shard; a row tail cut by
    ``true_n`` and a ``base`` shift the global positions."""
    cols = grid_columns(5000, seed=2)
    boxes, times = grid_payload(cols, 6, 8, 16, seed=3)
    tc = [_t(c) for c in cols]
    full_c, full_p, full_h = batched_edge_gather_plain(*tc, 4096, 4096 + 4000, _t(boxes),
                                                       _t(times), capacity=5000)
    c, p, h = batched_edge_gather_plain(*tc, 4096, 4096 + 4000, _t(boxes), _t(times),
                                        capacity=8, chunk=1000)
    assert torch.equal(c, full_c) and torch.equal(h, full_h)
    assert (full_h > 8).any() and (full_p[full_p >= 0] >= 4096).all()
    assert (full_p < 4096 + 4000).all()
    for k in range(6):
        assert torch.equal(p[k, 0], full_p[k, 0, :8])
    with pytest.raises(ValueError, match="capacity"):
        batched_edge_gather(*tc, 0, 5000, _t(boxes), _t(times), capacity=-1)
    with pytest.raises(ValueError, match="2\\^31"):
        batched_edge_gather(*tc, 2**31 - 4000, 2**31 - 1, _t(boxes), _t(times))


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernel has no CPU mode")
    dev = torch.device("cuda")
    kernels.path_blocks("batched_count")
    for n, q, nb, nt, mode in [(*s, "random") for s in SHAPES] + EDGE_SHAPES:
        cols, payload = _inputs(n, q, nb, nt, mode, n, q)
        cols = [_t(c).to(dev) for c in cols]
        boxes, times = (_t(a).to(dev) for a in payload)
        for base, true_n in ((0, n), (4096, 4096 + n - 100)):
            got = batched_count(*cols, base, true_n, boxes, times)
            want = batched_count_plain(*cols, base, true_n, boxes, times)
            torch.cuda.synchronize()
            assert torch.equal(got, want)
    single, general = kernels.path_blocks("batched_count")
    assert single > 0 and general > 0


HITS_SHAPES = [(n, q, nb, nt) for n in (777, 12_288) for q in (1, 5, 64)
               for nb, nt in ((1, 1), (8, 16))]


@pytest.mark.parametrize("n,q,nb,nt,mode", _cases(HITS_SHAPES))
def test_hits_plain_equals_pallas_interpret(n, q, nb, nt, mode):
    """Counts and the (Q, 128) lane scoreboard equal the Pallas kernel's,
    with and without a base/true_n tail, at a chunking that splits lanes'
    rows across chunks; so do the staged mirror's."""
    cols, (boxes, times) = _inputs(n, q, nb, nt, mode, n + 1, q * 100 + nb + 1)
    for base, true_n in ((0, n), (4096, 4096 + n - 100)):
        want_c, want_p = ref_batched_count_hits(
            *(jnp.asarray(c) for c in cols), jnp.int32(base), jnp.int32(true_n),
            jnp.asarray(boxes), jnp.asarray(times), interpret=True)
        for got_c, got_p in (
            batched_count_hits(*(_t(c) for c in cols), base, true_n, _t(boxes), _t(times)),
            batched_count_hits_plain(*(_t(c) for c in cols), base, true_n, _t(boxes),
                                     _t(times), chunk=256),
            _staged_mirror(*(_t(c) for c in cols), base, true_n, _t(boxes), _t(times), 3)[:2],
        ):
            assert got_c.dtype == torch.int32 and got_p.dtype == torch.int32
            assert got_p.shape == (q, 128)
            assert np.array_equal(got_c.numpy(), np.asarray(want_c))
            assert np.array_equal(got_p.numpy(), np.asarray(want_p))
        # the counts are batched_count's
        assert np.array_equal(
            np.asarray(want_c),
            batched_count(*(_t(c) for c in cols), base, true_n, _t(boxes), _t(times)).numpy())


@pytest.mark.parametrize("density", [0.002, 0.1, 0.5, 1.0])
def test_hits_warp_fold_keeps_newest_per_lane(density):
    """The hits kernel's epilogue (``csrc/batched_count_hits.cu``), modelled
    for one warp: 32 threads hold 16 consecutive rows each, so threads t,
    t + 8, t + 16, t + 24 share 16 lanes; a matched row is dropped when a
    later thread of its group matched the same bit. What remains is one row
    per matched lane, its newest, at any match density."""
    rng = np.random.default_rng(int(density * 1000))
    pos = np.arange(32)[:, None] * 16 + np.arange(16)[None, :]  # warp-local rows
    lane = pos & 127
    for _ in range(25):
        m = rng.random((32, 16)) < density  # thread t, bit r
        later = np.zeros_like(m)
        for t in range(32):
            for d in (8, 16, 24):
                if t + d < 32:
                    later[t] |= m[t + d]
        kept = m & ~later
        assert np.bincount(lane[kept], minlength=128).max() <= 1
        want = np.full(128, -1)
        np.maximum.at(want, lane[m], pos[m])
        got = np.full(128, -1)
        got[lane[kept]] = pos[kept]
        assert np.array_equal(got, want)


def test_hits_wrapper_rejects_int32_position_overflow():
    cols = [torch.zeros(256, dtype=torch.int32) for _ in range(4)]
    boxes = torch.zeros((2, 1, 4), dtype=torch.int32)
    times = torch.zeros((2, 1, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="2\\^31"):
        batched_count_hits(*cols, 2**31 - 200, 2**31 - 1, boxes, times)
    with pytest.raises(ValueError, match="multiple of 128"):
        batched_count_hits_plain(*cols, 0, 256, boxes, times, chunk=100)
    counts, lane_pos = batched_count_hits(*cols, 2**31 - 257, 2**31 - 1, boxes, times)
    assert counts.shape == (2,) and lane_pos.shape == (2, 128)


# -- the edge gather's per-chunk cull ---------------------------------------------

CULL_N, CULL_Q = 40_000, 7
CULL_MAKERS = ("gdelt-z3", "grid", "edge", "dateless", "tail")


def _store_columns(seed, dated=True):
    """GDELT-shaped rows through a CPU ``DataStore``: the resident columns
    of its z3 state (z3 order) or, date-less, of its z2 state (``bins =
    offs = 0``), cut to the true rows; and the store and its schema."""
    from geomesa_tpu_torch.schema.columnar import Column, FeatureTable, point_column
    from geomesa_tpu_torch.schema.sft import AttributeType
    from geomesa_tpu_torch.store.datastore import DataStore
    from geomesa_tpu_torch.workload import SPEC, synth_gdelt

    lon, lat, t = synth_gdelt(CULL_N, seed=seed)
    ds = DataStore(device="cpu")
    sft = ds.create_schema("g", SPEC if dated else "*geom:Point:srid=4326")
    attrs = {"geom": point_column(lon, lat)}
    if dated:
        attrs["dtg"] = Column(AttributeType.DATE, t)
    ds.write("g", FeatureTable.from_columns(sft, np.arange(CULL_N).astype("U9"), attrs))
    ds.compact("g")
    state = ds._state("g").backend_state["z3" if dated else "z2"]
    return tuple(c[:CULL_N].numpy() for c in state.spatial_cols()), ds, sft


def _city_payload(ds, sft, seed, dated=True):
    from geomesa_tpu_torch.filter.bounds import extract
    from geomesa_tpu_torch.filter.cql import parse
    from geomesa_tpu_torch.workload import bbox_cql, bbox_time_cql, make_queries

    boxes_f64, windows = make_queries(CULL_Q, seed=seed)
    cqls = ([bbox_time_cql(b, w) for b, w in zip(boxes_f64, windows)] if dated
            else [bbox_cql(b) for b in boxes_f64])
    pays = [ds.backend.payload(sft, extract(parse(c), "geom", "dtg" if dated else None))
            for c in cqls]
    return tuple(np.ascontiguousarray(np.stack([p[k] for p in pays])) for k in (0, 1))


def _cull_inputs(maker, seed):
    """(host columns, boxes, times, base, true_n) for one column maker."""
    if maker in ("gdelt-z3", "tail", "dateless"):
        cols, ds, sft = _store_columns(seed, dated=maker != "dateless")
        boxes, times = _city_payload(ds, sft, seed, dated=maker != "dateless")
    elif maker == "grid":
        cols = grid_columns(CULL_N, seed=seed)
        boxes, times = grid_payload(cols, CULL_Q, 8, 16, seed=seed + 1)
    else:
        cols = edge_columns(CULL_N, seed=seed)
        boxes, times = edge_payload(cols, CULL_Q, 8, 16, seed=seed + 1, single=False)
    # the tail ends before the last chunk starts (at 9 x 4096 = 36,864 rows)
    base, true_n = (3 * 4096, 3 * 4096 + CULL_N - 3500) if maker == "tail" else (0, CULL_N)
    return cols, boxes, times, base, true_n


@pytest.mark.parametrize("seed", [5, 6])
@pytest.mark.parametrize("maker", CULL_MAKERS)
def test_chunk_query_pairs_never_culls_a_match(maker, seed):
    """No (chunk, query) pair that ``chunk_query_pairs`` culls holds a
    match: per-chunk counts of ``batched_count_plain``'s predicate are zero
    on every culled pair, and the counts over the kept pairs equal the JAX
    ``make_batched_edge_gather_step``'s. On GDELT-shaped rows in z3 order
    the cull keeps a minority of the pairs; a chunk past ``true_n`` keeps
    none."""
    cols, boxes, times, base, true_n = _cull_inputs(maker, seed)
    tc = [_t(c) for c in cols]
    args = (*tc, base, true_n, _t(boxes), _t(times))
    kept = chunk_query_pairs(*args)
    n_chunks = -(-CULL_N // 4096)
    assert kept.shape == (n_chunks, CULL_Q) and kept.dtype == torch.bool
    per_chunk = torch.stack([m.sum(dim=1) for _, _, m, _ in
                             kernels._plain_masks(*args, chunk=4096)])  # (chunks, Q)
    assert not (per_chunk[~kept] > 0).any()
    kept_counts = (per_chunk * kept).sum(dim=0)
    want_c, _, _ = _ref_edge_gather(cols, CULL_N, boxes, times, 16, true_n=true_n - base)
    assert np.array_equal(kept_counts.numpy(), want_c)
    assert torch.equal(kept_counts.int(), batched_count_plain(*args))
    if maker in ("gdelt-z3", "tail"):
        assert kept.float().mean() < 0.5 and kept_counts.sum() > 0
    if maker == "tail":
        assert not kept[-1].any()  # the last chunk starts past true_n - base


def test_chunk_query_pairs_extent_is_over_loaded_rows():
    """The cull's extent runs over every loaded row, invalid ones included,
    and the rows past N of the last chunk count as zeros, as the kernel's
    zero-filled copies do: a box that meets only a row past ``true_n`` (or
    only the zero fill) keeps its pair, one that meets no loaded row does
    not; dead slots never keep a pair."""
    n = 4096 + 10
    x = torch.full((n,), 1000, dtype=torch.int32)
    y = torch.full((n,), 1000, dtype=torch.int32)
    x[4096 + 5] = 50_000  # past true_n below, in the second chunk
    bins = torch.zeros(n, dtype=torch.int32)
    offs = torch.zeros(n, dtype=torch.int32)
    world_t = torch.tensor([[[0, -1, 2**31 - 1, 2**31 - 1]]], dtype=torch.int32)
    boxes = torch.tensor([[[50_000, 50_000, 1000, 1000]],   # the invalid row only
                          [[0, 0, 0, 0]],                   # the zero fill only
                          [[70_000, 80_000, 0, 2000]],      # no loaded row
                          [[1, 0, 1, 0]]], dtype=torch.int32)  # dead
    kept = chunk_query_pairs(x, y, bins, offs, 0, 4096 + 5, boxes, world_t.expand(4, 1, 4)
                             .contiguous())
    assert kept.tolist() == [[False, False, False, False], [True, True, False, False]]
    # a chunk with no valid row keeps nothing
    none = chunk_query_pairs(x, y, bins, offs, 0, 4096, boxes, world_t.expand(4, 1, 4)
                             .contiguous())
    assert not none[1].any()


@pytest.mark.cuda
def test_edge_gather_cull_matches_plain_on_card():
    """On GDELT-shaped rows in z3 order (most pairs culled) and the same
    rows shuffled (none culled): the kernel equals its plain version and
    ``batched_count``, and both orders give the same counts and hits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernel has no CPU mode")
    dev = torch.device("cuda")
    for maker in CULL_MAKERS:
        cols, boxes, times, base, true_n = _cull_inputs(maker, 5)
        tc = [_t(c).to(dev) for c in cols]
        perm = torch.from_numpy(np.random.default_rng(1).permutation(CULL_N)).to(dev)
        shuffled = [c[perm].contiguous() for c in tc]
        for c in (tc, shuffled):
            args = (*c, base, true_n, _t(boxes).to(dev), _t(times).to(dev))
            got_c, got_p, got_h = batched_edge_gather(*args)
            want_c, want_p, want_h = batched_edge_gather_plain(*args)
            torch.cuda.synchronize()
            assert torch.equal(got_c, want_c) and torch.equal(got_h, want_h)
            assert torch.equal(got_c, batched_count(*args))
            fits = want_h[:, 0] <= kernels.EDGE_CAPACITY
            assert torch.equal(got_p[fits], want_p[fits])


def test_library_path_follows_shared_headers(tmp_path, monkeypatch):
    """Editing a header under csrc/ must change every kernel's library
    name, or a stale build would be loaded; no nvcc is needed to check."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "a.cu").write_text('#include "shared.cuh"\n')
    (csrc / "b.cu").write_text("// no include\n")
    (csrc / "shared.cuh").write_text("#define V 1\n")
    monkeypatch.setattr(kernels, "CSRC", csrc)
    monkeypatch.setattr(kernels, "BUILD", tmp_path / "_build")
    before = {name: kernels._lib_path(csrc / name) for name in ("a.cu", "b.cu")}
    assert all(p.parent == tmp_path / "_build" for p in before.values())
    assert before == {name: kernels._lib_path(csrc / name) for name in ("a.cu", "b.cu")}
    (csrc / "shared.cuh").write_text("#define V 2\n")
    after = {name: kernels._lib_path(csrc / name) for name in ("a.cu", "b.cu")}
    assert all(after[k] != before[k] for k in after)
    (csrc / "other.cuh").write_text("#define W 1\n")
    assert kernels._lib_path(csrc / "a.cu") != after["a.cu"]
    a_path, b_path = kernels._lib_path(csrc / "a.cu"), kernels._lib_path(csrc / "b.cu")
    (csrc / "a.cu").write_text('#include "shared.cuh"\n// edited\n')
    assert kernels._lib_path(csrc / "a.cu") != a_path
    assert kernels._lib_path(csrc / "b.cu") == b_path


@pytest.mark.cuda
def test_hits_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernel has no CPU mode")
    dev = torch.device("cuda")
    kernels.path_blocks("batched_count_hits")
    for n, q, nb, nt, mode in [(*s, "random") for s in HITS_SHAPES] + EDGE_SHAPES:
        cols, payload = _inputs(n, q, nb, nt, mode, n + 1, q + 1)
        cols = [_t(c).to(dev) for c in cols]
        boxes, times = (_t(a).to(dev) for a in payload)
        for base, true_n in ((0, n), (4096, 4096 + n - 100)):
            got = batched_count_hits(*cols, base, true_n, boxes, times)
            want = batched_count_hits_plain(*cols, base, true_n, boxes, times)
            torch.cuda.synchronize()
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    single, general = kernels.path_blocks("batched_count_hits")
    assert single > 0 and general > 0


@pytest.mark.cuda
def test_edge_gather_kernel_matches_plain_on_card():
    """Counts and hits equal; lanes equal where they hold every candidate
    (the wrapper sorts the kernel's appends); an overflowed query's lanes
    are distinct candidates of it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernel has no CPU mode")
    dev = torch.device("cuda")
    kernels.path_blocks("batched_edge_gather")
    overflowed = 0
    for nb, nt, mode in EDGE_CASES:
        for n, q in ((777, 5), (40_000, 64)):
            cols, payload = _inputs(n, q, nb, nt, mode, n + 2, q + 2)
            cols = [_t(c).to(dev) for c in cols]
            boxes, times = (_t(a).to(dev) for a in payload)
            for base, true_n in ((0, n), (4096, 4096 + n - 100)):
                args = (*cols, base, true_n, boxes, times)
                got_c, got_p, got_h = batched_edge_gather(*args, capacity=64)
                want_c, want_p, want_h = batched_edge_gather_plain(*args, capacity=64)
                _, all_p, _ = batched_edge_gather_plain(*args, capacity=n)
                torch.cuda.synchronize()
                assert torch.equal(got_c, want_c) and torch.equal(got_h, want_h)
                assert torch.equal(got_c, batched_count(*args))
                for k in range(q):
                    h = int(got_h[k, 0])
                    if h <= 64:
                        assert torch.equal(got_p[k], want_p[k])
                    else:
                        overflowed += 1
                        lanes = got_p[k, 0].cpu().numpy()
                        assert len(np.unique(lanes)) == 64
                        assert np.isin(lanes, all_p[k, 0, :h].cpu().numpy()).all()
    single, general = kernels.path_blocks("batched_edge_gather")
    assert single > 0 and general > 0 and overflowed > 0


@pytest.mark.cuda
def test_count_kernels_reject_misaligned_inputs_on_card():
    """The count kernels load 16-byte vectors: a column or payload that does
    not start on a 16-byte boundary raises instead of launching."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernel has no CPU mode")
    dev = torch.device("cuda")
    cols = [torch.zeros(1025, dtype=torch.int32, device=dev)[1:] for _ in range(4)]
    boxes, times = (_t(a).to(dev) for a in _payload(3, 1, 1))
    before = dict(kernels.launches)
    for fn in (batched_count, batched_count_hits, batched_edge_gather):
        with pytest.raises(ValueError, match="16-byte"):
            fn(*cols, 0, 1024, boxes, times)
    assert kernels.launches == before


# -- z3_encode / z2_encode -----------------------------------------------------

# edge values of each width: 0, 1, the largest in-width value, then values
# above the width (which the first mask word must cut), negatives included
Z3_EDGES = [0, 1, 2**21 - 1, 2**21, 2**21 + 5, 2**30, 2**31 - 1, -1, -(2**31)]
Z2_EDGES = [0, 1, 2**31 - 1, 2**30, -1, -(2**31), -12345]


def _morton_inputs(n, dims, bits, edges, seed):
    """``dims`` seeded int32 columns of ``bits``-bit values with the edge
    values spliced in (each column gets them at different rows)."""
    rng = np.random.default_rng(seed)
    cols = [rng.integers(0, 2**bits, n, dtype=np.int64).astype(np.int32) for _ in range(dims)]
    for d, c in enumerate(cols):
        k = min(n, len(edges))
        c[(np.arange(k) * 7 + d) % n if n else slice(0)] = np.roll(edges, d)[:k]
    return cols


def _pallas_codes(fn, cols):
    hi, lo = fn(*(jnp.asarray(c) for c in cols), interpret=True)
    hi, lo = np.asarray(hi).astype(np.uint64), np.asarray(lo).astype(np.uint64)
    return ((hi << np.uint64(32)) | lo).view(np.int64)


@pytest.mark.parametrize("n", [0, 1, 3000, 32769])
@pytest.mark.parametrize("kernel", ["z3", "z2"])
def test_morton_plain_equals_pallas_and_zorder(n, kernel):
    """Exact, at a ragged N one past the Pallas tile of 256 x 128 rows; the
    Pallas kernel refuses an empty input, so N = 0 is held to zorder only."""
    if kernel == "z3":
        cols = _morton_inputs(n, 3, 21, Z3_EDGES, seed=n + 3)
        port, plain, pallas, ref = z3_encode, z3_encode_plain, ref_z3_encode, ref_zorder.encode3
    else:
        cols = _morton_inputs(n, 2, 31, Z2_EDGES, seed=n + 2)
        port, plain, pallas, ref = z2_encode, z2_encode_plain, ref_z2_encode, ref_zorder.encode2
    want = ref(*cols).view(np.int64)
    for got in (port(*(_t(c) for c in cols)), plain(*(_t(c) for c in cols))):
        assert got.dtype == torch.int64 and got.shape == (n,)
        assert np.array_equal(got.numpy(), want)
    if n:
        assert np.array_equal(_pallas_codes(pallas, cols), want)
    if kernel == "z3" or n == 0:
        assert (want >= 0).all()  # bit 63 is 0: int64 order is the unsigned order


def test_morton_in_width_codes_keep_bit_63_clear():
    """Normalized (31-bit) z2 inputs give 62-bit codes, so torch.sort on the
    int64 codes orders them as the reference's uint64 sort does."""
    rng = np.random.default_rng(21)
    x, y = (rng.integers(0, 2**31, 5000).astype(np.int32) for _ in range(2))
    x[:2], y[:2] = 2**31 - 1, 2**31 - 1
    got = z2_encode(_t(x), _t(y)).numpy()
    assert (got >= 0).all() and got.max() < 2**62
    assert np.array_equal(np.argsort(got, kind="stable"),
                          np.argsort(ref_zorder.encode2(x, y), kind="stable"))


def test_morton_wrapper_rejects_bad_inputs():
    a = torch.zeros(10, dtype=torch.int32)
    with pytest.raises(TypeError):
        z3_encode(a.long(), a, a)
    with pytest.raises(TypeError):
        z2_encode(a, a.reshape(2, 5))
    with pytest.raises(ValueError, match="contiguous"):
        z2_encode(torch.zeros(20, dtype=torch.int32)[::2], a)
    with pytest.raises(ValueError, match="length and device"):
        z3_encode(a, a, torch.zeros(9, dtype=torch.int32))
    with pytest.raises(ValueError, match="length and device"):
        z2_encode(a, torch.zeros(10, dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError, match="cuda or cpu"):
        z2_encode(*(torch.zeros(10, dtype=torch.int32, device="meta") for _ in range(2)))


@pytest.mark.cuda
def test_morton_kernels_match_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernel has no CPU mode")
    dev = torch.device("cuda")
    for n in (0, 1, 3000, 32769, 1_000_003):
        cols3 = [_t(c).to(dev) for c in _morton_inputs(n, 3, 21, Z3_EDGES, seed=n)]
        cols2 = [_t(c).to(dev) for c in _morton_inputs(n, 2, 31, Z2_EDGES, seed=n)]
        got3, got2 = z3_encode(*cols3), z2_encode(*cols2)
        torch.cuda.synchronize()
        assert torch.equal(got3, z3_encode_plain(*cols3))
        assert torch.equal(got2, z2_encode_plain(*cols2))
