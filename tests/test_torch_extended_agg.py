"""The overlap form of the grouped fold, the device step of
``aggregate_many`` on a line or polygon store, against geomesa_tpu on the
same seeded data, on the CPU (the store-level answers are
``tests/test_torch_extended_store.py``'s and
``tests/test_torch_extended_density.py``'s).

- ``grouped_agg_overlap_plain`` (and ``grouped_agg_step(overlap=True)``,
  the wrapper on CPU tensors) against ``make_grouped_agg_step(overlap=True)``
  on a one-device mesh: V = 0, 1 and 2 value columns with NaN, config-5
  bboxes with rows on the queries' opposing edges, zero-size, whole-world
  and stamped invalid rows, an all-dead query, ``true_n`` inside the last
  chunk and lanes that overflow; dead and inverted box slots, which the
  port's overlap predicate drops;
- the work list over a bbox state's extents (``chunk_extents_bbox``): no
  (chunk, query) pair it drops holds an overlap match (the point cull is an
  exact superset for overlap).

Tolerance: counts, first rows, value counts, min, max and lanes compare
exactly; f64 sums within a relative 1e-12 (another fold order).
"""

import numpy as np
import pytest
import torch

import geomesa_tpu  # noqa: F401  (x64 on)
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec
from geomesa_tpu.parallel.mesh import DATA_AXIS, make_mesh, shard_columns
from geomesa_tpu.parallel.query import make_grouped_agg_step

from geomesa_tpu_torch.ops import kernels
from geomesa_tpu_torch.ops.kernels import (
    chunk_extents_bbox, grouped_agg_overlap, grouped_agg_overlap_plain)
from geomesa_tpu_torch.parallel.query import grouped_agg_step
from geomesa_tpu_torch.parallel.residency import stage_columns

from test_torch_overlap import COLS, _payload, _rows

RTOL = 1e-12
N, Q, GROUPS = 16_000, 10, 50
G_PAD = 64


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


_STEPS: dict = {}


def _ref_step(cols, gid, rowid, vals, true_n, boxes, times, cap):
    """``make_grouped_agg_step(overlap=True)`` on a one-device mesh, the
    columns padded to 4096 rows as the store pads them."""
    mesh = make_mesh(1)
    key = (vals.shape[0], boxes.shape, times.shape, cap)
    step = _STEPS.get(key)
    if step is None:
        step = _STEPS[key] = make_grouped_agg_step(mesh, G_PAD, vals.shape[0], cap,
                                                   impl="segment", overlap=True)
    sharded, padded, _ = shard_columns(mesh, {**dict(zip(COLS, cols)), "gid": gid},
                                       multiple=4096)
    rid, _, _ = shard_columns(mesh, {"rowid": rowid}, multiple=4096,
                              pad_value=np.iinfo(np.int32).max)
    pv = np.zeros((vals.shape[0], padded))
    pv[:, : vals.shape[1]] = vals
    dv = jax.device_put(pv, NamedSharding(mesh, PartitionSpec(None, DATA_AXIS)))
    out = step(*(sharded[c] for c in COLS), sharded["gid"], rid["rowid"], dv,
               jnp.int32(true_n), jnp.asarray(boxes), jnp.asarray(times))
    return [np.asarray(o) for o in out], padded


def _inputs(n_vals: int, nb: int, nt: int, seed: int):
    cols, edge_rows = _rows(N, seed=seed)
    boxes, times = _payload(cols, edge_rows, Q, nb, nt, seed=seed + 1)
    # a query with no live slot: the overlap pad, dead in both packages
    boxes[2, :] = [[2**31 - 1, -1, 2**31 - 1, -1]] * nb
    rng = np.random.default_rng(seed + 7)
    gid = rng.integers(0, GROUPS, N).astype(np.int32)
    rowid = rng.permutation(N).astype(np.int32)
    vals = rng.normal(50.0, 20.0, (n_vals, N))
    vals[rng.random((n_vals, N)) < 0.1] = np.nan
    return cols, boxes, times, gid, rowid, vals


# (V, box slots, time slots, lane capacity): one compile of the reference
# step each; capacity 8 overflows some queries' lanes
STEP_CASES = [(0, 3, 4, 512), (1, 8, 16, 512), (2, 3, 4, 512), (2, 3, 4, 8), (1, 1, 1, 512)]


@pytest.mark.parametrize("n_vals,nb,nt,cap", STEP_CASES)
def test_overlap_plain_equals_jax_step(n_vals, nb, nt, cap):
    cols, boxes, times, gid, rowid, vals = _inputs(n_vals, nb, nt, seed=5 * n_vals + nb)
    true_n = N - 1234  # inside the last chunk (rows 12288..15999)
    want, padded = _ref_step(cols, gid, rowid, vals, true_n, boxes, times, cap)

    def pad(a, value):
        out = np.full(a.shape[:-1] + (padded,), value, dtype=a.dtype)
        out[..., : a.shape[-1]] = a
        return _t(out)

    staged, _ = stage_columns(dict(zip(COLS, cols)), torch.device("cpu"))
    tc = tuple(staged[c] for c in COLS)
    args = (pad(gid, 0), pad(rowid, np.iinfo(np.int32).max), pad(vals, 0.0), 0, true_n,
            _t(boxes), _t(times), G_PAD, cap)
    got = grouped_agg_overlap_plain(tc, *args, chunk=8192)  # two chunks of rows
    hits = want[7].sum(axis=1)
    fits = hits <= cap
    names = ("cnt", "first", "vcnt", "vsum", "vmin", "vmax", "positions", "hits")
    for name, g, w in zip(names, got, want):
        g = g.cpu().numpy()
        assert g.shape == w.shape and g.dtype == w.dtype, name
        if name == "vsum":
            assert np.allclose(g, w, rtol=RTOL, atol=0), name
        elif name == "positions":
            assert np.array_equal(g[fits], w[fits]), name
        else:
            assert np.array_equal(g, w), name
    if nb == 1:  # the wrapper and the step take the plain version on CPU tensors
        for out in (grouped_agg_overlap(tc, *args),
                    grouped_agg_step(tc, *args[:3], true_n, _t(boxes), _t(times), G_PAD, cap,
                                     overlap=True)):
            for name, g, w in zip(names, out, got):
                assert torch.allclose(g, w, rtol=RTOL, atol=0) if name == "vsum" \
                    else torch.equal(g, w), name
    assert want[0].sum() > 0 and hits.sum() > 0
    assert want[0][2].sum() == 0 and hits[2] == 0  # the all-dead query
    if cap == 8:
        assert not fits.all()


def test_dead_and_inverted_slots_match_nothing():
    """An inverted box slot is dead in the port's overlap predicate (as the
    kernels stage it): adding one to a query changes nothing, and a query of
    dead slots folds nothing. The reference's packers never make one (every
    box they pack has lo <= hi)."""
    cols, boxes, times, gid, rowid, vals = _inputs(1, 3, 4, seed=9)
    staged, _ = stage_columns(dict(zip(COLS, cols)), torch.device("cpu"))
    tc = tuple(staged[c] for c in COLS)
    args = (_t(gid), _t(rowid), _t(vals), 0, N, _t(boxes), _t(times), G_PAD, 512)
    want = grouped_agg_overlap_plain(tc, *args)
    adv = boxes.copy()
    adv[1, -1] = [500, 100, 500, 100]  # inverted in x and y: overlaps wide rows if live
    adv[3, :] = [[7, 3, 2**31 - 9, 2]] * adv.shape[1]
    got = grouped_agg_overlap_plain(tc, *args[:5], _t(adv), *args[6:])
    for i, (g, w) in enumerate(zip(got, want)):
        if i == 3:
            assert torch.allclose(g[[0, 1, 2] + list(range(4, Q))],
                                  w[[0, 1, 2] + list(range(4, Q))], rtol=RTOL, atol=0)
        else:
            assert torch.equal(g[[0, 1, 2] + list(range(4, Q))],
                               w[[0, 1, 2] + list(range(4, Q))]), i
    assert int(got[0][3].sum()) == int(got[7][3, 0]) == 0
    assert int(want[0][3].sum()) > 0


def test_step_checks_its_mode():
    cols, boxes, times, gid, rowid, vals = _inputs(1, 1, 1, seed=3)
    staged, _ = stage_columns(dict(zip(COLS, cols)), torch.device("cpu"))
    tc = tuple(staged[c] for c in COLS)
    with pytest.raises(ValueError, match="overlap mode takes 6"):
        grouped_agg_step(tc[:4], _t(gid), _t(rowid), _t(vals), N, _t(boxes), _t(times), G_PAD,
                         overlap=True)
    with pytest.raises(ValueError, match="point mode takes 4"):
        grouped_agg_step(tc, _t(gid), _t(rowid), _t(vals), N, _t(boxes), _t(times), G_PAD)
    with pytest.raises(ValueError, match="time columns"):
        grouped_agg_overlap(tc[:4], _t(gid), _t(rowid), _t(vals), 0, N, _t(boxes), None, G_PAD)


@pytest.mark.parametrize("seed", [1, 2, 4])
def test_work_list_over_bbox_extents_keeps_every_match(seed):
    cols, boxes, times, *_ = _inputs(0, 3, 4, seed=seed)
    staged, _ = stage_columns(dict(zip(COLS, cols)), torch.device("cpu"))
    tc = tuple(staged[c] for c in COLS)
    true_n = N - 77
    ext = chunk_extents_bbox(*tc)
    chunks, kept, runs, work = kernels.agg_work_list(ext, tc[0].shape[0], 0, true_n, _t(boxes),
                                                     _t(times), 5)
    keep = torch.zeros((Q, ext.shape[0]), dtype=torch.bool)
    for q in range(Q):
        keep[q, chunks[q, : kept[q]].long()] = True
    n = tc[0].shape[0]
    (_, _, m, _), = kernels._overlap_plain_masks(tc, 0, true_n, _t(boxes), _t(times), n)
    matched = m.view(Q, n // 4096, 4096).any(dim=2)  # a chunk holding a match of the query
    assert matched.any() and not (matched & ~keep).any()
    assert torch.equal(keep, kernels.overlap_chunk_pairs(tc, 0, true_n, _t(boxes),
                                                         _t(times)).T)
    assert int(kept.sum()) < keep.numel()  # the cull drops pairs
