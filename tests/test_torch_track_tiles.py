"""The model of the card's ``track_stats`` tile by tile
(``track_stats_tiles_plain``) against ``track_stats_plain``, which
``tests/test_torch_track_stats.py`` holds to the JAX package, on layouts
built around the tile edges, at tile sizes from one row up to the card's
``TRACK_TILE``. No jax.

Layouts (``tile_layout``, for a tile of ``t`` rows):
- ``span``: an entity over five tiles and more, begun and ended mid-tile;
- ``edge_empties``: empty entities on tile edges and between entities
  inside a tile, before the first row and after the last;
- ``aligned``: entities that start on a tile's first row;
- ``edge_steps``: a zero-length step and a 90-degree turn across tile
  edges, inside one entity;
- ``one``: a single entity (E = 1);
- ``small``: fewer rows than a tile;
- ``ragged``: a row count that is not a multiple of the tile.

The model also checks that its decomposition writes every entity exactly
once (it raises otherwise). Tolerance: rtol 1e-4 + atol 1e-3 against the
plain version (the sums' order differs); the step decisions (moved, dwell)
are taken on the same f32 terms, so a wrong carry or a lost entity shows
as a large difference.
"""

import numpy as np
import pytest
import torch

from geomesa_tpu_torch.ops.kernels import (
    TRACK_TILE, track_stats_plain, track_stats_tiles_plain, track_terms)

RTOL, ATOL = 1e-4, 1e-3
EPS = 1e-4
KINDS = ("span", "edge_empties", "aligned", "edge_steps", "one", "small", "ragged")
TILES = (1, 5, 64, TRACK_TILE)


def tile_layout(kind: str, tile: int, seed: int = 0):
    """(offsets int64, dt f32 seconds, x f32, y f32) of a track layout built
    around tiles of ``tile`` rows (see the module docstring)."""
    rng = np.random.default_rng(seed)
    t = tile
    third = max(1, t // 3)
    if kind == "span":
        sizes = [max(1, t // 2), 5 * t + 3, t + 2, 1, 3]
    elif kind == "edge_empties":
        sizes = [0, 0, t, 0, 0, t, 0, third, 0, 0, 2 * t - third, 0, 1, 0, 0]
    elif kind == "aligned":
        sizes = [t, t, 2 * t, t + 1, max(1, t - 1), t]
    elif kind == "edge_steps":
        sizes = [t + 2, 2 * t + 3, 5]
    elif kind == "one":
        sizes = [3 * t + 5]
    elif kind == "small":
        sizes = [1, t // 4 + 1, 0, t // 4 + 1]
    else:  # "ragged": 4t + 37 rows, entity ends a row either side of the edges
        sizes = [max(1, t - 1), 2, t + 1, 7]
        sizes.append(4 * t + 37 - sum(sizes))
    sizes = np.asarray(sizes, dtype=np.int64)
    offsets = np.r_[0, np.cumsum(sizes)].astype(np.int64)
    n = int(offsets[-1])
    x = rng.uniform(-30, 30, n).astype(np.float32)
    y = rng.uniform(-20, 20, n).astype(np.float32)
    dt = rng.integers(1, 90, n).astype(np.float32)
    if kind == "edge_steps" and n > 2 * t + 1:
        x[t], y[t] = x[t - 1], y[t - 1]  # a zero-length step into a tile's first row
        a = 2 * t - 2 if t > 1 else 3  # a turn whose middle row ends a tile
        x[a:a + 3] = [1.0, 2.0, 2.0]
        y[a:a + 3] = [1.0, 1.0, 2.0]
    dt[offsets[:-1][sizes > 0]] = 0
    return offsets, dt, x, y


def _tensors(layout):
    offsets, dt, x, y = layout
    return [torch.from_numpy(a) for a in (x, y, dt, offsets)]


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("kind", KINDS)
def test_tiles_equal_plain(kind, tile):
    """The tile model's sums equal the plain version's at tiles from one
    row up, on layouts built around that tile's edges; empty entities are
    0 and every entity is written once."""
    layout = tile_layout(kind, tile, KINDS.index(kind) + tile)
    args = _tensors(layout)
    got = track_stats_tiles_plain(*args, EPS, tile)
    want = track_stats_plain(*args, EPS)
    sizes = np.diff(layout[0])
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == (len(sizes),)
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=RTOL, atol=ATOL)
        assert (g.numpy()[sizes == 0] == 0).all()
    if kind == "edge_steps" and tile > 1:
        _, dist, _, turn, dwell = track_terms(*args, EPS)
        assert float(dist[tile]) == 0 and float(dwell[tile]) > 0  # the step across the edge
        assert float(turn[2 * tile]) == pytest.approx(90.0)  # the turn across the next edge


def test_no_rows_gives_zeros():
    """No row: every entity's sums are 0 (E > 0), and no entity gives no
    sums."""
    empty = torch.zeros(0, dtype=torch.float32)
    for e in (0, 3):
        off = torch.zeros(e + 1, dtype=torch.int64)
        got = track_stats_tiles_plain(empty, empty, empty, off, EPS, 4)
        assert all(g.shape == (e,) and not g.any() for g in got)
