"""The interlink's routes where pairs sit exactly at the predicate's
distance, and the route it takes by default.

The port's ``interlink`` takes the block route by default where the right
store holds point z2 residency and the call has neither ``rfilter`` nor
``time_buffer_ms`` (``DEFAULT_PAIRING``), else the XZ pairing. Its answers
must not depend on the route. On an integer point grid (11 x 11) against a
half-integer one (25 x 25, from -1 to 11), every pair of ``dwithin 1.0``
and ``dwithin 0.5`` lies at a distance of 0, 0.5, 1 or sqrt(0.5), and
``intersects`` pairs equal points; 16 unit squares against the half-integer
grid put points on their corners and edges (``intersects``) and at 0.5 from
them (``dwithin 0.5``). For each case the port's default route, its forced
``"xz"`` and ``"block"`` routes and the reference's two routes all equal
``interlink_referee``, with the pair counts stated.

No tolerance: pair lists compare exactly.
"""

import importlib

import numpy as np
import pytest

import geomesa_tpu  # noqa: F401  (x64 on)
from geomesa_tpu.geometry.types import Point as RefPoint, Polygon as RefPolygon
from geomesa_tpu.store.datastore import DataStore as RefDataStore
from geomesa_tpu.trajectory.interlink import interlink as ref_interlink

from geomesa_tpu_torch.geometry.types import Point, Polygon
from geomesa_tpu_torch.planning.planner import Query
from geomesa_tpu_torch.store.datastore import DataStore
from geomesa_tpu_torch.trajectory.interlink import interlink, interlink_referee

# the module (the package exports its ``interlink`` function under the same name)
link = importlib.import_module("geomesa_tpu_torch.trajectory.interlink")

T0 = 1_600_000_000_000


def _stores(name, geoms):
    """The same features in the port's store and the reference's: points
    given as (x, y), polygons as rings."""
    poly = not isinstance(geoms[0], tuple)
    spec = "dtg:Date,*geom:" + ("Polygon" if poly else "Point") + ":srid=4326"
    ours = [{"dtg": T0 + i, "geom": Polygon(g) if poly else Point(*g)}
            for i, g in enumerate(geoms)]
    theirs = [{"dtg": T0 + i, "geom": RefPolygon(g) if poly else RefPoint(*g)}
              for i, g in enumerate(geoms)]
    fids = [f"{name}.{i}" for i in range(len(geoms))]
    ds = DataStore(device="cpu")
    ds.create_schema(name, spec)
    ds.write(name, ours, fids=fids)
    ref = RefDataStore(backend="tpu")
    ref.create_schema(name, spec)
    ref.write(name, theirs, fids=fids)
    ref.compact(name)
    return ds, ref


@pytest.fixture(scope="module")
def grids():
    ints = [(float(x), float(y)) for x in range(11) for y in range(11)]
    halves = [(x, y) for x in np.arange(-1.0, 11.5, 0.5) for y in np.arange(-1.0, 11.5, 0.5)]
    squares = [np.array([[x, y], [x + 1, y], [x + 1, y + 1], [x, y + 1], [x, y]])
               for x in (0.0, 2.0, 4.0, 6.0) for y in (1.0, 3.0, 5.0, 7.0)]
    return {"I": _stores("I", ints), "H": _stores("H", [(float(x), float(y)) for x, y in halves]),
            "S": _stores("S", squares)}


@pytest.fixture
def block_calls(monkeypatch):
    """Counts the block route's candidate pairings."""
    calls = []
    real = link._block_candidates

    def spy(*a, **k):
        calls.append(a[2])
        return real(*a, **k)

    monkeypatch.setattr(link, "_block_candidates", spy)
    return calls


@pytest.mark.parametrize("left,pred,dist,pairs", [
    ("I", "dwithin", 1.0, 1573),
    ("I", "dwithin", 0.5, 605),
    ("I", "intersects", 0.0, 121),
    ("S", "intersects", 0.0, 144),
    ("S", "dwithin", 0.5, 336),
])
def test_routes_equal_referee_at_exact_distances(grids, block_calls, left, pred, dist, pairs):
    (lds, lref), (rds, rref) = grids[left], grids["H"]
    lt, rt = lds.query(left, Query()).table, rds.query("H", Query()).table
    want = interlink_referee(lt, rt, pred=pred, distance=dist)
    assert len(want) == pairs
    default = interlink(lds, left, rds, "H", pred=pred, distance=dist)
    assert block_calls == ["H"]  # the default took the block route
    for route in ("xz", "block"):
        assert interlink(lds, left, rds, "H", pred=pred, distance=dist, route=route) == want
        assert ref_interlink(lref, left, rref, "H", pred=pred, distance=dist,
                             route=route) == want
    assert default == want


@pytest.mark.parametrize("case", ["plain", "time_buffer", "rfilter", "polygon_right"])
def test_default_route(grids, block_calls, case):
    """The block route by default where it is servable and the call has no
    ``rfilter`` or ``time_buffer_ms``; the XZ pairing otherwise, with the
    referee's pairs either way."""
    (lds, _), (rds, _) = grids["I"], grids["H"]
    rtype, rstore = ("S", grids["S"][0]) if case == "polygon_right" else ("H", rds)
    kw = {"time_buffer_ms": 60_000} if case == "time_buffer" else {}
    if case == "rfilter":
        kw["rfilter"] = "BBOX(geom, 2, 2, 8, 8)"
    got = interlink(lds, "I", rstore, rtype, pred="dwithin", distance=0.5, **kw)
    lt = lds.query("I", Query()).table
    rt = rstore.query(rtype, Query(filter=kw.get("rfilter"))).table
    assert got == interlink_referee(lt, rt, "dwithin", 0.5, kw.get("time_buffer_ms"))
    assert len(got) > 0
    assert link.DEFAULT_PAIRING == "block"
    assert block_calls == (["H"] if case == "plain" else [])
