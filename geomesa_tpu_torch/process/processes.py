"""Geoprocessing operations over a store.

Port of :func:`geomesa_tpu.process.processes.density` (``processes.py:57``,
the ``DensityProcess`` role); the module's other processes are not ported.
"""

from __future__ import annotations

from geomesa_tpu_torch.planning.planner import Query


def density(ds, type_name: str, filter=None, bbox=None, width: int = 256, height: int = 256,
            weight_by=None):
    """Heatmap grid over the matching features, riding the ``density``
    query hint. Returns (height, width) float64."""
    opts = {"width": width, "height": height}
    if bbox is not None:
        opts["bbox"] = bbox
    if weight_by:
        opts["weight_by"] = weight_by
    return ds.query(type_name, Query(filter=filter, hints={"density": opts})).density
