"""Trajectory plane: track statistics, the corridor engine and interlinking.

Port of :mod:`geomesa_tpu.trajectory`:

- :mod:`.state` — the per-entity track layout (rows sorted by track and
  time, CSR entity offsets, cached on the store's data epoch) and every
  entity's statistics in one pass of the ``track_stats`` kernel;
- :mod:`.corridor` — tube select and route search as one (rows x
  corridors) problem on the card (the ``corridor_masks`` kernel: its gather
  form over a point store's resident candidates,
  :func:`geomesa_tpu_torch.ops.kernels.corridor_masks_gather`, its row
  form over a candidate table, through
  :func:`geomesa_tpu_torch.parallel.query.corridor_step`), exact by an f64
  refine of the band between its two f32 masks;
- :mod:`.interlink` — predicate links between two stores (2D and XZ3
  time-lifted) by XZ-range pairing, or by the blocked device join.
"""

from geomesa_tpu_torch.trajectory.corridor import (  # noqa: F401
    CorridorSpec, route_search_device, tube_select_device, tube_select_many)
from geomesa_tpu_torch.trajectory.interlink import interlink, interlink_referee  # noqa: F401
from geomesa_tpu_torch.trajectory.state import (  # noqa: F401
    TrackState, build_track_state, track_stats, track_stats_host)
