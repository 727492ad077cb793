"""Int-domain candidate refinement and the packed query payloads.

Port of :mod:`geomesa_tpu.ops.refine`: the numpy payload packers are
byte-equal copies (a test holds them so), and :func:`refine_points` /
:func:`refine_bboxes` are the gather + int-domain bbox/time tests (point
containment / bbox overlap) in torch over any device. Int compares
are a superset test (normalization is monotone); the exact f64 residual
runs downstream on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from geomesa_tpu_torch.ops.kernels import overlap_masks, row_masks

MAX_BOXES = 8  # padded box-slot count
MAX_TIMES = 16  # padded time-window slot count

# sentinel rows make padded slots always-false (lo > hi)
_BOX_PAD = np.array([1, 0, 1, 0], dtype=np.int32)
# the overlap (XZ) pad: [1, 0, 1, 0] is empty under point containment but a
# feature bbox spanning the origin corner overlaps it; [qxlo=MAX, qxhi=-1,
# ...] overlaps no bbox with non-negative normalized coordinates
_BOX_PAD_OVERLAP = np.array([2**31 - 1, -1, 2**31 - 1, -1], dtype=np.int32)
_TIME_PAD = np.array([1, 0, 0, -1], dtype=np.int32)


def pack_boxes(boxes_i32: np.ndarray | None, slots: int = MAX_BOXES,
               overlap: bool = False) -> np.ndarray:
    """(B, 4) [xlo, xhi, ylo, yhi] int32 → padded (``slots``, 4). More boxes
    than slots collapse to their bounding envelope (still a superset).
    ``overlap=True`` pads with the overlap sentinel, for the bbox-overlap
    kernels of line and polygon stores."""
    if boxes_i32 is None or len(boxes_i32) == 0:
        boxes_i32 = np.array([[0, 2**31 - 1, 0, 2**31 - 1]], dtype=np.int32)
    b = np.asarray(boxes_i32, dtype=np.int32)
    if len(b) > slots:
        b = np.array(
            [[b[:, 0].min(), b[:, 1].max(), b[:, 2].min(), b[:, 3].max()]],
            dtype=np.int32,
        )
    pad = np.broadcast_to(_BOX_PAD_OVERLAP if overlap else _BOX_PAD, (slots - len(b), 4))
    return np.vstack([b, pad])


def pack_times(times_i32: np.ndarray | None, slots: int = MAX_TIMES) -> np.ndarray:
    """(T, 4) [bin_lo, off_lo, bin_hi, off_hi] int32 → padded (``slots``, 4)."""
    if times_i32 is None or len(times_i32) == 0:
        # unconstrained: off_lo = -1 matches every row, endpoints unhittable
        times_i32 = np.array([[0, -1, 2**31 - 1, 2**31 - 1]], dtype=np.int32)
    t = np.asarray(times_i32, dtype=np.int32)
    if len(t) > slots:
        t = np.array(
            [[t[:, 0].min(), -1, t[:, 2].max(), 2**31 - 1]], dtype=np.int32
        )
    pad = np.broadcast_to(_TIME_PAD, (slots - len(t), 4))
    return np.vstack([t, pad])


def unsat_rows(box_slots: int, time_slots: int) -> tuple[np.ndarray, np.ndarray]:
    """The payload pair that matches NOTHING while keeping the packed shapes:
    every box slot empty, every time window ending before it starts."""
    return (
        pack_boxes(_BOX_PAD[None], slots=box_slots),
        pack_times(_TIME_PAD[None], slots=time_slots),
    )


def refine_points(x, y, bins, offs, idx, count: int, boxes, times) -> torch.Tensor:
    """Gather + int-domain bbox/time test over candidate slots.

    ``x, y, bins, offs``: (N,) int32 sorted columns; ``idx``: (C,) int64 or
    int32 candidate slot → sorted position; ``count``: real (non-padding)
    slots; ``boxes`` (B, 4) / ``times`` (T, 4) int32. Returns (C,) bool. The
    test is :func:`~geomesa_tpu_torch.ops.kernels.row_masks`, the predicate
    every count kernel's plain version runs."""
    m, _ = row_masks(x[idx][None, :], y[idx][None, :], bins[idx][None, :],
                     offs[idx][None, :], boxes[None], times[None])
    return m[0] & (torch.arange(idx.shape[0], device=idx.device) < count)


def refine_bboxes(xmin, ymin, xmax, ymax, bins, offs, idx, count: int, boxes,
                  times) -> torch.Tensor:
    """Gather + int-domain bbox-overlap/time test over candidate slots, for
    line and polygon stores (the reference's ``refine_bboxes`` :138):
    ``xmin, ymin, xmax, ymax, bins, offs`` (N,) int32 sorted columns, the
    rest as in :func:`refine_points`, ``boxes`` packed with
    ``pack_boxes(..., overlap=True)``. Returns (C,) bool. The test is
    :func:`~geomesa_tpu_torch.ops.kernels.overlap_masks`, the predicate
    every overlap kernel's plain version runs."""
    m, _ = overlap_masks(*(c[idx][None, :] for c in (xmin, ymin, xmax, ymax, bins, offs)),
                         boxes[None], times[None])
    return m[0] & (torch.arange(idx.shape[0], device=idx.device) < count)
