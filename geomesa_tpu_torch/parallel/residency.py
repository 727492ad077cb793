"""Single-GPU residency: pad and stage sorted int32 columns on the device.

Port of :func:`geomesa_tpu.parallel.mesh.shard_columns` for one shard: the
columns are padded to a multiple of ``JOIN_BLOCK`` rows and staged whole, so
``base = 0`` and ``rows_per_shard = padded``. Padding rows sit past the true
row count and every kernel masks them by it.
"""

from __future__ import annotations

import numpy as np
import torch

from geomesa_tpu_torch.ops.kernels import JOIN_BLOCK  # row alignment of the resident layout


def pad_rows(n: int) -> int:
    """Row count padded up to a multiple of ``JOIN_BLOCK`` (at least one)."""
    return max(-(-n // JOIN_BLOCK), 1) * JOIN_BLOCK


def stage_columns(columns: dict[str, np.ndarray], device: torch.device):
    """Pad with zeros + stage int32 columns on ``device``.

    Returns (dict of contiguous int32 tensors, padded row count)."""
    n = len(next(iter(columns.values())))
    padded = pad_rows(n)
    out = {}
    for name, arr in columns.items():
        if len(arr) != n or arr.dtype != np.int32:
            raise ValueError(f"column {name} must be int32 of length {n}")
        host = np.zeros(padded, dtype=np.int32)
        host[:n] = arr
        out[name] = torch.from_numpy(host).to(device)
    return out, padded
