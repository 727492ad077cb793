"""geomesa_tpu_torch — the point bbox+time path (z3 and z2 indexes), line and
polygon stores (xz3 and xz2), grouped aggregation, density heatmaps, batched
KNN, spatial joins, the resident count steps, the trajectory plane (corridor
engine and interlink) and the standing-query stream in PyTorch and CUDA.

A port of :mod:`geomesa_tpu` (the JAX package, kept beside it as the
reference) for one NVIDIA H100. It imports torch and numpy and never jax or
anything of ``geomesa_tpu``: host-side helpers are trimmed copies, each held
equal to its original by a test in ``tests/test_torch_*.py``.

Layers, top to bottom: :mod:`~geomesa_tpu_torch.store.datastore` (schema,
write, compact, query, count_many, select_many, aggregate_many,
density_many) and :mod:`~geomesa_tpu_torch.process` (knn_many, density, joins) and
:mod:`~geomesa_tpu_torch.trajectory` (tube select, route search, interlink) →
:mod:`~geomesa_tpu_torch.planning` and
:mod:`~geomesa_tpu_torch.index` (host planning to sorted-row intervals) →
:mod:`~geomesa_tpu_torch.store.backends` and
:mod:`~geomesa_tpu_torch.parallel` (device residency and steps) →
:mod:`~geomesa_tpu_torch.ops.kernels` (the hand-written CUDA kernels, built
from ``csrc/`` with ``nvcc`` at first use).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; with
no device given and no CUDA they raise instead of falling back.
"""

from geomesa_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
