"""Carry a reference store's main tier across into the port's store.

:func:`load_reference_state` takes the main tier of a ``geomesa_tpu``
DataStore as plain numpy arrays — extracted by the caller, so this module
never imports the reference — and installs it in the port's store in the
same row order, without re-sorting, staging the same device columns.
"""

from __future__ import annotations

import numpy as np

from geomesa_tpu_torch.schema.columnar import Column, FeatureTable, point_column
from geomesa_tpu_torch.schema.sft import AttributeType


def load_reference_state(store, type_name: str, spec: str, columns: dict,
                         fids, perm) -> None:
    """Create ``type_name`` from ``spec`` and install a main tier.

    ``columns``: attribute name → numpy array in the reference table's row
    order; the point geometry maps to a ``(lon, lat)`` pair of f64 arrays,
    the date to int64 epoch millis. ``fids``: feature ids in that order.
    ``perm``: the reference indexes' sorted position → row permutations by
    index name (``{"z3": ..., "z2": ...}``), each installed into that index;
    a bare array is the z3 permutation. An index of the schema without one
    is built by the store.
    """
    sft = store.create_schema(type_name, spec)
    cols = {}
    for a in sft.attributes:
        v = columns[a.name]
        if a.type == AttributeType.POINT:
            lon, lat = v
            cols[a.name] = point_column(lon, lat)
        else:
            cols[a.name] = Column(a.type, np.asarray(v))
    table = FeatureTable.from_columns(sft, fids, cols)
    store._validate(sft, table)
    perms = perm if isinstance(perm, dict) else {"z3": perm}
    store._rebuild(store._state(type_name), table,
                   perms={name: np.asarray(p) for name, p in perms.items()})
