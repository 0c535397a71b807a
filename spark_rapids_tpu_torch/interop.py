"""Column data in, port batch out: the counterpart of carrying weights
across between the two packages.

The JAX package's host columns are numpy arrays (``HostColumn.data`` and
``.validity``); ``host_batch_from_numpy`` builds the port's ``HostBatch``
from exactly those arrays, so a test or a script can feed both packages
the same seeded data without the port importing the JAX package.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from spark_rapids_tpu_torch.columnar.host import HostBatch, HostColumn
from spark_rapids_tpu_torch.sql import types as T


def host_batch_from_numpy(fields: Sequence[Tuple[str, T.DataType]],
                          arrays: Sequence[np.ndarray],
                          validities: Optional[Sequence[
                              Optional[np.ndarray]]] = None) -> HostBatch:
    """``fields`` are (name, port DataType) pairs; ``arrays[i]`` is the
    column's storage (int64 unscaled for decimals <= 18 digits, an
    (n, 2) int64 [hi, lo] pair beyond, int32 days for dates, an object
    array of str for strings); ``validities[i]`` is a bool mask or None
    for all-valid."""
    if len(fields) != len(arrays):
        raise ValueError("one array per field")
    validities = list(validities or [None] * len(arrays))
    n = len(arrays[0]) if len(arrays) else 0
    schema = T.StructType([T.StructField(name, dt) for name, dt in fields])
    cols = []
    for (name, dt), data, valid in zip(fields, arrays, validities):
        data = np.asarray(data)
        if len(data) != n:
            raise ValueError(f"column {name} has {len(data)} rows, not {n}")
        if valid is None:
            valid = np.ones(n, dtype=bool)
        cols.append(HostColumn(dt, data, np.asarray(valid, dtype=bool))
                    .normalized())
    return HostBatch(schema, cols, n)


def array_column(element_type: T.DataType, lengths: np.ndarray,
                 values: np.ndarray,
                 validity: Optional[np.ndarray] = None,
                 value_validity: Optional[np.ndarray] = None,
                 varbytes: Optional[Tuple[np.ndarray, np.ndarray]] = None
                 ) -> HostColumn:
    """An ``array<element_type>`` host column from numpy: row i holds the
    next ``lengths[i]`` entries of ``values`` (storage form, as
    ``host_batch_from_numpy`` takes a flat column); a null row
    (``validity`` False) must have length 0. ``varbytes`` are a string
    element column's UTF-8 bytes and lengths, where the caller has them.
    The rows' tuples are made only if something reads them."""
    lengths = np.asarray(lengths, dtype=np.int32)
    n = len(lengths)
    validity = np.ones(n, bool) if validity is None else \
        np.asarray(validity, dtype=bool)
    if (lengths[~validity] != 0).any():
        raise ValueError("a null array row must have length 0")
    if int(lengths.sum()) != len(values):
        raise ValueError(f"lengths sum to {int(lengths.sum())}, "
                         f"not {len(values)} values")
    ev = np.ones(len(values), bool) if value_validity is None else \
        np.asarray(value_validity, dtype=bool)
    child = HostColumn(element_type, np.asarray(values), ev, varbytes)
    return HostColumn(T.ArrayType(element_type), None, validity,
                      elements=(lengths, child))
