"""Device sort keys (the counterpart of ``spark_rapids_tpu.ops.sort``):
every SortOrder becomes words whose ascending lexicographic order is
Spark's ordering — nulls first/last via a validity word, descending via
bitwise complement of the uint64 words (negation for float words) — and
``sort_with_payload`` chains stable single-key sorts over them.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from spark_rapids_tpu_torch.columnar.device import (
    AnyDeviceColumn, DeviceDecimal128Column, DeviceStringColumn,
    sort_with_payload)
from spark_rapids_tpu_torch.ops.groupby import (_descending, limb_words,
                                                pack_string_words,
                                                rank_words)


def order_subkeys(col: AnyDeviceColumn, ascending: bool,
                  nulls_first: bool) -> List[torch.Tensor]:
    """Words (most significant first) whose joint ascending order is the
    SortOrder's ordering of this column."""
    if isinstance(col, DeviceStringColumn):
        data_keys = pack_string_words(col) + [col.lengths.to(torch.int64)]
    elif isinstance(col, DeviceDecimal128Column):
        data_keys = limb_words(col)
    else:
        data_keys = rank_words(col)
    if not ascending:
        data_keys = _descending(data_keys)
    # False sorts before True: validity as-is puts nulls first
    null_key = col.validity if nulls_first else ~col.validity
    return [null_key] + data_keys


def sort_permutation(key_cols: Sequence[AnyDeviceColumn], orders: Sequence,
                     active: torch.Tensor) -> torch.Tensor:
    """Stable permutation sorting rows by the SortOrders, inactive rows
    sunk to the tail."""
    keys: List[torch.Tensor] = [~active]
    for col, o in zip(key_cols, orders):
        keys.extend(order_subkeys(col, o.ascending, o.nulls_first))
    return sort_with_payload(keys, [])[1]
