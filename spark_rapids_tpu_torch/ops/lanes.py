"""Multi-tensor gather and the raw-bit view of key words (the counterpart
of ``spark_rapids_tpu.ops.lanes``).

The JAX package packs many arrays into one lane matrix so a gather costs
one dispatch on its backend. On the card each gather is one launch of a
memory-bound kernel either way, so ``fused_take`` here only deduplicates
repeated tensors and gathers each once.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

_M32 = 0xFFFFFFFF


def _as_u64_bits(a: torch.Tensor) -> torch.Tensor:
    """Value -> its raw bits zero-extended into an int64 (the uint64 bit
    image the JAX package builds), elementwise."""
    if a.dtype == torch.bool:
        return a.to(torch.int64)
    if a.dtype == torch.int64:
        return a
    if a.dtype == torch.float32:
        return a.view(torch.int32).to(torch.int64) & _M32
    if a.dtype == torch.float64:
        return a.view(torch.int64)
    if a.dtype == torch.uint8:
        return a.to(torch.int64)
    width = {torch.int8: 8, torch.int16: 16, torch.int32: 32}[a.dtype]
    return a.to(torch.int64) & ((1 << width) - 1)


def fused_take(arrays: Sequence[torch.Tensor], idx: torch.Tensor
               ) -> List[torch.Tensor]:
    """``[a[idx] for a in arrays]``, gathering each distinct tensor once
    (along dim 0; 2-D byte matrices gather whole rows)."""
    seen: dict = {}
    out: List[torch.Tensor] = []
    for a in arrays:
        g = seen.get(id(a))
        if g is None:
            g = a.index_select(0, idx)
            seen[id(a)] = g
        out.append(g)
    return out
