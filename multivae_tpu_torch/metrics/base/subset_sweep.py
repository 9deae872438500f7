"""The order in which the evaluators sweep the conditioning subsets
(counterpart of ``multivae_tpu/metrics/base/subset_sweep.py``'s
``all_subsets``). The JAX package's fused sweep, every subset in one
compiled program a batch, is not part of the port: its evaluators run the
per-subset loop."""

from __future__ import annotations

from itertools import combinations
from typing import List, Optional, Sequence, Tuple


def all_subsets(modalities: Sequence[str], min_size: int = 1,
                max_size: Optional[int] = None) -> List[Tuple[str, ...]]:
    """All modality subsets, by size and then in ``combinations`` order."""
    mods = list(modalities)
    if max_size is None:
        max_size = len(mods)
    out: List[Tuple[str, ...]] = []
    for n in range(min_size, max_size + 1):
        out.extend(combinations(mods, n))
    return out
