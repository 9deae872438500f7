"""Modality subsets as membership matrices (counterpart of
``multivae_tpu/ops/subsets.py``; pure numpy, the port's own copy).

The subset models (MVAE, MoPoE) enumerate the modality subsets once at
construction and turn each into a row of an (n_subsets, n_modalities) 0/1
matrix, so every per-subset product of experts is one batched op over the
subset axis.
"""

from __future__ import annotations

from itertools import chain, combinations
from typing import List, Sequence, Tuple

import numpy as np


def all_subsets(modalities: Sequence[str], include_empty: bool = False,
                include_full: bool = True) -> List[Tuple[str, ...]]:
    """All subsets of the modality list, ordered by size, then position."""
    mods = list(modalities)
    start = 0 if include_empty else 1
    end = len(mods) + 1 if include_full else len(mods)
    return list(chain.from_iterable(combinations(mods, n) for n in range(start, end)))


def subsets_to_mask(subsets: Sequence[Sequence[str]],
                    modalities: Sequence[str]) -> np.ndarray:
    """The (n_subsets, n_modalities) float32 membership matrix."""
    mod_index = {m: i for i, m in enumerate(modalities)}
    mask = np.zeros((len(subsets), len(modalities)), dtype=np.float32)
    for s, subset in enumerate(subsets):
        for m in subset:
            mask[s, mod_index[m]] = 1.0
    return mask


def all_subsets_mask(modalities: Sequence[str], include_empty: bool = False,
                     include_full: bool = True
                     ) -> Tuple[List[Tuple[str, ...]], np.ndarray]:
    """(subset name tuples, membership matrix)."""
    subsets = all_subsets(modalities, include_empty, include_full)
    return subsets, subsets_to_mask(subsets, modalities)
