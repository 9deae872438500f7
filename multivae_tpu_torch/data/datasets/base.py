"""Multimodal dataset bases (numpy-backed, batch-gather oriented).

Counterpart of ``multivae_tpu/data/datasets/base.py``: storage is host
numpy and batches are gathered with one row gather per modality
(``get_batch``): the threaded native gather (``data/native_gather.py``)
for rows of 512 bytes or more, numpy's fancy indexing otherwise.
``IncompleteDataset`` keeps the reference convention: missing entries are
zero-filled at the right shape and a boolean mask per modality carries
availability. A modality may be a dict of arrays with a
common leading axis (CUB's ``{"tokens", "padding_mask"}`` text): its rows
are taken from each array. ``ResampleDataset`` is an index view over
another dataset, and ``random_split`` cuts a dataset into such views (the
case studies' 90/10 train/eval split).
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np

from ...utils.model_output import ModelOutput
from ..batch import first_leaf, map_leaves


class DatasetOutput(ModelOutput):
    """Attr-dict returned by ``__getitem__`` and ``get_batch``."""


def _as_numpy(x):
    if isinstance(x, dict):
        return {k: _as_numpy(v) for k, v in x.items()}
    if hasattr(x, "detach"):  # torch tensor
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _length(value) -> int:
    return len(first_leaf(value))


def _take_rows(v, index):
    if (isinstance(v, np.ndarray) and isinstance(index, np.ndarray)
            and index.ndim == 1 and v.ndim >= 2
            and v.dtype.itemsize * math.prod(v.shape[1:]) >= 512):
        # rows of 512 bytes or more: the threaded native gather
        from ..native_gather import gather_rows

        return gather_rows(v, index)
    return v[index]


def _take(value, index):
    return map_leaves(lambda v: _take_rows(v, index), value)


class MultimodalBaseDataset:
    """Base class for multimodal datasets.

    Args:
        data: dict modality name -> array (n_samples, *dims), or a dict of
            such arrays (a token modality).
        labels: optional (n_samples,) array.
    """

    def __init__(self, data: dict, labels=None):
        self.data = _as_numpy(data)
        self.labels = None if labels is None else _as_numpy(labels)
        self._check_lengths()

    def _check_lengths(self):
        length = len(self)
        for m in self.data:
            if _length(self.data[m]) != length:
                raise AttributeError(
                    "The size of the provided datasets doesn't correspond "
                    "between modalities!"
                )
        if self.labels is not None and len(self.labels) != length:
            raise AttributeError(
                "The size of the provided labels doesn't correspond to the data"
            )

    def __len__(self):
        return _length(next(iter(self.data.values())))

    def __getitem__(self, index):
        return self.get_batch(index)

    def get_batch(self, indices) -> DatasetOutput:
        """Vectorized gather of a batch of samples by index array."""
        out = DatasetOutput(data={m: _take(v, indices) for m, v in self.data.items()})
        if self.labels is not None:
            out["labels"] = self.labels[indices]
        return out

    def transform_for_plotting(self, tensor, modality):
        """Hook mapping a model-space array of ``modality`` to a plottable
        image (the identity here)."""
        return tensor


class IncompleteDataset(MultimodalBaseDataset):
    """Multimodal dataset with per-modality availability masks.

    Missing entries must be zero-filled at the right shape in ``data``; the
    boolean ``masks[m][i]`` says whether sample i's modality m is real.
    """

    def __init__(self, data: dict, masks: Dict[str, np.ndarray], labels=None):
        self.masks = {k: _as_numpy(v).astype(bool) for k, v in masks.items()}
        super().__init__(data, labels)

    def _check_lengths(self):
        super()._check_lengths()
        length = len(self)
        for m in self.data:
            if m not in self.masks or len(self.masks[m]) != length:
                raise AttributeError(
                    "The size of the provided datasets/masks doesn't "
                    "correspond between modalities!"
                )

    def get_batch(self, indices) -> DatasetOutput:
        out = super().get_batch(indices)
        out["masks"] = {m: v[indices] for m, v in self.masks.items()}
        return out


class ResampleDataset(MultimodalBaseDataset):
    """Index-remapping view over another dataset: row ``i`` is the base
    dataset's row ``indices[i]``."""

    def __init__(self, dataset: MultimodalBaseDataset, indices=None):
        self.dataset = dataset
        if indices is None:
            indices = np.arange(len(dataset))
        self.indices = np.asarray(indices)

    def __len__(self):
        return len(self.indices)

    def get_batch(self, indices) -> DatasetOutput:
        return self.dataset.get_batch(self.indices[indices])

    @property
    def labels(self):
        base_labels = getattr(self.dataset, "labels", None)
        return None if base_labels is None else base_labels[self.indices]

    def transform_for_plotting(self, tensor, modality):
        return self.dataset.transform_for_plotting(tensor, modality)


def random_split(dataset, fractions, seed: int = 0):
    """Split a dataset into ``ResampleDataset`` views of a
    ``default_rng(seed)`` permutation, of ``floor(fraction * n)`` rows each,
    the remainder going to the first.

    Args:
        dataset: any multimodal dataset.
        fractions: sequence of floats summing to 1 (e.g. ``[0.9, 0.1]``).
        seed: permutation seed.
    """
    fracs = np.asarray(list(fractions), dtype=np.float64)
    if not np.isclose(fracs.sum(), 1.0):
        raise ValueError(f"fractions must sum to 1, got {fracs.sum()}")
    n = len(dataset)
    perm = np.random.default_rng(seed).permutation(n)
    sizes = np.floor(fracs * n).astype(int)
    sizes[0] += n - sizes.sum()
    out, start = [], 0
    for s in sizes:
        out.append(ResampleDataset(dataset, perm[start:start + s]))
        start += s
    return out
