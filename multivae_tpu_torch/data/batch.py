"""The batch consumed by every model's compute path.

Counterpart of ``multivae_tpu/data/batch.py``, as a plain dataclass of
tensors:

- ``masks`` is always present (all-ones for complete datasets), so complete
  and incomplete data run the same code; models simply multiply;
- ``weights`` is 0 on the padding rows the loader adds to keep every batch
  the same size, 1 elsewhere;
- ``incomplete`` says whether the source dataset declared masks.

A modality may be a dict of tensors with a common leading axis (CUB's
``{"tokens", "padding_mask"}`` text), as the JAX batch's pytree allows:
``map_leaves`` applies a tensor operation to each of them.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch


def map_leaves(fn, value):
    """``fn(value)`` on a modality's tensor, or on each tensor of a nested
    (dict) modality, keeping its keys."""
    if isinstance(value, dict):
        return {k: map_leaves(fn, v) for k, v in value.items()}
    return fn(value)


def add_axes(value, n: int = 1):
    """A modality with ``n`` leading axes of size 1 (on each tensor of a
    nested one): the target a (K, B, ...) reconstruction is scored on."""
    return map_leaves(lambda t: t[(None,) * n], value)


def first_leaf(value):
    """The tensor of a modality, or the first one of a nested modality."""
    while isinstance(value, dict):
        value = next(iter(value.values()))
    return value


def _tensor(x, dtype=None) -> torch.Tensor:
    if isinstance(x, dict):
        return map_leaves(lambda v: _tensor(v, dtype), x)
    if isinstance(x, torch.Tensor):
        return x if dtype is None else x.to(dtype)
    arr = np.asarray(x)
    t = torch.from_numpy(np.ascontiguousarray(arr))
    return t if dtype is None else t.to(dtype)


@dataclasses.dataclass
class MultimodalBatch:
    """A batch of multimodal data.

    Attributes:
        data: modality name -> tensor of shape (B, *modality_dims), or a
            dict of such tensors (a token modality).
        masks: modality name -> float (B,) availability (1 = available).
        weights: float (B,) sample weights; 0 marks padding samples.
        labels: optional (B,) labels.
        incomplete: did the source dataset declare masks?
    """

    data: Dict[str, torch.Tensor]
    masks: Dict[str, torch.Tensor]
    weights: torch.Tensor
    labels: Optional[torch.Tensor] = None
    incomplete: bool = False

    @property
    def n_samples(self) -> int:
        return first_leaf(next(iter(self.data.values()))).shape[0]

    def to(self, device, non_blocking: bool = False) -> "MultimodalBatch":
        return map_tensors(lambda t: t.to(device, non_blocking=non_blocking), self)


def floats_to(batch: MultimodalBatch, dtype: torch.dtype) -> MultimodalBatch:
    """The batch with its float32 tensors (data, masks, weights, float
    labels) in ``dtype`` and the others (integer tokens and labels) as they
    are: JAX ``_to_bf16`` on a batch."""
    return map_tensors(lambda t: t.to(dtype) if t.dtype == torch.float32 else t, batch)


def map_tensors(fn, batch: MultimodalBatch, skip=()) -> MultimodalBatch:
    """A batch with ``fn`` applied to each of its tensors, in a fixed order
    (the data's, the masks', the weights, the labels), those of the fields
    named in ``skip`` left as they are."""
    def apply(field, value):
        return value if field in skip or value is None else fn(value)

    return MultimodalBatch(
        data={k: map_leaves(lambda t: apply("data", t), v) for k, v in batch.data.items()},
        masks={k: apply("masks", v) for k, v in batch.masks.items()},
        weights=apply("weights", batch.weights),
        labels=apply("labels", batch.labels),
        incomplete=batch.incomplete)


def batch_from_arrays(data: dict, masks: Optional[dict] = None, labels=None,
                      weights=None, dtype=torch.float32,
                      incomplete: Optional[bool] = None) -> MultimodalBatch:
    """Build a MultimodalBatch from numpy arrays or tensors, filling
    defaults (all-ones masks and weights)."""
    if incomplete is None:
        incomplete = masks is not None
    data = {k: _tensor(v) for k, v in data.items()}
    n = first_leaf(next(iter(data.values()))).shape[0]
    if masks is None:
        masks = {k: torch.ones(n, dtype=dtype) for k in data}
    else:
        masks = {k: _tensor(masks[k], dtype).reshape(n) for k in data}
    weights = (torch.ones(n, dtype=dtype) if weights is None
               else _tensor(weights, dtype))
    if labels is not None:
        labels = _tensor(labels)
    return MultimodalBatch(data=data, masks=masks, weights=weights,
                           labels=labels, incomplete=bool(incomplete))


def as_batch(inputs) -> MultimodalBatch:
    """Coerce user inputs to a MultimodalBatch.

    Accepts a MultimodalBatch (pass-through), a dataset / DatasetOutput /
    dict exposing ``data`` (and optional ``masks`` / ``labels``), or a bare
    dict of modality arrays.
    """
    if isinstance(inputs, MultimodalBatch):
        return inputs
    if isinstance(inputs, dict) and "data" not in inputs:
        return batch_from_arrays(data=inputs)
    if isinstance(inputs, dict):
        return batch_from_arrays(data=inputs["data"],
                                 masks=inputs.get("masks"),
                                 labels=inputs.get("labels"))
    return batch_from_arrays(data=inputs.data,
                             masks=getattr(inputs, "masks", None),
                             labels=getattr(inputs, "labels", None))
