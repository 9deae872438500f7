"""Per-step scalars passed into model loss functions (counterpart of
``multivae_tpu/models/base/step.py``).

Each field is a Python number or a 0-d float32 tensor on the model's
device: the trainer's graphed chunks (``steps_per_execution``) hand the
latter, as the JAX package hands traced float32 scalars, so that one
captured CUDA graph serves every epoch and batch. A loss that anneals on
these fields computes in float32 tensor ops through ``f32``, which gives
the JAX package's values for either kind.
"""

from __future__ import annotations

import dataclasses
from typing import Union

import torch

Scalar = Union[float, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class StepInfo:
    epoch: Scalar = 1.0
    batch_ratio: Scalar = 0.0
    dataset_size: Scalar = 1.0


def f32(value: Scalar, device) -> torch.Tensor:
    """``value`` as a 0-d float32 tensor on ``device``: a tensor as it is, a
    number through a fill on the device (no host-to-device copy)."""
    if isinstance(value, torch.Tensor):
        return value
    return torch.full((), value, dtype=torch.float32, device=device)
