"""Per-step scalars passed into model loss functions (counterpart of
``multivae_tpu/models/base/step.py``; plain floats, since eager PyTorch
does not retrace)."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class StepInfo:
    epoch: float = 1.0
    batch_ratio: float = 0.0
    dataset_size: float = 1.0
