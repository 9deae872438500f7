"""Reconstruction evaluator config (counterpart of
``multivae_tpu/metrics/reconstruction/reconstruction_config.py``, without
its TPU-only ``fused_sweep``)."""

from __future__ import annotations

import dataclasses

from ..base.evaluator_config import EvaluatorConfig

METRICS = ("SSIM", "MSE")


@dataclasses.dataclass
class ReconstructionConfig(EvaluatorConfig):
    """Config for reconstruction metrics.

    Args:
        metric: 'SSIM' (images only) or 'MSE'.
    """

    metric: str = "SSIM"

    def __post_init__(self):
        if self.metric not in METRICS:
            raise ValueError(f"metric must be one of {METRICS}, got {self.metric!r}")
