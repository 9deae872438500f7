"""MVTCAE config (counterpart of ``multivae_tpu/models/mvtcae/mvtcae_config.py``)."""

from __future__ import annotations

import dataclasses

from ..base.base_config import BaseMultiVAEConfig


@dataclasses.dataclass
class MVTCAEConfig(BaseMultiVAEConfig):
    """Config for MVTCAE ('Multi-View Representation Learning via Total
    Correlation Objective', NeurIPS 2021).

    Args:
        alpha: ponderates the total-correlation ratio. Default 0.1.
        beta: weights the sum of all KLs. Default 2.5.
    """

    alpha: float = 0.1
    beta: float = 2.5
