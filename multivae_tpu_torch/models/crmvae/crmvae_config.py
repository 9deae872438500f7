"""CRMVAE config (counterpart of ``multivae_tpu/models/crmvae/crmvae_config.py``)."""

from __future__ import annotations

import dataclasses

from ..base.base_config import BaseMultiVAEConfig


@dataclasses.dataclass
class CRMVAEConfig(BaseMultiVAEConfig):
    """Config for CRMVAE (a coordination-regularized multimodal VAE,
    https://openreview.net/forum?id=Rn8u4MYgeNJ).

    Args:
        beta: weight of the sum of all KL terms. Default 2.5.
    """

    beta: float = 2.5
