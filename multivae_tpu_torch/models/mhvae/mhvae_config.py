"""MHVAE config (counterpart of ``multivae_tpu/models/mhvae/mhvae_config.py``)."""

from __future__ import annotations

import dataclasses

from ..base.base_config import BaseMultiVAEConfig


@dataclasses.dataclass
class MHVAEConfig(BaseMultiVAEConfig):
    """Config for MHVAE ('Unified Brain MR-Ultrasound Synthesis using
    Multi-Modal Hierarchical Representations').

    Args:
        n_latent: number of latent levels in the hierarchy.
        beta: KL weight.
    """

    n_latent: int = 3
    beta: float = 1.0
