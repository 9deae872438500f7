"""DMVAE config (counterpart of ``multivae_tpu/models/dmvae/dmvae_config.py``)."""

from __future__ import annotations

import dataclasses
from typing import Optional

from ..base.base_config import BaseMultiVAEConfig


@dataclasses.dataclass
class DMVAEConfig(BaseMultiVAEConfig):
    """Config for DMVAE ('Private-Shared Disentangled Multimodal VAE for
    Learning of Latent Representations').

    Args:
        modalities_specific_dim: private latent dims per modality (default 1
            each; the default nets need it).
        modalities_specific_betas: weights of the private KL terms (default
            1 each).
        beta: weight of the shared KL term.
    """

    modalities_specific_dim: Optional[dict] = None
    modalities_specific_betas: Optional[dict] = None
    beta: float = 1.0
