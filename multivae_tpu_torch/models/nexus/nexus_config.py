"""Nexus config (counterpart of ``multivae_tpu/models/nexus/nexus_config.py``)."""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from ..base.base_config import BaseMultiVAEConfig


@dataclasses.dataclass
class NexusConfig(BaseMultiVAEConfig):
    """Config for Nexus ('Leveraging hierarchy in multimodal generative
    models for effective cross-modality inference', Vasco et al 2022).

    Args:
        modalities_specific_dim: bottom latent dim per modality.
        bottom_betas: per-modality bottom KL scales (default 1 each).
        dropout_rate: forced perceptual dropout rate during training.
        msg_dim: dimension of each modality's message.
        aggregator: only 'mean' is supported.
        top_beta: scales the top-level KL.
        gammas: per-modality top reconstruction scales (default 1 each).
        warmup: KL annealing epochs.
        adapt_top_decoder_variance: modalities whose top-decoder scale is
            set to the RMS reconstruction error.
    """

    modalities_specific_dim: Optional[Dict[str, int]] = None
    bottom_betas: Optional[Dict[str, float]] = None
    dropout_rate: float = 0.0
    msg_dim: int = 10
    aggregator: str = "mean"
    top_beta: float = 1.0
    gammas: Optional[Dict[str, float]] = None
    warmup: int = 20
    adapt_top_decoder_variance: Optional[List[str]] = None
