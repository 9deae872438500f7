"""TELBO config (counterpart of ``multivae_tpu/models/telbo/telbo_config.py``)."""

from __future__ import annotations

import dataclasses
from typing import Optional

from ..joint_models.joint_model_config import BaseJointModelConfig


@dataclasses.dataclass
class TELBOConfig(BaseJointModelConfig):
    """Config for TELBO ('Generative models of visually grounded
    imagination').

    Args:
        warmup: epochs of joint-ELBO training (stage 1); after them the
            joint encoder and the decoders are frozen and the unimodal
            ELBOs train (stage 2). Needs the MultistageTrainer.
        lambda_factors: per-modality reconstruction weights of stage 1
            (default: the likelihood rescale factors).
        gamma_factors: per-modality reconstruction weights of stage 2
            (default: the likelihood rescale factors).
    """

    warmup: int = 10
    lambda_factors: Optional[dict] = None
    gamma_factors: Optional[dict] = None
