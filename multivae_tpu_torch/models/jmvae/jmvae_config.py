"""JMVAE config (counterpart of ``multivae_tpu/models/jmvae/jmvae_config.py``)."""

from __future__ import annotations

import dataclasses

from ..joint_models.joint_model_config import BaseJointModelConfig


@dataclasses.dataclass
class JMVAEConfig(BaseJointModelConfig):
    """Config for JMVAE ('Joint Multimodal Learning with Deep Generative
    Models').

    Args:
        alpha: weight of the KL(joint || unimodal) terms.
        warmup: epochs over which the regularization grows linearly to 1.
        beta: weight of the prior KL.
    """

    alpha: float = 0.1
    warmup: int = 10
    beta: float = 1.0
