"""JNF config (counterpart of ``multivae_tpu/models/jnf/jnf_config.py``)."""

from __future__ import annotations

import dataclasses

from ..joint_models.joint_model_config import BaseJointModelConfig


@dataclasses.dataclass
class JNFConfig(BaseJointModelConfig):
    """Config for JNF ('Improving Multimodal Joint Variational Autoencoders
    through Normalizing Flows and Correlation Analysis').

    Args:
        warmup: epochs of joint-VAE training (stage 1); after them the
            joint VAE is frozen and per-modality flows are trained to match
            the unimodal posteriors to the joint one. Needs the
            MultistageTrainer (``reset_optimizer_epochs = [warmup + 1]``).
        beta: weighs the joint-VAE KL regularization.
    """

    warmup: int = 10
    beta: float = 1.0
