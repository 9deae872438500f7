"""Base config of the joint-encoder models (counterpart of
``multivae_tpu/models/joint_models/joint_model_config.py``)."""

from __future__ import annotations

import dataclasses

from ..base.base_config import BaseMultiVAEConfig


@dataclasses.dataclass
class BaseJointModelConfig(BaseMultiVAEConfig):
    """Base config for models that use a joint encoder over all modalities."""
