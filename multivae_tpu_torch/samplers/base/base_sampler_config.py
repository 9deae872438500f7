"""Base sampler config (counterpart of
``multivae_tpu/samplers/base/base_sampler_config.py``)."""

from __future__ import annotations

import dataclasses

from ...utils.config import BaseConfig


@dataclasses.dataclass
class BaseSamplerConfig(BaseConfig):
    """Base configuration of a latent-space sampler."""
