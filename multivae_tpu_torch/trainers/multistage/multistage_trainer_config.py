"""Multistage trainer config (counterpart of
``multivae_tpu/trainers/multistage/multistage_trainer_config.py``)."""

from __future__ import annotations

import dataclasses

from ..base.base_trainer_config import BaseTrainerConfig


@dataclasses.dataclass
class MultistageTrainerConfig(BaseTrainerConfig):
    """Training config for multistage models (TELBO)."""
