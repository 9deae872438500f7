"""Evaluator base config (counterpart of
``multivae_tpu/metrics/base/evaluator_config.py``).

The JAX package's TPU fields (``n_devices``, ``cache_on_device``,
``device_cache_budget_gb``) are not part of the port: it evaluates on one
device, reading the test set from the host.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from ...utils.config import BaseConfig


@dataclasses.dataclass
class EvaluatorConfig(BaseConfig):
    """Base config for evaluation modules.

    Args:
        batch_size: evaluation batch size.
        wandb_path: 'entity/project/run_id' to resume logging into an
            existing wandb run (requires the optional wandb package).
    """

    batch_size: int = 512
    wandb_path: Optional[str] = None
