"""Evaluator base config (counterpart of
``multivae_tpu/metrics/base/evaluator_config.py``).

The JAX package's ``n_devices`` is not part of the port: it evaluates on
one device.
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
        cache_on_device: keep the test set on the model's device and gather
            each batch there (``data/device_cache.py``): the sweeps read the
            test set many times. The batches are bit-identical to the host
            loader's. A set over ``device_cache_budget_gb``, or one that
            cannot be indexed in bulk, is read from the host through a
            prefetching thread instead, with a warning. On by default, as
            in the JAX package.
        device_cache_budget_gb: device memory the test-set cache may take.
    """

    batch_size: int = 512
    wandb_path: Optional[str] = None
    cache_on_device: bool = True
    device_cache_budget_gb: float = 8.0
