"""Evaluator base config (counterpart of
``multivae_tpu/metrics/base/evaluator_config.py``)."""

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
        n_devices: evaluate over this many data-parallel processes, one card
            each (the JAX field's meaning, as the trainer's ``n_devices``
            counts them: ``parallel/mesh.get_data_mesh``). Each process
            takes its columns of every test batch, the global batch's draws
            keeping its rows, and the sums and embeddings are gathered over
            the process group, so every process returns what one process
            returns; ``batch_size`` is rounded up to a multiple of
            ``n_devices`` (the padding rows carry zero weight). A value the
            group does not match raises, as does ``n_devices > 1`` without
            a group. 1 (default): one process, or a process group of one;
            in a larger group each process evaluates alone.
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
    n_devices: int = 1
    cache_on_device: bool = True
    device_cache_budget_gb: float = 8.0

    def __post_init__(self):
        if self.n_devices < 1:
            raise AttributeError(f"n_devices must be a positive integer, got {self.n_devices}.")
