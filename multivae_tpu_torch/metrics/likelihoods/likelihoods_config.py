"""Likelihoods evaluator config (counterpart of
``multivae_tpu/metrics/likelihoods/likelihoods_config.py``)."""

from __future__ import annotations

import dataclasses

from ..base.evaluator_config import EvaluatorConfig


@dataclasses.dataclass
class LikelihoodsEvaluatorConfig(EvaluatorConfig):
    """Config for the joint-likelihood evaluation.

    Args:
        num_samples: number of importance samples (K).
        batch_size_k: K-chunk size.
        unified_implementation: use the unified NLL implementation instead
            of per-paper variants where they differ.
    """

    num_samples: int = 1000
    batch_size_k: int = 100
    unified_implementation: bool = True
