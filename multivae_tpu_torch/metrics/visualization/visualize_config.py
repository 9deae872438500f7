"""Visualization config (counterpart of
``multivae_tpu/metrics/visualization/visualize_config.py``)."""

from __future__ import annotations

import dataclasses

from ..base.evaluator_config import EvaluatorConfig


@dataclasses.dataclass
class VisualizationConfig(EvaluatorConfig):
    """Config for the visualization module.

    Args:
        n_samples: number of generated samples per grid row.
        n_data_cond: number of datapoints for conditional generation.
    """

    n_samples: int = 8
    n_data_cond: int = 8
