"""Clustering evaluator config (counterpart of
``multivae_tpu/metrics/latent_clustering/clustering_config.py``)."""

from __future__ import annotations

import dataclasses
from typing import Optional

from ..base.evaluator_config import EvaluatorConfig


@dataclasses.dataclass
class ClusteringConfig(EvaluatorConfig):
    """Config for latent-space clustering.

    Args:
        clustering_method: only 'kmeans'.
        n_clusters: number of clusters.
        number_of_runs: clustering runs to average the accuracy over.
        num_samples_for_fit: training samples for the fit (None = all).
        use_mean: use the posterior mean instead of a sample.
    """

    clustering_method: str = "kmeans"
    n_clusters: int = 10
    number_of_runs: int = 20
    num_samples_for_fit: Optional[int] = None
    use_mean: bool = True

    def __post_init__(self):
        if self.clustering_method != "kmeans":
            raise ValueError("clustering_method must be 'kmeans', got "
                             f"{self.clustering_method!r}")
