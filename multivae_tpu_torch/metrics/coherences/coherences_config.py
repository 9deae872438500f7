"""Coherence evaluator config (counterpart of
``multivae_tpu/metrics/coherences/coherences_config.py``, without its
TPU-only ``fused_sweep``)."""

from __future__ import annotations

import dataclasses
from typing import Optional

from ..base.evaluator_config import EvaluatorConfig


@dataclasses.dataclass
class CoherenceEvaluatorConfig(EvaluatorConfig):
    """Config for coherence evaluation.

    Args:
        num_classes: number of label classes.
        include_recon: include self-reconstructions in cross-coherences.
        nb_samples_for_joint: samples for the joint coherence.
        nb_samples_for_cross: posterior samples per datapoint for cross.
        give_details_per_class: log per-class accuracies.
    """

    num_classes: Optional[int] = 10
    include_recon: bool = False
    nb_samples_for_joint: int = 10000
    nb_samples_for_cross: int = 1
    give_details_per_class: bool = False
