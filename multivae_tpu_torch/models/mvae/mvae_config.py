"""MVAE config (counterpart of ``multivae_tpu/models/mvae/mvae_config.py``)."""

from __future__ import annotations

import dataclasses

from ..base.base_config import BaseMultiVAEConfig


@dataclasses.dataclass
class MVAEConfig(BaseMultiVAEConfig):
    """Config for MVAE ('Multimodal Generative Models for Scalable
    Weakly-Supervised Learning', NeurIPS 2018).

    Args:
        use_subsampling: besides the joint ELBO, train the unimodal ELBOs
            and ``k`` random subset ELBOs. Set False on incomplete datasets.
        k: number of random subset ELBOs a training step.
        warmup: epochs over which the KL weight grows linearly to ``beta``.
        beta: weight of the divergence term.
    """

    use_subsampling: bool = True
    k: int = 0
    warmup: int = 10
    beta: float = 1.0
