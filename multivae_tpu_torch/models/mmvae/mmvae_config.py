"""MMVAE config (counterpart of ``multivae_tpu/models/mmvae/mmvae_config.py``)."""

from __future__ import annotations

import dataclasses

from ..base.base_config import BaseMultiVAEConfig

_DISTS = ("laplace_with_softmax", "normal")
_LOSSES = ("dreg_looser", "iwae_looser")


@dataclasses.dataclass
class MMVAEConfig(BaseMultiVAEConfig):
    """Config for MMVAE ('Variational Mixture-of-Experts Autoencoders for
    Multi-Modal Deep Generative Models', NeurIPS 2019).

    Args:
        K: number of importance samples in the objective.
        prior_and_posterior_dist: 'laplace_with_softmax' or 'normal'.
        learn_prior: make the prior log-variance learnable.
        loss: 'dreg_looser' or 'iwae_looser'.
    """

    K: int = 10
    prior_and_posterior_dist: str = "laplace_with_softmax"
    learn_prior: bool = True
    loss: str = "dreg_looser"

    def __post_init__(self):
        super().__post_init__()
        if self.prior_and_posterior_dist not in _DISTS:
            raise ValueError(
                f"prior_and_posterior_dist must be one of {_DISTS}, got "
                f"{self.prior_and_posterior_dist!r}")
        if self.loss not in _LOSSES:
            raise ValueError(f"loss must be one of {_LOSSES}, got {self.loss!r}")
