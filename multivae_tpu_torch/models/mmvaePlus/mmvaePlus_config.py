"""MMVAE+ config (counterpart of
``multivae_tpu/models/mmvaePlus/mmvaePlus_config.py``)."""

from __future__ import annotations

import dataclasses
from typing import Optional

from ..base.base_config import BaseMultiVAEConfig

_DISTS = ("laplace_with_softmax", "normal", "normal_with_softplus")
_OPTIONS = ("single_prior", "joint_prior")
_LOSSES = ("dreg_looser", "iwae_looser")


@dataclasses.dataclass
class MMVAEPlusConfig(BaseMultiVAEConfig):
    """Config for MMVAE+ ('MMVAE+: Enhancing the Generative Quality of
    Multimodal VAEs without Compromises', ICLR 2023).

    Args:
        K: number of importance samples in the objective.
        prior_and_posterior_dist: 'laplace_with_softmax', 'normal' or
            'normal_with_softplus'.
        learn_shared_prior: learn the shared prior log-variance.
        learn_modality_prior: learn the modality priors' log-variance.
        beta: weights the divergence term (used with K = 1).
        modalities_specific_dim: dimension of the private latent spaces (an
            int, shared across modalities); required.
        reconstruction_option: 'single_prior' or 'joint_prior': the prior of
            the private code of a modality outside the conditioning subset.
        loss: 'dreg_looser' or 'iwae_looser'.
    """

    K: int = 10
    prior_and_posterior_dist: str = "laplace_with_softmax"
    learn_shared_prior: bool = False
    learn_modality_prior: bool = True
    beta: float = 1.0
    modalities_specific_dim: Optional[int] = None
    reconstruction_option: str = "joint_prior"
    loss: str = "dreg_looser"

    def __post_init__(self):
        super().__post_init__()
        for field, value, allowed in (
                ("prior_and_posterior_dist", self.prior_and_posterior_dist, _DISTS),
                ("reconstruction_option", self.reconstruction_option, _OPTIONS),
                ("loss", self.loss, _LOSSES)):
            if value not in allowed:
                raise ValueError(f"{field} must be one of {allowed}, got {value!r}")
