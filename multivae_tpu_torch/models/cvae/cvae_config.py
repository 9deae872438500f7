"""CVAE config (counterpart of ``multivae_tpu/models/cvae/cvae_config.py``)."""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from ...utils.config import BaseConfig

DECODER_DISTS = ("normal", "laplace", "bernoulli", "categorical")


@dataclasses.dataclass
class CVAEConfig(BaseConfig):
    """Config for the Conditional Variational Autoencoder.

    Args:
        conditioning_modalities: modalities to condition on.
        main_modality: the modality to reconstruct.
        input_dims: modality name -> input shape.
        latent_dim: latent space dimension.
        beta: KL weight in the ELBO.
        decoder_dist: decoder distribution name, one of ``DECODER_DISTS``.
        decoder_dist_params: extra params of the decoder distribution.
        custom_architectures: names of user-supplied nets, for save/load.
    """

    conditioning_modalities: List[str] = dataclasses.field(default_factory=list)
    main_modality: str = ""
    input_dims: Optional[Dict[str, Tuple[int, ...]]] = None
    latent_dim: int = 10
    beta: float = 1.0
    decoder_dist: str = "normal"
    decoder_dist_params: dict = dataclasses.field(default_factory=dict)
    custom_architectures: List[str] = dataclasses.field(default_factory=list)

    def __post_init__(self):
        if self.decoder_dist not in DECODER_DISTS:
            raise ValueError(f"decoder_dist must be one of {DECODER_DISTS}, "
                             f"got {self.decoder_dist!r}")
        if self.input_dims is not None:
            self.input_dims = {k: tuple(int(d) for d in v)
                               for k, v in self.input_dims.items()}
