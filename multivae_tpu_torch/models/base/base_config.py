"""Base model config (counterpart of
``multivae_tpu/models/base/base_config.py``; same field names)."""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from ...utils.config import BaseConfig, EnvironmentConfig  # noqa: F401


@dataclasses.dataclass
class BaseMultiVAEConfig(BaseConfig):
    """Base config for multimodal VAE models.

    Args:
        n_modalities: number of modalities.
        latent_dim: dimension of the (shared) latent space.
        input_dims: modality name -> input shape tuple.
        uses_likelihood_rescaling: rescale reconstruction log-probs per
            modality to mitigate modality collapse.
        rescale_factors: explicit per-modality rescale factors.
        decoders_dist: per-modality decoder distribution name in
            {'normal','bernoulli','laplace'}.
        decoder_dist_params: per-modality dist params (e.g. {'scale': 0.75}).
        custom_architectures: names of user-supplied network groups, tracked
            for save/load.
        use_remat: recompute the encoders' and decoders' activations in
            the backward instead of keeping them (``torch.utils.checkpoint``;
            same numbers, less memory).
    """

    n_modalities: int = 1
    latent_dim: int = 10
    input_dims: Optional[Dict[str, Tuple[int, ...]]] = None
    uses_likelihood_rescaling: bool = False
    rescale_factors: Optional[Dict[str, float]] = None
    decoders_dist: Optional[Dict[str, str]] = None
    decoder_dist_params: Optional[dict] = None
    custom_architectures: List[str] = dataclasses.field(default_factory=list)
    use_remat: bool = False

    def __post_init__(self):
        if self.input_dims is not None:
            self.input_dims = {k: tuple(int(d) for d in v)
                               for k, v in self.input_dims.items()}
