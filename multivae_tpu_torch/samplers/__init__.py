"""Post-hoc latent samplers (counterpart of ``multivae_tpu/samplers``): fit
a density to a trained model's latents, then draw latents in
``model.encode``'s output format."""

from .base import BaseSampler, BaseSamplerConfig
from .gaussian_mixture import GaussianMixtureSampler, GaussianMixtureSamplerConfig
from .iaf_sampler import IAFSampler, IAFSamplerConfig
from .maf_sampler import MAFSampler, MAFSamplerConfig

__all__ = [
    "BaseSampler",
    "BaseSamplerConfig",
    "GaussianMixtureSampler",
    "GaussianMixtureSamplerConfig",
    "IAFSampler",
    "IAFSamplerConfig",
    "MAFSampler",
    "MAFSamplerConfig",
]
