from .gaussian_mixture_config import GaussianMixtureSamplerConfig
from .gaussian_mixture_sampler import GaussianMixtureSampler

__all__ = ["GaussianMixtureSampler", "GaussianMixtureSamplerConfig"]
