from .iaf_sampler import IAFSampler
from .iaf_sampler_config import IAFSamplerConfig

__all__ = ["IAFSampler", "IAFSamplerConfig"]
