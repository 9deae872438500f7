"""IAF sampler (counterpart of
``multivae_tpu/samplers/iaf_sampler/iaf_sampler.py``): the MAF sampler
with an IAF flow (fast sampling; the fit's density pass is sequential in
the latent dimension)."""

from __future__ import annotations

from ...ops.flows import IAF
from ..maf_sampler.maf_sampler import MAFSampler
from .iaf_sampler_config import IAFSamplerConfig


class IAFSampler(MAFSampler):
    """Fits one IAF per latent space."""

    flow_class = IAF
    name = "IAFSampler"

    def __init__(self, model, sampler_config=None):
        if sampler_config is None:
            sampler_config = IAFSamplerConfig()
        super().__init__(model, sampler_config)
