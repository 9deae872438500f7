"""IAF sampler config (counterpart of
``multivae_tpu/samplers/iaf_sampler/iaf_sampler_config.py``)."""

from __future__ import annotations

import dataclasses

from ..maf_sampler.maf_sampler_config import MAFSamplerConfig


@dataclasses.dataclass
class IAFSamplerConfig(MAFSamplerConfig):
    """IAF sampler configuration (the MAF sampler's knobs)."""
