"""MAF sampler config (counterpart of
``multivae_tpu/samplers/maf_sampler/maf_sampler_config.py``)."""

from __future__ import annotations

import dataclasses

from ..base.base_sampler_config import BaseSamplerConfig


@dataclasses.dataclass
class MAFSamplerConfig(BaseSamplerConfig):
    """MAF sampler configuration.

    Args:
        n_made_blocks: number of MADE blocks in the flow.
        n_hidden_in_made: hidden layers per MADE.
        hidden_size: units per hidden layer.
        include_batch_norm: unused (kept for config parity).
    """

    n_made_blocks: int = 2
    n_hidden_in_made: int = 3
    hidden_size: int = 128
    include_batch_norm: bool = False
