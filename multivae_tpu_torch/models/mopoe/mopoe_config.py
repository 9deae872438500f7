"""MoPoE config (counterpart of ``multivae_tpu/models/mopoe/mopoe_config.py``)."""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Union

from ..base.base_config import BaseMultiVAEConfig


@dataclasses.dataclass
class MoPoEConfig(BaseMultiVAEConfig):
    """Config for MoPoE ('Generalized Multimodal ELBO', ICLR 2021).

    Args:
        subsets: the modality subsets of the mixture (a list, or a dict of
            lists); None takes every non-empty subset (2^M - 1).
        beta: weight of the KL terms.
        beta_style: weight of the private KLs (with private latent spaces).
        modalities_specific_dim: modality -> private latent dim; given, the
            model has a private latent space per modality.
    """

    subsets: Union[List[list], Dict[str, list], None] = None
    beta: float = 1.0
    beta_style: float = 1.0
    modalities_specific_dim: Optional[Dict[str, int]] = None
