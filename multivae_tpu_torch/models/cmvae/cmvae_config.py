"""CMVAE config (counterpart of ``multivae_tpu/models/cmvae/cmvae_config.py``)."""

from __future__ import annotations

import dataclasses

from ..mmvaePlus.mmvaePlus_config import MMVAEPlusConfig


@dataclasses.dataclass
class CMVAEConfig(MMVAEPlusConfig):
    """Config for CMVAE ('Deep Generative Clustering with Multimodal
    Diffusion Variational Autoencoders', Palumbo et al. 2023, without the
    diffusion decoders): MMVAE+'s fields (``learn_shared_prior`` is unused)
    and

    Args:
        number_of_clusters: mixture components of the clustering prior on
            the shared latent space.
    """

    number_of_clusters: int = 10
