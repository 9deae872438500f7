"""Network contracts (counterpart of ``multivae_tpu/nn/base_architectures.py``).

Thin ``nn.Module`` subclasses used as isinstance markers and to document
the output contract:

- encoder(x) -> ModelOutput(embedding, log_covariance)
- multilatent encoder -> + style_embedding, style_log_covariance
- joint encoder(dict x) -> ModelOutput(embedding, log_covariance)
- decoder(z) -> ModelOutput(reconstruction)
- conditional decoder(z, cond_mods) -> ModelOutput(reconstruction)
"""

from __future__ import annotations

from torch import nn


class BaseEncoder(nn.Module):
    """Unimodal encoder: x -> ModelOutput(embedding, log_covariance)."""


class BaseMultilatentEncoder(BaseEncoder):
    """Encoder with shared and private (style) latent heads."""


class BaseDecoder(nn.Module):
    """Unimodal decoder: z -> ModelOutput(reconstruction)."""


class BaseJointEncoder(nn.Module):
    """Joint encoder over a dict of modalities:
    dict x -> ModelOutput(embedding, log_covariance)."""


class BaseConditionalDecoder(nn.Module):
    """Decoder conditioned on other modalities' data:
    (z, cond_mods) -> ModelOutput(reconstruction)."""
