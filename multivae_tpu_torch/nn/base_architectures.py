"""Network contracts (counterpart of ``multivae_tpu/nn/base_architectures.py``).

Thin ``nn.Module`` subclasses used as isinstance markers and to document
the output contract:

- encoder(x) -> ModelOutput(embedding, log_covariance)
- multilatent encoder -> + style_embedding, style_log_covariance
- decoder(z) -> ModelOutput(reconstruction)
"""

from __future__ import annotations

from torch import nn


class BaseEncoder(nn.Module):
    """Unimodal encoder: x -> ModelOutput(embedding, log_covariance)."""


class BaseMultilatentEncoder(BaseEncoder):
    """Encoder with shared and private (style) latent heads."""


class BaseDecoder(nn.Module):
    """Unimodal decoder: z -> ModelOutput(reconstruction)."""
