from .base_architectures import BaseDecoder, BaseEncoder
from .default_architectures import (
    BaseAEConfig,
    BaseDictDecoders,
    BaseDictEncoders,
    Decoder_AE_MLP,
    Encoder_VAE_MLP,
)

__all__ = [
    "BaseAEConfig",
    "BaseDecoder",
    "BaseDictDecoders",
    "BaseDictEncoders",
    "BaseEncoder",
    "Decoder_AE_MLP",
    "Encoder_VAE_MLP",
]
