from .base_architectures import BaseDecoder, BaseEncoder
from .default_architectures import (
    BaseAEConfig,
    BaseDictDecoders,
    BaseDictEncoders,
    Decoder_AE_MLP,
    Encoder_VAE_MLP,
)
from .mmnist import DecoderConvMMNIST, EncoderConvMMNIST, EncoderConvMMNIST_adapted

__all__ = [
    "BaseAEConfig",
    "BaseDecoder",
    "BaseDictDecoders",
    "BaseDictEncoders",
    "BaseEncoder",
    "DecoderConvMMNIST",
    "Decoder_AE_MLP",
    "EncoderConvMMNIST",
    "EncoderConvMMNIST_adapted",
    "Encoder_VAE_MLP",
]
