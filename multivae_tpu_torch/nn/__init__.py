from .base_architectures import BaseDecoder, BaseEncoder, BaseMultilatentEncoder
from .default_architectures import (
    BaseAEConfig,
    BaseDictDecoders,
    BaseDictDecodersMultiLatents,
    BaseDictEncoders,
    BaseDictEncoders_MultiLatents,
    Decoder_AE_MLP,
    Encoder_VAE_MLP,
    Encoder_VAE_MLP_Style,
)
from .mmnist import (
    DecoderConvMMNIST,
    DecoderResnetMMNIST,
    EncoderConvMMNIST,
    EncoderConvMMNIST_adapted,
    EncoderConvMMNIST_multilatents,
    EncoderResnetMMNIST,
    ResnetBlock,
)

__all__ = [
    "BaseAEConfig",
    "BaseDecoder",
    "BaseDictDecoders",
    "BaseDictDecodersMultiLatents",
    "BaseDictEncoders",
    "BaseDictEncoders_MultiLatents",
    "BaseEncoder",
    "BaseMultilatentEncoder",
    "DecoderConvMMNIST",
    "DecoderResnetMMNIST",
    "Decoder_AE_MLP",
    "EncoderConvMMNIST",
    "EncoderConvMMNIST_adapted",
    "EncoderConvMMNIST_multilatents",
    "EncoderResnetMMNIST",
    "Encoder_VAE_MLP",
    "Encoder_VAE_MLP_Style",
    "ResnetBlock",
]
