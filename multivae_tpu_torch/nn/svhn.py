"""SVHN nets (counterpart of ``multivae_tpu/nn/svhn.py``), channels-first.

The encoder: three 4x4 stride-2 convs with padding 1 (32 -> 16 -> 8 -> 4,
widths fBase, 2 fBase, 4 fBase, ReLU), then two 4x4 stride-2 unpadded conv
heads to 1x1 (embedding, log_covariance). The decoder: a 4x4 stride-1
transposed conv from 1x1 to 4x4, then three 4x4 stride-2 ones (4 -> 8 ->
16 -> 32), ReLU between them and a sigmoid at the end.

The JAX package gives its transposed convs Flax paddings (lo, hi) of (3, 3)
and then (2, 2) (``multivae_tpu/nn/svhn.py:66-69``); a Flax ``ConvTranspose``
padded (p, p) is torch's ``ConvTranspose2d`` with ``padding = k - 1 - p``
and the kernel flipped (``utils/convert.py``): padding 0, then 1. Each net
keeps its layers in the ModuleList ``conv`` or ``deconv`` in Flax's
creation order.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..utils.model_output import ModelOutput
from .base_architectures import BaseDecoder, BaseEncoder
from .default_architectures import BaseAEConfig
from .mmnist import reset_conv_


class Encoder_VAE_SVHN(BaseEncoder):
    """Conv encoder (C, 32, 32) -> (embedding, log_covariance) of
    ``latent_dim``."""

    def __init__(self, args: BaseAEConfig, fBase: int = 32):
        super().__init__()
        self.input_dim = args.input_dim
        self.latent_dim = D = args.latent_dim
        C, f = args.input_dim[0], fBase
        self.conv = nn.ModuleList([nn.Conv2d(C, f, 4, 2, 1), nn.Conv2d(f, 2 * f, 4, 2, 1),
                                   nn.Conv2d(2 * f, 4 * f, 4, 2, 1),
                                   nn.Conv2d(4 * f, D, 4, 2, 0), nn.Conv2d(4 * f, D, 4, 2, 0)])

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        reset_conv_(self.conv, generator)

    def forward(self, x):
        h = x.reshape(-1, *self.input_dim)
        for layer in self.conv[:3]:
            h = torch.relu(layer(h))
        return ModelOutput(embedding=self.conv[3](h).flatten(1),
                           log_covariance=self.conv[4](h).flatten(1))


class Decoder_VAE_SVHN(BaseDecoder):
    """Conv decoder (*, latent_dim) -> (*, C, 32, 32) in [0, 1]."""

    def __init__(self, args: BaseAEConfig, fBase: int = 32):
        super().__init__()
        self.input_dim = args.input_dim
        self.latent_dim = D = args.latent_dim
        C, f = args.input_dim[0], fBase
        self.deconv = nn.ModuleList([nn.ConvTranspose2d(D, 4 * f, 4, 1, 0),
                                     nn.ConvTranspose2d(4 * f, 2 * f, 4, 2, 1),
                                     nn.ConvTranspose2d(2 * f, f, 4, 2, 1),
                                     nn.ConvTranspose2d(f, C, 4, 2, 1)])

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        reset_conv_(self.deconv, generator)

    def forward(self, z):
        lead = z.shape[:-1]
        h = z.reshape(-1, z.shape[-1], 1, 1)
        for layer in self.deconv[:-1]:
            h = torch.relu(layer(h))
        h = torch.sigmoid(self.deconv[-1](h))
        return ModelOutput(reconstruction=h.reshape(*lead, *self.input_dim))
