"""PolyMNIST conv nets (counterpart of the conv encoders and decoder of
``multivae_tpu/nn/mmnist.py``), channels-first (NCHW) throughout.

Each net keeps its layers in the ModuleLists ``conv``, ``deconv`` and
``dense``, in the order the Flax modules create ``Conv_i``,
``ConvTranspose_i`` and ``Dense_i``, which is what
``utils/convert.params_from_jax`` relies on. ``reset_parameters`` draws
PyTorch's default Conv/Linear init, U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for
weight and bias, from an explicit generator (fan_in of a transposed conv
is out_channels * k * k, as torch computes it).

The decoder computes the JAX package's function, which is not torch's
``ConvTranspose2d(padding=1, output_padding=1)``: Flax pads the dilated
input by (2, 1) on the two upsampling layers, so they run
``padding=0`` and drop the last row and column (see ``DecoderConvMMNIST``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..utils.model_output import ModelOutput
from .base_architectures import BaseDecoder, BaseEncoder
from .default_architectures import BaseAEConfig, reset_linear_


def reset_conv_(layers, generator: Optional[torch.Generator] = None):
    """PyTorch's default Conv2d / ConvTranspose2d init, drawn from
    ``generator``."""
    for layer in layers:
        fan_in = layer.weight.shape[1] * math.prod(layer.weight.shape[2:])
        bound = 1.0 / math.sqrt(fan_in)
        with torch.no_grad():
            nn.init.uniform_(layer.weight, -bound, bound, generator=generator)
            if layer.bias is not None:
                nn.init.uniform_(layer.bias, -bound, bound, generator=generator)


def _conv_trunk():
    """(3, 28, 28) -> (128, 4, 4): three 3x3 stride-2 convs."""
    return [nn.Conv2d(3, 32, 3, 2, 1), nn.Conv2d(32, 64, 3, 2, 1),
            nn.Conv2d(64, 128, 3, 2, 1)]


def _run_trunk(convs, x):
    h = x.reshape(-1, 3, 28, 28)
    for layer in convs:
        h = torch.relu(layer(h))
    return h


class EncoderConvMMNIST(BaseEncoder):
    """Conv encoder (3, 28, 28) -> Dense(D) ReLU -> (embedding,
    log_covariance) Dense heads, without bias unless ``bias``."""

    def __init__(self, args: BaseAEConfig, bias: bool = False):
        super().__init__()
        self.input_dim = (3, 28, 28)
        self.latent_dim = D = args.latent_dim
        self.conv = nn.ModuleList(_conv_trunk())
        self.dense = nn.ModuleList([nn.Linear(128 * 4 * 4, D),
                                    nn.Linear(D, D, bias=bias),
                                    nn.Linear(D, D, bias=bias)])

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        reset_conv_(self.conv, generator)
        reset_linear_(self.dense, generator)

    def forward(self, x):
        # CHW flatten; params_from_jax permutes Dense_0 from Flax's HWC order
        h = _run_trunk(self.conv, x).flatten(1)
        h = torch.relu(self.dense[0](h))
        return ModelOutput(embedding=self.dense[1](h),
                           log_covariance=self.dense[2](h))


class EncoderConvMMNIST_adapted(BaseEncoder):
    """Conv encoder with 4x4 conv latent heads: (3, 28, 28) -> (D,) twice."""

    def __init__(self, args: BaseAEConfig):
        super().__init__()
        self.input_dim = (3, 28, 28)
        self.latent_dim = D = args.latent_dim
        self.conv = nn.ModuleList(_conv_trunk() + [nn.Conv2d(128, D, 4, 2, 0),
                                                   nn.Conv2d(128, D, 4, 2, 0)])

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        reset_conv_(self.conv, generator)

    def forward(self, x):
        h = _run_trunk(self.conv[:3], x)
        return ModelOutput(embedding=self.conv[3](h).flatten(1),
                           log_covariance=self.conv[4](h).flatten(1))


class DecoderConvMMNIST(BaseDecoder):
    """Conv decoder (*, D) -> (*, 3, 28, 28): Dense(2048) ReLU, reshape to
    (128, 4, 4), three 3x3 stride-2 transposed convs (4 -> 7 -> 14 -> 28),
    ReLU between them.

    Flax's ``ConvTranspose`` with padding (lo, hi) is torch's
    ``conv_transpose2d`` with the kernel flipped in both spatial axes and
    ``padding = k - 1 - lo``, then the last ``lo - hi`` rows and columns
    dropped: (1, 1) is ``padding=1``; (2, 1) is ``padding=0`` with the last
    row and column dropped. ``params_from_jax`` does the flip.
    """

    def __init__(self, args: BaseAEConfig):
        super().__init__()
        self.input_dim = (3, 28, 28)
        self.latent_dim = args.latent_dim
        self.dense = nn.ModuleList([nn.Linear(args.latent_dim, 2048)])
        self.deconv = nn.ModuleList([nn.ConvTranspose2d(128, 64, 3, 2, 1),
                                     nn.ConvTranspose2d(64, 32, 3, 2, 0),
                                     nn.ConvTranspose2d(32, 3, 3, 2, 0)])

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        reset_linear_(self.dense, generator)
        reset_conv_(self.deconv, generator)

    def forward(self, z):
        lead = z.shape[:-1]
        h = torch.relu(self.dense[0](z.reshape(-1, z.shape[-1])))
        h = torch.relu(self.deconv[0](h.reshape(-1, 128, 4, 4)))    # 7x7
        h = torch.relu(self.deconv[1](h)[..., :-1, :-1])            # 14x14
        h = self.deconv[2](h)[..., :-1, :-1]                        # 28x28
        return ModelOutput(reconstruction=h.reshape(*lead, 3, 28, 28))
