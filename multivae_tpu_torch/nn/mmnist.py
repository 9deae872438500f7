"""PolyMNIST nets (counterpart of ``multivae_tpu/nn/mmnist.py``): the conv
encoders and decoder, the multi-latent conv encoder and the resnet encoder
and decoder, channels-first (NCHW) throughout.

Each net keeps its layers in the ModuleLists ``conv``, ``deconv``,
``dense`` and ``blocks``, in the order the Flax modules create ``Conv_i``,
``ConvTranspose_i``, ``Dense_i`` and ``ResnetBlock_i``, which is what
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

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils.model_output import ModelOutput
from .base_architectures import BaseDecoder, BaseEncoder, BaseMultilatentEncoder
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


class EncoderConvMMNIST_multilatents(BaseMultilatentEncoder):
    """Conv encoder with separate shared and style branches, each the conv
    trunk and two 4x4 conv heads; the style branch exists when
    ``args.style_dim > 0``."""

    def __init__(self, args: BaseAEConfig):
        super().__init__()
        self.input_dim = (3, 28, 28)
        self.latent_dim, self.style_dim = args.latent_dim, args.style_dim
        branches = [args.latent_dim] + ([args.style_dim] if args.style_dim > 0 else [])
        self.conv = nn.ModuleList(
            [layer for d in branches
             for layer in _conv_trunk() + [nn.Conv2d(128, d, 4, 2, 0),
                                           nn.Conv2d(128, d, 4, 2, 0)]])

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        reset_conv_(self.conv, generator)

    def forward(self, x):
        h = _run_trunk(self.conv[:3], x)
        out = ModelOutput(embedding=self.conv[3](h).flatten(1),
                          log_covariance=self.conv[4](h).flatten(1))
        if self.style_dim > 0:
            h = _run_trunk(self.conv[5:8], x)
            out["style_embedding"] = self.conv[8](h).flatten(1)
            out["style_log_covariance"] = self.conv[9](h).flatten(1)
        return out


class ResnetBlock(nn.Module):
    """Residual block: x_s + 0.1 * dx, dx two 3x3 convs with LeakyReLU(0.2),
    x_s a 1x1 bias-free conv when the channel counts differ, else x."""

    def __init__(self, c_in: int, c_out: int, c_hidden: Optional[int] = None):
        super().__init__()
        hidden = c_hidden or min(c_in, c_out)
        convs = [nn.Conv2d(c_in, hidden, 3, 1, 1), nn.Conv2d(hidden, c_out, 3, 1, 1)]
        if c_in != c_out:
            convs.append(nn.Conv2d(c_in, c_out, 1, 1, 0, bias=False))
        self.conv = nn.ModuleList(convs)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        reset_conv_(self.conv, generator)

    def forward(self, x):
        dx = F.leaky_relu(self.conv[0](x), 0.2)
        dx = F.leaky_relu(self.conv[1](dx), 0.2)
        x_s = self.conv[2](x) if len(self.conv) == 3 else x
        return x_s + 0.1 * dx


def upsample_nearest_2x(x):
    """2x nearest-neighbour upsampling of an NCHW map (row i reads i // 2)."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


def avg_pool_3_2_1(x):
    """AvgPool2d(3, stride=2, padding=1) with the padding counted (sum / 9)."""
    return F.avg_pool2d(x, 3, 2, 1, count_include_pad=True)


def _n_layers(s0: int) -> int:
    return int(np.log2(28 / s0))


class EncoderResnetMMNIST(BaseMultilatentEncoder):
    """Resnet encoder (3, 28, 28) -> shared and private heads. Each branch:
    a 3x3 conv to ``nf`` channels, ResnetBlock(nf, nf), then per layer an
    average pool and a ResnetBlock doubling the channels (up to
    ``nf_max``), down to (C, s0, s0); two Dense heads read the flattened
    map. The private branch exists when ``private_latent_dim > 0``."""

    def __init__(self, private_latent_dim: int, shared_latent_dim: int,
                 nf: int = 64, nf_max: int = 1024, s0: int = 7):
        super().__init__()
        self.input_dim = (3, 28, 28)
        self.latent_dim, self.style_dim = shared_latent_dim, private_latent_dim
        self.n_layers = nl = _n_layers(s0)
        widths = [min(nf * 2 ** i, nf_max) for i in range(nl + 1)]
        heads = [shared_latent_dim] + ([private_latent_dim] if private_latent_dim > 0 else [])
        self.conv = nn.ModuleList([nn.Conv2d(3, nf, 3, 1, 1) for _ in heads])
        self.blocks = nn.ModuleList(
            [block for _ in heads for block in
             [ResnetBlock(nf, nf)] + [ResnetBlock(widths[i], widths[i + 1])
                                      for i in range(nl)]])
        flat = widths[-1] * s0 * s0
        self.dense = nn.ModuleList([nn.Linear(flat, d) for d in heads for _ in range(2)])

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        reset_conv_(self.conv, generator)
        for block in self.blocks:
            block.reset_parameters(generator)
        reset_linear_(self.dense, generator)

    def _branch(self, x, k: int):
        n = self.n_layers + 1
        h = self.blocks[k * n](self.conv[k](x))
        for block in self.blocks[k * n + 1:(k + 1) * n]:
            h = block(avg_pool_3_2_1(h))
        # CHW flatten; params_from_jax permutes the heads from Flax's HWC order
        return h.flatten(1)

    def forward(self, x):
        x = x.reshape(-1, 3, 28, 28)
        h = self._branch(x, 0)
        out = ModelOutput(embedding=self.dense[0](h), log_covariance=self.dense[1](h))
        if self.style_dim > 0:
            h = self._branch(x, 1)
            out["style_embedding"] = self.dense[2](h)
            out["style_log_covariance"] = self.dense[3](h)
        return out


class DecoderResnetMMNIST(BaseDecoder):
    """Resnet decoder (*, latent_dim) -> (*, 3, 28, 28): Dense to (nf0, s0,
    s0), per layer a ResnetBlock halving the channels and a 2x upsampling,
    ResnetBlock(nf, nf), then a 3x3 conv to 3 channels with
    LeakyReLU(0.2)."""

    def __init__(self, latent_dim: int, nf: int = 64, nf_max: int = 512, s0: int = 7):
        super().__init__()
        self.input_dim = (3, 28, 28)
        self.latent_dim, self.s0 = latent_dim, s0
        nl = _n_layers(s0)
        self.nf0 = min(nf_max, nf * 2 ** nl)
        self.dense = nn.ModuleList([nn.Linear(latent_dim, self.nf0 * s0 * s0)])
        self.blocks = nn.ModuleList(
            [ResnetBlock(min(nf * 2 ** (nl - i), nf_max), min(nf * 2 ** (nl - i - 1), nf_max))
             for i in range(nl)] + [ResnetBlock(nf, nf)])
        self.conv = nn.ModuleList([nn.Conv2d(nf, 3, 3, 1, 1)])

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        reset_linear_(self.dense, generator)
        for block in self.blocks:
            block.reset_parameters(generator)
        reset_conv_(self.conv, generator)

    def forward(self, z):
        lead = z.shape[:-1]
        # (nf0, s0, s0) channels-first, as the Flax module reshapes it
        h = self.dense[0](z.reshape(-1, z.shape[-1])).reshape(-1, self.nf0, self.s0, self.s0)
        for block in self.blocks[:-1]:
            h = upsample_nearest_2x(block(h))
        h = F.leaky_relu(self.conv[0](self.blocks[-1](h)), 0.2)
        return ModelOutput(reconstruction=h.reshape(*lead, 3, 28, 28))
