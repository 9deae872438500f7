"""The nets of the MHVAE PolyMNIST example (``examples/mhvae_polymnist.py:34-100``),
channels-first, with their widths as arguments.

A 3-level MHVAE over 3x28x28 images: z_1 is a (c1, 14, 14) map, z_2 a
(c2, 7, 7) map, z_3 a vector of ``latent``; the example's widths are c1 32,
c2 64, c3 128, hidden 512, latent 64. ``build_blocks`` returns the six
block groups in ``MHVAE``'s argument order.

Flax's ``Conv`` pads 'SAME' asymmetrically when the stride does not divide
the padding evenly: a 3x3 stride-2 conv on 28 or 14 rows pads (0, 1), on 7
rows (1, 1). ``conv_same`` pads the same way before an unpadded conv. Flax's
3x3 stride-2 ``ConvTranspose`` 'SAME' pads the dilated input (2, 1): an
unpadded ``ConvTranspose2d`` with its last row and column dropped (the
kernel flip is ``utils/convert.py``'s). The example flattens the (4, 4, c3)
map of ``BottomUpLast`` and unflattens the Dense output of ``TopDown2`` in
NHWC order; these nets do the same through a permute, so their Dense
weights are Flax's as they are.

Each net keeps its layers in the ModuleLists ``conv``, ``deconv`` and
``dense`` in the Flax modules' creation order, and ``reset_parameters``
draws PyTorch's default init from a generator (see ``nn/mmnist.py``);
``reset_blocks`` draws all of them.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.default_architectures import reset_linear_
from ..nn.mmnist import reset_conv_
from ..utils.model_output import ModelOutput


def conv_same(layer: nn.Conv2d, x):
    """``layer`` (built with padding 0) on ``x`` padded as Flax's 'SAME':
    per spatial axis of n, max((ceil(n / s) - 1) * s + k - n, 0) in all,
    the odd one after."""
    k, s = layer.kernel_size[0], layer.stride[0]
    pads = []
    for n in (x.shape[-1], x.shape[-2]):     # F.pad: the last axis first
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads += [total // 2, total - total // 2]
    return layer(F.pad(x, pads))


def deconv_same(layer: nn.ConvTranspose2d, x):
    """Flax's 3x3 stride-2 'SAME' transposed conv: 2n rows from n."""
    return layer(x)[..., :-1, :-1]


class _Net(nn.Module):
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        for name in ("conv", "deconv"):
            if hasattr(self, name):
                reset_conv_(getattr(self, name), generator)
        if hasattr(self, "dense"):
            reset_linear_(self.dense, generator)


class InputEncoder(_Net):
    """Images (B, C, 28, 28) -> the (width, 14, 14) level-1 skip."""

    def __init__(self, width: int = 32, in_channels: int = 3):
        super().__init__()
        self.conv = nn.ModuleList([nn.Conv2d(in_channels, width, 3),
                                   nn.Conv2d(width, width, 3, 2)])

    def forward(self, x):
        h = F.silu(conv_same(self.conv[0], x))
        return ModelOutput(embedding=F.silu(conv_same(self.conv[1], h)))


class BottomUpMid(_Net):
    """The level-1 map -> the (width, 7, 7) level-2 skip."""

    def __init__(self, in_channels: int = 32, width: int = 64):
        super().__init__()
        self.conv = nn.ModuleList([nn.Conv2d(in_channels, width, 3, 2)])

    def forward(self, h):
        return F.silu(conv_same(self.conv[0], h))


class BottomUpLast(_Net):
    """The level-2 map -> a (width, 4, 4) map, flattened in (h, w, c)
    order -> Dense(hidden) -> the deepest level's (embedding,
    log_covariance)."""

    def __init__(self, in_channels: int = 64, width: int = 128, hidden: int = 512,
                 latent: int = 64, side: int = 4):
        super().__init__()
        self.conv = nn.ModuleList([nn.Conv2d(in_channels, width, 3, 2)])
        self.dense = nn.ModuleList([nn.Linear(side * side * width, hidden),
                                    nn.Linear(hidden, latent), nn.Linear(hidden, latent)])

    def forward(self, h):
        h = F.silu(conv_same(self.conv[0], h))
        h = F.silu(self.dense[0](h.permute(0, 2, 3, 1).flatten(1)))
        return ModelOutput(embedding=self.dense[1](h), log_covariance=self.dense[2](h))


class TopDown2(_Net):
    """z_3 -> Dense(hidden) -> Dense(side * side * width), unflattened in
    (h, w, c) order to the (width, side, side) level-2 state."""

    def __init__(self, latent: int = 64, hidden: int = 512, width: int = 64,
                 side: int = 7):
        super().__init__()
        self.shape = (side, side, width)
        self.dense = nn.ModuleList([nn.Linear(latent, hidden),
                                    nn.Linear(hidden, side * side * width)])

    def forward(self, z):
        h = F.silu(self.dense[1](F.silu(self.dense[0](z))))
        return h.reshape(z.shape[0], *self.shape).permute(0, 3, 1, 2)


class TopDown1(_Net):
    """z_2 (c2, 7, 7) -> the (width, 14, 14) level-1 state."""

    def __init__(self, in_channels: int = 64, width: int = 32):
        super().__init__()
        self.deconv = nn.ModuleList([nn.ConvTranspose2d(in_channels, width, 3, 2)])

    def forward(self, z):
        return F.silu(deconv_same(self.deconv[0], z))


class ConvHead(_Net):
    """A 3x3 conv, then 1x1-conv (embedding, log_covariance) heads."""

    def __init__(self, in_channels: int, channels: int):
        super().__init__()
        self.conv = nn.ModuleList([nn.Conv2d(in_channels, channels, 3),
                                   nn.Conv2d(channels, channels, 1),
                                   nn.Conv2d(channels, channels, 1)])

    def forward(self, h):
        h = F.silu(conv_same(self.conv[0], h))
        return ModelOutput(embedding=self.conv[1](h), log_covariance=self.conv[2](h))


class OutputDecoder(_Net):
    """z_1 (in_channels, 14, 14) -> a (out_channels, 28, 28) image."""

    def __init__(self, in_channels: int = 32, width: int = 32, out_channels: int = 3):
        super().__init__()
        self.deconv = nn.ModuleList([nn.ConvTranspose2d(in_channels, width, 3, 2)])
        self.conv = nn.ModuleList([nn.Conv2d(width, out_channels, 3)])

    def forward(self, z):
        h = F.silu(deconv_same(self.deconv[0], z))
        return ModelOutput(reconstruction=conv_same(self.conv[0], h))


def build_blocks(modalities, c1: int = 32, c2: int = 64, c3: int = 128, hidden: int = 512,
                 latent: int = 64, channels: int = 3, shared_posteriors: bool = True):
    """(encoders, decoders, bottom_up_blocks, top_down_blocks,
    posterior_blocks, prior_blocks) of a 3-level MHVAE over ``modalities``;
    the defaults are the example's widths."""
    encoders = {m: InputEncoder(c1, channels) for m in modalities}
    decoders = {m: OutputDecoder(c1, c1, channels) for m in modalities}
    bottom_up = {m: [BottomUpMid(c1, c2), BottomUpLast(c2, c3, hidden, latent)]
                 for m in modalities}
    top_down = [TopDown1(c2, c1), TopDown2(latent, hidden, c2)]

    def posterior():
        return [ConvHead(2 * c1, c1), ConvHead(2 * c2, c2)]

    posteriors = (posterior() if shared_posteriors
                  else {m: posterior() for m in modalities})
    prior = [ConvHead(c1, c1), ConvHead(c2, c2)]
    return encoders, decoders, bottom_up, top_down, posteriors, prior


def reset_blocks(blocks, generator: Optional[torch.Generator] = None):
    """Draw the weights of every net of ``build_blocks``'s groups from
    ``generator``, group by group in order."""
    def nets(group):
        if isinstance(group, nn.Module):
            yield group
        else:
            for v in (group.values() if isinstance(group, dict) else group):
                yield from nets(v)

    for group in blocks:
        for net in nets(group):
            net.reset_parameters(generator)
