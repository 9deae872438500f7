"""CUB nets (counterpart of ``multivae_tpu/nn/cub.py``): the transformer
text encoder, the MLP text decoder and the pre-activation resnet image
encoder and decoder for (3, 64, 64) images, channels-first.

Text comes as a dict ``{"tokens": (B, L) int, "padding_mask": (B, L)}``
(1 = a real token). The Flax modules' functions are kept:

- ``TransformerEncoderLayer`` is post-norm, with the attention of Flax's
  ``MultiHeadDotProductAttention``: per-head query, key and value
  projections, the query scaled by 1/sqrt(head_dim), a padded key's logit
  set to float32's lowest value before the softmax, an output projection;
  ``LayerNorm`` with Flax's epsilon, 1e-6. No dropout runs: the JAX layer
  is called deterministic;
- ``CubTextEncoder`` embeds the tokens, scales them by sqrt(embed_size),
  adds sinusoidal positional encodings and flattens the last layer's
  (L, E) output into two Dense heads;
- ``PreActResnetBlock`` applies LeakyReLU(0.2) before each of its two 3x3
  convs; the encoder's heads read the flattened map in torch's (c, h, w)
  order, and ``utils/convert.params_from_jax`` permutes their rows from
  Flax's (h, w, c).

Layers sit in the ModuleLists ``dense``, ``conv``, ``blocks`` and
``layers`` in the order Flax creates ``Dense_i``, ``Conv_i``,
``PreActResnetBlock_i`` and ``TransformerEncoderLayer_i``.
``reset_parameters`` draws from an explicit generator the JAX nets' inits:
Flax's for the text nets (LeCun normal Dense kernels, zero biases, the
embedding U(0, 0.2)), PyTorch's default for the convs.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils.model_output import ModelOutput
from .base_architectures import BaseDecoder, BaseEncoder
from .default_architectures import BaseAEConfig
from .mmnist import avg_pool_3_2_1, reset_conv_, upsample_nearest_2x

LAYER_NORM_EPS = 1e-6   # Flax's LayerNorm default (torch's is 1e-5)
# the std of a standard normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


def positional_encoding(max_len: int, d_model: int) -> np.ndarray:
    """(max_len, d_model) sinusoidal positional encodings."""
    position = np.arange(max_len)[:, None]
    div_term = np.exp(np.arange(0, d_model, 2) * (-math.log(10000.0) / d_model))
    pe = np.zeros((max_len, d_model), np.float32)
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)
    return pe


def reset_lecun_(layers, generator: Optional[torch.Generator] = None):
    """Flax's Dense init: kernel LeCun normal (truncated at 2 std, variance
    1 / fan_in), bias zero."""
    for layer in layers:
        std = 1.0 / math.sqrt(layer.weight.shape[1]) / _TRUNC_STD
        with torch.no_grad():
            nn.init.trunc_normal_(layer.weight, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
            if layer.bias is not None:
                layer.bias.zero_()


class TransformerEncoderLayer(nn.Module):
    """Post-norm encoder layer: x + attention, LayerNorm, x + Dense(ff)
    ReLU Dense(E), LayerNorm."""

    # The JAX leaves of the attention projections, which are Linears here:
    # Flax's per-head (E, H, D) query, key and value kernels with (H, D)
    # biases and its (H, D, E) out kernel (E embed, H heads, D head_dim),
    # reshapes of these parameters and no permutation of them. For each
    # parameter: its JAX leaf's axes by size, and for each torch axis the
    # JAX axes merged into it, in order. ``utils/convert.py`` builds the
    # parameters from the JAX leaves by it, and ``parallel/mesh.py`` judges
    # their placements on the JAX leaves by it. The out bias (E,) is a
    # Linear's own.
    JAX_LAYOUT = {
        **{f"{name}.weight": ("EHD", ((1, 2), (0,))) for name in ("query", "key", "value")},
        **{f"{name}.bias": ("HD", ((0, 1),)) for name in ("query", "key", "value")},
        "out.weight": ("HDE", ((2,), (0, 1))),
    }

    def __init__(self, embed_size: int, nhead: int, ff_size: int, dropout: float = 0.5):
        super().__init__()
        if embed_size % nhead:
            raise ValueError(f"embed_size {embed_size} is not a multiple of nhead {nhead}")
        self.nhead, self.embed_size = nhead, embed_size
        self.query = nn.Linear(embed_size, embed_size)
        self.key = nn.Linear(embed_size, embed_size)
        self.value = nn.Linear(embed_size, embed_size)
        self.out = nn.Linear(embed_size, embed_size)
        self.norm = nn.ModuleList([nn.LayerNorm(embed_size, eps=LAYER_NORM_EPS)
                                   for _ in range(2)])
        self.dense = nn.ModuleList([nn.Linear(embed_size, ff_size),
                                    nn.Linear(ff_size, embed_size)])

    def jax_leaves(self) -> dict:
        """``{parameter name: (its JAX leaf's shape, the JAX axes of each
        torch axis)}`` of ``JAX_LAYOUT`` at this layer's widths."""
        sizes = {"E": self.embed_size, "H": self.nhead, "D": self.embed_size // self.nhead}
        return {name: (tuple(sizes[a] for a in axes), groups)
                for name, (axes, groups) in self.JAX_LAYOUT.items()}

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        reset_lecun_([self.query, self.key, self.value, self.out, *self.dense], generator)
        for norm in self.norm:
            norm.reset_parameters()

    def attention(self, x, padding_mask):
        b, n, e = x.shape
        heads = (b, n, self.nhead, e // self.nhead)
        q = self.query(x).reshape(heads) / math.sqrt(e // self.nhead)
        k = self.key(x).reshape(heads)
        v = self.value(x).reshape(heads)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k)
        keep = padding_mask[:, None, None, :] > 0
        logits = torch.where(keep, logits, torch.finfo(logits.dtype).min)
        weights = torch.softmax(logits, dim=-1)
        return self.out(torch.einsum("bhqk,bkhd->bqhd", weights, v).reshape(b, n, e))

    def forward(self, x, padding_mask):
        x = self.norm[0](x + self.attention(x, padding_mask))
        ff = self.dense[1](torch.relu(self.dense[0](x)))
        return self.norm[1](x + ff)


class CubTextEncoder(BaseEncoder):
    """Transformer text encoder: {"tokens", "padding_mask"} ->
    (embedding, log_covariance) of ``latent_dim``, and the last layer's
    output as ``transformer_output``."""

    def __init__(self, latent_dim: int, max_sentence_length: int, ntokens: int,
                 embed_size: int = 512, nhead: int = 4, ff_size: int = 1024,
                 n_layers: int = 4, dropout: float = 0.5):
        super().__init__()
        self.latent_dim = latent_dim
        self.embed_size = embed_size
        self.embed = nn.Embedding(ntokens, embed_size)
        self.layers = nn.ModuleList([TransformerEncoderLayer(embed_size, nhead, ff_size, dropout)
                                     for _ in range(n_layers)])
        flat = max_sentence_length * embed_size
        self.dense = nn.ModuleList([nn.Linear(flat, latent_dim), nn.Linear(flat, latent_dim)])
        self.register_buffer("pe", torch.from_numpy(
            positional_encoding(max_sentence_length, embed_size)), persistent=False)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        with torch.no_grad():
            nn.init.uniform_(self.embed.weight, 0.0, 0.2, generator=generator)
        for layer in self.layers:
            layer.reset_parameters(generator)
        reset_lecun_(self.dense, generator)

    def forward(self, inputs):
        tokens, padding_mask = inputs["tokens"], inputs["padding_mask"]
        h = self.embed(tokens.long()) * math.sqrt(self.embed_size)
        h = h + self.pe[None, :h.shape[1]]
        for layer in self.layers:
            h = layer(h, padding_mask)
        flat = h.reshape(h.shape[0], -1)
        return ModelOutput(embedding=self.dense[0](flat), log_covariance=self.dense[1](flat),
                           transformer_output=h)


class CubTextDecoderMLP(BaseDecoder):
    """(*, latent_dim) -> Dense(512) ReLU -> Dense -> (*, L, V) logits."""

    def __init__(self, args: BaseAEConfig):
        super().__init__()
        self.latent_dim = args.latent_dim
        self.input_dim = tuple(args.input_dim)
        self.dense = nn.ModuleList([nn.Linear(args.latent_dim, 512),
                                    nn.Linear(512, int(np.prod(self.input_dim)))])

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        reset_lecun_(self.dense, generator)

    def forward(self, z):
        out = self.dense[1](torch.relu(self.dense[0](z)))
        return ModelOutput(reconstruction=out.reshape(*z.shape[:-1], *self.input_dim))


class PreActResnetBlock(nn.Module):
    """x_s + 0.1 * dx: dx two 3x3 convs, each after LeakyReLU(0.2); x_s a
    1x1 bias-free conv when the channel counts differ, else x."""

    def __init__(self, fin: int, fout: int, fhidden: Optional[int] = None):
        super().__init__()
        hidden = fhidden or min(fin, fout)
        convs = [nn.Conv2d(fin, hidden, 3, 1, 1), nn.Conv2d(hidden, fout, 3, 1, 1)]
        if fin != fout:
            convs.append(nn.Conv2d(fin, fout, 1, 1, 0, bias=False))
        self.conv = nn.ModuleList(convs)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        reset_conv_(self.conv, generator)

    def forward(self, x):
        dx = self.conv[0](F.leaky_relu(x, 0.2))
        dx = self.conv[1](F.leaky_relu(dx, 0.2))
        x_s = self.conv[2](x) if len(self.conv) == 3 else x
        return x_s + 0.1 * dx


def _n_layers(s0: int) -> int:
    return int(np.log2(64 / s0))


class CUB_Resnet_Encoder(BaseEncoder):
    """(3, 64, 64) -> a 3x3 conv to ``nfilter`` channels,
    PreActResnetBlock(nf, nf), then per layer an average pool and a block
    doubling the channels (up to ``nfilter_max``), down to (C, s0, s0);
    LeakyReLU(0.2) on the flattened map, two Dense heads."""

    def __init__(self, latent_dim: int, s0: int = 16, nfilter: int = 64,
                 nfilter_max: int = 1024):
        super().__init__()
        self.latent_dim = latent_dim
        nf, nl = nfilter, _n_layers(s0)
        widths = [min(nf * 2 ** i, nfilter_max) for i in range(nl + 1)]
        self.conv = nn.ModuleList([nn.Conv2d(3, nf, 3, 1, 1)])
        self.blocks = nn.ModuleList([PreActResnetBlock(nf, nf)] + [
            PreActResnetBlock(widths[i], widths[i + 1]) for i in range(nl)])
        flat = widths[-1] * s0 * s0
        self.dense = nn.ModuleList([nn.Linear(flat, latent_dim), nn.Linear(flat, latent_dim)])

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        reset_conv_(self.conv, generator)
        for block in self.blocks:
            block.reset_parameters(generator)
        reset_lecun_(self.dense, generator)

    def forward(self, x):
        h = self.blocks[0](self.conv[0](x.reshape(-1, 3, 64, 64)))
        for block in self.blocks[1:]:
            h = block(avg_pool_3_2_1(h))
        # CHW flatten; params_from_jax permutes the heads from Flax's HWC order
        h = F.leaky_relu(h.flatten(1), 0.2)
        return ModelOutput(embedding=self.dense[0](h), log_covariance=self.dense[1](h))


class CUB_Resnet_Decoder(BaseDecoder):
    """(*, latent_dim) -> Dense to (nf0, s0, s0) channels-first, per layer a
    PreActResnetBlock halving the channels and a 2x upsampling,
    PreActResnetBlock(nf, nf), then LeakyReLU(0.2) and a 3x3 conv to 3
    channels: (*, 3, 64, 64)."""

    def __init__(self, latent_dim: int, s0: int = 16, nfilter: int = 64,
                 nfilter_max: int = 512):
        super().__init__()
        self.latent_dim, self.s0 = latent_dim, s0
        nf, nl = nfilter, _n_layers(s0)
        self.nf0 = min(nfilter_max, nf * 2 ** nl)
        self.dense = nn.ModuleList([nn.Linear(latent_dim, self.nf0 * s0 * s0)])
        self.blocks = nn.ModuleList(
            [PreActResnetBlock(min(nf * 2 ** (nl - i), nfilter_max),
                               min(nf * 2 ** (nl - i - 1), nfilter_max)) for i in range(nl)]
            + [PreActResnetBlock(nf, nf)])
        self.conv = nn.ModuleList([nn.Conv2d(nf, 3, 3, 1, 1)])

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        reset_lecun_(self.dense, generator)
        for block in self.blocks:
            block.reset_parameters(generator)
        reset_conv_(self.conv, generator)

    def forward(self, z):
        lead = z.shape[:-1]
        h = self.dense[0](z.reshape(-1, z.shape[-1])).reshape(-1, self.nf0, self.s0, self.s0)
        for block in self.blocks[:-1]:
            h = upsample_nearest_2x(block(h))
        h = self.conv[0](F.leaky_relu(self.blocks[-1](h), 0.2))
        return ModelOutput(reconstruction=h.reshape(*lead, 3, 64, 64))
