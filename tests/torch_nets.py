"""Torch copies of the JAX tests' MLP test blocks, importing no JAX, so that
the data-parallel tests' worker processes can build them too."""

import math

import torch
from torch import nn

from multivae_tpu_torch.utils.model_output import ModelOutput


class _MLP(nn.Module):
    """The torch copy of a block of ``tests/mhvae_test_architectures.py``:
    ReLU layers through ``widths``, then (embedding, log_covariance) heads
    of ``heads`` when given, an embedding alone when ``embedding``, or the
    hidden tensor itself."""

    def __init__(self, widths, heads=None, out=None, embedding=False):
        super().__init__()
        layers = [nn.Linear(a, b) for a, b in zip(widths, widths[1:])]
        if heads:
            layers += [nn.Linear(widths[-1], heads), nn.Linear(widths[-1], heads)]
        if out:
            layers.append(nn.Linear(widths[-1], out))
        self.dense = nn.ModuleList(layers)
        self.n_hidden, self.heads, self.out = len(widths) - 1, heads, out
        self.embedding = embedding

    def forward(self, x):
        h = x.flatten(1)
        for layer in self.dense[:self.n_hidden]:
            h = torch.relu(layer(h))
        if self.heads:
            return ModelOutput(embedding=self.dense[-2](h), log_covariance=self.dense[-1](h))
        if self.out:
            return ModelOutput(reconstruction=self.dense[-1](h))
        return ModelOutput(embedding=h) if self.embedding else h


def mhvae_mlp_blocks(dims: dict, latent: int, shared: bool = True):
    """Torch copies of ``build_mhvae_blocks(dims, 3, latent, shared)``
    (``tests/mhvae_test_architectures.py``): hidden 16, in MHVAE's argument
    order."""
    def head(n_in):
        return _MLP([n_in, 16], heads=latent)

    def posterior():
        return [head(32), head(32)]

    return ({m: _MLP([math.prod(d), 16], embedding=True) for m, d in dims.items()},
            {m: _MLP([latent, 16], out=math.prod(d)) for m, d in dims.items()},
            {m: [_MLP([16, 16]), head(16)] for m in dims},
            [_MLP([latent, 16]), _MLP([latent, 16])],
            posterior() if shared else {m: posterior() for m in dims},
            [head(16), head(16)])
