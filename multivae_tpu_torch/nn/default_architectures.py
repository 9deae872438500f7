"""Default MLP architectures (counterpart of
``multivae_tpu/nn/default_architectures.py``).

- ``Encoder_VAE_MLP``: flatten -> [hidden ReLU] x (1 + n_hidden) ->
  (embedding, log_covariance) heads.
- ``Encoder_VAE_MLP_Style``: flatten -> hidden ReLU -> shared and style
  (embedding, log_covariance) heads.
- ``Decoder_AE_MLP``: z -> hidden ReLU -> prod(input_dim) sigmoid ->
  reshape; accepts any leading shape (*, latent_dim).
- ``MultipleHeadJointEncoder``: its own copies of the unimodal encoders,
  their embeddings concatenated -> [hidden ReLU] x n_hidden_layers ->
  (embedding, log_covariance) heads.
- ``ConditionalDecoderMLP``: concat(z, each conditioning modality's data
  flattened) -> ``Decoder_AE_MLP``.

Each net keeps its ``nn.Linear`` layers in the ModuleList ``dense`` in the
order the Flax modules create ``Dense_0, Dense_1, ...``, which is what
``utils/convert.params_from_jax`` relies on. ``reset_parameters`` draws
PyTorch's default Linear init, U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for
weight and bias, from an explicit generator.
"""

from __future__ import annotations

import copy
import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..utils.config import BaseConfig
from ..utils.model_output import ModelOutput
from .base_architectures import (
    BaseConditionalDecoder,
    BaseDecoder,
    BaseEncoder,
    BaseJointEncoder,
    BaseMultilatentEncoder,
)


@dataclasses.dataclass
class BaseAEConfig(BaseConfig):
    """Config for encoder/decoder nets.

    Args:
        input_dim: the input data dimension (channels, x, y) or (D,).
        latent_dim: latent space dimension.
        style_dim: private latent dimension (multi-latent models).
    """

    input_dim: Optional[Tuple[int, ...]] = None
    latent_dim: int = 10
    style_dim: int = 0

    def __post_init__(self):
        if self.input_dim is not None:
            self.input_dim = tuple(int(d) for d in self.input_dim)


def reset_linear_(layers, generator: Optional[torch.Generator] = None):
    """PyTorch's default Linear init, drawn from ``generator``."""
    for lin in layers:
        bound = 1.0 / math.sqrt(lin.in_features)
        with torch.no_grad():
            nn.init.uniform_(lin.weight, -bound, bound, generator=generator)
            if lin.bias is not None:
                nn.init.uniform_(lin.bias, -bound, bound, generator=generator)


class Encoder_VAE_MLP(BaseEncoder):
    """MLP encoder with Gaussian posterior heads."""

    def __init__(self, args: BaseAEConfig, n_hidden: int = 1,
                 hidden_dim: int = 512):
        super().__init__()
        self.input_dim = args.input_dim
        self.latent_dim = args.latent_dim
        in_features = int(np.prod(args.input_dim))
        widths = [in_features] + [hidden_dim] * (1 + n_hidden)
        self.dense = nn.ModuleList(
            [nn.Linear(a, b) for a, b in zip(widths[:-1], widths[1:])]
            + [nn.Linear(hidden_dim, args.latent_dim),
               nn.Linear(hidden_dim, args.latent_dim)]
        )
        self.in_features = in_features

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        reset_linear_(self.dense, generator)

    def forward(self, x):
        h = x.reshape(-1, self.in_features)
        for lin in self.dense[:-2]:
            h = torch.relu(lin(h))
        return ModelOutput(embedding=self.dense[-2](h),
                           log_covariance=self.dense[-1](h))


class Encoder_VAE_MLP_Style(BaseMultilatentEncoder):
    """MLP encoder with shared and style Gaussian heads."""

    def __init__(self, args: BaseAEConfig, hidden_dim: int = 512):
        super().__init__()
        self.input_dim = args.input_dim
        self.latent_dim = args.latent_dim
        self.style_dim = args.style_dim
        self.in_features = int(np.prod(args.input_dim))
        self.dense = nn.ModuleList(
            [nn.Linear(self.in_features, hidden_dim)]
            + [nn.Linear(hidden_dim, d) for d in (args.latent_dim, args.latent_dim,
                                                  args.style_dim, args.style_dim)])

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        reset_linear_(self.dense, generator)

    def forward(self, x):
        h = torch.relu(self.dense[0](x.reshape(-1, self.in_features)))
        return ModelOutput(embedding=self.dense[1](h), log_covariance=self.dense[2](h),
                           style_embedding=self.dense[3](h),
                           style_log_covariance=self.dense[4](h))


class Decoder_AE_MLP(BaseDecoder):
    """MLP decoder; accepts any leading shape (*, latent_dim)."""

    def __init__(self, args: BaseAEConfig, hidden_dim: int = 512):
        super().__init__()
        self.input_dim = args.input_dim
        self.latent_dim = args.latent_dim
        out_features = int(np.prod(args.input_dim))
        self.dense = nn.ModuleList([nn.Linear(args.latent_dim, hidden_dim),
                                    nn.Linear(hidden_dim, out_features)])

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        reset_linear_(self.dense, generator)

    def forward(self, z):
        h = torch.relu(self.dense[0](z))
        out = torch.sigmoid(self.dense[1](h))
        return ModelOutput(
            reconstruction=out.reshape(*z.shape[:-1], *self.input_dim))


def BaseDictEncoders(input_dims: dict, latent_dim: int) -> Dict[str, BaseEncoder]:
    """Default MLP encoder per modality."""
    return {
        mod: Encoder_VAE_MLP(BaseAEConfig(input_dim=tuple(input_dims[mod]),
                                          latent_dim=latent_dim))
        for mod in input_dims
    }


def BaseDictDecoders(input_dims: dict, latent_dim: int) -> Dict[str, BaseDecoder]:
    """Default MLP decoder per modality."""
    return {
        mod: Decoder_AE_MLP(BaseAEConfig(input_dim=tuple(input_dims[mod]),
                                         latent_dim=latent_dim))
        for mod in input_dims
    }


def BaseDictEncoders_MultiLatents(input_dims: dict, latent_dim: int,
                                  modality_dims: dict) -> Dict[str, BaseMultilatentEncoder]:
    """Default multi-latent MLP encoder per modality."""
    return {
        mod: Encoder_VAE_MLP_Style(BaseAEConfig(input_dim=tuple(input_dims[mod]),
                                                latent_dim=latent_dim,
                                                style_dim=modality_dims[mod]))
        for mod in input_dims
    }


def BaseDictDecodersMultiLatents(input_dims: dict, latent_dim: int,
                                 modality_dims: dict) -> Dict[str, BaseDecoder]:
    """MLP decoders of concat(shared z, private z) per modality."""
    return {
        mod: Decoder_AE_MLP(BaseAEConfig(input_dim=tuple(input_dims[mod]),
                                         latent_dim=latent_dim + modality_dims[mod]))
        for mod in input_dims
    }


class MultipleHeadJointEncoder(BaseJointEncoder):
    """Joint encoder: independent copies of the unimodal encoders (deep
    copies: their weights are not tied to the originals), the concatenation
    of their embeddings through ``n_hidden_layers`` hidden ReLU layers, and
    (embedding, log_covariance) heads of ``args.latent_dim``.

    The copies sit in the ModuleDict ``dict_encoders`` and the fusion layers
    in ``dense``, as the Flax module's ``dict_encoders_<m>`` and ``Dense_i``.
    """

    def __init__(self, dict_encoders: dict, args: BaseAEConfig, hidden_dim: int = 512,
                 n_hidden_layers: int = 2):
        super().__init__()
        self.latent_dim = args.latent_dim
        self.dict_encoders = nn.ModuleDict(
            {m: copy.deepcopy(enc) for m, enc in dict_encoders.items()})
        joint_input_dim = sum(enc.latent_dim for enc in self.dict_encoders.values())
        widths = [joint_input_dim] + [hidden_dim] * n_hidden_layers
        self.dense = nn.ModuleList(
            [nn.Linear(a, b) for a, b in zip(widths[:-1], widths[1:])]
            + [nn.Linear(hidden_dim, args.latent_dim),
               nn.Linear(hidden_dim, args.latent_dim)])

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        for enc in self.dict_encoders.values():
            enc.reset_parameters(generator)
        reset_linear_(self.dense, generator)

    def forward(self, x: dict):
        h = torch.cat([enc(x[m])["embedding"] for m, enc in self.dict_encoders.items()],
                      -1)
        for lin in self.dense[:-2]:
            h = torch.relu(lin(h))
        return ModelOutput(embedding=self.dense[-2](h), log_covariance=self.dense[-1](h))


class ConditionalDecoderMLP(BaseConditionalDecoder):
    """MLP decoder of z concatenated with the conditioning modalities' data,
    each flattened, in ``cond_data_dims`` order."""

    def __init__(self, latent_dim: int, data_dim: tuple, cond_data_dims: dict):
        super().__init__()
        self.latent_dim = latent_dim
        self.cond_data_dims = {m: tuple(d) for m, d in cond_data_dims.items()}
        all_dim = latent_dim + sum(int(np.prod(d)) for d in self.cond_data_dims.values())
        self.network = Decoder_AE_MLP(BaseAEConfig(input_dim=tuple(data_dim),
                                                   latent_dim=all_dim))

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        self.network.reset_parameters(generator)

    def forward(self, z, cond_mods: dict):
        parts = [z] + [cond_mods[m].reshape(z.shape[0], -1) for m in self.cond_data_dims]
        return self.network(torch.cat(parts, -1))
