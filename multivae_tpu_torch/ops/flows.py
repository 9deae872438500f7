"""Masked autoregressive flows (MADE / MAF / IAF) as torch modules.

Counterpart of ``multivae_tpu/ops/flows.py``:

- MADE masks are constant buffers built at construction (``made_masks``;
  with ``input_dim == 1`` the output mask is all zeros, so mu and alpha
  are the output layers' biases);
- ``MAF.forward(x)``: the density direction x -> u, parallel:
  u = (x - mu(x)) * exp(-alpha(x)), log|det| = -sum(alpha), the last axis
  flipped after each block;
- ``MAF.inverse(u)``: the sampling direction, sequential: per block,
  ``input_dim`` full MADE passes from zeros, then one more for alpha;
- IAF is the transpose: sequential density, parallel sampling;
- ``log_prob`` uses a standard-normal base distribution.

Each direction returns ``ModelOutput(out=..., log_abs_det_jac=...)``.
Weights: Glorot-uniform kernels and zero biases, drawn from an explicit
generator by ``reset_parameters``.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..utils.model_output import ModelOutput

_LOG_2PI = math.log(2.0 * math.pi)


def made_masks(input_dim: int, hidden_sizes: Sequence[int]):
    """Binary MADE masks (in, out) for the hidden layers and the output
    layer."""
    degrees = [np.arange(1, input_dim + 1)]
    for h in hidden_sizes:
        if input_dim > 1:
            degrees.append((np.arange(h) % (input_dim - 1)) + 1)
        else:
            degrees.append(np.ones(h, dtype=int))
    masks = []
    for d_in, d_out in zip(degrees[:-1], degrees[1:]):
        masks.append((d_out[None, :] >= d_in[:, None]).astype(np.float32))
    # output layer: strict inequality (outputs depend only on x_<i)
    out_mask = (degrees[0][None, :] > degrees[-1][:, None]).astype(np.float32)
    return masks, out_mask


class MaskedLinear(nn.Linear):
    """``x @ (kernel * mask) + bias``: a Linear whose weight (out, in) is
    multiplied by a fixed mask (the transpose of the (in, out) ``mask``),
    a buffer that the ``state_dict`` leaves out: it follows from the
    flow's shape."""

    def __init__(self, mask: np.ndarray):
        super().__init__(mask.shape[0], mask.shape[1])
        self.register_buffer("mask", torch.tensor(np.ascontiguousarray(mask.T)),
                             persistent=False)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Glorot-uniform weight, zero bias."""
        bound = math.sqrt(6.0 / (self.in_features + self.out_features))
        with torch.no_grad():
            nn.init.uniform_(self.weight, -bound, bound, generator=generator)
            nn.init.zeros_(self.bias)

    def forward(self, x):
        return nn.functional.linear(x, self.weight * self.mask, self.bias)


class MADE(nn.Module):
    """One autoregressive block producing (mu, alpha) per dimension."""

    def __init__(self, input_dim: int, hidden_sizes: Sequence[int] = (128, 128, 128)):
        super().__init__()
        self.input_dim = input_dim
        masks, out_mask = made_masks(input_dim, hidden_sizes)
        self.hidden = nn.ModuleList([MaskedLinear(m) for m in masks])
        self.mu = MaskedLinear(out_mask)
        self.alpha = MaskedLinear(out_mask)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        for layer in (*self.hidden, self.mu, self.alpha):
            layer.reset_parameters(generator)

    def forward(self, x):
        h = x
        for layer in self.hidden:
            h = torch.relu(layer(h))
        # the scale is bounded as in standard MAF implementations
        return self.mu(h), torch.tanh(self.alpha(h)) * 3.0


class _AutoregressiveFlow(nn.Module):
    """``n_made_blocks`` MADE blocks over ``input_dim`` coordinates. The
    parallel direction flips the last axis before each block where
    ``_parallel_flips_first`` (IAF), after it otherwise (MAF); the
    sequential direction undoes it."""

    _parallel_flips_first = False

    def __init__(self, input_dim: int, n_made_blocks: int = 2, hidden_size: int = 128,
                 n_hidden_in_made: int = 3):
        super().__init__()
        self.input_dim = input_dim
        self.blocks = nn.ModuleList(
            [MADE(input_dim, (hidden_size,) * n_hidden_in_made)
             for _ in range(n_made_blocks)])

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        for block in self.blocks:
            block.reset_parameters(generator)

    def _parallel(self, x) -> ModelOutput:
        """Per block: flip (IAF) or not (MAF) first, then
        x <- (x - mu(x)) * exp(-alpha(x))."""
        log_det = x.new_zeros(x.shape[:-1])
        flip_first = self._parallel_flips_first
        for block in self.blocks:
            if flip_first:
                x = x.flip(-1)
            mu, alpha = block(x)
            x = (x - mu) * torch.exp(-alpha)
            log_det = log_det - alpha.sum(-1)
            if not flip_first:
                x = x.flip(-1)
        return ModelOutput(out=x, log_abs_det_jac=log_det)

    def _sequential(self, y) -> ModelOutput:
        """The inverse of ``_parallel``: per block in reverse order, solve
        x = y * exp(alpha(x)) + mu(x) with ``input_dim`` passes from zeros
        (pass i fixes coordinate i), then one more pass for alpha."""
        log_det = y.new_zeros(y.shape[:-1])
        flip_first = not self._parallel_flips_first
        for block in reversed(self.blocks):
            if flip_first:
                y = y.flip(-1)
            x = torch.zeros_like(y)
            for _ in range(self.input_dim):
                mu, alpha = block(x)
                x = y * torch.exp(alpha) + mu
            _, alpha = block(x)
            log_det = log_det + alpha.sum(-1)
            y = x if flip_first else x.flip(-1)
        return ModelOutput(out=y, log_abs_det_jac=log_det)

    def log_prob(self, x):
        """log density under a standard-normal base."""
        out = self(x)
        base = -0.5 * (out["out"] ** 2 + _LOG_2PI)
        return base.sum(-1) + out["log_abs_det_jac"]


class MAF(_AutoregressiveFlow):
    """Masked Autoregressive Flow: fast density, sequential sampling."""

    def forward(self, x) -> ModelOutput:
        """Density direction x -> u (parallel)."""
        return self._parallel(x)

    def inverse(self, u) -> ModelOutput:
        """Sampling direction u -> x (sequential in D per block)."""
        return self._sequential(u)


class IAF(_AutoregressiveFlow):
    """Inverse Autoregressive Flow: fast sampling, sequential density."""

    _parallel_flips_first = True

    def forward(self, x) -> ModelOutput:
        """Density direction x -> u (sequential in D per block)."""
        return self._sequential(x)

    def inverse(self, u) -> ModelOutput:
        """Sampling direction u -> x (parallel)."""
        return self._parallel(u)
