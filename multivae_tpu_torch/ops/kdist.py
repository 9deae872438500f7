"""Location-scale distributions for the K-sample MoE models (counterpart of
``multivae_tpu/ops/kdist.py``).

Scale transforms:

- 'laplace_with_softmax': scale = softmax(log_var, -1) * D + 1e-6
- 'normal':               scale = exp(0.5 * log_var)
- 'normal_with_softplus': scale = softplus(log_var) + 1e-6

Sampling takes the noise as an argument (``u``) or draws it from an
explicit ``torch.Generator`` with ``sample_noise``: Laplace uses the
inverse-CDF transform on u ~ U[-0.5 + eps, 0.5), Normal uses u ~ N(0, 1).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from .mixture import mixture_log_density

_LOG_2PI = math.log(2.0 * math.pi)


def log_var_to_std(log_var, dist_name: str):
    if dist_name == "laplace_with_softmax":
        return torch.softmax(log_var, dim=-1) * log_var.shape[-1] + 1e-6
    if dist_name == "normal_with_softplus":
        return F.softplus(log_var) + 1e-6
    return torch.exp(0.5 * log_var)


def base_dist(dist_name: str) -> str:
    return "laplace" if dist_name == "laplace_with_softmax" else "normal"


def dist_log_prob(dist_name: str, x, loc, scale):
    """Elementwise log-prob of the location-scale family."""
    if base_dist(dist_name) == "laplace":
        return -torch.abs(x - loc) / scale - torch.log(2.0 * scale)
    return -0.5 * ((x - loc) / scale) ** 2 - torch.log(scale) - 0.5 * _LOG_2PI


def sample_noise(dist_name: str, shape, *, generator: Optional[torch.Generator] = None,
                 dtype=torch.float32, device=None) -> torch.Tensor:
    """The noise ``dist_rsample`` consumes: U[-0.5 + eps, 0.5) for Laplace
    (as ``jax.random.uniform(minval=-0.5 + eps, maxval=0.5)``), N(0, 1)
    for Normal."""
    if base_dist(dist_name) == "laplace":
        eps = torch.finfo(dtype).eps
        u = torch.rand(shape, generator=generator, dtype=dtype, device=device)
        return u * (1.0 - eps) + (-0.5 + eps)
    return torch.randn(shape, generator=generator, dtype=dtype, device=device)


def dist_rsample(dist_name: str, loc, scale, K: int = 1, *, u=None,
                 generator: Optional[torch.Generator] = None):
    """Reparameterized sampling; K > 1 prepends a sample axis. ``u`` is the
    noise of ``sample_noise`` at the output's shape; drawn from
    ``generator`` when not given."""
    shape = loc.shape if K == 1 else (K, *loc.shape)
    if u is None:
        u = sample_noise(dist_name, shape, generator=generator,
                         dtype=loc.dtype, device=loc.device)
    u = u.reshape(shape)
    if base_dist(dist_name) == "laplace":
        return loc - scale * torch.sign(u) * torch.log1p(-2.0 * torch.abs(u))
    return loc + scale * u


def dist_rsample_k(dist_name: str, loc, scale, K: int, *, u=None,
                   generator: Optional[torch.Generator] = None):
    """Like ``dist_rsample`` but ALWAYS returns a leading K axis, K=1
    included."""
    z = dist_rsample(dist_name, loc, scale, K=K, u=u, generator=generator)
    return z[None] if K == 1 else z


def mixture_logsumexp(z, mus, sigmas, mask, dist_name: str):
    """logsumexp over experts of the masked MoE density, (MZ, K, B).

    The hot op of the MMVAE-family objectives: the mixture kernel on CUDA
    tensors, its plain PyTorch version on CPU tensors."""
    return mixture_log_density(z, mus, sigmas, mask, dist=base_dist(dist_name))
