"""Gaussian aggregation: KL, Product-of-Experts, reparameterized sampling
(counterpart of ``multivae_tpu/ops/gaussian.py``).

Missing modalities are multiplicative precision masks (``mask *
exp(-log_var)``), never ``log_var = +inf``: no inf enters a computation and
a masked expert's (mu, log_var) gets exactly zero gradient. A row with no
live expert falls back to the prior N(0, I) (see ``masked_poe``).

Feature-axis sums accumulate in at least float32 (``sum_f32``), as the JAX
package's ``dtype=jnp.float32`` sums do.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

_LOG_2PI = math.log(2.0 * math.pi)


def sum_f32(x, dim=-1):
    """Sum over ``dim`` accumulated in float32, or in x's dtype when wider."""
    return x.sum(dim, dtype=torch.promote_types(x.dtype, torch.float32))


def kl_divergence(mean, log_var, prior_mean, prior_log_var):
    """KL(N(mean, e^log_var) || N(prior_mean, e^prior_log_var)), summed
    over the last axis."""
    kl = 0.5 * (prior_log_var - log_var + torch.exp(log_var - prior_log_var)
                + (mean - prior_mean) ** 2 / torch.exp(prior_log_var) - 1.0)
    return sum_f32(kl)


def gaussian_log_prob(x, mean, log_var):
    """Elementwise log N(x; mean, exp(log_var)) (diagonal)."""
    return -0.5 * (_LOG_2PI + log_var + (x - mean) ** 2 * torch.exp(-log_var))


def poe(mus, log_vars, eps: float = 1e-8):
    """Product of the Gaussian experts along the leading axis: (M, ..., D)
    -> (joint_mu, joint_log_var) of shape (..., D); ``eps`` is added to
    every variance."""
    precision = 1.0 / (torch.exp(log_vars) + eps)
    total_precision = precision.sum(0)
    joint_mu = (mus * precision).sum(0) / total_precision
    return joint_mu, -torch.log(total_precision)


def masked_poe(mus, log_vars, mask=None, prior_expert: bool = False,
               eps: float = 1e-8):
    """Masked Product of Gaussian experts along the leading axis.

    Args:
        mus, log_vars: (M, B, ...) expert parameters.
        mask: (M, B) float availability (broadcast over every trailing
            axis), or None for all available.
        prior_expert: include a standard-normal expert in the product.
        eps: added to every variance.

    A row is dead when no expert is unmasked or when its total precision
    (not differentiated) is at most 1e-20; a dead row gets precision 1 added
    to its total, as a 0/1 term rather than a select, and so falls back to
    N(0, I) with finite gradients. The total is then clamped at 1e-20.
    """
    precision = 1.0 / (torch.exp(log_vars) + eps)
    if mask is not None:
        mask = mask.reshape(*mask.shape, *(1,) * (precision.ndim - mask.ndim))
        precision = precision * mask
    total_precision = precision.sum(0)
    weighted_mu = (mus * precision).sum(0)
    if prior_expert:
        total_precision = total_precision + 1.0 / (1.0 + eps)
    if mask is not None and not prior_expert:
        alive = mask.amax(0) > 0
        dead = ~alive | (total_precision.detach() <= 1e-20)
        total_precision = total_precision + dead.to(total_precision.dtype)
    safe_precision = total_precision.clamp_min(1e-20)
    return weighted_mu / safe_precision, -torch.log(safe_precision)


def stable_poe(mus, log_vars, mask=None):
    """Product of experts with the joint log-variance as
    ``-logsumexp(-log_vars)``. Masked experts enter as -1e30 (zero
    gradient); rows with every expert masked fall back to N(0, I)."""
    if mask is None and mus.shape[0] == 1:
        return mus[0], log_vars[0]
    ln_inv_vars = -log_vars
    if mask is not None:
        ln_inv_vars = torch.where(mask[..., None] > 0, ln_inv_vars,
                                  torch.full_like(ln_inv_vars, -1e30))
    ln_var = -torch.logsumexp(ln_inv_vars, 0)
    weights = torch.exp(ln_inv_vars + ln_var)  # normalized precisions
    joint_mu = (weights * mus).sum(0)
    if mask is not None:
        any_avail = (mask.amax(0) > 0)[..., None]
        joint_mu = torch.where(any_avail, joint_mu, 0.0)
        ln_var = torch.where(any_avail, ln_var, 0.0)
    return joint_mu, ln_var


def rsample_from_gaussian(mu, log_var, N: int = 1, return_mean: bool = False,
                          flatten: bool = False, *, noise=None,
                          generator: Optional[torch.Generator] = None):
    """Reparameterized samples of N(mu, exp(log_var)).

    With N == 1 the output has mu's shape; with N > 1 a leading sample axis
    is added, and ``flatten`` merges it with the batch axis (a 1-D mu counts
    as a batch of one). ``noise`` is the standard-normal draw at that shape;
    it is drawn from ``generator`` when not given. ``return_mean`` returns
    mu (broadcast to the shape) and draws nothing.
    """
    shape = mu.shape if N == 1 else (N, *mu.shape)
    if return_mean:
        z = mu.expand(shape)
    else:
        if noise is None:
            noise = torch.randn(shape, generator=generator, dtype=mu.dtype,
                                device=mu.device)
        z = mu + torch.exp(0.5 * log_var) * noise.reshape(shape)
    if N > 1 and flatten:
        if z.ndim == 2:
            z = z[:, None, :]
        z = z.reshape(-1, *z.shape[2:])
    return z
