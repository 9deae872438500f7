"""Full-covariance Gaussian-mixture fit (EM) and sampling on the device.

Counterpart of ``multivae_tpu/ops/gmm.py`` (the device fit behind
``GaussianMixtureSampler``), with its numerics: float32 throughout,
k-means++ seeding and Lloyd iterations for the initial hard labels,
initial log-responsibilities ``log(one_hot + 1e-37)``, ``10 * eps`` added
to the component counts, ``reg_covar`` on the covariance diagonals, and EM
until the mean log-likelihood moves less than ``tol`` (or ``max_iter``
iterations). The E-step is a batched Cholesky factorization and
triangular solve over the (K, D, D) covariances; the M-step two batched
matmuls. The EM loop runs on the host and reads the convergence test, one
scalar, each iteration.

A covariance that is not positive definite factors to NaN on and below
the diagonal, as ``jnp.linalg.cholesky`` gives it (``torch.linalg.cholesky``
would raise): the fit then carries NaNs, as the JAX package's does.

The random draws (the k-means++ centres, the sampled components and their
noise) come from a ``torch.Generator``, or are given: ``_kmeans`` takes
its initial centres, ``fit_gmm`` initial ``labels``, ``sample_gmm``
``components`` and ``eps``.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

_F32_EPS = torch.finfo(torch.float32).eps


class GMMParams(NamedTuple):
    """Fitted mixture: ``weights (K,)``, ``means (K, D)``, ``covariances
    (K, D, D)`` and their lower Cholesky factors ``chol``; the last
    ``lower_bound`` (mean log-likelihood) and the EM iterations ``n_iter``."""

    weights: torch.Tensor
    means: torch.Tensor
    covariances: torch.Tensor
    chol: torch.Tensor
    lower_bound: torch.Tensor
    n_iter: int


def cholesky(covs):
    """Lower Cholesky factors; for a matrix that is not positive definite,
    NaN on and below the diagonal (the JAX behaviour)."""
    chol, info = torch.linalg.cholesky_ex(covs)
    lower = torch.ones(covs.shape[-2:], dtype=torch.bool, device=covs.device).tril()
    return torch.where((info > 0)[..., None, None] & lower, torch.nan, chol)


def _log_gaussian_prob(X, means, chol):
    """``(N, K)`` log N(x | mu_k, Sigma_k) from the Cholesky factors."""
    d = X.shape[-1]
    diff = (X[None] - means[:, None]).transpose(1, 2)               # (K, D, N)
    y = torch.linalg.solve_triangular(chol, diff, upper=False)
    quad = (y * y).sum(1)                                           # (K, N)
    logdet = torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)).sum(-1)
    return (-0.5 * (d * math.log(2.0 * math.pi) + quad) - logdet[:, None]).T


def _m_step(X, log_resp, reg_covar: float):
    """Weights, means and covariances from log-responsibilities."""
    n, d = X.shape
    resp = torch.exp(log_resp)
    nk = resp.sum(0) + 10 * _F32_EPS
    means = resp.T @ X / nk[:, None]
    diff = X[None] - means[:, None]                                 # (K, N, D)
    covs = (resp.T[:, :, None] * diff).transpose(1, 2) @ diff / nk[:, None, None]
    covs = covs + reg_covar * torch.eye(d, dtype=X.dtype, device=X.device)
    return nk / n, means, covs


def _sq_dist(X, centers):
    x2 = (X * X).sum(1)
    return x2[:, None] - 2.0 * (X @ centers.T) + (centers * centers).sum(1)[None, :]


def _kmeans_pp_init(X, k: int, generator: Optional[torch.Generator] = None):
    """k-means++ seeding: each next centre drawn with probability in
    proportion to its squared distance to the nearest centre so far
    (uniform when every distance is 0)."""
    n = X.shape[0]
    centers = torch.zeros((k, X.shape[1]), dtype=X.dtype, device=X.device)
    first = int(torch.randint(n, (), generator=generator, device=X.device))
    centers[0] = X[first]
    min_d = _sq_dist(X, centers[:1])[:, 0].clamp_min(0.0)
    for i in range(1, k):
        tot = min_d.sum()
        weights = torch.where(tot > 0, min_d + 1e-30, torch.ones_like(min_d))
        idx = torch.multinomial(weights, 1, generator=generator)[0]
        centers[i] = X[idx]
        min_d = torch.minimum(min_d, _sq_dist(X, X[idx][None])[:, 0].clamp_min(0.0))
    return centers


def _kmeans(X, centers, n_iters: int = 50):
    """Lloyd iterations from ``centers``; returns the hard labels. An empty
    cluster keeps its centre."""
    k = centers.shape[0]
    for _ in range(n_iters):
        onehot = torch.nn.functional.one_hot(_sq_dist(X, centers).argmin(1), k).to(X.dtype)
        counts = onehot.sum(0)
        new = onehot.T @ X / counts.clamp_min(1.0)[:, None]
        centers = torch.where(counts[:, None] > 0, new, centers)
    return _sq_dist(X, centers).argmin(1)


def _e_step(X, weights, means, covs):
    chol = cholesky(covs)
    weighted = _log_gaussian_prob(X, means, chol) + torch.log(weights)[None, :]
    norm = torch.logsumexp(weighted, 1, keepdim=True)
    return weighted - norm, norm.mean(), chol


def fit_gmm(X, n_components: int, generator: Optional[torch.Generator] = None,
            max_iter: int = 2000, tol: float = 1e-3, reg_covar: float = 1e-6,
            labels=None) -> GMMParams:
    """Fit a full-covariance GMM to ``X (N, D)`` on X's device.

    The initial hard labels come from k-means seeded by k-means++ with
    ``generator``, or are ``labels``."""
    X = X.to(torch.float32)
    k = n_components
    if labels is None:
        labels = _kmeans(X, _kmeans_pp_init(X, k, generator))
    log_resp = torch.log(torch.nn.functional.one_hot(labels.to(X.device), k).to(X.dtype)
                         + 1e-37)
    weights, means, covs = _m_step(X, log_resp, reg_covar)
    log_resp, lb, chol = _e_step(X, weights, means, covs)
    prev_lb, n_iter = lb - 2 * tol - 1.0, 1
    while n_iter < max_iter and bool((lb - prev_lb).abs() >= tol):
        weights, means, covs = _m_step(X, log_resp, reg_covar)
        prev_lb = lb
        log_resp, lb, chol = _e_step(X, weights, means, covs)
        n_iter += 1
    return GMMParams(weights=weights, means=means, covariances=covs, chol=chol,
                     lower_bound=lb, n_iter=n_iter)


def sample_gmm(params: GMMParams, n_samples: int,
               generator: Optional[torch.Generator] = None, components=None, eps=None):
    """``(n_samples, D)`` draws from the fitted mixture: a component per row
    by its weight, then mean + chol @ eps."""
    means, chol = params.means, params.chol
    if components is None:
        components = torch.multinomial(params.weights, n_samples, replacement=True,
                                       generator=generator)
    if eps is None:
        eps = torch.randn((n_samples, means.shape[1]), generator=generator,
                          device=means.device)
    components, eps = components.to(means.device), eps.to(means)
    out = means[components]
    for k in torch.unique(components).tolist():
        rows = components == k
        out[rows] += eps[rows] @ chol[k].T
    return out


def score_samples(params: GMMParams, X):
    """Per-sample log-likelihood under the mixture."""
    log_prob = _log_gaussian_prob(X.to(torch.float32), params.means, params.chol)
    return torch.logsumexp(log_prob + torch.log(params.weights)[None, :], 1)
