"""Chunked importance-weighted marginal-likelihood estimation (counterpart
of ``multivae_tpu/ops/iwae.py``).

The K importance samples are drawn in chunks of ``batch_size_K`` (plus a
remainder chunk), each chunk over the whole batch at once; a Python loop
replaces the JAX package's ``lax.scan``. The chunk callables draw their own
noise, so a caller controls the noise source of every chunk (the models draw
it through their ``draw_noise`` hook, in chunk order).
"""

from __future__ import annotations

import math

import torch


def _chunk_sizes(K: int, batch_size_K: int):
    batch_size_K = min(batch_size_K, K)
    n_full, remainder = divmod(K, batch_size_K)
    return [batch_size_K] * n_full + ([remainder] if remainder else [])


def iwae_log_marginal(logw_chunk_fn, K: int, batch_size_K: int):
    """log(1/K sum_k w_k) per batch element.

    Args:
        logw_chunk_fn: ``chunk_size -> (chunk_size, B)`` log importance
            weights (log p(x, z_k) - log q(z_k)).
        K: total number of importance samples.
        batch_size_K: samples per chunk.

    Returns:
        (B,) logsumexp of all K log-weights minus log K.
    """
    lses = [torch.logsumexp(logw_chunk_fn(n), 0)
            for n in _chunk_sizes(K, batch_size_K)]
    return torch.logsumexp(torch.stack(lses), 0) - math.log(K)


def chunked_logsumexp(chunk_lse_fn, K: int, batch_size_K: int):
    """logsumexp over chunks of pre-reduced values: ``chunk_lse_fn(n)``
    returns the (B,) unnormalized logsumexp of one chunk of ``n`` samples;
    the caller subtracts its own normalization."""
    return torch.logsumexp(
        torch.stack([chunk_lse_fn(n) for n in _chunk_sizes(K, batch_size_K)]), 0)
