"""Decoder reconstruction distributions as elementwise log-prob closures
(counterpart of ``multivae_tpu/ops/dists.py``).

Each callable maps (reconstruction, target) -> elementwise log-probs, so
model code can ``.reshape(B, -1).sum(-1)`` as in the JAX package.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

_LOG_2PI = math.log(2.0 * math.pi)


def normal_log_prob(recon, target, scale: float = 1.0):
    """log N(target; recon, scale^2), elementwise."""
    var = scale * scale
    return -0.5 * ((target - recon) ** 2 / var + _LOG_2PI) - math.log(scale)


def bernoulli_logits_log_prob(logits, target):
    """log Bernoulli(target; sigmoid(logits)), elementwise; valid for
    continuous targets in [0, 1]."""
    return target * F.logsigmoid(logits) + (1.0 - target) * F.logsigmoid(-logits)


def laplace_log_prob(recon, target, scale: float = 1.0):
    """log Laplace(target; recon, scale), elementwise."""
    return -torch.abs(target - recon) / scale - math.log(2.0 * scale)


def cross_entropy_(logits, target_probs, eps: float = 1e-6):
    """``target * log_softmax(logits + eps)`` over the class axis, with the
    shape of ``logits`` (per-class terms, not reduced)."""
    return target_probs * F.log_softmax(logits + eps, dim=-1)


def cross_entropy(logits, target, eps: float = 1e-6):
    """``cross_entropy_`` for text modalities: ``logits`` may be a dict with
    a 'one_hot' field; ``target`` may be a dict with 'one_hot' probabilities
    or integer 'tokens' (one-hot over the logits' class axis; a token
    outside it gives a zero row, as ``jax.nn.one_hot`` does)."""
    if isinstance(logits, dict):
        if "one_hot" not in logits:
            raise NotImplementedError("dict logits must contain a 'one_hot' field")
        logits = logits["one_hot"]
    if isinstance(target, dict):
        if "one_hot" in target:
            target = target["one_hot"]
        elif "tokens" in target:
            classes = torch.arange(logits.shape[-1], device=logits.device)
            target = (target["tokens"][..., None] == classes).to(logits.dtype)
    return cross_entropy_(logits, target, eps)


def set_decoder_dist(dist_name: str, dist_params: dict):
    """Build an elementwise log-prob callable from a distribution name:
    'normal', 'bernoulli' (decoder outputs logits), 'laplace' or
    'categorical' (``cross_entropy``)."""
    dist_params = dict(dist_params or {})
    if dist_name == "normal":
        scale = float(dist_params.pop("scale", 1.0))

        def log_prob(recon, target):
            return normal_log_prob(recon, target, scale)

    elif dist_name == "bernoulli":
        log_prob = bernoulli_logits_log_prob

    elif dist_name == "laplace":
        scale = float(dist_params.pop("scale", 1.0))

        def log_prob(recon, target):
            return laplace_log_prob(recon, target, scale)

    elif dist_name == "categorical":
        log_prob = cross_entropy

    else:
        raise ValueError(f"The distribution type '{dist_name}' is not supported")

    return log_prob
