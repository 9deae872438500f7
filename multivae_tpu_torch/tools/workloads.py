"""The full-width training configurations the port runs on the card, with
random data in the real datasets' shapes, made from a seed.

- ``mmvae``: the repo's full-width MMVAE (``bench.py:299-318``): 5
  modalities of 3x28x28, latent 512, K=10, default MLP nets, Laplace
  decoders, ``laplace_with_softmax`` posteriors, DReG.
- ``mvtcae_mlp``: ``bench.py``'s ``bench_jax`` (``bench.py:24-26, 68-76``):
  ``m0`` (1,28,28) and ``m1`` (3,32,32), default MLP-512 nets, Bernoulli
  decoders, latent 512, alpha 0.1, beta 2.5.
- ``mvtcae_conv``: the partial-PolyMNIST protocol (``bench.py:375-388``,
  ``examples/case_studies/partial_polymnist/global_config.py:55-84``): 5
  modalities of 3x28x28, ``EncoderConvMMNIST_adapted`` /
  ``DecoderConvMMNIST``, latent 512, Laplace decoders of scale 0.75, beta
  2.5, alpha 5/6, ReduceLROnPlateau(patience=30) on an eval set. The train
  set is an ``IncompleteDataset``: each (row, modality) is missing with
  probability 0.2, and a few rows have no modality at all. The eval set is
  complete, as PolyMNIST's test set is.

All: batch 256, Adam 1e-3, float32, seed 0. Only depth is cut (rows,
epochs).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

NAMES = ("mmvae", "mvtcae_mlp", "mvtcae_conv")
POLYMNIST = (3, 28, 28)
LATENT = 512
MISSING = 0.2   # partial PolyMNIST: share of (row, modality) pairs missing
SEED = 0


@dataclasses.dataclass
class Workload:
    model: torch.nn.Module
    train: object                 # a MultimodalBaseDataset
    eval: Optional[object]        # None: no eval set
    trainer_kwargs: dict          # BaseTrainerConfig fields besides epochs/seed


def _images(rng, n, dims):
    return {m: rng.random((n, *d), dtype=np.float32) for m, d in dims.items()}


def _trainer_kwargs(**extra):
    return dict(per_device_train_batch_size=256, per_device_eval_batch_size=256,
                learning_rate=1e-3, optimizer_cls="Adam", **extra)


def build(name: str, n: int = 2048, n_eval: int = 512, device="cuda") -> Workload:
    """The workload ``name`` (one of ``NAMES``) with ``n`` train rows."""
    from ..data import IncompleteDataset, MultimodalBaseDataset
    from ..models import MMVAE, MMVAEConfig, MVTCAE, MVTCAEConfig
    from ..nn import BaseAEConfig, DecoderConvMMNIST, EncoderConvMMNIST_adapted

    rng = np.random.default_rng(SEED)
    if name == "mmvae":
        dims = {f"m{i}": POLYMNIST for i in range(5)}
        model = MMVAE(MMVAEConfig(
            n_modalities=5, latent_dim=LATENT, K=10, input_dims=dims,
            decoders_dist={m: "laplace" for m in dims},
            prior_and_posterior_dist="laplace_with_softmax", loss="dreg_looser"),
            seed=SEED, device=device)
        return Workload(model, MultimodalBaseDataset(_images(rng, n, dims)), None,
                        _trainer_kwargs())
    if name == "mvtcae_mlp":
        dims = {"m0": (1, 28, 28), "m1": (3, 32, 32)}
        model = MVTCAE(MVTCAEConfig(
            n_modalities=2, latent_dim=LATENT, input_dims=dims,
            decoders_dist={m: "bernoulli" for m in dims}), seed=SEED, device=device)
        return Workload(model, MultimodalBaseDataset(_images(rng, n, dims)), None,
                        _trainer_kwargs())
    if name != "mvtcae_conv":
        raise ValueError(f"unknown workload {name!r}; expected one of {NAMES}")

    dims = {f"m{i}": POLYMNIST for i in range(5)}
    cfg = BaseAEConfig(latent_dim=LATENT, input_dim=POLYMNIST)
    encoders = {m: EncoderConvMMNIST_adapted(cfg) for m in dims}
    decoders = {m: DecoderConvMMNIST(cfg) for m in dims}
    generator = torch.Generator().manual_seed(SEED)
    for m in dims:  # user nets keep their weights: seed them here
        encoders[m].reset_parameters(generator)
        decoders[m].reset_parameters(generator)
    model = MVTCAE(MVTCAEConfig(
        n_modalities=5, latent_dim=LATENT, input_dims=dims,
        decoders_dist={m: "laplace" for m in dims},
        decoder_dist_params={m: {"scale": 0.75} for m in dims},
        beta=2.5, alpha=5.0 / 6.0), encoders=encoders, decoders=decoders,
        seed=SEED, device=device)

    data = _images(rng, n, dims)
    available = rng.random((n, len(dims))) >= MISSING
    available[dead_rows(n)] = False
    masks = {m: available[:, i] for i, m in enumerate(dims)}
    for m in dims:
        data[m][~masks[m]] = 0.0
    eval_set = MultimodalBaseDataset(_images(rng, n_eval, dims)) if n_eval else None
    return Workload(model, IncompleteDataset(data, masks), eval_set,
                    _trainer_kwargs(scheduler_cls="ReduceLROnPlateau",
                                    scheduler_params={"patience": 30}))


def dead_rows(n: int) -> np.ndarray:
    """Rows of ``mvtcae_conv``'s train set with no modality (row 5 among
    them, so the first 8 rows hold one)."""
    return np.arange(5, n, 509)
