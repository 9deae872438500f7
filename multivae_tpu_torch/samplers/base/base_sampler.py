"""BaseSampler: the fit / sample / save contract over a model's latent
space(s).

Counterpart of ``multivae_tpu/samplers/base/base_sampler.py``. ``sample()``
returns ``ModelOutput(z, one_latent_space[, modalities_z])``, the format
of ``model.encode``, so that ``model.decode`` takes it as it is. The
latents come from ``_collect_latents``: one ``model.encode`` per batch of
the dataset in order, padding rows dropped, the private codes collected for
a model with several latent spaces; they stay on the model's device.

On an incomplete dataset a model with
``supports_per_sample_conditioning`` (the PoE families: MVTCAE, MVAE,
CRMVAE, DMVAE, MHVAE) encodes each incomplete batch through
``encode_per_sample``: every row is conditioned on the modalities it has,
and DMVAE draws the private code of a modality a row lacks from N(0, I).
Every other model keeps ``model.encode``'s availability error, as in the
JAX package.

Not ported: the JAX package's device-resident collection (one compiled
scan over a cached dataset); the port runs the host loop.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

import torch

from ...data.loader import DataLoader

logger = logging.getLogger(__name__)


class BaseSampler:
    """Base class of the post-hoc latent samplers."""

    name = "BaseSampler"

    def __init__(self, model, sampler_config=None):
        from .base_sampler_config import BaseSamplerConfig

        if sampler_config is None:
            sampler_config = BaseSamplerConfig()
        self.model = model
        self.sampler_config = sampler_config
        self.is_fitted = False

    @property
    def device(self) -> torch.device:
        return self.model.device

    def fit(self, train_data, **kwargs):
        """Fit the sampler before sampling."""
        return

    def sample(self, n_samples: int = 1, batch_size: int = 500, **kwargs):
        raise NotImplementedError()

    def save(self, dir_path: str):
        """Save the sampler config as ``sampler_config.json``."""
        logger.info("Saving sampler in %s.", dir_path)
        os.makedirs(dir_path, exist_ok=True)
        self.sampler_config.save_json(dir_path, "sampler_config")

    def _check_fitted(self):
        if not self.is_fitted:
            raise ArithmeticError(
                "The sampler needs to be fitted by calling sampler.fit() method "
                "before sampling.")

    def _collect_latents(self, dataset, batch_size: int = 100,
                         generator: Optional[torch.Generator] = None):
        """Encode the whole dataset (all modalities) in order; returns (z,
        modalities_z or None) on the model's device, padding rows removed.
        An incomplete batch goes through the per-sample encode where the
        model has one, else through ``encode``, which refuses it."""
        per_sample = getattr(self.model, "supports_per_sample_conditioning", False)
        loader = DataLoader(dataset, batch_size=batch_size, shuffle=False,
                            drop_last=False)
        multi = self.model.multiple_latent_spaces
        zs, mod_zs = [], {m: [] for m in self.model.encoders} if multi else None
        with torch.no_grad():
            for batch in loader:
                if batch.incomplete and per_sample:
                    out = self.model.encode_per_sample(batch, generator=generator)
                else:
                    out = self.model.encode(batch, generator=generator)
                valid = (batch.weights > 0).to(out.z.device)
                zs.append(out.z[valid])
                if multi:
                    for m in mod_zs:
                        mod_zs[m].append(out.modalities_z[m][valid])
        z = torch.cat(zs)
        if multi:
            mod_zs = {m: torch.cat(v) for m, v in mod_zs.items()}
        return z, mod_zs
