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

``_collect_latents(..., device=True)`` (the MAF, IAF and GMM fits) reads
the batches from a copy of the dataset on the model's device
(``data/device_cache.py``): the trainer's, where it left one on
``dataset._sampler_device_cache``, or one built and memoized there
(``release_sampler_cache`` drops it). The same batches go through the same
encode, so the latents are the host loop's; where no cache can be built
(or the data are incomplete and the model has no per-sample encode) the
host loop runs.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

import torch

from ...data.device_cache import build_device_cache, upload_plan
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

    def _encode(self, batch, generator):
        """The latents of one batch: the per-sample encode for an incomplete
        batch where the model has one, else ``encode``, which refuses it."""
        if batch.incomplete and getattr(self.model, "supports_per_sample_conditioning",
                                        False):
            return self.model.encode_per_sample(batch, generator=generator)
        return self.model.encode(batch, generator=generator)

    def _encode_all(self, batches, n: int, generator):
        """(z, modalities_z or None) of the batches in order, cut to their
        first ``n`` rows: an in-order loader's padding is the tail."""
        multi = self.model.multiple_latent_spaces
        zs, mod_zs = [], {m: [] for m in self.model.encoders} if multi else None
        with torch.no_grad():
            for batch in batches:
                out = self._encode(batch, generator)
                zs.append(out.z)
                for m in mod_zs or ():
                    mod_zs[m].append(out.modalities_z[m])
        if multi:
            mod_zs = {m: torch.cat(v)[:n] for m, v in mod_zs.items()}
        return torch.cat(zs)[:n], mod_zs

    def _collect_latents(self, dataset, batch_size: int = 100,
                         generator: Optional[torch.Generator] = None, device: bool = False):
        """Encode the whole dataset (all modalities) in order; returns (z,
        modalities_z or None) on the model's device, padding rows removed.
        ``device=True`` gathers the batches from a device cache of the
        dataset (``_collect_latents_device``) where one can be had."""
        if device:
            out = self._collect_latents_device(dataset, batch_size, generator)
            if out is not None:
                return out
        loader = DataLoader(dataset, batch_size=batch_size, shuffle=False, drop_last=False)
        return self._encode_all(loader, len(dataset), generator)

    def _collect_latents_device(self, dataset, batch_size: int,
                                generator: Optional[torch.Generator] = None):
        """``_collect_latents`` over the dataset's device cache; None where
        there is none to be had, or where the cache is incomplete and the
        model has no per-sample encode (the host loop then raises)."""
        model = self.model
        cache = getattr(dataset, "_sampler_device_cache", None)
        if cache is None or cache.device != model.device:
            budget = int(getattr(self.sampler_config, "device_cache_budget_gb", 8.0) * 1e9)
            cache = build_device_cache(dataset, model.device, budget)
            if cache is None:
                return None
            # memoized: a later fit on this dataset reuses the upload
            dataset._sampler_device_cache = cache
        if cache.incomplete and not getattr(model, "supports_per_sample_conditioning",
                                            False):
            return None
        loader = DataLoader(dataset, batch_size=batch_size, shuffle=False, drop_last=False)
        idx, weights = upload_plan(loader, cache.device)
        return self._encode_all((cache.gather(idx[i], weights[i]) for i in range(len(idx))),
                                len(dataset), generator)
