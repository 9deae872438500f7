"""Gaussian-mixture sampler over a model's latent space(s).

Counterpart of
``multivae_tpu/samplers/gaussian_mixture/gaussian_mixture_sampler.py``:
one full-covariance GMM per latent space (the shared one, and each
modality's private one for a multi-latent model), fitted on the device by
default (``ops/gmm.py``; fit ``i`` seeded with ``seed + i``) and sampled
there with fresh draws on each call, or fitted on the host with
scikit-learn (``fit_backend="sklearn"``, imported only then). More
components than latents are cut to the number of latents, with a warning.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from ...ops import gmm as gmm_ops
from ...utils.model_output import ModelOutput
from ..base.base_sampler import BaseSampler
from .gaussian_mixture_config import GaussianMixtureSamplerConfig

logger = logging.getLogger(__name__)


class GaussianMixtureSampler(BaseSampler):
    """Fits a full-covariance GMM per latent space."""

    name = "GaussianMixtureSampler"

    def __init__(self, model, sampler_config=None):
        if sampler_config is None:
            sampler_config = GaussianMixtureSamplerConfig()
        super().__init__(model, sampler_config)
        self.n_components = sampler_config.n_components
        self.fit_backend = sampler_config.fit_backend
        self.seed = sampler_config.seed
        self.generator = None

    def _fit_one(self, data, i: int):
        if self.fit_backend == "sklearn":
            from sklearn import mixture

            g = mixture.GaussianMixture(n_components=self.n_components,
                                        covariance_type="full", max_iter=2000, verbose=0,
                                        tol=1e-3)
            g.fit(data.cpu().numpy())
            return g
        generator = torch.Generator(device=data.device).manual_seed(self.seed + i)
        return gmm_ops.fit_gmm(data, self.n_components, generator)

    def fit(self, train_data, **kwargs):
        """Encode the train set and fit a GMM per latent space."""
        # the torch fit takes the latents where they are: collect them on the device
        z, mod_z = self._collect_latents(train_data, device=self.fit_backend == "torch")
        if self.n_components > z.shape[0]:
            self.n_components = z.shape[0]
            logger.warning("Setting the number of components to %d since n_components "
                           "> n_samples when fitting the gmm", z.shape[0])
        self.gmm = self._fit_one(z, 0)
        if mod_z is not None:
            self.mod_gmms = {m: self._fit_one(v, 1 + i)
                             for i, (m, v) in enumerate(mod_z.items())}
        # each sample() call draws anew from this generator
        self.generator = torch.Generator(device=self.device).manual_seed(self.seed)
        self.is_fitted = True

    def _draw(self, g, n_samples: int):
        if self.fit_backend == "sklearn":
            return torch.tensor(g.sample(n_samples)[0].astype(np.float32),
                                device=self.device)
        return gmm_ops.sample_gmm(g, n_samples, self.generator)

    def sample(self, n_samples: int = 1, batch_size: int = 500, **kwargs) -> ModelOutput:
        """Latents in the ``model.encode`` output format."""
        self._check_fitted()
        output = ModelOutput(z=self._draw(self.gmm, n_samples),
                             one_latent_space=not self.model.multiple_latent_spaces)
        if self.model.multiple_latent_spaces:
            output["modalities_z"] = {m: self._draw(g, n_samples)
                                      for m, g in self.mod_gmms.items()}
        return output
