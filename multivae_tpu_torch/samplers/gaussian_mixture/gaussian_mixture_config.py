"""GMM sampler config (counterpart of
``multivae_tpu/samplers/gaussian_mixture/gaussian_mixture_config.py``)."""

from __future__ import annotations

import dataclasses

from ..base.base_sampler_config import BaseSamplerConfig

FIT_BACKENDS = ("torch", "jax", "sklearn")


@dataclasses.dataclass
class GaussianMixtureSamplerConfig(BaseSamplerConfig):
    """Gaussian mixture sampler config.

    Args:
        n_components: number of Gaussians in the mixture.
        fit_backend: ``"torch"`` (default) fits the full-covariance GMM on
            the model's device (``ops/gmm.py``: k-means++ seeding, EM with a
            batched Cholesky E-step) and samples there; ``"jax"``, the JAX
            package's name for its device fit, means the same, so that its
            configs load; ``"sklearn"`` fits on the host with scikit-learn
            (``max_iter=2000, tol=1e-3`` in both).
        seed: seed of the device fit's k-means++ seeding and of its draws.
    """

    n_components: int = 10
    fit_backend: str = "torch"
    seed: int = 0

    def __post_init__(self):
        if self.fit_backend not in FIT_BACKENDS:
            raise ValueError(f"fit_backend must be one of {FIT_BACKENDS}, "
                             f"got {self.fit_backend!r}")
