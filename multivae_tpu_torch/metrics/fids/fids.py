"""FID evaluator: Fréchet distance per modality and conditioning subset
(counterpart of ``multivae_tpu/metrics/fids/fids.py``).

The embedders are callables from a tensor on the model's device to an
embedding (or a ModelOutput holding ``embedding``): by default one
InceptionV3 (``inception_networks.py``) shared by every modality, or the
user's ``custom_encoders``. The embeddings come to the host, where the
Fréchet distance is computed with numpy and ``scipy.linalg.sqrtm``, as in
the JAX package. Conditional FIDs sweep the subsets one at a time. Over a
process group each process embeds its columns' real rows (and their
generations) and the embeddings are gathered in the global batch's order
before the host's mean, covariance and Fréchet step; the prior's (or a
sampler's) draws are the global batch's, each process decoding its rows.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ...utils.model_output import ModelOutput
from ..base.evaluator_class import Evaluator
from ..base.subset_sweep import all_subsets
from .fids_config import FIDEvaluatorConfig


def _rows(latents, lo: int, hi: int, n: int):
    """Rows ``[lo, hi)`` of each tensor of ``latents`` (an ``encode``-style
    output of ``n`` rows) whose first axis holds the rows; a single draw's
    (latent,) is one row."""
    def take(v):
        if isinstance(v, dict):
            return {k: take(x) for k, x in v.items()}
        if isinstance(v, torch.Tensor) and v.dim():
            if n == 1 and v.dim() == 1:
                v = v[None]
            if v.shape[0] == n:
                return v[lo:hi]
        return v

    return ModelOutput(**{k: take(v) for k, v in latents.items()})


class AdaptShapeFID:
    """Make every sample (3, 299, 299) for the Inception embedder: vectors
    and maps gain axes, one channel is tiled to three, two get a zero third,
    more are cut to three, then a bilinear resize with antialiasing (the
    JAX package's ``jax.image.resize(..., "bilinear")``, which antialiases
    when it shrinks)."""

    def __init__(self, resize: bool = True, size=(299, 299)):
        self.resize = resize
        self.size = tuple(size)

    def __call__(self, x):
        x = torch.as_tensor(x)
        if x.ndim == 1:
            x = x[:, None]
        if x.ndim == 2:
            x = x[:, None]
        if x.ndim == 3:
            x = x[:, None]
        if x.ndim != 4:
            raise AttributeError("Can't compute FID for data with more than 3 dimensions")
        if x.shape[1] == 1:
            x = torch.cat([x] * 3, 1)
        elif x.shape[1] == 2:
            n, _, h, w = x.shape
            x = torch.cat([x, x.new_zeros((n, 1, h, w))], 1)
        else:
            x = x[:, :3]
        if self.resize:
            x = F.interpolate(x, size=self.size, mode="bilinear", align_corners=False,
                              antialias=True)
        return x


class FIDEvaluator(Evaluator):
    """Fréchet distance metrics.

    Args:
        model / test_dataset / output / eval_config / sampler / generator:
            see Evaluator.
        custom_encoders: modality -> callable(tensor) -> embedding to use
            instead of InceptionV3.
        transform: preprocessing applied before embedding (default: the
            FID shape adapter when using Inception, none otherwise).
    """

    def __init__(self, model, test_dataset, output=None, eval_config=None, sampler=None,
                 custom_encoders: Optional[Dict] = None, transform=None, generator=None):
        if eval_config is None:
            eval_config = FIDEvaluatorConfig()
        super().__init__(model, test_dataset, output, eval_config, sampler, generator)
        if custom_encoders is not None:
            self.model_fds = dict(custom_encoders)
        else:
            from .inception_networks import wrapper_inception

            inception = wrapper_inception(dims=eval_config.dims_inception,
                                          path_weights=eval_config.inception_weights_path,
                                          device=model.device)
            self.model_fds = {m: inception for m in model.encoders}
        if transform is not None:
            self.inception_transform = transform
        elif custom_encoders is None:
            self.inception_transform = AdaptShapeFID()
        else:
            self.inception_transform = None

    def _embed(self, mod, data) -> np.ndarray:
        if self.inception_transform is not None:
            data = self.inception_transform(data)
        pred = self.model_fds[mod](data)
        if isinstance(pred, dict):
            pred = pred["embedding"]
        return pred.detach().cpu().numpy()

    @torch.no_grad()
    def get_frechet_distance(self, mod, generate_latent_function):
        """Embeddings of the true and of the generated ``mod`` over the
        test set, then the Fréchet distance of their Gaussian fits.
        ``generate_latent_function(n, inputs=batch)`` gives the latents of
        a batch (of its ``n`` real rows, or of all its rows)."""
        acts_true, acts_gen = [], []
        for batch in self.test_loader:
            valid = batch.weights > 0
            n_valid = int(valid.sum())
            true_data = batch.data[mod][valid].to(self.model.device)
            acts_true.append(self._embed(mod, true_data))
            latents = generate_latent_function(n_valid, inputs=batch)
            gen = self.model.decode(latents, modalities=mod)[mod]
            if gen.shape[0] != n_valid:
                gen = gen[valid.to(gen.device)]
            acts_gen.append(self._embed(mod, gen))
            if self.shard.distributed:
                acts_true[-1], acts_gen[-1] = (
                    self.gather_valid(torch.from_numpy(a), valid).numpy()
                    for a in (acts_true[-1], acts_gen[-1]))

        act_true = np.concatenate(acts_true, axis=0)
        act_gen = np.concatenate(acts_gen, axis=0)
        mu1, mu2 = act_true.mean(0), act_gen.mean(0)
        s1 = np.cov(act_true, rowvar=False)
        s2 = np.cov(act_gen, rowvar=False)
        return self.calculate_frechet_distance(mu1, s1, mu2, s2)

    def calculate_frechet_distance(self, mu1, sigma1, mu2, sigma2, eps: float = 1e-6):
        """|mu1 - mu2|^2 + tr(sigma1 + sigma2 - 2 sqrt(sigma1 sigma2)), on the
        host; a singular product is retried with ``eps`` on the diagonals,
        and a square root whose diagonal has an imaginary part above 1e-3
        raises."""
        from scipy import linalg

        mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
        sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
        if mu1.shape != mu2.shape or sigma1.shape != sigma2.shape:
            raise ValueError(f"mean shapes {mu1.shape}, {mu2.shape} or covariance shapes "
                             f"{sigma1.shape}, {sigma2.shape} differ")
        diff = mu1 - mu2
        covmean = linalg.sqrtm(sigma1.dot(sigma2))
        if not np.isfinite(covmean).all():
            self.logger.info("fid calculation produces singular product; adding %s to "
                             "diagonal of cov estimates", eps)
            offset = np.eye(sigma1.shape[0]) * eps
            covmean = linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))
        if np.iscomplexobj(covmean):
            if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
                raise ValueError(f"Imaginary component {np.max(np.abs(covmean.imag))}")
            covmean = covmean.real
        return (diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2)
                - 2 * np.trace(covmean))

    def unconditional_fids(self):
        """The FID of each modality's generations from the prior (or the
        sampler)."""
        output = {}
        if self.sampler is None:
            def draw(n):
                return self.model.generate_from_prior(n, generator=self.generator)
        else:
            draw = self.sampler.sample

        def generate_function(n, inputs=None):
            if not self.shard.distributed:
                return draw(n)
            # the global batch's draw, alike on every process: this
            # process's real rows follow those of the ranks before it
            counts = self.shard.gather(torch.tensor([n], device=self.mesh.device)).tolist()
            lo = sum(counts[:self.mesh.rank])
            return _rows(draw(sum(counts)), lo, lo + n, sum(counts))

        sampler_name = "prior" if self.sampler is None else self.sampler.name
        for mod in self.model.encoders:
            self.logger.info("Start computing FID for modality %s", mod)
            fd = self.get_frechet_distance(mod, generate_function)
            output[f"fd_{mod}_sampler_{sampler_name}"] = fd
            self.logger.info("The FD for modality %s with sampler %s is %s", mod,
                             sampler_name, fd)
        self.metrics.update(output)
        return ModelOutput(**output)

    def eval(self):
        self.unconditional_fids()
        self.log_to_wandb()
        return ModelOutput(**self.metrics)

    def compute_fid_from_conditional_generation(self, subset, gen_mod):
        """The FID of ``gen_mod`` generated from ``subset``."""
        def generate_function(n_samples, inputs):
            with self.on_ranks():
                return self.model.encode(inputs, cond_mod=subset, generator=self.generator,
                                         ignore_incomplete=True)

        fd = self.get_frechet_distance(gen_mod, generate_function)
        self.logger.info("The FD for modality %s computed from subset=%s is %s", gen_mod,
                         subset, fd)
        self.metrics[f"Conditional FD from {'_'.join(subset)} to {gen_mod}"] = fd
        return fd

    def compute_all_conditional_fids(self, gen_mod):
        """The FID of ``gen_mod`` from every subset of the other modalities,
        and their mean by subset size."""
        by_size = {}
        for s in all_subsets([k for k in self.model.encoders if k != gen_mod]):
            fdn = by_size.setdefault(len(s), [])
            fdn.append(self.compute_fid_from_conditional_generation(list(s), gen_mod))
            self.metrics[f"Mean FD from {len(s)} modalities to {gen_mod}"] = float(
                np.mean(fdn))
        return ModelOutput(**self.metrics)
