"""MMVAE: Mixture-of-Experts multimodal VAE with K-sample objectives.

Counterpart of ``multivae_tpu/models/mmvae/mmvae_model.py``: the training
objectives and the inference methods (``encode`` from one random expert of
the conditioning subset, ``generate_from_prior`` from MMVAE's own prior,
``compute_joint_nll`` and ``compute_joint_nll_paper``).

- The K importance-sample axis is a leading axis (K, B, D); all M x M
  cross reconstructions go through one decoder call per recon modality on
  the stacked latents (M, K, B, D).
- The mixture density log q(z|X) is ``ops.kdist.mixture_logsumexp``: the
  CUDA mixture kernel on the card, its plain version on the CPU.
- DReG: pass 1 computes the importance weights under ``torch.no_grad``;
  pass 2 re-evaluates the log-weights on latents wrapped in
  ``ops.dreg.scale_grad`` so the z-path gradient picks up the w_k factor.
  The posterior parameters are detached inside the mixture density in both
  passes.
- Missing modalities: masked experts are filled with -1e30 inside the
  mixture logsumexp and masked terms carry exactly zero gradient.
- Every random draw goes through ``draw_noise`` and the random expert of
  ``encode`` and ``compute_joint_nll`` through ``draw_expert``, so a test
  can feed the JAX package's draws.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ...data.batch import MultimodalBatch, add_axes, as_batch
from ...ops.dreg import scale_grad
from ...ops.gaussian import sum_f32
from ...ops.iwae import chunked_logsumexp, iwae_log_marginal
from ...ops.kdist import (
    dist_log_prob,
    dist_rsample,
    dist_rsample_k,
    log_var_to_std,
    mixture_logsumexp,
    sample_noise,
)
from ...utils.model_output import ModelOutput
from ..base.base_ae_model import BaseMultiVAE, pick_expert, sum_except_batch
from ..base.step import StepInfo
from .mmvae_config import MMVAEConfig


class MMVAE(BaseMultiVAE):
    """Variational Mixture-of-Experts Autoencoder."""

    model_name = "MMVAE"
    # the objective is a sum over the rows (loss == loss_sum): the
    # trainer's microbatch_steps accumulates exact gradients over chunks
    loss_is_sum = True

    def __init__(self, model_config: MMVAEConfig, encoders: dict = None,
                 decoders: dict = None, seed: int = 0, device="cuda"):
        super().__init__(model_config, encoders, decoders, seed=seed,
                         device=device)
        self.dist_name = model_config.prior_and_posterior_dist
        self.K = model_config.K
        self.learn_prior = model_config.learn_prior
        self.objective = model_config.loss
        self.init_params()

    def _init_extra_params(self):
        # the prior mean is a fixed zero; its log-variance is learnable
        # iff learn_prior
        if self.learn_prior:
            return {"prior_log_var": nn.Parameter(torch.zeros(1, self.latent_dim))}
        return {}

    def pz_params(self):
        """(mean, std) of the prior, in ``param_dtype``."""
        mean = torch.zeros(1, self.latent_dim, device=self.device, dtype=self.param_dtype)
        log_var = self.prior_log_var if self.learn_prior else mean
        return mean, log_var_to_std(log_var, self.dist_name)

    # ------------------------------------------------------------ internals
    def _posterior_params(self, batch: MultimodalBatch, mods=None):
        mods = list(self.encoders.keys()) if mods is None else list(mods)
        out = {}
        for m in mods:
            o = self.encode_mod(m, batch.data[m])
            out[m] = (o["embedding"],
                      log_var_to_std(o["log_covariance"], self.dist_name))
        return out

    def draw_noise(self, shape, generator: Optional[torch.Generator] = None):
        """The sampling noise of one modality's K latents (see
        ``ops.kdist.sample_noise``) in ``param_dtype``; drawn in modality
        order."""
        return sample_noise(self.dist_name, shape, generator=generator,
                            dtype=self.param_dtype, device=self.device)

    def _sample_embeddings(self, post_params, K: int,
                           generator: Optional[torch.Generator] = None):
        zs = {}
        for m, (mu, sigma) in post_params.items():
            u = self.data_shard.draw(self.draw_noise, (K, *mu.shape), generator)
            zs[m] = dist_rsample_k(self.dist_name, mu, sigma, K, u=u)
        return zs

    def _compute_k_lws(self, batch: MultimodalBatch, post_params, zs,
                       detach_posteriors: bool):
        """Per-modality (K, B) log importance weights and the per-sample
        number of available modalities."""
        mods = list(post_params.keys())
        mask = torch.stack([batch.masks[m] for m in mods])   # (M, B)
        n_mods_sample = mask.sum(0).clamp_min(1.0)          # (B,)
        prior_mu, prior_std = self.pz_params()

        Z = torch.stack([zs[m] for m in mods])               # (M, K, B, D)
        lpz = sum_f32(dist_log_prob(self.dist_name, Z, prior_mu, prior_std))

        mus = torch.stack([post_params[m][0] for m in mods])  # (Mq, B, D)
        sigmas = torch.stack([post_params[m][1] for m in mods])
        if detach_posteriors:
            mus, sigmas = mus.detach(), sigmas.detach()
        lqz_x = (mixture_logsumexp(Z, mus, sigmas, mask, self.dist_name)
                 - torch.log(n_mods_sample))

        # sum_m log p(x_m | z): ONE decode per recon modality on (M*K*B)
        lpx_z = 0.0
        for recon_mod in mods:
            recon = self.decode_mod(recon_mod, Z)             # (M, K, B, *)
            lp = self.recon_log_probs[recon_mod](
                recon, add_axes(batch.data[recon_mod], 2))
            lp = sum_except_batch(lp, 3) * self.rescale_factors[recon_mod]
            lpx_z = lpx_z + lp * batch.masks[recon_mod][None, None, :]

        lw = (lpx_z + lpz - lqz_x) * mask[:, None, :]
        return {m: lw[i] for i, m in enumerate(mods)}, n_mods_sample

    # ----------------------------------------------------------------- loss
    def loss_function(self, batch: MultimodalBatch, step: Optional[StepInfo] = None,
                      generator: Optional[torch.Generator] = None) -> ModelOutput:
        post_params = self._posterior_params(batch)
        zs = self._sample_embeddings(post_params, self.K, generator)
        if self.objective == "dreg_looser":
            return self._dreg_looser(batch, post_params, zs)
        if self.objective == "iwae_looser":
            return self._iwae_looser(batch, post_params, zs)
        raise NotImplementedError(self.objective)

    def _dreg_looser(self, batch, post_params, zs):
        """DReG objective (reference ``dreg_looser``)."""
        with torch.no_grad():  # pass 1: importance weights only
            lws_val, _ = self._compute_k_lws(batch, post_params, zs,
                                             detach_posteriors=True)
            wk = {m: torch.exp(lw - torch.logsumexp(lw, 0, keepdim=True))
                  for m, lw in lws_val.items()}
        # pass 2: gradient path with the z-cotangent scaled by wk
        zs_hooked = {m: scale_grad(zs[m], wk[m][..., None]) for m in zs}
        lws, n_mods_sample = self._compute_k_lws(batch, post_params, zs_hooked,
                                                 detach_posteriors=True)
        total = torch.stack([lws[m] * wk[m] for m in lws]).sum(1)  # (M, B)
        total = total.sum(0) / n_mods_sample                       # (B,)
        loss = -(total * batch.weights).sum()
        return ModelOutput(loss=loss, loss_sum=loss, metrics={})

    def _iwae_looser(self, batch, post_params, zs):
        """IWAE objective (reference ``iwae_looser``)."""
        lws, n_mods_sample = self._compute_k_lws(batch, post_params, zs,
                                                 detach_posteriors=False)
        stacked = torch.stack(list(lws.values()))  # (M, K, B)
        k_est = torch.logsumexp(stacked, dim=1) - math.log(stacked.shape[1])
        per_sample = k_est.sum(0) / n_mods_sample
        loss = -(per_sample * batch.weights).sum()
        return ModelOutput(loss=loss, loss_sum=loss, metrics={})

    def _iwae(self, batch, post_params, zs):
        """Per-row log-likelihood: log-mean-exp over the K samples, then
        over the modalities (reference ``iwae``)."""
        lws, n_mods_sample = self._compute_k_lws(batch, post_params, zs,
                                                 detach_posteriors=False)
        stacked = torch.stack(list(lws.values()))  # (M, K, B)
        k_est = torch.logsumexp(stacked, dim=1) - math.log(stacked.shape[1])
        return torch.logsumexp(k_est, dim=0) - torch.log(n_mods_sample)

    # ------------------------------------------------------------ inference
    def _encode_subset(self, batch: MultimodalBatch, *, cond_mod: tuple, N: int,
                       return_mean: bool, flatten: bool,
                       generator: Optional[torch.Generator]) -> dict:
        """One random expert of the conditioning mixture, or the experts'
        mean with ``return_mean``."""
        post_params = self._posterior_params(batch, mods=cond_mod)
        mus = torch.stack([post_params[m][0] for m in cond_mod])
        if return_mean:
            emb = mus.mean(0)
            z = emb.expand(N, *emb.shape) if N > 1 else emb
        else:
            idx = self.draw_expert(len(cond_mod), generator)
            mu = pick_expert(mus, idx)
            sigma = pick_expert(torch.stack([post_params[m][1] for m in cond_mod]), idx)
            shape = mu.shape if N == 1 else (N, *mu.shape)
            z = dist_rsample(self.dist_name, mu, sigma, K=N,
                             u=self.data_shard.draw(self.draw_noise, shape, generator))
        if flatten:
            z = z.reshape(-1, self.latent_dim)
        return {"z": z}

    def generate_from_prior(self, n_samples: int,
                            generator: Optional[torch.Generator] = None) -> ModelOutput:
        """Latents from MMVAE's prior: (n_samples, latent_dim), or
        (latent_dim,) when n_samples == 1."""
        mean, std = self.pz_params()
        shape = (n_samples, *mean.shape) if n_samples > 1 else mean.shape
        z = dist_rsample(self.dist_name, mean, std, K=n_samples,
                         u=self.draw_noise(shape, generator))
        z = z.reshape(-1, self.latent_dim) if n_samples > 1 else z[0]
        return ModelOutput(z=z, one_latent_space=True)

    @torch.no_grad()
    def compute_joint_nll(self, inputs, K: int = 1000, batch_size_K: int = 100,
                          generator: Optional[torch.Generator] = None):
        """K-sample estimate of -sum_rows ln p(X): samples of one random
        expert, weighted by the mixture density (the logsumexp of the
        experts' densities over the number of modalities); complete data
        only."""
        self._check_complete_for_nll(inputs)
        batch = as_batch(inputs).to(self.device)
        post_params = self._posterior_params(batch)
        mods = list(post_params)
        e_mu, e_sigma = post_params[mods[self.draw_expert(len(mods), generator)]]
        prior_mu, prior_std = self.pz_params()

        def logw_chunk(chunk: int):
            z = dist_rsample_k(self.dist_name, e_mu, e_sigma, chunk,
                               u=self.data_shard.draw(self.draw_noise,
                                                      (chunk, *e_mu.shape), generator))
            lpx_z = 0.0
            for m in mods:
                recon = self.decode_mod(m, z)
                lpx_z = lpx_z + sum_except_batch(
                    self.recon_log_probs[m](recon, add_axes(batch.data[m])), 2)
            lpz = dist_log_prob(self.dist_name, z, prior_mu, prior_std).sum(-1)
            lqz = torch.logsumexp(torch.stack([
                dist_log_prob(self.dist_name, z, mu, sigma).sum(-1)
                for mu, sigma in post_params.values()]), 0) - math.log(self.n_modalities)
            return lpx_z + lpz - lqz

        ln_px = iwae_log_marginal(logw_chunk, K, batch_size_K)
        return -(ln_px * batch.weights).sum()

    @torch.no_grad()
    def compute_joint_nll_paper(self, inputs, K: int = 1000, batch_size_K: int = 10,
                                generator: Optional[torch.Generator] = None):
        """The paper's estimate: K samples of every expert through ``_iwae``
        (the mixture density), chunks combined by logsumexp; returns the
        (B,) per-row NLL."""
        batch = as_batch(inputs).to(self.device)
        post_params = self._posterior_params(batch)

        def chunk_lse(n: int):
            zs = self._sample_embeddings(post_params, n, generator)
            # undo _iwae's normalization by n and the modality count, so
            # chunks of different sizes combine exactly
            return self._iwae(batch, post_params, zs) + math.log(n * self.n_modalities)

        lse = chunked_logsumexp(chunk_lse, K, batch_size_K)
        return -(lse - math.log(K * self.n_modalities))
