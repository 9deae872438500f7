"""MMVAE+: a mixture-of-experts shared code u and a private code w per
modality.

Counterpart of ``multivae_tpu/models/mmvaePlus/mmvaePlus_model.py``:

- each modality's encoder gives a posterior over u and one over w; the
  cross-modal reconstructions draw the private code from the modality prior
  r_m, one (M, K, B, S) draw per recon modality with the self row replaced
  by the posterior sample, and decode the stacked (u, w) latents in one
  decoder call per recon modality;
- the K-sample objectives ``dreg_looser`` and ``iwae_looser`` weigh the
  divergence block by ``beta``; the mixture density of u is
  ``ops.kdist.mixture_logsumexp``, the CUDA mixture kernel on the card;
- DReG: pass 1 (the importance weights) decodes under ``torch.no_grad``;
  pass 2 re-decodes the latents wrapped in ``ops.dreg.scale_grad`` with the
  same prior draws, which keep their gradient to the priors' log-variance;
- inference: ``encode`` returns the shared code of one random expert and a
  private code per modality (the posterior's for the conditioning
  modalities, else the single or joint prior's), ``generate_from_prior``
  the full (u, w) code, which ``decode`` takes as is, and
  ``compute_joint_nll`` K // M samples of every expert.

Every draw goes through ``draw_noise`` (in the JAX package's order: u and w
per modality, then one prior draw per recon modality) and the random
expert through ``draw_expert``, so a test can feed the JAX package's draws.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ...data.batch import MultimodalBatch, add_axes, as_batch
from ...nn.default_architectures import (
    BaseDictDecodersMultiLatents,
    BaseDictEncoders_MultiLatents,
)
from ...ops.dreg import scale_grad
from ...ops.gaussian import sum_f32
from ...ops.iwae import chunked_logsumexp
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
from .mmvaePlus_config import MMVAEPlusConfig


class MMVAEPlus(BaseMultiVAE):
    """The MMVAE+ model."""

    model_name = "MMVAEPlus"
    # the objective is a sum over the rows (loss == loss_sum): the
    # trainer's microbatch_steps accumulates exact gradients over chunks
    loss_is_sum = True

    def __init__(self, model_config: MMVAEPlusConfig, encoders: dict = None,
                 decoders: dict = None, seed: int = 0, device="cuda"):
        if model_config.modalities_specific_dim is None:
            raise AttributeError(
                "The modalities_specific_dim attribute must be provided in "
                "the model config.")
        super().__init__(model_config, encoders, decoders, seed=seed, device=device)
        self.dist_name = model_config.prior_and_posterior_dist
        self.K = model_config.K
        self.beta = model_config.beta
        self.objective = model_config.loss
        self.modalities_specific_dim = model_config.modalities_specific_dim
        self.reconstruction_option = model_config.reconstruction_option
        self.multiple_latent_spaces = True
        self.style_dims = {m: self.modalities_specific_dim for m in self.encoders}
        self.init_params()

    def default_encoders(self, model_config) -> dict:
        return BaseDictEncoders_MultiLatents(
            model_config.input_dims, model_config.latent_dim,
            {m: model_config.modalities_specific_dim for m in model_config.input_dims})

    def default_decoders(self, model_config) -> dict:
        return BaseDictDecodersMultiLatents(
            model_config.input_dims, model_config.latent_dim,
            {m: model_config.modalities_specific_dim for m in model_config.input_dims})

    def _init_extra_params(self):
        """The log-variances of the modality priors r_m and of the shared
        prior p, learnable per the config (their means are fixed zeros)."""
        extra = {}
        if self.model_config.learn_modality_prior:
            for m in self.encoders:
                extra[f"prior_log_var_{m}"] = nn.Parameter(
                    torch.zeros(1, self.modalities_specific_dim))
        if self.model_config.learn_shared_prior:
            extra["prior_log_var_shared"] = nn.Parameter(
                torch.zeros(1, self.latent_dim + self.modalities_specific_dim))
        return extra

    def _modality_prior(self, mod: str):
        """(mean, std) of r_mod, (1, S), in ``param_dtype``."""
        mean = torch.zeros(1, self.modalities_specific_dim, device=self.device,
                           dtype=self.param_dtype)
        log_var = (getattr(self, f"prior_log_var_{mod}")
                   if self.model_config.learn_modality_prior else mean)
        return mean, log_var_to_std(log_var, self.dist_name)

    def pz_params(self):
        """(mean, std) of the prior of the full (u, w) code, (1, D + S), in
        ``param_dtype``."""
        mean = torch.zeros(1, self.latent_dim + self.modalities_specific_dim,
                           device=self.device, dtype=self.param_dtype)
        log_var = (self.prior_log_var_shared
                   if self.model_config.learn_shared_prior else mean)
        return mean, log_var_to_std(log_var, self.dist_name)

    def draw_noise(self, shape, generator: Optional[torch.Generator] = None):
        """The sampling noise of one draw (see ``ops.kdist.sample_noise``),
        in ``param_dtype``."""
        return sample_noise(self.dist_name, shape, generator=generator,
                            dtype=self.param_dtype, device=self.device)

    # ------------------------------------------------------------ internals
    def _posteriors(self, batch: MultimodalBatch, mods=None):
        mods = list(self.encoders.keys()) if mods is None else list(mods)
        out = {}
        for m in mods:
            o = self.encode_mod(m, batch.data[m])
            out[m] = {"u": (o["embedding"],
                            log_var_to_std(o["log_covariance"], self.dist_name)),
                      "w": (o["style_embedding"],
                            log_var_to_std(o["style_log_covariance"], self.dist_name))}
        return out

    def _sample_embeddings(self, posteriors, K: int,
                           generator: Optional[torch.Generator] = None):
        """(K, B, D) and (K, B, S) samples of u and w, modality by modality."""
        zs = {}
        for m, post in posteriors.items():
            zs[m] = {}
            for code in ("u", "w"):
                mu, sigma = post[code]
                zs[m][code] = dist_rsample_k(
                    self.dist_name, mu, sigma, K,
                    u=self.data_shard.draw(self.draw_noise, (K, *mu.shape), generator))
        return zs

    def _cross_prior_draws(self, zs, K: int,
                           generator: Optional[torch.Generator] = None):
        """Per recon modality, the private codes of the cross-modal
        reconstructions: an (M, K, B, S) draw from its prior r_m."""
        mods = list(zs)
        M, B = len(mods), zs[mods[0]]["u"].shape[1]
        cross_w = {}
        for recon_mod in mods:
            p_mu, p_std = self._modality_prior(recon_mod)
            shape = (M, B, self.modalities_specific_dim)
            w_prior = dist_rsample_k(self.dist_name, p_mu.expand(shape),
                                     p_std.expand(shape), K,
                                     u=self.data_shard.draw(self.draw_noise, (K, *shape),
                                                            generator))
            cross_w[recon_mod] = w_prior.movedim(0, 1)  # (M, K, B, S)
        return cross_w

    def _decode_with_latents(self, zs, cross_w):
        """All M x M reconstructions, one decoder call per recon modality on
        the stacked (M, K, B, D + S) latents: row j of recon modality j holds
        its own posterior sample w, the others its prior draws."""
        mods = list(zs)
        U = torch.stack([zs[m]["u"] for m in mods])  # (M, K, B, D)
        out = {}
        for j, recon_mod in enumerate(mods):
            W = cross_w[recon_mod]
            W = torch.cat([W[:j], zs[recon_mod]["w"][None], W[j + 1:]])
            out[recon_mod] = self.decode_mod(recon_mod, torch.cat([U, W], -1))
        return out

    def _k_lw_terms(self, batch: MultimodalBatch, posteriors, zs, recons,
                    detach_posteriors: bool, unit_rescale: bool = False) -> dict:
        """The terms of the log importance weights that MMVAE+ and CMVAE
        share, on the stacked (M, K, B) layout: the availability ``mask``
        (M, B) and ``n_mods_sample`` (B,), the samples ``U`` and ``W``, the
        mixture density of u ``lqu_x`` (the one mixture call), the private
        posterior's ``lqw_x`` and the masked reconstruction term ``lpx_z``.
        ``detach_posteriors`` stops the gradient to the posteriors'
        parameters in both densities (DReG)."""
        mods = list(posteriors)
        mask = torch.stack([batch.masks[m] for m in mods])  # (M, B)
        n_mods_sample = mask.sum(0).clamp_min(1.0)
        U = torch.stack([zs[m]["u"] for m in mods])           # (M, K, B, D)
        W = torch.stack([zs[m]["w"] for m in mods])           # (M, K, B, S)

        stacked = [torch.stack([posteriors[m][code][i] for m in mods])
                   for code in ("u", "w") for i in (0, 1)]
        if detach_posteriors:
            stacked = [t.detach() for t in stacked]
        u_mu, u_sig, w_mu, w_sig = stacked
        # the mixture over experts of the shared code: (M, K, B)
        lqu_x = (mixture_logsumexp(U, u_mu, u_sig, mask, self.dist_name)
                 - torch.log(n_mods_sample))
        # the private posterior, own modality only: (M, K, B)
        lqw_x = sum_f32(dist_log_prob(self.dist_name, W, w_mu[:, None], w_sig[:, None]))

        lpx_z = 0.0
        for recon_mod in mods:
            lp = self.recon_log_probs[recon_mod](
                recons[recon_mod], add_axes(batch.data[recon_mod], 2))
            factor = 1.0 if unit_rescale else self.rescale_factors[recon_mod]
            lp = sum_except_batch(lp, 3) * factor
            lpx_z = lpx_z + lp * batch.masks[recon_mod][None, None, :]
        return {"mask": mask, "n_mods_sample": n_mods_sample, "U": U, "W": W,
                "lqu_x": lqu_x, "lqw_x": lqw_x, "lpx_z": lpx_z}

    def _compute_k_lws(self, batch: MultimodalBatch, posteriors, zs, recons,
                       detach_posteriors: bool, beta: Optional[float] = None,
                       unit_rescale: bool = False):
        """Per-modality (K, B) log importance weights and the per-sample
        number of available modalities."""
        beta = self.beta if beta is None else beta
        t = self._k_lw_terms(batch, posteriors, zs, recons, detach_posteriors,
                             unit_rescale)
        pz_mu, pz_std = self.pz_params()
        lpz = sum_f32(dist_log_prob(self.dist_name, torch.cat([t["U"], t["W"]], -1), pz_mu,
                                    pz_std))
        lw = (t["lpx_z"] + beta * (lpz - t["lqu_x"] - t["lqw_x"])) * t["mask"][:, None, :]
        return {m: lw[i] for i, m in enumerate(posteriors)}, t["n_mods_sample"]

    # ----------------------------------------------------------------- loss
    def loss_function(self, batch: MultimodalBatch, step: Optional[StepInfo] = None,
                      generator: Optional[torch.Generator] = None) -> ModelOutput:
        posteriors = self._posteriors(batch)
        zs = self._sample_embeddings(posteriors, self.K, generator)
        cross_w = self._cross_prior_draws(zs, self.K, generator)
        if self.objective == "dreg_looser":
            return self._dreg_looser(batch, posteriors, zs, cross_w)
        if self.objective == "iwae_looser":
            return self._iwae_looser(batch, posteriors, zs,
                                     self._decode_with_latents(zs, cross_w))
        raise NotImplementedError(self.objective)

    def _dreg_looser(self, batch, posteriors, zs, cross_w):
        """DReG objective (reference ``_dreg_looser``)."""
        with torch.no_grad():  # pass 1: importance weights only
            recons = self._decode_with_latents(zs, cross_w)
            lws_val, _ = self._compute_k_lws(batch, posteriors, zs, recons,
                                             detach_posteriors=True)
            wk = {m: torch.exp(lw - torch.logsumexp(lw, 0, keepdim=True))
                  for m, lw in lws_val.items()}
        # pass 2: re-decode with the z-cotangent scaled by wk, same prior draws
        zs_hooked = {m: {c: scale_grad(z, wk[m][..., None]) for c, z in zs[m].items()}
                     for m in zs}
        recons_hooked = self._decode_with_latents(zs_hooked, cross_w)
        lws, n_mods_sample = self._compute_k_lws(batch, posteriors, zs_hooked,
                                                 recons_hooked, detach_posteriors=True)
        total = torch.stack([lws[m] * wk[m] for m in lws]).sum(1)  # (M, B)
        total = total.sum(0) / n_mods_sample
        loss = -(total * batch.weights).sum()
        return ModelOutput(loss=loss, loss_sum=loss, metrics={})

    def _iwae_looser(self, batch, posteriors, zs, recons):
        """IWAE objective (reference ``_iwae_looser``)."""
        lws, n_mods_sample = self._compute_k_lws(batch, posteriors, zs, recons,
                                                 detach_posteriors=False)
        stacked = torch.stack(list(lws.values()))  # (M, K, B)
        k_est = torch.logsumexp(stacked, dim=1) - math.log(stacked.shape[1])
        per_sample = k_est.sum(0) / n_mods_sample
        loss = -(per_sample * batch.weights).sum()
        return ModelOutput(loss=loss, loss_sum=loss, metrics={})

    # ------------------------------------------------------------ inference
    def _style_prior(self, mod: str):
        """(mean, std) of mod's private code outside the conditioning subset:
        r_mod ('single_prior') or the private part of p ('joint_prior')."""
        if self.reconstruction_option == "single_prior":
            return self._modality_prior(mod)
        pz_mu, pz_std = self.pz_params()
        return pz_mu[:, self.latent_dim:], pz_std[:, self.latent_dim:]

    def _shared_posterior(self, posteriors, cond_mod: tuple, return_mean: bool,
                          generator: Optional[torch.Generator]):
        """(mean, std) that ``encode`` samples the shared code from: the
        mean of the subset's means (std unused) with ``return_mean``, else
        the posterior of one random conditioning modality."""
        if return_mean:
            return torch.stack([posteriors[m]["u"][0] for m in cond_mod]).mean(0), None
        idx = self.draw_expert(len(cond_mod), generator)
        return tuple(pick_expert(torch.stack([posteriors[m]["u"][i] for m in cond_mod]), idx)
                     for i in range(2))

    def _encode_subset(self, batch: MultimodalBatch, *, cond_mod: tuple, N: int,
                       return_mean: bool, flatten: bool,
                       generator: Optional[torch.Generator]) -> dict:
        posteriors = self._posteriors(batch, mods=cond_mod)
        B = batch.n_samples

        def sample(mu, std):
            if return_mean:
                return mu.expand(N, *mu.shape) if N > 1 else mu
            shape = mu.shape if N == 1 else (N, *mu.shape)
            return dist_rsample(self.dist_name, mu, std, K=N,
                                u=self.data_shard.draw(self.draw_noise, shape, generator))

        z = sample(*self._shared_posterior(posteriors, cond_mod, return_mean, generator))
        style_z = {}
        for m in self.encoders:
            if m in cond_mod:
                mu_m, std_m = posteriors[m]["w"]
            else:
                mu_m, std_m = (t.expand(B, -1) for t in self._style_prior(m))
            style_z[m] = sample(mu_m, std_m)
        if flatten:
            z = z.reshape(-1, self.latent_dim)
            style_z = {m: w.reshape(-1, self.modalities_specific_dim)
                       for m, w in style_z.items()}
        return {"z": z, "modalities_z": style_z}

    def generate_from_prior(self, n_samples: int,
                            generator: Optional[torch.Generator] = None) -> ModelOutput:
        """Full (u, w) codes from the prior p: (n_samples, D + S), or
        (D + S,) when n_samples == 1."""
        mean, std = self.pz_params()
        shape = (n_samples, *mean.shape) if n_samples > 1 else mean.shape
        z = dist_rsample(self.dist_name, mean, std, K=n_samples,
                         u=self.draw_noise(shape, generator))
        z = z.reshape(-1, z.shape[-1]) if n_samples > 1 else z[0]
        return ModelOutput(z=z, one_latent_space=True)

    def decode(self, embedding: ModelOutput, modalities="all") -> ModelOutput:
        """Decode; a one-latent-space code of width D + S (a prior sample)
        is decoded as the full (u, w) code."""
        if (embedding.get("one_latent_space", True) and embedding["z"].shape[-1]
                == self.latent_dim + self.modalities_specific_dim):
            return ModelOutput(**self._decode_mods(
                embedding["z"], self._decode_modalities(modalities)))
        return super().decode(embedding, modalities)

    @torch.no_grad()
    def compute_joint_nll(self, inputs, K: int = 1000, batch_size_K: int = 100,
                          generator: Optional[torch.Generator] = None):
        """K-sample estimate of -sum_rows ln p(X): K // M samples of every
        expert, their log-weights (beta 1, no rescaling) combined by
        logsumexp over experts and samples; complete data only."""
        self._check_complete_for_nll(inputs)
        batch = as_batch(inputs).to(self.device)
        k_iwae = max(K // self.n_modalities, 1)
        posteriors = self._posteriors(batch)

        def chunk_lse(n: int):
            zs = self._sample_embeddings(posteriors, n, generator)
            recons = self._decode_with_latents(
                zs, self._cross_prior_draws(zs, n, generator))
            lws, _ = self._compute_k_lws(batch, posteriors, zs, recons,
                                         detach_posteriors=False, beta=1.0,
                                         unit_rescale=True)
            return torch.logsumexp(torch.cat(list(lws.values())), 0)

        lse = chunked_logsumexp(chunk_lse, k_iwae, max(min(batch_size_K, k_iwae), 1))
        ll = lse - math.log(k_iwae * self.n_modalities)
        return -(ll * batch.weights).sum()
