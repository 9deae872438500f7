"""DMVAE: shared and private latent spaces, trained on the joint ELBO and
the ELBO of each unimodal shared posterior.

Counterpart of ``multivae_tpu/models/dmvae/dmvae_model.py``:

- the shared posterior is the product of the available experts and the
  prior expert N(0, I); each modality also has a private posterior;
- the loss sums M+1 negative ELBOs a row: the joint posterior's and each
  modality's shared posterior's (that one times the modality's mask), all
  in one stacked pass (each decoder takes (M+1, B) rows). Each ELBO draws
  its own shared code and its own private code of every modality:
  ``draw_noise`` gives the shared noise of the M+1 ELBOs, then each
  modality's private noise of the M+1 ELBOs. Reconstructions of available
  modalities are weighed by the rescale factors, the shared KL by ``beta``,
  each private KL by its modality's mask and ``private_betas``;
- encode: the conditioning modalities' shared PoE (with the prior expert);
  private codes from the posterior for conditioning modalities, from
  N(0, I) for the others; ``encode_per_sample`` draws a row's private code
  of a modality it lacks from N(0, I) too;
- the K-sample joint NLL weighs samples of the joint shared posterior and of
  every private posterior by p(X|z) p(z) / q(z|X). The JAX package resets
  the ln-prior and ln-posterior terms each chunk (its module docstring says
  why it departs from the reference there); so does the port.
"""

from __future__ import annotations

from typing import Optional

import torch

from ...data.batch import MultimodalBatch, add_axes, as_batch
from ...nn.default_architectures import (
    BaseDictDecodersMultiLatents,
    BaseDictEncoders_MultiLatents,
)
from ...ops.gaussian import (
    gaussian_log_prob,
    kl_divergence,
    rsample_from_gaussian,
    stable_poe,
    sum_f32,
)
from ...ops.iwae import iwae_log_marginal
from ...utils.model_output import ModelOutput
from ..base.base_ae_model import BaseMultiVAE, sum_except_batch
from ..base.step import StepInfo
from .dmvae_config import DMVAEConfig


def _std_normal_kl(mu, log_var):
    zeros = torch.zeros_like(mu)
    return kl_divergence(mu, log_var, zeros, zeros)


class DMVAE(BaseMultiVAE):
    """DMVAE: a shared latent space and a private one per modality."""

    model_name = "DMVAE"
    supports_per_sample_conditioning = True
    masked_encode_per_sample_flag = True

    def __init__(self, model_config: DMVAEConfig, encoders: dict = None,
                 decoders: dict = None, seed: int = 0, device="cuda"):
        super().__init__(model_config, encoders, decoders, seed=seed, device=device)
        self.beta = model_config.beta
        self.multiple_latent_spaces = True
        dims = model_config.modalities_specific_dim
        betas = model_config.modalities_specific_betas
        if dims is not None and dims.keys() != self.encoders.keys():
            raise AttributeError(
                "The keys in modalities_specific_dim don't match the keys in the "
                "encoders or input_dims")
        if betas is not None and betas.keys() != self.encoders.keys():
            raise AttributeError(
                "The modality_specific_betas doesn't have the same keys "
                "(modalities) as the provided encoders dict.")
        self.style_dims = dict(dims) if dims is not None else {m: 1 for m in self.encoders}
        self.private_betas = (dict(betas) if betas is not None
                              else {m: 1.0 for m in self.encoders})
        self.init_params()

    def default_encoders(self, model_config) -> dict:
        return BaseDictEncoders_MultiLatents(model_config.input_dims, model_config.latent_dim,
                                             model_config.modalities_specific_dim)

    def default_decoders(self, model_config) -> dict:
        return BaseDictDecodersMultiLatents(model_config.input_dims, model_config.latent_dim,
                                            model_config.modalities_specific_dim)

    # ------------------------------------------------------------ posterior
    def _infer_latent_parameters(self, batch: MultimodalBatch, subset=None):
        """The shared PoE of ``subset`` (default all) with the prior expert,
        each modality's shared (mu, log_var) and private (mu, log_var)."""
        subset = list(self.encoders) if subset is None else list(subset)
        outs = {m: self.encode_mod(m, batch.data[m]) for m in subset}
        shared = {m: (o["embedding"], o["log_covariance"]) for m, o in outs.items()}
        private = {m: (o["style_embedding"], o["style_log_covariance"])
                   for m, o in outs.items()}
        mus = torch.stack([o["embedding"] for o in outs.values()])
        lvs = torch.stack([o["log_covariance"] for o in outs.values()])
        mask = torch.stack([batch.masks[m] for m in subset])
        joint_mu, joint_lv = stable_poe(
            torch.cat([mus, torch.zeros_like(mus[:1])]),
            torch.cat([lvs, torch.zeros_like(lvs[:1])]),
            torch.cat([mask, torch.ones_like(mask[:1])]))
        return joint_mu, joint_lv, shared, private

    # ----------------------------------------------------------------- loss
    def loss_function(self, batch: MultimodalBatch, step: Optional[StepInfo] = None,
                      generator: Optional[torch.Generator] = None) -> ModelOutput:
        joint_mu, joint_lv, shared, private = self._infer_latent_parameters(batch)
        mods = list(self.encoders)
        E = len(mods) + 1      # the joint ELBO, then one per modality
        q_mu = torch.stack([joint_mu] + [shared[m][0] for m in mods])       # (E, B, D)
        q_lv = torch.stack([joint_lv] + [shared[m][1] for m in mods])
        shard = self.data_shard
        shared_z = rsample_from_gaussian(q_mu, q_lv, noise=shard.draw(
            self.draw_noise, q_mu.shape, generator))
        recon = 0.0
        kl = _std_normal_kl(q_mu, q_lv) * self.beta                          # (E, B)
        for m in mods:
            mu_p, lv_p = private[m]
            z_p = rsample_from_gaussian(mu_p, lv_p, N=E, noise=shard.draw(
                self.draw_noise, (E, *mu_p.shape), generator))
            out = self.decode_mod(m, torch.cat([shared_z, z_p], -1))
            rec = sum_except_batch(self.recon_log_probs[m](out, add_axes(batch.data[m]))
                                   * self.rescale_factors[m], batch_ndims=2)
            recon = recon + rec * batch.masks[m]
            kl = kl + _std_normal_kl(mu_p, lv_p) * batch.masks[m] * self.private_betas[m]
        elbos = kl - recon                                                  # (E, B)

        w = batch.weights
        n_data = shard.total(w.sum()).clamp_min(1.0)
        loss = elbos[0]
        metrics = {"joint": (elbos[0] * w).sum() / n_data}
        for i, m in enumerate(mods):
            mod_elbo = elbos[i + 1] * batch.masks[m]
            loss = loss + mod_elbo
            metrics[m] = (mod_elbo * w).sum() / n_data
        loss_sum = (loss * w).sum()
        return ModelOutput(loss=loss_sum / n_data, loss_sum=loss_sum, metrics=metrics)

    # ------------------------------------------------------------ inference
    def _encode_subset(self, batch: MultimodalBatch, *, cond_mod: tuple, N: int,
                       return_mean: bool, flatten: bool,
                       generator: Optional[torch.Generator],
                       per_sample: bool = False) -> dict:
        """With ``per_sample`` a row's private code of a conditioning
        modality it lacks comes from N(0, I) (the posterior's parameters
        times the row's mask), as the JAX package's ``per_sample=True``
        masked encode does."""
        joint_mu, joint_lv, _, private = self._infer_latent_parameters(batch, cond_mod)
        z = self._sample(joint_mu, joint_lv, N, return_mean, flatten, generator)
        modalities_z = {}
        for m in self.encoders:
            if m in cond_mod:
                mu_p, lv_p = private[m]
                if per_sample:
                    sel = batch.masks[m][:, None]
                    mu_p, lv_p = sel * mu_p, sel * lv_p
            else:
                mu_p = lv_p = torch.zeros(joint_mu.shape[0], self.style_dims[m],
                                          device=joint_mu.device)
            modalities_z[m] = self._sample(mu_p, lv_p, N, return_mean, flatten, generator)
        return {"z": z, "modalities_z": modalities_z}

    def generate_from_prior(self, n_samples: int,
                            generator: Optional[torch.Generator] = None) -> ModelOutput:
        """Shared and private codes from N(0, I): (n_samples, dim) each, or
        (dim,) when n_samples == 1."""
        def draw(dim):
            return self.draw_noise((n_samples, dim) if n_samples > 1 else (dim,), generator)

        z = draw(self.latent_dim)
        return ModelOutput(z=z, one_latent_space=False,
                           modalities_z={m: draw(d) for m, d in self.style_dims.items()})

    @torch.no_grad()
    def compute_joint_nll(self, inputs, K: int = 1000, batch_size_K: int = 100,
                          generator: Optional[torch.Generator] = None):
        """K-sample IWAE estimate of -sum_rows ln p(X); complete data only."""
        self._check_complete_for_nll(inputs)
        batch = as_batch(inputs).to(self.device)
        joint_mu, joint_lv, _, private = self._infer_latent_parameters(batch)

        def log_densities(z, mu, log_var):
            zeros = torch.zeros_like(z)
            return (sum_f32(gaussian_log_prob(z, zeros, zeros))
                    - sum_f32(gaussian_log_prob(z, mu[None], log_var[None])))

        def logw_chunk(chunk: int):
            z = rsample_from_gaussian(joint_mu, joint_lv, N=chunk, noise=self.data_shard.draw(
                self.draw_noise, (chunk, *joint_mu.shape), generator))
            logw = log_densities(z, joint_mu, joint_lv)
            for m in self.decoders:
                mu_p, lv_p = private[m]
                z_p = rsample_from_gaussian(mu_p, lv_p, N=chunk, noise=self.data_shard.draw(
                    self.draw_noise, (chunk, *mu_p.shape), generator))
                out = self.decode_mod(m, torch.cat([z, z_p], -1))
                logw = logw + sum_except_batch(
                    self.recon_log_probs[m](out, add_axes(batch.data[m])), batch_ndims=2)
                logw = logw + log_densities(z_p, mu_p, lv_p)
            return logw

        ln_px = iwae_log_marginal(logw_chunk, K, batch_size_K)
        return -(ln_px * batch.weights).sum()
