"""MVTCAE: total-correlation multimodal VAE (counterpart of
``multivae_tpu/models/mvtcae/mvtcae_model.py``).

The joint posterior is the masked Product of Experts of the unimodal
posteriors (``ops.gaussian.masked_poe``): a missing modality has zero
precision, and a row with none falls back to N(0, I). The loss is
``rec * (M - alpha) / M + beta * (alpha / M * sum_m KL(joint || q_m) +
(1 - alpha) * KL(joint || prior))``, with the per-modality terms zeroed
where the modality is missing; ``loss`` is the sum over the batch divided
by the number of real rows, ``loss_sum`` the sum.
"""

from __future__ import annotations

from typing import Optional

import torch

from ...data.batch import MultimodalBatch, as_batch
from ...ops.gaussian import masked_poe, rsample_from_gaussian, sum_f32
from ...utils.model_output import ModelOutput
from ..base.base_ae_model import BaseMultiVAE, sum_except_batch
from ..base.step import StepInfo
from .mvtcae_config import MVTCAEConfig


class MVTCAE(BaseMultiVAE):
    """MVTCAE model. See the config for the hyperparameters."""

    model_name = "MVTCAE"
    supports_per_sample_conditioning = True

    def __init__(self, model_config: MVTCAEConfig, encoders: dict = None,
                 decoders: dict = None, seed: int = 0, device="cuda"):
        super().__init__(model_config, encoders, decoders, seed=seed,
                         device=device)
        self.alpha = model_config.alpha
        self.beta = model_config.beta
        self.init_params()

    def _joint_posterior(self, batch: MultimodalBatch, mods=None):
        """PoE of the masked unimodal posteriors: (joint_mu, joint_log_var,
        (mus, log_vars, mask))."""
        mus, log_vars, mask = self.stacked_gaussian_params(batch, mods)
        joint_mu, joint_log_var = masked_poe(mus, log_vars, mask)
        return joint_mu, joint_log_var, (mus, log_vars, mask)

    # ----------------------------------------------------------------- loss
    def loss_function(self, batch: MultimodalBatch, step: Optional[StepInfo] = None,
                      generator: Optional[torch.Generator] = None) -> ModelOutput:
        joint_mu, joint_log_var, (mus, log_vars, _) = self._joint_posterior(batch)
        shard = self.data_shard
        w = batch.weights  # (B,), zero on padding rows
        n_data = shard.total(w.sum()).clamp_min(1.0)
        z = rsample_from_gaussian(joint_mu, joint_log_var, noise=shard.draw(
            self.draw_noise, joint_mu.shape, generator))

        # KL(joint || N(0, I)), summed over batch and dims
        joint_kld = (-0.5 * sum_f32(1.0 - torch.exp(joint_log_var) - joint_mu ** 2
                                    + joint_log_var) * w).sum()
        metrics = {"joint_divergence": joint_kld}

        loss_rec = 0.0
        for m in self.encoders:
            recon = self.decode_mod(m, z)
            m_rec = -self.recon_log_probs[m](recon, batch.data[m]) * self.rescale_factors[m]
            m_rec = (sum_except_batch(m_rec) * batch.masks[m] * w).sum()
            metrics[m] = m_rec
            loss_rec = loss_rec + m_rec

        # per-modality KL(joint || q_m), zero where m is missing
        kld_losses = 0.0
        for i, m in enumerate(self.encoders):
            mu_m, lv_m = mus[i], log_vars[i]
            kld_m = -0.5 * sum_f32(1.0 - torch.exp(joint_log_var - lv_m)
                                   - (joint_mu - mu_m) ** 2 / torch.exp(lv_m)
                                   + joint_log_var - lv_m)
            kld_m = (kld_m * batch.masks[m] * w).sum()
            metrics["kld_" + m] = kld_m
            kld_losses = kld_losses + kld_m

        M = float(self.n_modalities)
        rec_weight = (M - self.alpha) / M
        cvib_weight = self.alpha / M
        vib_weight = 1.0 - self.alpha
        kld_weighted = cvib_weight * kld_losses + vib_weight * joint_kld
        total_loss = rec_weight * loss_rec + self.beta * kld_weighted
        return ModelOutput(loss=total_loss / n_data, loss_sum=total_loss,
                           metrics=metrics)

    # ------------------------------------------------------------ inference
    def _encode_subset(self, batch: MultimodalBatch, *, cond_mod: tuple, N: int,
                       return_mean: bool, flatten: bool,
                       generator: Optional[torch.Generator]) -> dict:
        """PoE over the conditioning subset (with the rows' masks). Leaving
        the other experts out gives the same numbers as the JAX package's
        masked PoE over the subset indicator: their precision would be 0."""
        joint_mu, joint_log_var, _ = self._joint_posterior(batch, mods=cond_mod)
        return {"z": self._sample(joint_mu, joint_log_var, N, return_mean, flatten,
                                  generator)}

    @torch.no_grad()
    def compute_joint_nll(self, inputs, K: int = 1000, batch_size_K: int = 100,
                          generator: Optional[torch.Generator] = None):
        """K-sample IWAE estimate of -sum_rows ln p(X), in chunks of
        ``batch_size_K`` samples over the whole batch; complete data only."""
        self._check_complete_for_nll(inputs)
        batch = as_batch(inputs).to(self.device)
        joint_mu, joint_log_var, _ = self._joint_posterior(batch)
        return self._gaussian_iwae_joint_nll(batch, joint_mu, joint_log_var, K,
                                             batch_size_K, generator)
