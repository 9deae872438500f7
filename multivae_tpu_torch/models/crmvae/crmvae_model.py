"""CRMVAE: a coordination-regularized multimodal VAE.

Counterpart of ``multivae_tpu/models/crmvae/crmvae_model.py``. The joint
posterior q(z|X) is the masked product of the unimodal experts
(``ops.gaussian.masked_poe``); per row, the loss is

    1/(2(M+1)) * sum_m [-log p(x_m|z_joint) - log p(x_m|z_m)]
    + beta/(M+1) * [KL(q(z|X) || p(z)) + sum_m KL(q(z|X) || q(z|x_m))],

with z_m drawn from the unmasked unimodal posterior and the per-modality
terms zeroed where m is missing. Each decoder takes the joint and its own
modality's codes as one stack of 2B rows. ``loss`` and ``loss_sum`` are both
the batch sum. The noise of the joint code and of the M unimodal codes is
one (M + 1, B, D) ``draw_noise``.
"""

from __future__ import annotations

from typing import Optional

import torch

from ...data.batch import MultimodalBatch, as_batch, map_leaves
from ...ops.gaussian import kl_divergence, masked_poe, rsample_from_gaussian
from ...utils.model_output import ModelOutput
from ..base.base_ae_model import BaseMultiVAE, sum_except_batch
from ..base.step import StepInfo
from .crmvae_config import CRMVAEConfig


class CRMVAE(BaseMultiVAE):
    """CRMVAE model."""

    model_name = "CRMVAE"
    supports_per_sample_conditioning = True

    def __init__(self, model_config: CRMVAEConfig, encoders: dict = None,
                 decoders: dict = None, seed: int = 0, device="cuda"):
        super().__init__(model_config, encoders, decoders, seed=seed, device=device)
        self.beta = model_config.beta
        self.init_params()

    def _joint_posterior(self, batch: MultimodalBatch, mods=None):
        mus, log_vars, mask = self.stacked_gaussian_params(batch, mods)
        joint_mu, joint_log_var = masked_poe(mus, log_vars, mask)
        return joint_mu, joint_log_var, (mus, log_vars, mask)

    # ----------------------------------------------------------------- loss
    def loss_function(self, batch: MultimodalBatch, step: Optional[StepInfo] = None,
                      generator: Optional[torch.Generator] = None) -> ModelOutput:
        joint_mu, joint_lv, (mus, log_vars, _) = self._joint_posterior(batch)
        mods, M = list(self.encoders), self.n_modalities
        shard = self.data_shard
        w = batch.weights
        n_data = shard.total(w.sum()).clamp_min(1.0)
        B = w.shape[0]

        # the joint code, then each modality's own (unmasked) code
        z = rsample_from_gaussian(torch.cat([joint_mu[None], mus]),
                                  torch.cat([joint_lv[None], log_vars]),
                                  noise=shard.draw(self.draw_noise,
                                                   (M + 1, *joint_mu.shape), generator))
        zeros = torch.zeros_like(joint_mu)
        divergence = kl_divergence(joint_mu, joint_lv, zeros, zeros)       # (B,)
        metrics = {"joint_divergence": (divergence * w).sum() / n_data}
        for i, m in enumerate(mods):
            kl_m = kl_divergence(joint_mu, joint_lv, mus[i], log_vars[i]) * batch.masks[m]
            divergence = divergence + kl_m
            metrics[f"kl_{m}"] = (kl_m * w).sum() / n_data

        loss_rec = 0.0
        for i, m in enumerate(mods):
            recon = self.decode_mod(m, torch.cat([z[0], z[i + 1]]))        # (2B, ...)
            target = map_leaves(lambda t: torch.cat([t, t]), batch.data[m])
            rec_pair = (sum_except_batch(-self.recon_log_probs[m](recon, target)
                                         * self.rescale_factors[m])
                        * torch.cat([batch.masks[m]] * 2))
            for m_rec, src in ((rec_pair[:B], "joint"), (rec_pair[B:], m)):
                loss_rec = loss_rec + m_rec
                metrics[f"recon_{m}_from_{src}"] = (m_rec * w).sum() / n_data

        loss_rec = loss_rec / (2.0 * (M + 1))
        divergence = divergence / (M + 1)
        total = ((loss_rec + self.beta * divergence) * w).sum()
        return ModelOutput(loss=total, loss_sum=total, metrics=metrics)

    # ------------------------------------------------------------ inference
    def _encode_subset(self, batch: MultimodalBatch, *, cond_mod: tuple, N: int,
                       return_mean: bool, flatten: bool,
                       generator: Optional[torch.Generator]) -> dict:
        """The masked PoE of the conditioning modalities."""
        joint_mu, joint_lv, _ = self._joint_posterior(batch, mods=cond_mod)
        return {"z": self._sample(joint_mu, joint_lv, N, return_mean, flatten, generator)}

    @torch.no_grad()
    def compute_joint_nll(self, inputs, K: int = 1000, batch_size_K: int = 100,
                          generator: Optional[torch.Generator] = None):
        """K-sample IWAE estimate of -sum_rows ln p(X) from the joint
        posterior; complete data only."""
        self._check_complete_for_nll(inputs)
        batch = as_batch(inputs).to(self.device)
        joint_mu, joint_lv, _ = self._joint_posterior(batch)
        return self._gaussian_iwae_joint_nll(batch, joint_mu, joint_lv, K,
                                             batch_size_K, generator)
