"""JMVAE: the joint encoder's ELBO and KL(joint || unimodal) terms.

Counterpart of ``multivae_tpu/models/jmvae/jmvae_model.py``:

- the loss is the joint posterior's reconstruction (weighed by the rescale
  factors), plus ``beta`` times its KL to the prior and ``alpha`` times the
  sum over modalities of KL(q(z|X) || q(z|x_m)), the regularization (both
  KLs) annealed by ``epoch / warmup`` up to 1;
- encode: the joint encoder on the full set, the unimodal encoder on one
  modality, the exact product of the unimodal experts (no prior expert) on
  any other subset;
- ``start_keep_best_epoch = warmup + 1``: the trainer keeps every epoch's
  weights through the warm-up, then the best eval loss's.
"""

from __future__ import annotations

from typing import Optional

import torch

from ...data.batch import MultimodalBatch
from ...ops.gaussian import rsample_from_gaussian, stable_poe, sum_f32
from ...utils.model_output import ModelOutput
from ..base.base_ae_model import sum_except_batch
from ..base.step import StepInfo, f32
from ..joint_models.joint_model import BaseJointModel
from .jmvae_config import JMVAEConfig


class JMVAE(BaseJointModel):
    """The Joint Multimodal Variational Autoencoder."""

    model_name = "JMVAE"

    def __init__(self, model_config: JMVAEConfig, encoders: dict = None,
                 decoders: dict = None, joint_encoder=None, seed: int = 0,
                 device="cuda"):
        super().__init__(model_config, encoders, decoders, joint_encoder, seed=seed,
                         device=device)
        self.alpha = model_config.alpha
        self.warmup = model_config.warmup
        self.start_keep_best_epoch = model_config.warmup + 1
        self.beta = model_config.beta
        self.init_params()

    def loss_function(self, batch: MultimodalBatch, step: Optional[StepInfo] = None,
                      generator: Optional[torch.Generator] = None) -> ModelOutput:
        step = step or StepInfo()
        joint = self.encode_joint(batch.data)
        mu, log_var = joint["embedding"], joint["log_covariance"]
        shard = self.data_shard
        w = batch.weights
        n_data = shard.total(w.sum()).clamp_min(1.0)
        z = rsample_from_gaussian(mu, log_var, noise=shard.draw(self.draw_noise, mu.shape,
                                                                generator))

        recon_loss = 0.0
        for m in self.decoders:
            rec = sum_except_batch(-self.recon_log_probs[m](self.decode_mod(m, z),
                                                            batch.data[m])
                                   * self.rescale_factors[m])
            recon_loss = recon_loss + (rec * w).sum()
        kld = -0.5 * (sum_f32(1.0 + log_var - mu ** 2 - torch.exp(log_var)) * w).sum()
        kld = kld * self.beta

        ljm = 0.0
        for m in self.encoders:
            out = self.encode_mod(m, batch.data[m])
            uni_mu, uni_lv = out["embedding"], out["log_covariance"]
            term = 0.5 * (uni_lv - log_var
                          + (torch.exp(log_var) + (mu - uni_mu) ** 2) / torch.exp(uni_lv)
                          - 1.0)
            ljm = ljm + (sum_f32(term) * w).sum()
        reg_loss = kld + ljm * self.alpha

        epoch = f32(step.epoch, mu.device)
        annealing = torch.where(epoch >= self.warmup, 1.0, epoch / max(self.warmup, 1))
        loss_sum = recon_loss + annealing * reg_loss
        metrics = {"loss_no_ponderation": reg_loss + recon_loss,
                   "beta": shard.share(annealing),
                   "elbo": (recon_loss + kld) / n_data}
        return ModelOutput(loss=loss_sum / n_data, loss_sum=loss_sum, metrics=metrics)

    def _encode_subset(self, batch: MultimodalBatch, *, cond_mod: tuple, N: int,
                       return_mean: bool, flatten: bool,
                       generator: Optional[torch.Generator]) -> dict:
        if len(cond_mod) == self.n_modalities:
            out = self.encode_joint(batch.data)
            mu, log_var = out["embedding"], out["log_covariance"]
        elif len(cond_mod) == 1:
            out = self.encode_mod(cond_mod[0], batch.data[cond_mod[0]])
            mu, log_var = out["embedding"], out["log_covariance"]
        else:
            mu, log_var, _ = self.stacked_gaussian_params(batch, cond_mod)
            mu, log_var = stable_poe(mu, log_var)
        return {"z": self._sample(mu, log_var, N, return_mean, flatten, generator)}
