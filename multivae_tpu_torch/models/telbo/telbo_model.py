"""TELBO: the triple-ELBO joint model, trained in two stages.

Counterpart of ``multivae_tpu/models/telbo/telbo_model.py``:

- stage 1 (epochs up to ``warmup``) trains the joint ELBO, reconstructions
  weighed by ``lambda_factors``;
- stage 2 freezes the joint encoder and the decoders
  (``requires_grad_(False)``: their gradients stay None and the optimizer
  leaves them alone) and trains the unimodal ELBOs, reconstructions weighed
  by ``gamma_factors``. As in the JAX package, stage 2's KL takes the
  joint encoder's log-variance in its ``1 + log_var`` term;
- ``reset_optimizer_epochs = [warmup]``: the ``MultistageTrainer`` builds a
  fresh optimizer at the start of epoch ``warmup`` and sets the stage from
  ``stage_for_epoch`` before each epoch; ``BaseTrainer`` refuses the model;
- encode: the unimodal encoder on one modality, the joint encoder on all
  of them; any other subset is refused.
"""

from __future__ import annotations

from typing import Optional

import torch

from ...data.batch import MultimodalBatch
from ...ops.gaussian import rsample_from_gaussian, sum_f32
from ...utils.model_output import ModelOutput
from ..base.base_ae_model import sum_except_batch
from ..base.step import StepInfo
from ..joint_models.joint_model import BaseJointModel
from .telbo_config import TELBOConfig


class TELBO(BaseJointModel):
    """The Triple ELBO model (needs the MultistageTrainer)."""

    model_name = "TELBO"

    def __init__(self, model_config: TELBOConfig, encoders: dict = None,
                 decoders: dict = None, joint_encoder=None, seed: int = 0,
                 device="cuda"):
        super().__init__(model_config, encoders, decoders, joint_encoder, seed=seed,
                         device=device)
        self.warmup = model_config.warmup
        self.reset_optimizer_epochs = [self.warmup]
        self.current_stage = 1
        self.lambda_factors = dict(self.rescale_factors if model_config.lambda_factors
                                   is None else model_config.lambda_factors)
        self.gamma_factors = dict(self.rescale_factors if model_config.gamma_factors
                                  is None else model_config.gamma_factors)
        self.init_params()

    # -------------------------------------------------------------- staging
    def stage_for_epoch(self, epoch: int) -> int:
        return 1 if epoch <= self.warmup else 2

    def set_stage(self, stage: int) -> bool:
        """Enter ``stage`` (stage 2 freezes the joint encoder and the
        decoders); returns whether the stage changed."""
        changed = stage != self.current_stage
        self.current_stage = stage
        for net in (self.joint_encoder, self.decoders):
            net.requires_grad_(stage == 1)
        return changed

    # ----------------------------------------------------------------- loss
    @staticmethod
    def _kl_sum(joint_log_var, mu, log_var, w):
        """KL(N(mu, e^log_var) || N(0, I)) summed over the rows, with
        ``joint_log_var`` in the ``1 + log_var`` term."""
        return -0.5 * (sum_f32(1.0 + joint_log_var - mu ** 2 - torch.exp(log_var)) * w).sum()

    def loss_function(self, batch: MultimodalBatch, step: Optional[StepInfo] = None,
                      generator: Optional[torch.Generator] = None) -> ModelOutput:
        shard = self.data_shard
        w = batch.weights
        n_data = shard.total(w.sum()).clamp_min(1.0)
        joint = self.encode_joint(batch.data)
        mu, log_var = joint["embedding"], joint["log_covariance"]

        if self.current_stage == 1:
            z = rsample_from_gaussian(mu, log_var, noise=shard.draw(
                self.draw_noise, mu.shape, generator))
            recon_loss = 0.0
            for m in self.decoders:
                rec = sum_except_batch(-self.recon_log_probs[m](self.decode_mod(m, z),
                                                                batch.data[m])
                                       * self.lambda_factors[m])
                recon_loss = recon_loss + (rec * w).sum()
            kld = self._kl_sum(log_var, mu, log_var, w)
            loss_sum = recon_loss + kld
            return ModelOutput(loss=loss_sum / n_data, loss_sum=loss_sum,
                               recon_loss=recon_loss / n_data, KLD=kld / n_data,
                               metrics={"kld_joint": kld, "recon_joint": recon_loss / n_data})

        mods = list(self.encoders)
        outs = [self.encode_mod(m, batch.data[m]) for m in mods]
        mus = torch.stack([o["embedding"] for o in outs])
        log_vars = torch.stack([o["log_covariance"] for o in outs])
        zs = rsample_from_gaussian(mus, log_vars, noise=shard.draw(
            self.draw_noise, mus.shape, generator))
        loss = 0.0
        metrics = {}
        for i, m in enumerate(mods):
            rec = sum_except_batch(-self.recon_log_probs[m](self.decode_mod(m, zs[i]),
                                                            batch.data[m])
                                   * self.gamma_factors[m])
            elbo = (rec * w).sum() + self._kl_sum(log_var, mus[i], log_vars[i], w)
            metrics[m] = elbo
            loss = loss + elbo
        return ModelOutput(loss=loss / n_data, loss_sum=loss, metrics=metrics)

    # --------------------------------------------------------------- encode
    def _normalize_cond_mod(self, cond_mod) -> tuple:
        cond = super()._normalize_cond_mod(cond_mod)
        if len(cond) not in (1, self.n_modalities):
            raise ValueError(
                f"Conditioning on subset {list(cond)} is not handled. "
                f"Possible subsets are {list(self.encoders)} and 'all'.")
        return cond

    def _encode_subset(self, batch: MultimodalBatch, *, cond_mod: tuple, N: int,
                       return_mean: bool, flatten: bool,
                       generator: Optional[torch.Generator]) -> dict:
        if len(cond_mod) == 1:
            out = self.encode_mod(cond_mod[0], batch.data[cond_mod[0]])
        else:
            out = self.encode_joint(batch.data)
        return {"z": self._sample(out["embedding"], out["log_covariance"], N,
                                  return_mean, flatten, generator)}
