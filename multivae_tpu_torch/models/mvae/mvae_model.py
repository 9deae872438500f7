"""MVAE: product of experts over modality subsets, trained on sub-sampled
ELBOs.

Counterpart of ``multivae_tpu/models/mvae/mvae_model.py``:

- a subset's posterior is the product of its available experts and the
  prior expert N(0, I) (``ops.gaussian.stable_poe``);
- a training step takes the ELBO of the joint subset, then with
  ``use_subsampling`` of each unimodal subset and of ``k`` random subsets
  of 2 to M-1 modalities, drawn without replacement; all S subsets ride one
  stacked pass, each decoder taking (S, B) rows. A subset's ELBO is
  averaged over the rows that hold one of its modalities (zero weight on
  the others, where the reference drops them);
- the KL weight grows linearly to ``beta`` over the first ``warmup``
  epochs, per batch;
- no random subsets are drawn in eval mode (``self.training`` False, as the
  trainer's eval pass sets it), the JAX package's ``eval_loss_function``;
- ``loss`` is the sum of the subset ELBOs, ``loss_sum`` that times the
  effective row count of the last subset, as in the JAX package.

The random subsets are drawn through ``draw_subsets`` and the noise of all
S subsets as one (S, B, D) ``draw_noise``, so a test can feed another
package's draws.
"""

from __future__ import annotations

from typing import Optional

import torch

from ...data.batch import MultimodalBatch, add_axes, as_batch
from ...ops.gaussian import rsample_from_gaussian, stable_poe, sum_f32
from ...ops.subsets import all_subsets, subsets_to_mask
from ...utils.model_output import ModelOutput
from ..base.base_ae_model import BaseMultiVAE, sum_except_batch
from ..base.step import StepInfo, f32
from .mvae_config import MVAEConfig


class MVAE(BaseMultiVAE):
    """The multimodal VAE (product of experts)."""

    model_name = "MVAE"
    supports_per_sample_conditioning = True

    def __init__(self, model_config: MVAEConfig, encoders: dict = None,
                 decoders: dict = None, seed: int = 0, device="cuda"):
        super().__init__(model_config, encoders, decoders, seed=seed, device=device)
        self.subsampling = model_config.use_subsampling
        self.k = 0 if self.n_modalities <= 2 else model_config.k
        self.warmup = model_config.warmup
        self.start_keep_best_epoch = model_config.warmup + 1
        self.beta = model_config.beta
        mods = list(self.encoders)
        # the random-subset candidates: 2 to M-1 modalities
        self.subsets = [s for s in all_subsets(mods, include_full=False) if len(s) >= 2]
        self.register_buffer("_random_subset_mask", torch.as_tensor(
            subsets_to_mask(self.subsets, mods).reshape(-1, len(mods))), persistent=False)
        self.init_params()

    def draw_subsets(self, n_candidates: int, k: int,
                     generator: Optional[torch.Generator] = None):
        """``k`` distinct indices in [0, n_candidates): the head of a random
        permutation, the ranks of uniform draws (graph-safe on CUDA, where
        ``randperm`` is not)."""
        device = self.device if generator is None else generator.device
        return torch.rand(n_candidates, generator=generator, device=device).argsort()[:k]

    # --------------------------------------------------------- subset pieces
    def _subset_posteriors(self, mus, log_vars, mask, rows):
        """PoE of each subset's available experts and the prior expert:
        mus, log_vars (M, B, D), mask (M, B), rows (S, M) -> (S, B, D) x2."""
        S = rows.shape[0]
        eff = mask[None] * rows[:, :, None]                            # (S, M, B)
        all_mask = torch.cat([eff, torch.ones_like(eff[:, :1])], 1).transpose(0, 1)
        all_mu, all_lv = (torch.cat([t, torch.zeros_like(t[:1])])[:, None]
                          .expand(-1, S, -1, -1) for t in (mus, log_vars))
        return stable_poe(all_mu, all_lv, all_mask)

    def _elbo_subsets(self, batch: MultimodalBatch, mus, log_vars, mask, rows,
                      beta, generator: Optional[torch.Generator] = None):
        """The S subset ELBOs of ``rows`` (S, M) in one stacked pass:
        (elbo, kld, recon, effective rows), each (S,)."""
        sub_mu, sub_lv = self._subset_posteriors(mus, log_vars, mask, rows)
        shard = self.data_shard
        z = rsample_from_gaussian(sub_mu, sub_lv, noise=shard.draw(
            self.draw_noise, sub_mu.shape, generator))
        # a row counts for a subset when it holds one of its modalities
        w = (mask[None] * rows[:, :, None]).amax(1) * batch.weights[None]   # (S, B)
        w_total = shard.total(w.sum(-1))
        n_eff = w_total.clamp_min(1.0)
        recon_total = 0.0
        for i, m in enumerate(self.encoders):
            recon = self.decode_mod(m, z)                                   # (S, B, ...)
            rec_m = sum_except_batch(-self.recon_log_probs[m](recon, add_axes(batch.data[m]))
                                     * self.rescale_factors[m], batch_ndims=2)
            rec_m = rec_m * batch.masks[m][None] * rows[:, i:i + 1]
            recon_total = recon_total + (rec_m * w).sum(-1)
        kld = (-0.5 * sum_f32(1.0 + sub_lv - sub_mu ** 2 - torch.exp(sub_lv)) * w).sum(-1)
        elbo = (recon_total + beta * kld) / n_eff
        return elbo, kld / n_eff, recon_total / n_eff, w_total

    # ----------------------------------------------------------------- loss
    def loss_function(self, batch: MultimodalBatch, step: Optional[StepInfo] = None,
                      generator: Optional[torch.Generator] = None) -> ModelOutput:
        step = step or StepInfo()
        mus, log_vars, mask = self.stacked_gaussian_params(batch)
        # per-batch warm-up, in float32 tensor ops as the JAX package's jnp.where
        epoch = f32(step.epoch, mus.device)
        beta = torch.where(epoch >= self.warmup, self.beta,
                           (epoch - 1.0 + f32(step.batch_ratio, mus.device))
                           / max(self.warmup, 1) * self.beta)
        M, mods = self.n_modalities, list(self.encoders)

        # the joint subset, each unimodal subset, then k random subsets
        rows = [torch.ones(1, M, device=mus.device)]
        if self.subsampling:
            rows.append(torch.eye(M, device=mus.device))
        use_random = (self.subsampling and self.k > 0 and self.training
                      and bool(self.subsets))
        if use_random:
            idx = self.draw_subsets(len(self.subsets), self.k, generator)
            rows.append(self._random_subset_mask[idx.to(mus.device)])
        elbos, klds, recs, n_effs = self._elbo_subsets(
            batch, mus, log_vars, mask, torch.cat(rows), beta, generator)

        metrics = {"beta": self.data_shard.share(beta)}
        names = ["_".join(sorted(mods))] + (mods if self.subsampling else [])
        for i, name in enumerate(names):
            metrics[name] = elbos[i]
            metrics["kld" + name] = klds[i]
            metrics["recon" + name] = recs[i]
        if use_random:
            for j in range(self.k):
                metrics[f"random_subset_{j}"] = elbos[1 + M + j]
        loss = elbos.sum()
        return ModelOutput(loss=loss, loss_sum=loss * n_effs[-1], metrics=metrics)

    # ------------------------------------------------------------ inference
    def _joint_posterior(self, batch: MultimodalBatch, mods):
        mus, log_vars, mask = self.stacked_gaussian_params(batch, mods)
        rows = torch.ones(1, mus.shape[0], device=mus.device)
        mu, log_var = self._subset_posteriors(mus, log_vars, mask, rows)
        return mu[0], log_var[0]

    def _encode_subset(self, batch: MultimodalBatch, *, cond_mod: tuple, N: int,
                       return_mean: bool, flatten: bool,
                       generator: Optional[torch.Generator]) -> dict:
        """PoE of the conditioning modalities' available experts and the
        prior expert."""
        mu, log_var = self._joint_posterior(batch, cond_mod)
        return {"z": self._sample(mu, log_var, N, return_mean, flatten, generator)}

    @torch.no_grad()
    def compute_joint_nll(self, inputs, K: int = 1000, batch_size_K: int = 100,
                          generator: Optional[torch.Generator] = None):
        """K-sample IWAE estimate of -sum_rows ln p(X) from the joint
        posterior; complete data only."""
        self._check_complete_for_nll(inputs)
        batch = as_batch(inputs).to(self.device)
        mu, log_var = self._joint_posterior(batch, None)
        return self._gaussian_iwae_joint_nll(batch, mu, log_var, K, batch_size_K,
                                             generator)
