"""JNF: a joint VAE plus one normalizing flow per modality, trained in two
stages.

Counterpart of ``multivae_tpu/models/jnf/jnf_model.py``:

- ``flows``: by default one ``MAF(latent_dim)`` per modality, seeded after
  the joint encoder; a user's dict of flows (the encoders' keys, each an
  ``nn.Module`` with ``input_dim == latent_dim``) is recorded in
  ``custom_architectures``;
- stage 1 (epochs up to ``warmup``) trains the joint ELBO (metric ``ljm``
  0); stage 2 freezes the joint encoder and the decoders
  (``requires_grad_(False)``, as the port's TELBO does) and trains the
  unimodal encoders and the flows on
  L_JM = -sum_m log q_m(z_joint | x_m), the joint posterior sample pushed
  through each modality's flow. The JAX package draws that sample twice
  from one key, for the metrics and for L_JM: here it is drawn once;
- ``reset_optimizer_epochs = [warmup + 1]``: the ``MultistageTrainer``
  resets the optimizer in the same epoch as the stage flips;
- encode: the joint encoder on all modalities; on one modality the
  unimodal posterior sample through ``MAF.inverse`` (sequential); on any
  other subset Hamiltonian Monte Carlo over the product of the flow
  posteriors divided by the prior (``mcmc_steps`` steps of ``n_lf``
  leapfrog steps of size ``eps_lf``), started from one random expert per
  row. Its draws (the expert per row, the start's noise, each step's
  momentum and accept uniforms) go through ``draw_experts``,
  ``draw_noise`` and ``draw_uniform``; the chain's Metropolis ratios are
  kept in ``last_hmc_ratios``.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
from torch import nn

from ...data.batch import MultimodalBatch, map_leaves
from ...ops.flows import MAF
from ...ops.gaussian import rsample_from_gaussian, sum_f32
from ...utils.model_output import ModelOutput
from ..base.base_ae_model import sum_except_batch
from ..base.step import StepInfo
from ..joint_models.joint_model import BaseJointModel
from .jnf_config import JNFConfig

_LOG_2PI = math.log(2.0 * math.pi)


def _log_q(z0, mu, log_var):
    """sum_d log N(z0; mu, exp(log_var)), as the JAX package writes it."""
    return sum_f32(-0.5 * (log_var + _LOG_2PI + (z0 - mu) ** 2 / torch.exp(log_var)))


class JNF(BaseJointModel):
    """The JNF model (needs the MultistageTrainer)."""

    model_name = "JNF"

    def __init__(self, model_config: JNFConfig, encoders: dict = None,
                 decoders: dict = None, joint_encoder=None, flows: Dict = None,
                 seed: int = 0, device="cuda"):
        super().__init__(model_config, encoders, decoders, joint_encoder, seed=seed,
                         device=device)
        self._default_flows = flows is None
        if flows is None:
            flows = {m: MAF(model_config.latent_dim) for m in self.encoders}
        else:
            self.model_config.custom_architectures.append("flows")
        self._check_flows(flows)
        self.flows = nn.ModuleDict(flows)
        self.warmup = model_config.warmup
        self.reset_optimizer_epochs = [self.warmup + 1]
        self.beta = model_config.beta
        self.current_stage = 1
        # (mcmc_steps, rows) Metropolis ratios exp(H0 - H) of the last HMC
        # encode, a diagnostic: the acceptance rate is the mean of
        # min(1, ratio)
        self.last_hmc_ratios = None
        self.init_params()

    def _check_flows(self, flows: dict):
        if flows.keys() != self.encoders.keys():
            raise AttributeError(
                f"The keys of provided flows: {list(flows.keys())} don't match the "
                f"keys provided in encoders {list(self.encoders.keys())} or "
                "input_dims.")
        for f in flows.values():
            if not isinstance(f, nn.Module) or getattr(f, "input_dim", None) \
                    != self.latent_dim:
                raise AttributeError(
                    "The provided flows must be torch flow modules with input_dim "
                    "equal to the latent dimension.")

    def _reset_extra_nets(self, generator: torch.Generator):
        super()._reset_extra_nets(generator)
        if self._default_flows:
            for flow in self.flows.values():
                flow.reset_parameters(generator)

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
    def loss_function(self, batch: MultimodalBatch, step: Optional[StepInfo] = None,
                      generator: Optional[torch.Generator] = None) -> ModelOutput:
        shard = self.data_shard
        w = batch.weights
        n_data = shard.total(w.sum()).clamp_min(1.0)
        joint = self.encode_joint(batch.data)
        mu, log_var = joint["embedding"], joint["log_covariance"]
        z_joint = rsample_from_gaussian(mu, log_var, noise=shard.draw(
            self.draw_noise, mu.shape, generator))
        recon_loss = 0.0
        for m in self.decoders:
            rec = sum_except_batch(-self.recon_log_probs[m](self.decode_mod(m, z_joint),
                                                            batch.data[m])
                                   * self.rescale_factors[m])
            recon_loss = recon_loss + (rec * w).sum()
        kld = -0.5 * (sum_f32(1.0 + log_var - mu ** 2 - torch.exp(log_var)) * w).sum() \
            * self.beta
        metrics = {"kld_prior": kld, "recon_loss": recon_loss / n_data}
        if self.current_stage == 1:
            loss_sum = recon_loss + kld
            return ModelOutput(loss=loss_sum / n_data, loss_sum=loss_sum,
                               metrics={**metrics, "ljm": torch.zeros((), device=w.device)})
        ljm = self._compute_ljm(batch, z_joint, w)
        return ModelOutput(loss=ljm / n_data, loss_sum=ljm,
                           metrics={**metrics, "ljm": ljm / n_data})

    def _compute_ljm(self, batch: MultimodalBatch, z_joint, w):
        """-sum over rows and modalities of log q_m(z_joint | x_m) through
        the flows."""
        ljm = 0.0
        for m in self.encoders:
            out = self.encode_mod(m, batch.data[m])
            flow_out = self.flows[m](z_joint)
            log_q = _log_q(flow_out["out"], out["embedding"], out["log_covariance"])
            ljm = ljm + (-(log_q + flow_out["log_abs_det_jac"]) * w).sum()
        return ljm

    # --------------------------------------------------------------- encode
    @torch.no_grad()
    def encode(self, inputs, cond_mod="all", N: int = 1, return_mean: bool = False,
               flatten: bool = False, generator: Optional[torch.Generator] = None,
               ignore_incomplete: bool = False, mcmc_steps: int = 100, n_lf: int = 10,
               eps_lf: float = 0.01) -> ModelOutput:
        """The base ``encode`` plus the HMC settings of a subset of two or
        more modalities (and fewer than all)."""
        return super().encode(inputs, cond_mod, N, return_mean=return_mean,
                              flatten=flatten, generator=generator,
                              ignore_incomplete=ignore_incomplete, mcmc_steps=mcmc_steps,
                              n_lf=n_lf, eps_lf=eps_lf)

    def _encode_subset(self, batch: MultimodalBatch, *, cond_mod: tuple, N: int,
                       return_mean: bool, flatten: bool,
                       generator: Optional[torch.Generator], mcmc_steps: int = 100,
                       n_lf: int = 10, eps_lf: float = 0.01) -> dict:
        if len(cond_mod) == self.n_modalities:
            out = self.encode_joint(batch.data)
            return {"z": self._sample(out["embedding"], out["log_covariance"], N,
                                      return_mean, flatten, generator)}
        if len(cond_mod) == 1:
            mod = cond_mod[0]
            out = self.encode_mod(mod, batch.data[mod])
            z0 = self._sample(out["embedding"], out["log_covariance"], N, return_mean,
                              False, generator)
            z = self.flows[mod].inverse(z0.reshape(-1, self.latent_dim))["out"]
            z = z.reshape(z0.shape)
        else:
            z = self._sample_from_poe_subset(batch, cond_mod, mcmc_steps=mcmc_steps,
                                             n_lf=n_lf, eps_lf=eps_lf, K=N,
                                             divide_prior=True, generator=generator)
        if N > 1 and flatten:
            z = z.reshape(-1, self.latent_dim)
        return {"z": z}

    # ------------------------------------------------------------------ HMC
    def _poe_log_density(self, z, enc_params: dict, divide_prior: bool):
        """log density at z of the product of the flow posteriors of
        ``enc_params``' modalities (divided by the N(0, I) prior)."""
        lnqzs = sum_f32(0.5 * (z ** 2 + _LOG_2PI)) if divide_prior else 0.0
        for m, (mu, log_var) in enc_params.items():
            flow_out = self.flows[m](z)
            lnqzs = lnqzs + _log_q(flow_out["out"], mu, log_var) \
                + flow_out["log_abs_det_jac"]
        return lnqzs

    def _log_density_and_grad(self, z, enc_params: dict, divide_prior: bool):
        """(log density, its gradient with respect to z alone)."""
        with torch.enable_grad():
            z = z.detach().requires_grad_()
            ld = self._poe_log_density(z, enc_params, divide_prior)
            (grad,) = torch.autograd.grad(ld.sum(), z)
        return ld.detach(), grad

    def draw_experts(self, n_experts: int, n_rows: int,
                     generator: Optional[torch.Generator] = None):
        """A uniform random expert index in [0, n_experts) per row, on the
        model's device (the HMC chain's start)."""
        device = self.device if generator is None else generator.device
        return torch.randint(n_experts, (n_rows,), generator=generator,
                             device=device).to(self.device)

    def _sample_from_moe_subset(self, enc_params: dict,
                                generator: Optional[torch.Generator], blocks: int = 1):
        """One sample per row from a random expert of the subset; the rows
        hold ``blocks`` repeats of the batch (the global batch's draws under
        a data shard)."""
        shard = self.data_shard
        mus = torch.stack([mu for mu, _ in enc_params.values()])       # (S, B, D)
        log_vars = torch.stack([lv for _, lv in enc_params.values()])
        rows = torch.arange(mus.shape[1], device=mus.device)
        idx = shard.own(self.draw_experts(len(enc_params), mus.shape[1] * shard.world,
                                          generator), 0, blocks)
        mu, log_var = mus[idx, rows], log_vars[idx, rows]
        return rsample_from_gaussian(mu, log_var, noise=shard.draw(
            self.draw_noise, mu.shape, generator, axis=0, blocks=blocks))

    def _sample_from_poe_subset(self, batch: MultimodalBatch, subset: tuple, *,
                                mcmc_steps: int, n_lf: int, eps_lf: float, K: int,
                                divide_prior: bool,
                                generator: Optional[torch.Generator]):
        """HMC over the product of the flow posteriors of ``subset``, on the
        data repeated K times; (n, D) for K == 1, else (K, n, D)."""
        enc_params = {}
        for m in subset:
            out = self.encode_mod(m, map_leaves(lambda t: torch.cat([t] * K, 0),
                                                batch.data[m]))
            enc_params[m] = (out["embedding"], out["log_covariance"])
        z = self._sample_from_moe_subset(enc_params, generator, blocks=K)
        shard = self.data_shard
        ratios = []
        for _ in range(mcmc_steps):
            rho = shard.draw(self.draw_noise, z.shape, generator, axis=0, blocks=K)
            lnq, grad = self._log_density_and_grad(z, enc_params, divide_prior)
            h0 = -lnq + 0.5 * (rho ** 2).sum(-1)
            z_new = z
            for _ in range(n_lf):
                rho_half = rho + (eps_lf / 2) * grad
                z_new = z_new + eps_lf * rho_half
                lnq, grad = self._log_density_and_grad(z_new, enc_params, divide_prior)
                rho = rho_half + (eps_lf / 2) * grad
            h = -lnq + 0.5 * (rho ** 2).sum(-1)
            ratios.append(torch.exp(h0 - h))
            accept = shard.draw(self.draw_uniform, ratios[-1].shape, generator, axis=0,
                                blocks=K) < ratios[-1]
            z = torch.where(accept[:, None], z_new, z)
        self.last_hmc_ratios = torch.stack(ratios) if ratios else z.new_zeros(0, len(z))
        n_data = batch.n_samples
        return z.reshape(n_data, self.latent_dim) if K == 1 else \
            z.reshape(K, n_data, self.latent_dim)
