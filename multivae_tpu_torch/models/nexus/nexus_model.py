"""Nexus: the two-level hierarchical multimodal VAE.

Counterpart of ``multivae_tpu/models/nexus/nexus_model.py``:

- each modality has a bottom VAE (encoder and decoder over a code of
  ``modalities_specific_dim[m]``); its negative ELBO, with the KL times
  ``bottom_betas[m]`` and the annealing ``min(epoch / warmup, 1)``, counts
  where the modality is available;
- the bottom codes, detached, go through each modality's top encoder to a
  message of ``msg_dim``; the messages are averaged (on an incomplete batch
  with the rows' masks as weights; on a complete batch with forced
  perceptual dropout: a row drops out with probability ``dropout_rate`` and
  then keeps a random subset of 1 to M-1 messages, chosen by the ranks of
  uniform scores); the joint encoder maps the mean to the top posterior;
- the top decoders reconstruct the bottom codes from a top sample, under a
  unit variance or, for ``adapt_top_decoder_variance``, the RMS error over
  the batch, times ``gammas[m]`` and the mask; the top KL counts with
  ``top_beta`` and the annealing. ``loss`` divides the weighted sum by
  max(sum of the row weights, 1), ``loss_sum`` is the sum;
- encode samples the conditioning modalities' bottom codes (N per row),
  averages their messages and samples the top code; ``decode`` reconstructs
  a modality from its bottom code when the embedding holds one
  (``use_bottom_z_for_recon``), else through its top decoder;
- ``start_keep_best_epoch = warmup + 1``.

Every draw goes through a hook: ``draw_noise`` (the bottom codes in the
encoders' order, then the top code) and ``draw_dropout`` (the three draws
of the forced dropout).
"""

from __future__ import annotations

from typing import Optional, Union

import torch
from torch import nn

from ...data.batch import MultimodalBatch
from ...nn.default_architectures import BaseAEConfig, Decoder_AE_MLP, Encoder_VAE_MLP
from ...ops.gaussian import gaussian_log_prob, sum_f32
from ...utils.model_output import ModelOutput
from ..base.base_ae_model import BaseMultiVAE, sum_except_batch
from ..base.step import StepInfo, f32
from .nexus_config import NexusConfig


class Nexus(BaseMultiVAE):
    """The Nexus model."""

    model_name = "NEXUS"

    def __init__(self, model_config: NexusConfig, encoders: dict = None,
                 decoders: dict = None, top_encoders: dict = None,
                 joint_encoder: nn.Module = None, top_decoders: dict = None,
                 seed: int = 0, device="cuda"):
        super().__init__(model_config, encoders, decoders, seed=seed, device=device)
        self._default_top = []
        self.top_decoders = self._set_top_nets("top_decoders", top_decoders, model_config)
        self.top_encoders = self._set_top_nets("top_encoders", top_encoders, model_config)
        self._set_joint_encoder(joint_encoder, model_config)

        self._set_bottom_betas(model_config.bottom_betas)
        self._set_gammas(model_config.gammas)
        self.start_keep_best_epoch = model_config.warmup + 1
        self.adapt_top_decoder_variance = self._set_top_decoder_variance(model_config)
        self.check_aggregator(model_config)
        self.init_params()

    # ---------------------------------------------------------- networks
    def _check_specific_dims(self, model_config, what: str, need_input_dims=True):
        if ((need_input_dims and model_config.input_dims is None)
                or model_config.modalities_specific_dim is None):
            inputs = "valid input_dims and " if need_input_dims else "valid "
            raise AttributeError(
                f"Please provide {what} architectures or {inputs}"
                "modalities_specific_dim in the model configuration")

    def default_encoders(self, model_config) -> dict:
        self._check_specific_dims(model_config, "encoders")
        return {m: Encoder_VAE_MLP(BaseAEConfig(
            input_dim=tuple(d), latent_dim=model_config.modalities_specific_dim[m]))
            for m, d in model_config.input_dims.items()}

    def default_decoders(self, model_config) -> dict:
        self._check_specific_dims(model_config, "decoders")
        return {m: Decoder_AE_MLP(BaseAEConfig(
            input_dim=tuple(d), latent_dim=model_config.modalities_specific_dim[m]))
            for m, d in model_config.input_dims.items()}

    def _default_top_nets(self, group: str, model_config) -> dict:
        self._check_specific_dims(model_config, group, need_input_dims=False)
        specific = model_config.modalities_specific_dim
        if group == "top_encoders":
            return {m: Encoder_VAE_MLP(BaseAEConfig(input_dim=(specific[m],),
                                                    latent_dim=model_config.msg_dim))
                    for m in model_config.input_dims}
        return {m: Decoder_AE_MLP(BaseAEConfig(input_dim=(specific[m],),
                                               latent_dim=model_config.latent_dim))
                for m in model_config.input_dims}

    def _set_top_nets(self, group: str, nets, model_config) -> nn.ModuleDict:
        if nets is None:
            nets = self._default_top_nets(group, model_config)
            self._default_top.append(group)
        else:
            self.model_config.custom_architectures.append(group)
        kind = "encoder" if group == "top_encoders" else "decoder"
        for v in nets.values():
            if not isinstance(v, nn.Module):
                raise AttributeError(f"Top {kind}s must be torch {kind} modules")
        return nn.ModuleDict(nets)

    def _set_joint_encoder(self, joint_encoder, model_config):
        self._default_joint_encoder = joint_encoder is None
        if joint_encoder is None:
            joint_encoder = Encoder_VAE_MLP(BaseAEConfig(
                input_dim=(model_config.msg_dim,), latent_dim=model_config.latent_dim))
        else:
            self.model_config.custom_architectures.append("joint_encoder")
        if not isinstance(joint_encoder, nn.Module):
            raise AttributeError("Joint encoder must be a torch encoder module")
        self.joint_encoder = joint_encoder

    def _set_bottom_betas(self, bottom_betas):
        if bottom_betas is None:
            bottom_betas = {m: 1.0 for m in self.encoders}
        if bottom_betas.keys() != self.encoders.keys():
            raise AttributeError(
                "The bottom_betas keys do not match the modalities names in encoders.")
        self.bottom_betas = dict(bottom_betas)

    def _set_gammas(self, gammas):
        if gammas is None:
            gammas = {m: 1.0 for m in self.encoders}
        elif gammas.keys() != self.encoders.keys():
            raise AttributeError(
                "The gammas keys do not match the modalities names in encoders.")
        self.gammas = dict(gammas)

    def _set_top_decoder_variance(self, config):
        if config.adapt_top_decoder_variance is None:
            return []
        for m in config.adapt_top_decoder_variance:
            if m not in self.modalities_name:
                raise AttributeError(
                    "A string provided in *adapt_top_decoder_variance* doesn't "
                    f"match any of the modalities name: {m} is not in "
                    f"{self.modalities_name}")
        return list(config.adapt_top_decoder_variance)

    def check_aggregator(self, config):
        if config.aggregator not in ["mean"]:
            raise AttributeError(
                f"This aggregator {config.aggregator} is not supported at the moment")

    def _reset_extra_nets(self, generator: torch.Generator):
        """The default top nets per modality (top encoder, then top
        decoder), then the default joint encoder."""
        for m in self.encoders:
            for group in ("top_encoders", "top_decoders"):
                if group in self._default_top:
                    getattr(self, group)[m].reset_parameters(generator)
        if self._default_joint_encoder:
            self.joint_encoder.reset_parameters(generator)

    # --------------------------------------------------------------- draws
    def draw_dropout(self, n_mods: int, n_rows: int,
                     generator: Optional[torch.Generator] = None):
        """The forced dropout's draws: (drop (n_rows,) bool, Bernoulli of
        ``dropout_rate``; subset sizes (n_rows,) uniform in [1, max(M, 2));
        scores (n_mods, n_rows) uniform in [0, 1))."""
        device = self.device if generator is None else generator.device
        drop = torch.rand(n_rows, generator=generator, device=device) \
            < self.model_config.dropout_rate
        size = torch.randint(1, max(n_mods, 2), (n_rows,), generator=generator,
                             device=device)
        scores = torch.rand((n_mods, n_rows), generator=generator, device=device)
        return drop, size, scores

    # ---------------------------------------------------------------- loss
    def _compute_bottom_elbos(self, batch: MultimodalBatch, annealing: torch.Tensor,
                              generator: Optional[torch.Generator]):
        msgs, first_level_z, metrics = {}, {}, {}
        bottom_loss = 0.0
        for m in self.encoders:
            out = self.encode_mod(m, batch.data[m])
            mu, lv = out["embedding"], out["log_covariance"]
            z_m = self._sample(mu, lv, generator=generator)
            recon = self.decode_mod(m, z_m)
            nlogprob = sum_except_batch(-self.recon_log_probs[m](recon, batch.data[m])
                                        * self.rescale_factors[m])
            kld = -0.5 * sum_f32(1.0 + lv - mu ** 2 - torch.exp(lv))
            m_elbo = nlogprob + kld * self.bottom_betas[m] * annealing
            first_level_z[m] = z_m.detach()
            msgs[m] = self.top_encoders[m](first_level_z[m])["embedding"]
            metrics["recon_loss_" + m] = self.data_shard.mean(nlogprob)
            metrics["kl_" + m] = self.data_shard.mean(kld)
            bottom_loss = bottom_loss + m_elbo * batch.masks[m]
        return bottom_loss, msgs, first_level_z, metrics

    def _aggregate_during_training(self, batch: MultimodalBatch, msgs: dict,
                                   generator: Optional[torch.Generator]):
        """Mean of the messages: weighted by the masks on an incomplete
        batch, under forced perceptual dropout on a complete one."""
        stacked = torch.stack(list(msgs.values()))   # (M, B, d)
        if batch.incomplete:
            mask = torch.stack([batch.masks[m] for m in msgs])
            norm = mask.sum(0).clamp_min(1.0)
            return (stacked * mask[..., None]).sum(0) / norm[:, None]
        n_mods, n_rows = stacked.shape[:2]
        # drawn for the global batch's rows, this process's kept
        shard = self.data_shard
        drop, size, scores = self.draw_dropout(n_mods, n_rows * shard.world, generator)
        drop, size, scores = shard.own(drop), shard.own(size), shard.own(scores, 1)
        ranks = scores.argsort(0).argsort(0)
        keep = (ranks < size[None, :]).to(stacked.dtype)
        keep = torch.where(drop[None, :], keep, torch.ones_like(keep))
        return (stacked * keep[..., None]).sum(0) / keep.sum(0)[:, None]

    def loss_function(self, batch: MultimodalBatch, step: Optional[StepInfo] = None,
                      generator: Optional[torch.Generator] = None) -> ModelOutput:
        step = step or StepInfo()
        annealing = torch.clamp(f32(step.epoch, self.device) / max(self.model_config.warmup, 1),
                                max=1.0)
        bottom_loss, msgs, first_level_z, metrics = self._compute_bottom_elbos(
            batch, annealing, generator)
        joint = self.joint_encoder(self._aggregate_during_training(batch, msgs, generator))
        j_mu, j_lv = joint["embedding"], joint["log_covariance"]
        joint_z = self._sample(j_mu, j_lv, generator=generator)

        shard = self.data_shard
        z_recon_loss = 0.0
        for m in self.top_decoders:
            z_m_recon = self.top_decoders[m](joint_z)["reconstruction"]
            if m in self.adapt_top_decoder_variance:
                # the RMS error over the global batch
                scale = shard.global_mean((first_level_z[m] - z_m_recon) ** 2
                                          ).reshape(1, 1).sqrt()
                log_var = 2.0 * torch.log(scale.clamp_min(1e-12))
            else:
                log_var = torch.zeros((1, 1), dtype=z_m_recon.dtype, device=z_m_recon.device)
            lp = gaussian_log_prob(first_level_z[m], z_m_recon, log_var.expand_as(z_m_recon))
            z_m_loss = -sum_f32(lp) * self.gammas[m] * batch.masks[m]
            z_recon_loss = z_recon_loss + z_m_loss
            metrics["recon_z_" + m] = shard.mean(z_m_loss)

        joint_kld = -0.5 * sum_f32(1.0 + j_lv - j_mu ** 2 - torch.exp(j_lv))
        top_loss = z_recon_loss + self.model_config.top_beta * joint_kld * annealing
        total = (top_loss + bottom_loss) * batch.weights
        n_data = shard.total(batch.weights.sum()).clamp_min(1.0)
        metrics.update({"annealing": shard.share(annealing),
                        "bottom_loss": shard.mean(bottom_loss),
                        "top_loss": shard.mean(top_loss), "joint_KLD": shard.mean(joint_kld)})
        return ModelOutput(loss=total.sum() / n_data, loss_sum=total.sum(), metrics=metrics)

    # -------------------------------------------------------------- encode
    def _encode_subset(self, batch: MultimodalBatch, *, cond_mod: tuple, N: int,
                       return_mean: bool, flatten: bool,
                       generator: Optional[torch.Generator]) -> dict:
        """N bottom codes a row for each conditioning modality (rows in N
        blocks of the batch), the mean of their messages, one top code per
        (sample, row); (N, n_data, ...) unless ``flatten`` or N == 1."""
        modalities_z, msgs = {}, []
        for m in cond_mod:
            out = self.encode_mod(m, batch.data[m])
            z_m = self._sample(out["embedding"], out["log_covariance"], N, return_mean,
                               flatten=True, generator=generator)
            modalities_z[m] = z_m
            msgs.append(self.top_encoders[m](z_m)["embedding"])
        top = self.joint_encoder(torch.stack(msgs).mean(0))
        z = self._sample(top["embedding"], top["log_covariance"], 1, return_mean,
                         generator=generator)
        if N > 1 and not flatten:
            z = z.reshape(N, -1, *z.shape[1:])
            modalities_z = {m: v.reshape(N, -1, *v.shape[1:]) for m, v in modalities_z.items()}
        return {"z": z, "modalities_z": modalities_z}

    def decode(self, embedding: ModelOutput, modalities: Union[list, str] = "all",
               use_bottom_z_for_recon: bool = True) -> ModelOutput:
        """A modality whose bottom code the embedding holds is decoded from it
        (with ``use_bottom_z_for_recon``); the others through their top
        decoder from ``z``. ``z`` may be (n, D) or (N, n, D)."""
        mods = self._decode_modalities(modalities)
        if "modalities_z" not in embedding:
            use_bottom_z_for_recon = False
        z = embedding["z"]
        reshape = z.ndim == 3
        if reshape:
            N, bs = z.shape[:2]
        outputs = ModelOutput()
        for m in mods:
            if use_bottom_z_for_recon and m in embedding["modalities_z"]:
                z_m = embedding["modalities_z"][m]
                if reshape:
                    z_m = z_m.reshape(N * bs, -1)
            else:
                z_m = self.top_decoders[m](z.reshape(N * bs, -1) if reshape else z
                                           )["reconstruction"]
            recon = self.decode_mod(m, z_m)
            outputs[m] = recon.reshape(N, bs, *recon.shape[1:]) if reshape else recon
        return outputs
