"""MoPoE: a mixture over modality subsets of products of experts.

Counterpart of ``multivae_tpu/models/mopoe/mopoe_model.py``:

- every subset's PoE posterior at once: the precisions ``1/(exp(lv) +
  1e-8)`` and precision-weighted means of the M experts summed per subset
  by an (S, M) x (M, B, D) product with the 0/1 membership matrix; the
  prior expert joins the full subset only;
- each row trains on one component: on complete data the rows are split
  into S equal index ranges, on incomplete data (a batch from a dataset
  with masks) one subset is drawn per row among those whose modalities are
  all available (uniformly among all when none is), through
  ``draw_components``;
- the divergence is the availability-weighted sum of the subsets' KLs; with
  ``modalities_specific_dim`` each modality also has a private code,
  decoded with the shared one and weighed by ``beta_style``;
- inference: ``encode`` samples the subset's posterior (``return_mean`` on
  the full subset gives the mean of all subsets' means, as the JAX package
  does); ``compute_joint_nll`` weighs samples of the split components by the
  whole mixture's density, ``compute_joint_nll_paper`` by the full subset's.

The mixture density of the NLL is reduced over D one subset at a time, so
its peak holds one (chunk, B, D) term, not S of them.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ...data.batch import MultimodalBatch, add_axes, as_batch
from ...nn.default_architectures import (
    BaseDictDecodersMultiLatents,
    BaseDictEncoders_MultiLatents,
)
from ...ops.gaussian import gaussian_log_prob, rsample_from_gaussian, sum_f32
from ...ops.iwae import iwae_log_marginal
from ...ops.subsets import all_subsets, subsets_to_mask
from ...utils.model_output import ModelOutput
from ..base.base_ae_model import BaseMultiVAE, sum_except_batch
from ..base.step import StepInfo
from .mopoe_config import MoPoEConfig


def _std_normal_kl(mu, log_var):
    """KL(N(mu, exp(log_var)) || N(0, I)), summed over the last axis."""
    return -0.5 * sum_f32(1.0 - torch.exp(log_var) - mu ** 2 + log_var)


class MoPoE(BaseMultiVAE):
    """Mixture of products of experts."""

    model_name = "MoPoE"

    def __init__(self, model_config: MoPoEConfig, encoders: dict = None,
                 decoders: dict = None, seed: int = 0, device="cuda"):
        super().__init__(model_config, encoders, decoders, seed=seed, device=device)
        self.multiple_latent_spaces = model_config.modalities_specific_dim is not None
        if self.multiple_latent_spaces:
            self.style_dims = dict(model_config.modalities_specific_dim)
        self.beta = model_config.beta
        self.beta_style = model_config.beta_style
        subsets = model_config.subsets
        if isinstance(subsets, dict):
            subsets = list(subsets.values())
        self.set_subsets(all_subsets(list(self.encoders)) if subsets is None else subsets)
        self.init_params()

    def default_encoders(self, model_config) -> dict:
        if model_config.modalities_specific_dim is not None:
            return BaseDictEncoders_MultiLatents(
                model_config.input_dims, model_config.latent_dim,
                model_config.modalities_specific_dim)
        return super().default_encoders(model_config)

    def default_decoders(self, model_config) -> dict:
        if model_config.modalities_specific_dim is not None:
            return BaseDictDecodersMultiLatents(
                model_config.input_dims, model_config.latent_dim,
                model_config.modalities_specific_dim)
        return super().default_decoders(model_config)

    # -------------------------------------------------------------- subsets
    def set_subsets(self, subsets_list):
        """The mixture's subsets, keyed by their sorted modality names
        joined by '_' (the empty subset is skipped); unknown names raise."""
        subsets = {}
        for mod_names in subsets_list:
            clean = []
            for name in sorted(mod_names):
                if name not in self.encoders and name != "":
                    raise AttributeError(
                        "The provided subsets list contains unknown modality "
                        f"name {name}.")
                clean.append(name)
            if clean:
                subsets["_".join(clean)] = clean
        self.subsets = subsets
        self.model_config.subsets = subsets
        self._subset_names = list(subsets)
        membership = subsets_to_mask(list(subsets.values()), list(self.encoders))
        self.register_buffer("_subset_mask", torch.as_tensor(membership, device=self.device),
                             persistent=False)
        # the prior expert joins the full subset only
        self.register_buffer("_full_subset_flag", torch.as_tensor(
            (membership.sum(-1) == len(self.encoders)).astype("float32"),
            device=self.device), persistent=False)

    def draw_components(self, logits, generator: Optional[torch.Generator] = None):
        """One subset index per row, from ``softmax(logits)`` (B, S)."""
        return torch.multinomial(torch.softmax(logits, -1), 1,
                                 generator=generator).squeeze(-1)

    def _all_subset_posteriors(self, batch: MultimodalBatch, eps: float = 1e-8):
        """(mus, log_vars) (S, B, D) of every subset's PoE, and the
        encoders' outputs."""
        enc = {m: self.encode_mod(m, batch.data[m]) for m in self.encoders}
        mus = torch.stack([enc[m]["embedding"] for m in self.encoders])
        precision = 1.0 / (torch.exp(torch.stack(
            [enc[m]["log_covariance"] for m in self.encoders])) + eps)    # (M, B, D)
        # the float32 membership promotes bf16 experts (JAX's einsum does)
        dtype = torch.promote_types(mus.dtype, self._subset_mask.dtype)
        S = self._subset_mask.to(dtype)
        total = torch.einsum("sm,mbd->sbd", S, precision.to(dtype))
        total = total + (self._full_subset_flag.to(dtype) / (1.0 + eps))[:, None, None]
        mu_sub = torch.einsum("sm,mbd->sbd", S, (mus * precision).to(dtype))
        return mu_sub / total, -torch.log(total), enc

    def _availabilities(self, batch: MultimodalBatch):
        """(S, B): 1 where every modality of the subset is available, in at
        least float32 (as JAX's)."""
        mask = torch.stack([batch.masks[m] for m in self.encoders])     # (M, B)
        missing = torch.einsum("sm,mb->sb", self._subset_mask.to(mask.dtype), 1.0 - mask)
        return (missing == 0).to(torch.promote_types(mask.dtype, torch.float32))

    def _inference(self, batch: MultimodalBatch, incomplete: bool,
                   generator: Optional[torch.Generator] = None) -> dict:
        """All subset posteriors, the mixture weights (S, B) and each row's
        component ``joint``: drawn among the available subsets on
        incomplete data, the equal index-range split on complete data."""
        mus, log_vars, enc = self._all_subset_posteriors(batch)
        S, B = mus.shape[:2]
        shard = self.data_shard
        if incomplete:
            avail = self._availabilities(batch)
            weights = avail / avail.sum(0).clamp_min(1e-12)
            # drawn for the global batch's rows, this process's kept
            idx = shard.own(self.draw_components(
                shard.spread(torch.log(weights.T.clamp_min(1e-12))), generator))
        else:
            # the split of the global batch's index range
            weights = torch.full((S, B), 1.0 / S, dtype=mus.dtype, device=mus.device)
            idx = (shard.rows(B, mus.device) // max(B * shard.world // S, 1)).clamp_max(S - 1)
        rows = torch.arange(B, device=mus.device)
        return {"mus": mus, "log_vars": log_vars, "weights": weights,
                "joint": (mus[idx, rows], log_vars[idx, rows]), "modalities": enc}

    # ----------------------------------------------------------------- loss
    def loss_function(self, batch: MultimodalBatch, step: Optional[StepInfo] = None,
                      generator: Optional[torch.Generator] = None) -> ModelOutput:
        latents = self._inference(batch, batch.incomplete, generator)
        jmu, jlv = latents["joint"]
        shard = self.data_shard
        z = rsample_from_gaussian(jmu, jlv, noise=shard.draw(self.noise_for(jmu), jmu.shape,
                                                             generator))
        w = batch.weights
        n_data = shard.total(w.sum()).clamp_min(1.0)
        klds = _std_normal_kl(latents["mus"], latents["log_vars"])        # (S, B)
        kld = ((latents["weights"] * klds).sum(0) * w).sum() / n_data
        metrics = {"joint_divergence": kld}

        loss = 0.0
        for m in self.encoders:
            emb = z
            if self.multiple_latent_spaces:
                o = latents["modalities"][m]
                style_mu, style_lv = o["style_embedding"], o["style_log_covariance"]
                style_z = rsample_from_gaussian(
                    style_mu, style_lv, noise=shard.draw(self.draw_noise, style_mu.shape,
                                                         generator))
                emb = torch.cat([z, style_z], -1)
            m_rec = sum_except_batch(-self.recon_log_probs[m](self.decode_mod(m, emb),
                                                              batch.data[m])
                                     * self.rescale_factors[m])
            rec_m = (m_rec * batch.masks[m] * w).sum() / n_data
            metrics["recon_" + m] = rec_m
            loss = loss + rec_m
            if self.multiple_latent_spaces:
                style_kld = (_std_normal_kl(style_mu, style_lv) * batch.masks[m] * w).sum()
                kld = kld + style_kld / n_data * self.beta_style
        loss = loss + self.beta * kld
        return ModelOutput(loss=loss, loss_sum=loss * n_data, metrics=metrics)

    # ------------------------------------------------------------ inference
    def _encode_subset(self, batch: MultimodalBatch, *, cond_mod: tuple, N: int,
                       return_mean: bool, flatten: bool,
                       generator: Optional[torch.Generator]) -> dict:
        """The subset's PoE posterior (the mean of every subset's mean with
        ``return_mean`` on the full subset); private codes from the
        conditioning modalities' posteriors, else from N(0, I)."""
        key = "_".join(sorted(cond_mod))
        if key not in self._subset_names:
            raise AttributeError(
                f"Subset {key} is not in the model's subsets; cannot encode.")
        s_idx = self._subset_names.index(key)
        mus, log_vars, enc = self._all_subset_posteriors(batch)
        mu, log_var = mus[s_idx], log_vars[s_idx]
        if return_mean and len(cond_mod) == self.n_modalities:
            mu = mus.mean(0)
        out = {"z": self._sample(mu, log_var, N, return_mean, flatten, generator)}
        if self.multiple_latent_spaces:
            out["modalities_z"] = {}
            for m in self.encoders:
                if m in cond_mod:
                    mu_s, lv_s = enc[m]["style_embedding"], enc[m]["style_log_covariance"]
                else:
                    mu_s = lv_s = torch.zeros(mu.shape[0], self.style_dims[m],
                                              device=mu.device)
                out["modalities_z"][m] = self._sample(mu_s, lv_s, N, return_mean,
                                                      flatten, generator)
        return out

    def _private_terms(self, enc, chunk: int, generator: Optional[torch.Generator]):
        """Private codes (chunk, B, S_m) of every modality and their prior
        and posterior log-densities (chunk, B)."""
        private_z, lpz, lqz = {}, 0.0, 0.0
        for m in self.encoders:
            mu_s, lv_s = enc[m]["style_embedding"], enc[m]["style_log_covariance"]
            z_s = rsample_from_gaussian(mu_s, lv_s, N=chunk, noise=self.data_shard.draw(
                self.draw_noise, (chunk, *mu_s.shape), generator))
            private_z[m] = z_s
            zeros = torch.zeros_like(z_s)
            lpz = lpz + sum_f32(gaussian_log_prob(z_s, zeros, zeros))
            lqz = lqz + sum_f32(gaussian_log_prob(z_s, mu_s[None], lv_s[None]))
        return private_z, lpz, lqz

    def _iwae_nll(self, batch: MultimodalBatch, enc, jmu, jlv, lq_fn, K: int,
                  batch_size_K: int, generator: Optional[torch.Generator]):
        """-sum_rows ln p(X) from K samples of N(jmu, exp(jlv)) weighed by
        ``lq_fn(z)``, the importance density of the shared code."""

        def logw_chunk(chunk: int):
            z = rsample_from_gaussian(jmu, jlv, N=chunk, noise=self.data_shard.draw(
                self.draw_noise, (chunk, *jmu.shape), generator))
            private_z, lpz, lqz = ({}, 0.0, 0.0)
            if self.multiple_latent_spaces:
                private_z, lpz, lqz = self._private_terms(enc, chunk, generator)
            lpx_z = 0.0
            for m in self.decoders:
                emb = torch.cat([z, private_z[m]], -1) if private_z else z
                lpx_z = lpx_z + sum_except_batch(
                    self.recon_log_probs[m](self.decode_mod(m, emb), add_axes(batch.data[m])),
                    batch_ndims=2)
            zeros = torch.zeros_like(z)
            lpz = gaussian_log_prob(z, zeros, zeros).sum(-1) + lpz
            return lpx_z + lpz - (lq_fn(z) + lqz)

        ln_px = iwae_log_marginal(logw_chunk, K, batch_size_K)
        return -(ln_px * batch.weights).sum()

    @torch.no_grad()
    def compute_joint_nll(self, inputs, K: int = 1000, batch_size_K: int = 100,
                          generator: Optional[torch.Generator] = None):
        """K-sample estimate of -sum_rows ln p(X): samples of each row's
        component of the complete-data split, weighed by the mixture density
        log(1/S sum_s q_s(z)); complete data only."""
        self._check_complete_for_nll(inputs)
        batch = as_batch(inputs).to(self.device)
        latents = self._inference(batch, incomplete=False)
        mus, log_vars = latents["mus"], latents["log_vars"]

        def mixture_lq(z):
            # one subset at a time: the peak holds one (chunk, B, D) term
            lq = torch.stack([sum_f32(gaussian_log_prob(z, mus[s][None], log_vars[s][None]))
                              for s in range(mus.shape[0])])
            return torch.logsumexp(lq, 0) - math.log(float(mus.shape[0]))

        return self._iwae_nll(batch, latents["modalities"], *latents["joint"],
                              mixture_lq, K, batch_size_K, generator)

    @torch.no_grad()
    def _compute_joint_nll_from_subset_encoding(self, subset, inputs, K: int = 1000,
                                                batch_size_K: int = 100,
                                                generator: Optional[torch.Generator] = None):
        """K-sample estimate of -sum_rows ln p(X) with the PoE posterior of
        ``subset`` as the importance distribution; complete data only."""
        self._check_complete_for_nll(inputs)
        batch = as_batch(inputs).to(self.device)
        mus, log_vars, enc = self._all_subset_posteriors(batch)
        s_idx = self._subset_names.index("_".join(sorted(subset)))
        jmu, jlv = mus[s_idx], log_vars[s_idx]
        return self._iwae_nll(
            batch, enc, jmu, jlv,
            lambda z: sum_f32(gaussian_log_prob(z, jmu[None], jlv[None])),
            K, batch_size_K, generator)

    def compute_joint_nll_paper(self, inputs, K: int = 1000, batch_size_K: int = 100,
                                generator: Optional[torch.Generator] = None):
        """The joint NLL of the original paper's code: the full subset's PoE
        posterior as the importance distribution."""
        return self._compute_joint_nll_from_subset_encoding(
            list(self.encoders), inputs, K, batch_size_K, generator)
