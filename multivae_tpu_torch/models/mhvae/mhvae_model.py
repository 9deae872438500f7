"""MHVAE: the multimodal hierarchical VAE with L latent levels.

Counterpart of ``multivae_tpu/models/mhvae/mhvae_model.py``:

- each modality's encoder and its L-1 bottom-up blocks give the deepest
  level's posterior parameters and a skip per level (the encoder's output,
  then each block's but the last);
- the top-down pass samples z_L from the product of the subset's experts
  and the prior expert N(0, I); at each level i below, the top-down block
  maps z_{i+1} to h, the prior block gives p(z_i | z_{i+1}) from h, and each
  of the subset's modalities gives an expert from its posterior block on
  ``[h, skip]`` (concatenated on the channel axis of NCHW maps, the feature
  axis of vectors); z_i is sampled from the product of those experts and
  the prior. Missing modalities have zero precision (the rows' masks);
- the loss is, for every non-empty subset in ``all_subsets`` order, the
  reconstruction of every modality from z_1 plus ``beta`` times the sum of
  the levels' KLs, each summed over rows (row weights and modality masks
  applied) and over every trailing axis; ``loss`` is the mean over the
  subsets and ``loss_sum`` the same number (not divided by the row count);
  ``metrics`` are the KLs of the last subset;
- posterior blocks are shared by the modalities (a list) or one list per
  modality (a dict);
- encode replicates the posteriors' parameters and skips N times, then runs
  the top-down pass: ``z`` is z_1 and ``all_z`` holds every level.

The JAX package runs the subsets' passes one after the other; here every
subset's pass runs at once, as one batch of (subsets x rows) rows a level
(one top-down, prior and shared posterior call a level, each decoder
once), so that the 31 subsets of 5 modalities cost the host few launches.
The numbers are the same: each row sees the same experts. Noise is drawn
through ``draw_noise``, one draw a level, the deepest first, of (subsets x
rows, ...) with the subsets in ``all_subsets`` order; the JAX package draws
subset by subset, each from its own key. The JAX package builds its
blocks' parameters lazily from a first batch; here the caller passes built
modules, which keep their weights. Every block group is a custom
architecture, saved and reloaded with the model.
"""

from __future__ import annotations

from typing import Optional, Union

import torch
from torch import nn

from ...data.batch import MultimodalBatch, add_axes
from ...ops.gaussian import kl_divergence, masked_poe, sum_f32
from ...ops.subsets import all_subsets
from ...utils.model_output import ModelOutput
from ..base.base_ae_model import BaseMultiVAE, sum_except_batch
from ..base.step import StepInfo
from .mhvae_config import MHVAEConfig


def _sum_trailing(x):
    """Sum every axis but the first (latents may be conv feature maps)."""
    return sum_f32(x.reshape(x.shape[0], -1))


def _embedding_of(out):
    return out["embedding"] if isinstance(out, dict) else out


class MHVAE(BaseMultiVAE):
    """Multimodal hierarchical VAE; every block architecture is required."""

    model_name = "MHVAE"
    supports_per_sample_conditioning = True

    def __init__(self, model_config: MHVAEConfig, encoders: dict, decoders: dict,
                 bottom_up_blocks: dict, top_down_blocks: list,
                 posterior_blocks: Union[list, dict], prior_blocks: list,
                 seed: int = 0, device="cuda"):
        super().__init__(model_config, encoders, decoders, seed=seed, device=device)
        self.n_latent = model_config.n_latent
        self.beta = model_config.beta

        self.sanity_check_bottom_up(encoders, bottom_up_blocks)
        self.bottom_up_blocks = nn.ModuleDict(
            {m: nn.ModuleList(v) for m, v in bottom_up_blocks.items()})
        self.sanity_check_top_down_blocks(top_down_blocks)
        self.top_down_blocks = nn.ModuleList(top_down_blocks)
        self.sanity_check_prior_blocks(prior_blocks)
        self.prior_blocks = nn.ModuleList(prior_blocks)
        self.check_and_set_posterior_blocks(posterior_blocks)

        self.model_config.custom_architectures.extend(
            ["bottom_up_blocks", "top_down_blocks", "prior_blocks", "posterior_blocks"])
        self.subsets = all_subsets(list(self.encoders.keys()))
        self.init_params()

    # ------------------------------------------------------------ checks
    def sanity_check_bottom_up(self, encoders, bottom_up_blocks):
        if self.n_modalities != len(bottom_up_blocks.keys()):
            raise AttributeError(
                f"The provided number of bottom_up_blocks "
                f"{len(bottom_up_blocks.keys())} doesn't match the number of "
                f"modalities ({self.n_modalities}) in model config")
        if encoders.keys() != bottom_up_blocks.keys():
            raise AttributeError(
                "The names of the modalities in the encoders dict don't "
                "match the names in the bottom_up_blocks dict.")
        for mod in bottom_up_blocks:
            if len(bottom_up_blocks[mod]) != self.model_config.n_latent - 1:
                raise AttributeError(
                    f"There must be {self.model_config.n_latent - 1} "
                    f"bottom_up_blocks for modality {mod} but you provided "
                    f"{len(bottom_up_blocks[mod])} layers.")

    def sanity_check_top_down_blocks(self, top_down_blocks):
        if len(top_down_blocks) != self.model_config.n_latent - 1:
            raise AttributeError(
                f"There must be {self.model_config.n_latent - 1} modules in "
                "top_down_blocks.")

    def sanity_check_prior_blocks(self, prior_blocks):
        if len(prior_blocks) != self.model_config.n_latent - 1:
            raise AttributeError(
                f"There must be {self.model_config.n_latent - 1} modules in prior.")

    def check_and_set_posterior_blocks(self, posterior_blocks):
        n = self.model_config.n_latent - 1
        if isinstance(posterior_blocks, (list, nn.ModuleList)):
            self.share_posterior_weights = True
            if len(posterior_blocks) != n:
                raise AttributeError(
                    f"There must be {n} modules in posterior_blocks.")
            self.posterior_blocks = nn.ModuleList(posterior_blocks)
            return
        if isinstance(posterior_blocks, dict):
            self.share_posterior_weights = False
            if posterior_blocks.keys() != self.encoders.keys():
                raise AttributeError(
                    "The keys of posterior_blocks must match the keys of encoders.")
            for m, p in posterior_blocks.items():
                if len(p) != n:
                    raise AttributeError(
                        f"There must be {n} modules in posterior_blocks[{m}].")
            self.posterior_blocks = nn.ModuleDict(
                {m: nn.ModuleList(v) for m, v in posterior_blocks.items()})
            return
        raise AttributeError("posterior_blocks must be a list or a dict")

    # ----------------------------------------------------------- passes
    def modality_encode(self, data: dict):
        """Bottom-up pass of each modality in ``data``: the deepest level's
        posterior parameters and the skips, per modality."""
        skips, z_l_params = {}, {}
        for m in data:
            z = _embedding_of(self.encode_mod(m, data[m]))
            mod_skips = [z]
            for block in self.bottom_up_blocks[m][:-1]:
                z = _embedding_of(block(z))
                mod_skips.append(z)
            z_l_params[m] = self.bottom_up_blocks[m][-1](z)
            skips[m] = mod_skips
        return z_l_params, skips

    def _top_down(self, z_l_params, skips, subsets, batch: MultimodalBatch,
                  return_mean: bool = False, generator: Optional[torch.Generator] = None):
        """The top-down passes of ``subsets``, all at once: their rows in
        blocks of the batch's, one block per subset. At every level, each
        subset's product of its modalities' experts (times the rows' masks)
        and the prior expert. Returns (z_dict, kl_dict): ``z_<i>`` of
        (len(subsets) * B, ...) rows and ``kl_<i>`` of (len(subsets),), each
        subset's KL summed over its weighted rows, for i = L ... 1."""
        mods = [m for m in self.encoders if m in z_l_params]
        n_sub, n_rows = len(subsets), batch.weights.shape[0]
        # the (modality, subset) pairs of the subsets' members, by modality
        pairs = [(j, k) for j, m in enumerate(mods) for k, sub in enumerate(subsets)
                 if m in sub]
        # modality j's pairs: pairs[runs[j][0]:runs[j][1]]
        runs = [(sum(j < jj for j, _ in pairs), sum(j <= jj for j, _ in pairs))
                for jj in range(len(mods))]
        pair_mod = torch.tensor([j for j, _ in pairs], device=self.device)
        pair_sub = torch.tensor([k for _, k in pairs], device=self.device)
        member = torch.zeros(len(mods), n_sub, device=self.device)
        member[pair_mod, pair_sub] = 1.0
        mask = member[..., None] * torch.stack([batch.masks[m] for m in mods])[:, None]
        mask = torch.cat([mask.reshape(len(mods), -1),
                          torch.ones_like(mask[:1].reshape(1, -1))])

        def experts(values, prior):
            """(members' values (P, B, ...), the prior's (S * B, ...)) ->
            (M + 1, S * B, ...), zero where a modality is not a member."""
            dense = values.new_zeros(len(mods), n_sub, *values.shape[1:])
            dense = dense.index_put((pair_mod, pair_sub), values)
            return torch.cat([dense.reshape(len(mods), -1, *values.shape[2:]), prior[None]])

        def level(key, mu, lv, prior_mu, prior_lv):
            z_dict[f"z_{key}"] = self._sample(mu, lv, return_mean=return_mean,
                                              generator=generator, row_blocks=n_sub)
            kl = _sum_trailing(kl_divergence(mu, lv, prior_mu, prior_lv))
            kl_dict[f"kl_{key}"] = (kl.reshape(n_sub, n_rows) * batch.weights).sum(-1)

        z_dict, kl_dict = {}, {}
        mus = torch.stack([z_l_params[m]["embedding"] for m in mods])[pair_mod]
        lvs = torch.stack([z_l_params[m]["log_covariance"] for m in mods])[pair_mod]
        zeros = mus.new_zeros(n_sub * n_rows, *mus.shape[2:])
        joint_mu, joint_lv = masked_poe(experts(mus, zeros), experts(lvs, zeros), mask)
        level(self.n_latent, joint_mu, joint_lv, zeros, zeros)
        for i in range(self.n_latent - 1, 0, -1):
            h = _embedding_of(self.top_down_blocks[i - 1](z_dict[f"z_{i + 1}"]))
            prior = self.prior_blocks[i - 1](h)
            h = h.reshape(n_sub, n_rows, *h.shape[1:])
            skip = torch.stack([skips[m][i - 1] for m in mods])
            inputs = torch.cat([h[pair_sub], skip[pair_mod]], 2)    # (P, B, C, ...)
            if self.share_posterior_weights:
                post = self.posterior_blocks[i - 1](inputs.flatten(0, 1))
                post_mu, post_lv = post["embedding"], post["log_covariance"]
            else:
                outs = [self.posterior_blocks[m][i - 1](inputs[a:b].flatten(0, 1))
                        for m, (a, b) in zip(mods, runs) if b > a]
                post_mu = torch.cat([o["embedding"] for o in outs])
                post_lv = torch.cat([o["log_covariance"] for o in outs])
            post_mu = post_mu.reshape(len(pairs), n_rows, *post_mu.shape[1:])
            post_lv = post_lv.reshape(len(pairs), n_rows, *post_lv.shape[1:])
            level_mu, level_lv = masked_poe(experts(post_mu, prior["embedding"]),
                                            experts(post_lv, prior["log_covariance"]), mask)
            level(i, level_mu, level_lv, prior["embedding"], prior["log_covariance"])
        return z_dict, kl_dict

    # ------------------------------------------------------------- loss
    def loss_function(self, batch: MultimodalBatch, step: Optional[StepInfo] = None,
                      generator: Optional[torch.Generator] = None) -> ModelOutput:
        """Every subset's top-down pass at once, then their z_1 through each
        decoder."""
        z_l_params, skips = self.modality_encode(batch.data)
        z_dict, kl_dict = self._top_down(z_l_params, skips, self.subsets, batch,
                                         generator=generator)
        n_sub, n_rows = len(self.subsets), batch.n_samples
        recon_loss = 0.0
        for mod in self.decoders:
            recon = self.decode_mod(mod, z_dict["z_1"])
            recon = recon.reshape(n_sub, n_rows, *recon.shape[1:])
            mod_loss = sum_except_batch(-self.recon_log_probs[mod](recon, add_axes(batch.data[mod]))
                                        * self.rescale_factors[mod], batch_ndims=2)
            recon_loss = recon_loss + (mod_loss * batch.masks[mod] * batch.weights).sum(-1)
        kl = sum(kl_dict[f"kl_{i}"] for i in range(1, self.n_latent + 1))
        loss = (recon_loss + self.beta * kl).mean()
        return ModelOutput(loss=loss, loss_sum=loss,
                           metrics={k: v[-1] for k, v in kl_dict.items()})

    # ------------------------------------------------------------ encode
    def _encode_subset(self, batch: MultimodalBatch, *, cond_mod: tuple, N: int,
                       return_mean: bool, flatten: bool,
                       generator: Optional[torch.Generator]) -> dict:
        """The posteriors and skips replicated N times (rows in N blocks of
        the batch), then the top-down pass over ``cond_mod``'s experts (with
        the rows' masks). Returns z_1 as ``z`` and every level as ``all_z``,
        (N, n_data, ...) unless ``flatten`` or N == 1."""
        z_l_params, skips = self.modality_encode(batch.data)
        n_data = batch.n_samples
        if N > 1:
            z_l_params = {m: ModelOutput(embedding=torch.cat([v["embedding"]] * N),
                                         log_covariance=torch.cat([v["log_covariance"]] * N))
                          for m, v in z_l_params.items()}
            skips = {m: [torch.cat([t] * N) for t in v] for m, v in skips.items()}
            batch = MultimodalBatch(
                data=batch.data, masks={m: torch.cat([v] * N) for m, v in batch.masks.items()},
                weights=torch.cat([batch.weights] * N), labels=None,
                incomplete=batch.incomplete)
        z_dict, _ = self._top_down(z_l_params, skips, [tuple(cond_mod)], batch,
                                   return_mean=return_mean, generator=generator)
        if not flatten and N > 1:
            z_dict = {k: v.reshape(N, n_data, *v.shape[1:]) for k, v in z_dict.items()}
        return {"z": z_dict["z_1"], "all_z": z_dict}
