"""BaseMultiVAE: the shared multimodal-VAE machinery.

Counterpart of ``multivae_tpu/models/base/base_ae_model.py``: the
constructor checks, ``set_rescale_factors``, ``set_decoders_dist``,
``encode_mod`` / ``decode_mod`` (any leading shape; under
``torch.utils.checkpoint`` with ``use_remat``), ``forward`` and the
inference surface: ``encode`` / ``decode`` / ``predict`` /
``generate_from_prior``, the Gaussian-posterior K-sample joint NLL
(``_gaussian_iwae_joint_nll``) and ``compute_cond_nll``. Models with
private latent spaces set ``multiple_latent_spaces``: their ``encode``
returns ``modalities_z`` beside ``z``, and ``decode`` concatenates each
modality's private code to ``z``. The PoE families
(``supports_per_sample_conditioning``) also encode an incomplete batch row
by row from the modalities each row has (``encode_per_sample``).

Every random draw goes through ``draw_noise(shape, generator)`` (standard
normal, from ``BaseModel``; MMVAE overrides it), so a test can feed another
package's noise. The JAX package compiles one program per encode subset;
eager PyTorch needs no such sharing, so a model implements
``_encode_subset`` alone.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Union

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ...data.batch import MultimodalBatch, add_axes, as_batch
from ...nn.default_architectures import BaseDictDecoders, BaseDictEncoders
from ...ops.dists import set_decoder_dist
from ...ops.gaussian import gaussian_log_prob, rsample_from_gaussian, sum_f32
from ...ops.iwae import iwae_log_marginal
from ...utils.device import resolve_device
from ...utils.model_output import ModelOutput
from .base_config import BaseMultiVAEConfig
from .base_model import BaseModel
from .step import StepInfo


def sum_except_batch(x, batch_ndims: int = 1):
    """Sum all but the leading ``batch_ndims`` axes, in at least float32."""
    return sum_f32(x.reshape(*x.shape[:batch_ndims], -1))


def pick_expert(stacked: torch.Tensor, idx) -> torch.Tensor:
    """``stacked[idx]`` for an expert index from ``draw_expert`` (a 0-d
    tensor, or an int from a test's hook), read on the device: no host
    read, so a traced program keeps the pick as an input."""
    idx = torch.as_tensor(idx, device=stacked.device).reshape(1)
    return stacked.index_select(0, idx)[0]


def _all_available(mask) -> bool:
    if isinstance(mask, torch.Tensor):
        return bool(mask.bool().all())
    return bool(np.all(np.asarray(mask)))


class BaseMultiVAE(BaseModel):
    """Base class for multimodal VAE models.

    Args:
        model_config: a BaseMultiVAEConfig (or subclass).
        encoders: dict modality -> encoder ``nn.Module``. Defaults to MLP
            encoders built from ``model_config.input_dims``.
        decoders: dict modality -> decoder ``nn.Module``.
        seed: seed of the generator that initializes the default nets.
        device: where the model lives (default "cuda"; raises when CUDA
            is absent).
    """

    model_name = "BaseMultiVAE"

    def __init__(self, model_config: BaseMultiVAEConfig, encoders: dict = None,
                 decoders: dict = None, seed: int = 0, device="cuda"):
        super().__init__(model_config)
        self._device = resolve_device(device)
        self._seed = seed

        self.n_modalities = model_config.n_modalities
        self.input_dims = model_config.input_dims
        self.latent_dim = model_config.latent_dim
        self.multiple_latent_spaces = False
        self.use_likelihood_rescaling = model_config.uses_likelihood_rescaling
        self._check_input_dims(model_config)

        self._default_nets = []
        if encoders is None:
            if self.input_dims is None:
                raise AttributeError(
                    "Please provide encoders or input dims for the modalities "
                    "in the model_config.")
            encoders = self.default_encoders(model_config)
            self._default_nets.append("encoders")
        else:
            model_config.custom_architectures.append("encoders")
        if decoders is None:
            if self.input_dims is None:
                raise AttributeError(
                    "Please provide decoders or input dims for the modalities "
                    "in the model_config.")
            decoders = self.default_decoders(model_config)
            self._default_nets.append("decoders")
        else:
            model_config.custom_architectures.append("decoders")

        self.sanity_check(encoders, decoders)
        self.encoders = nn.ModuleDict(encoders)
        self.decoders = nn.ModuleDict(decoders)
        self.modalities_name = list(self.decoders.keys())
        self.rescale_factors = self.set_rescale_factors()

        if model_config.decoders_dist is None:
            model_config.decoders_dist = {k: "normal" for k in self.encoders}
        if model_config.decoder_dist_params is None:
            model_config.decoder_dist_params = {}
        self.set_decoders_dist(model_config.decoders_dist,
                               dict(model_config.decoder_dist_params))

    # ----------------------------------------------------------- validation
    def _check_input_dims(self, model_config):
        if (model_config.input_dims is not None
                and len(model_config.input_dims) != model_config.n_modalities):
            raise AttributeError(
                f"The provided number of input_dims "
                f"{len(model_config.input_dims)} doesn't match the number "
                f"of modalities ({model_config.n_modalities}) in model config")

    def sanity_check(self, encoders, decoders):
        """Coherence checks between encoders/decoders and the config."""
        if self.n_modalities != len(encoders):
            raise AttributeError(
                f"The provided number of encoders {len(encoders)} doesn't "
                f"match the number of modalities ({self.n_modalities}) in "
                "model config")
        if self.n_modalities != len(decoders):
            raise AttributeError(
                f"The provided number of decoders {len(decoders)} doesn't "
                f"match the number of modalities ({self.n_modalities}) in "
                "model config")
        if encoders.keys() != decoders.keys():
            raise AttributeError(
                "The names of the modalities in the encoders dict doesn't match "
                "the names of the modalities in the decoders dict.")
        for kind, nets in (("encoder", encoders), ("decoder", decoders)):
            for m, net in nets.items():
                if not isinstance(net, nn.Module):
                    raise AttributeError(
                        f"For modality {m}, the {kind} must be a "
                        f"torch.nn.Module (got {type(net)}).")
        if self.input_dims is not None and self.input_dims.keys() != encoders.keys():
            raise KeyError(
                f"The modalities names in model_config.input_dims: "
                f"{list(self.input_dims.keys())} do not match the "
                f"modalities names in encoders: {list(encoders.keys())}")

    def set_rescale_factors(self):
        """Per-modality reconstruction rescaling."""
        if self.use_likelihood_rescaling:
            if self.model_config.rescale_factors is not None:
                return dict(self.model_config.rescale_factors)
            if self.input_dims is None:
                raise AttributeError(
                    "inputs_dim is None but uses_likelihood_rescaling = True in "
                    "model_config. Please provide input_dims or rescale_factors.")
            sizes = {k: float(np.prod(self.input_dims[k])) for k in self.input_dims}
            max_dim = max(sizes.values())
            return {k: max_dim / sizes[k] for k in sizes}
        return {k: 1.0 for k in self.encoders}

    def set_decoders_dist(self, recon_dict, dist_params_dict):
        """Per-modality elementwise reconstruction log-prob closures."""
        self.recon_log_probs = {
            k: set_decoder_dist(recon_dict[k], dict(dist_params_dict.get(k, {})))
            for k in recon_dict
        }

    # ------------------------------------------------------------- defaults
    def default_encoders(self, model_config) -> dict:
        return BaseDictEncoders(self.input_dims, model_config.latent_dim)

    def default_decoders(self, model_config) -> dict:
        return BaseDictDecoders(self.input_dims, model_config.latent_dim)

    # ------------------------------------------------------- initialization
    def _init_extra_params(self):
        """Extra learnable tensors (prior params...): name -> Parameter."""
        return {}

    def _reset_extra_nets(self, generator: torch.Generator):
        """Draw the weights of the default nets beyond the per-modality ones
        (a joint encoder) from ``generator``."""

    def init_params(self):
        """Draw the default nets' weights from ``torch.Generator(seed)`` (per
        modality: encoder, then decoder; then ``_reset_extra_nets``),
        register the extra parameters and move everything to the model's
        device. User-supplied nets keep their own weights."""
        generator = torch.Generator().manual_seed(self._seed)
        for mod in self.encoders:
            for group in self._default_nets:
                getattr(self, group)[mod].reset_parameters(generator)
        self._reset_extra_nets(generator)
        for name, param in self._init_extra_params().items():
            self.register_parameter(name, param)
        self.to(self._device)

    # -------------------------------------------------------------- compute
    def _remat(self, fn, *args):
        """``fn(*args)``; with ``use_remat`` and gradients on, its
        activations are recomputed in the backward instead of kept (the
        same numbers, less memory)."""
        if self.model_config.use_remat and torch.is_grad_enabled():
            return checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    def encode_mod(self, mod: str, x) -> ModelOutput:
        return self._remat(self.encoders[mod], x)

    def decode_mod(self, mod: str, z):
        """Decoder output for ``mod``; ``z`` may have any leading shape."""
        return self._remat(lambda v: self.decoders[mod](v)["reconstruction"], z)

    def draw_expert(self, n_experts: int,
                    generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """A uniform random expert index in [0, n_experts) (the mixture
        models' encode and NLL), a 0-d int64 tensor on the generator's
        device: the encode picks the expert with it on the device
        (``pick_expert``), so an exported endpoint takes it as an input."""
        device = self.device if generator is None else generator.device
        return torch.randint(n_experts, (), generator=generator, device=device)

    def stacked_gaussian_params(self, batch: MultimodalBatch, mods=None):
        """Encode ``mods`` (default all) and stack (mus, log_vars, mask) of
        shapes (M, B, D), (M, B, D), (M, B)."""
        mods = list(self.encoders.keys()) if mods is None else list(mods)
        outs = [self.encode_mod(m, batch.data[m]) for m in mods]
        return (torch.stack([o["embedding"] for o in outs]),
                torch.stack([o["log_covariance"] for o in outs]),
                torch.stack([batch.masks[m] for m in mods]))

    def loss_function(self, batch: MultimodalBatch, step: Optional[StepInfo] = None,
                      generator: Optional[torch.Generator] = None) -> ModelOutput:
        """Must return ModelOutput(loss, loss_sum, metrics)."""
        raise NotImplementedError

    def forward(self, inputs, epoch: int = 1,
                generator: Optional[torch.Generator] = None, **kwargs) -> ModelOutput:
        """Loss on ``inputs`` (a batch, dataset slice or dict of arrays)."""
        batch = as_batch(inputs).to(self.device)
        step = StepInfo(
            epoch=epoch,
            batch_ratio=kwargs.get("batch_ratio", 0.0),
            dataset_size=kwargs.get("dataset_size", batch.n_samples),
        )
        return self.loss_function(batch, step, generator=generator)

    # ------------------------------------------------------------ inference
    def _normalize_cond_mod(self, cond_mod) -> tuple:
        if isinstance(cond_mod, str):
            if cond_mod == "all":
                return tuple(self.encoders.keys())
            if cond_mod in self.encoders:
                return (cond_mod,)
            raise AttributeError(
                'If cond_mod is a string, it must either be "all" or a '
                f"modality name. The provided string {cond_mod} is neither.")
        cond = tuple(cond_mod)
        for m in cond:
            if m not in self.encoders:
                raise AttributeError(f"Unknown modality in cond_mod: {m}")
        return cond

    def _check_availability(self, inputs, cond_mod, ignore_incomplete: bool):
        """Refuse to encode samples missing a conditioning modality."""
        masks = getattr(inputs, "masks", None)
        if ignore_incomplete or masks is None:
            return
        for m in cond_mod:
            if m in masks and not _all_available(masks[m]):
                raise AttributeError(
                    "You tried to encode an incomplete dataset conditioning on "
                    f"modalities {list(cond_mod)}, but some samples are not "
                    "available in all those modalities.")

    def _encode_subset(self, batch: MultimodalBatch, *, cond_mod: tuple, N: int,
                       return_mean: bool, flatten: bool,
                       generator: Optional[torch.Generator]) -> dict:
        """Model-specific encoding; returns {'z': ...}."""
        raise NotImplementedError

    # True on the models whose posterior of a subset is a product of the
    # experts weighed by the rows' masks (the PoE families): an encode from
    # every modality then conditions each row on the modalities it has, and
    # ``encode_per_sample`` serves it. The mixture models draw one expert
    # for the whole batch and stay False.
    supports_per_sample_conditioning = False
    # True on the models whose ``_encode_subset`` takes ``per_sample``: a
    # row's private code of a modality it lacks then comes from N(0, I)
    # instead of the posterior (DMVAE).
    masked_encode_per_sample_flag = False

    def encode_per_sample(self, inputs, N: int = 1, return_mean: bool = False,
                          flatten: bool = False,
                          generator: Optional[torch.Generator] = None) -> ModelOutput:
        """Encode every row from the modalities it has (its mask), without
        ``encode``'s availability error; a row with none falls back to the
        prior. Only for ``supports_per_sample_conditioning`` models."""
        if not self.supports_per_sample_conditioning:
            raise AttributeError(
                f"{self.model_name} cannot condition each row on its own "
                "modalities: its encode takes one subset for the whole batch.")
        kwargs = {"per_sample": True} if self.masked_encode_per_sample_flag else {}
        return self.encode(inputs, "all", N=N, return_mean=return_mean, flatten=flatten,
                           generator=generator, ignore_incomplete=True, **kwargs)

    def encode(self, inputs, cond_mod: Union[list, str] = "all", N: int = 1,
               return_mean: bool = False, flatten: bool = False,
               generator: Optional[torch.Generator] = None,
               ignore_incomplete: bool = False, **kwargs) -> ModelOutput:
        """Sample the posterior conditioned on a subset of modalities.
        Returns ModelOutput(z, one_latent_space, cond_mod[, modalities_z]).
        Other keyword arguments go to the model's ``_encode_subset`` (JNF's
        HMC settings)."""
        batch = as_batch(inputs).to(self.device)
        cond = self._normalize_cond_mod(cond_mod)
        self._check_availability(inputs, cond, ignore_incomplete)
        out = self._encode_subset(batch, cond_mod=cond, N=N,
                                  return_mean=bool(return_mean),
                                  flatten=bool(flatten), generator=generator, **kwargs)
        result = ModelOutput(z=out["z"],
                             one_latent_space=not self.multiple_latent_spaces)
        result["cond_mod"] = list(cond)
        for k, v in out.items():
            if k != "z":
                result[k] = v
        if self.multiple_latent_spaces and "modalities_z" not in result:
            raise RuntimeError(
                "Model declares multiple latent spaces but _encode_subset "
                "returned no 'modalities_z'.")
        return result

    def _decode_modalities(self, modalities) -> tuple:
        if modalities == "all":
            return tuple(self.decoders.keys())
        return (modalities,) if isinstance(modalities, str) else tuple(modalities)

    def _decode_mods(self, z, mods: tuple, modalities_z=None) -> dict:
        """Decode ``z`` in ``mods``, with each modality's private code
        concatenated when ``modalities_z`` is given."""
        return {m: self.decode_mod(m, z if modalities_z is None
                                   else torch.cat([z, modalities_z[m]], -1))
                for m in mods}

    def decode(self, embedding: ModelOutput,
               modalities: Union[list, str] = "all") -> ModelOutput:
        """Decode a latent code (any leading shape) in ``modalities``."""
        mods = self._decode_modalities(modalities)
        one_latent_space = embedding.get("one_latent_space", True)
        modalities_z = None if one_latent_space else embedding["modalities_z"]
        return ModelOutput(**self._decode_mods(embedding["z"], mods, modalities_z))

    def predict(self, inputs, cond_mod: Union[list, str] = "all",
                gen_mod: Union[list, str] = "all", N: int = 1,
                flatten: bool = False, generator: Optional[torch.Generator] = None,
                ignore_incomplete: bool = False) -> ModelOutput:
        """Cross-modal generation: encode on ``cond_mod``, decode on
        ``gen_mod``; with N > 1 and not ``flatten`` the outputs are
        (N, n_data, ...)."""
        z = self.encode(inputs, cond_mod, N=N, flatten=True, generator=generator,
                        ignore_incomplete=ignore_incomplete)
        output = self.decode(z, gen_mod)
        n_data = z.z.shape[0] // N
        if not flatten and N > 1:
            for m in list(output.keys()):
                output[m] = output[m].reshape(N, n_data, *output[m].shape[1:])
        return output

    def generate_from_prior(self, n_samples: int,
                            generator: Optional[torch.Generator] = None
                            ) -> ModelOutput:
        """Latents from the standard-normal prior: (n_samples, latent_dim),
        or (latent_dim,) when n_samples == 1."""
        shape = (n_samples, self.latent_dim) if n_samples > 1 else (self.latent_dim,)
        return ModelOutput(z=self.draw_noise(shape, generator), one_latent_space=True)

    def compute_joint_nll(self, inputs, K: int = 1000, batch_size_K: int = 100,
                          generator: Optional[torch.Generator] = None):
        raise NotImplementedError

    def _gaussian_iwae_joint_nll(self, batch: MultimodalBatch, joint_mu,
                                 joint_log_var, K: int, batch_size_K: int,
                                 generator: Optional[torch.Generator] = None):
        """K-sample IWAE joint NLL for a Gaussian joint posterior: z ~ q(z|X)
        weighted by p(X|z) p(z) / q(z|X), in chunks of ``batch_size_K``.
        Returns the sum over rows of -ln p(X) times the row weights."""

        def logw_chunk(chunk: int):
            z = rsample_from_gaussian(
                joint_mu, joint_log_var, N=chunk,
                noise=self.data_shard.draw(self.draw_noise, (chunk, *joint_mu.shape),
                                           generator))
            lpx_z = 0.0
            for m in self.decoders:
                recon = self.decode_mod(m, z)
                lpx_z = lpx_z + sum_except_batch(
                    self.recon_log_probs[m](recon, add_axes(batch.data[m])),
                    batch_ndims=2)
            zeros = torch.zeros_like(z)
            lpz = sum_f32(gaussian_log_prob(z, zeros, zeros))
            lqz = sum_f32(gaussian_log_prob(z, joint_mu[None], joint_log_var[None]))
            return lpx_z + lpz - lqz

        ln_px = iwae_log_marginal(logw_chunk, K, batch_size_K)
        return -(ln_px * batch.weights).sum()

    def _check_complete_for_nll(self, inputs):
        incomplete = (inputs.incomplete if isinstance(inputs, MultimodalBatch)
                      else getattr(inputs, "masks", None) is not None)
        if incomplete:
            raise AttributeError(
                "The compute_joint_nll method is not yet implemented for "
                "incomplete datasets.")

    @torch.no_grad()
    def compute_cond_nll(self, inputs, subset, pred_mods, k_iwae: int = 1000,
                         batch_size_k: int = 100,
                         generator: Optional[torch.Generator] = None
                         ) -> Dict[str, torch.Tensor]:
        """Monte-Carlo conditional NLL -ln p(x_pred | x_subset), averaged
        over the rows: ``batch_size_k`` posterior draws per chunk, chunks
        combined by logsumexp."""
        batch = as_batch(inputs).to(self.device)
        subset = self._normalize_cond_mod(subset)
        pred_mods = tuple(pred_mods)
        chunks = {m: [] for m in pred_mods}
        n_done = 0
        while n_done < k_iwae:
            n = min(batch_size_k, k_iwae - n_done)
            enc = self.encode(batch, list(subset), N=n, flatten=True,
                              generator=generator, ignore_incomplete=True)
            dec = self.decode(enc, list(pred_mods))
            for m in pred_mods:
                recon = dec[m].reshape(n, -1, *dec[m].shape[1:])
                chunks[m].append(sum_except_batch(
                    self.recon_log_probs[m](recon, add_axes(batch.data[m])),
                    batch_ndims=2))
            n_done += n
        cnll = {}
        for m in pred_mods:
            lnp = torch.logsumexp(torch.cat(chunks[m]), 0) - math.log(k_iwae)
            cnll[m] = -lnp.sum() / lnp.shape[0]
        return cnll
