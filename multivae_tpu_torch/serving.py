"""Serving: fixed-batch cross-modal generation endpoints.

Counterpart of ``multivae_tpu/serving.py``'s ``Predictor`` and
``AnySubsetPredictor``. An endpoint serves a trained model on the model's
device (the card unless the model was built on the CPU) at one batch
size:

- a request of up to ``batch_size`` rows is zero-padded to it and the
  padding rows are cut from the reply, so every call runs the same shapes;
- the draws come from the endpoint's own ``torch.Generator``, seeded with
  ``seed``, which advances from call to call (``deterministic=True`` uses
  the posterior means and draws nothing);
- ``warmup()`` runs one call before the first request.

Replies are numpy arrays in a ``ModelOutput``. The JAX package's
``export`` / ``load_exported`` (a serialized StableHLO program) are not
part of the port yet.

Example::

    pred = Predictor(model, cond_mod=["m0"], gen_mod="all", batch_size=64)
    pred.warmup()
    out = pred({"m0": images})
"""

from __future__ import annotations

from typing import Dict, List, Union

import numpy as np
import torch

from .data.batch import MultimodalBatch
from .utils.model_output import ModelOutput


def _request_batch_size(data):
    """Validate a request dict: non-empty, consistent leading dims."""
    if not data:
        raise ValueError("Empty request: provide at least one modality.")
    sizes = {m: np.asarray(v).shape[0] for m, v in data.items()}
    if len(set(sizes.values())) != 1:
        raise ValueError(
            f"All request modalities must share the leading batch "
            f"dimension, got {sizes}."
        )
    return next(iter(sizes.values()))


def _pad_rows(x, batch_size):
    """Zero-pad a (n, ...) array to (batch_size, ...)."""
    pad = batch_size - x.shape[0]
    if pad:
        x = np.concatenate([x, np.zeros((pad, *x.shape[1:]), x.dtype)])
    return x


class _Endpoint:
    """What both endpoints share: the model, the generated modalities, the
    batch size, the draws, the reply."""

    def __init__(self, model, gen_mod, batch_size: int, deterministic: bool,
                 seed: int):
        self.model = model
        if gen_mod == "all":
            gen_mod = list(model.decoders.keys())
        elif isinstance(gen_mod, str):
            gen_mod = [gen_mod]
        self.gen_mod = tuple(gen_mod)
        self.batch_size = int(batch_size)
        self.deterministic = bool(deterministic)
        self.device = model.device
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

    def _tensor(self, x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    def _zeros(self, mod):
        return np.zeros((self.batch_size, *self.model.model_config.input_dims[mod]),
                        np.float32)

    @torch.no_grad()
    def _reply(self, batch: MultimodalBatch, encode, n: int) -> ModelOutput:
        enc = encode(batch)
        out = self.model._decode_mods(enc["z"], self.gen_mod,
                                      modalities_z=enc.get("modalities_z"))
        return ModelOutput(**{m: v[:n].cpu().numpy() for m, v in out.items()})


class Predictor(_Endpoint):
    """A fixed-batch endpoint generating ``gen_mod`` from ``cond_mod``."""

    def __init__(self, model, cond_mod: Union[str, List[str]] = "all",
                 gen_mod: Union[str, List[str]] = "all",
                 batch_size: int = 64, deterministic: bool = False,
                 seed: int = 0):
        super().__init__(model, gen_mod, batch_size, deterministic, seed)
        if cond_mod == "all":
            cond_mod = list(model.encoders.keys())
        elif isinstance(cond_mod, str):
            cond_mod = [cond_mod]
        self.cond_mod = tuple(model._normalize_cond_mod(list(cond_mod)))

    def warmup(self):
        """Run one call before the first request."""
        self({m: self._zeros(m) for m in self.cond_mod})
        return self

    def __call__(self, data: Dict[str, np.ndarray]) -> ModelOutput:
        n = _request_batch_size(data)
        missing = set(self.cond_mod) - set(data)
        if missing:
            raise ValueError(
                f"Request is missing the compiled conditioning modalities "
                f"{sorted(missing)} (endpoint conditions on "
                f"{list(self.cond_mod)}).")
        if n > self.batch_size:
            raise ValueError(
                f"Request batch {n} exceeds compiled batch_size "
                f"{self.batch_size}; split the request or build a bigger "
                "Predictor."
            )
        b = self.batch_size
        ones = torch.ones(b, device=self.device)
        batch = MultimodalBatch(
            data={m: self._tensor(_pad_rows(np.asarray(data[m], np.float32), b))
                  for m in self.cond_mod},
            masks={m: ones for m in self.cond_mod}, weights=ones)
        return self._reply(batch, lambda bt: self.model._encode_subset(
            bt, cond_mod=self.cond_mod, N=1, return_mean=self.deterministic,
            flatten=True, generator=self.generator), n)


class AnySubsetPredictor(_Endpoint):
    """One fixed-batch endpoint serving any conditioning pattern, row by
    row: a row conditions on the modalities it brings (``data``, qualified
    by ``masks``). Only for the models whose subset posterior is a product
    of experts weighed per row (``supports_per_sample_conditioning``: the
    PoE families); it encodes through ``encode_per_sample``, which gives
    DMVAE's ``per_sample`` flag. Rows must have at least one modality.

    Example::

        pred = AnySubsetPredictor(model, batch_size=64)
        out = pred({"image": imgs, "audio": wavs},
                   masks={"audio": audio_present})
    """

    def __init__(self, model, gen_mod: Union[str, List[str]] = "all",
                 batch_size: int = 64, deterministic: bool = False,
                 seed: int = 0):
        if not getattr(model, "supports_per_sample_conditioning", False):
            raise TypeError(
                f"{type(model).__name__} does not support per-sample "
                "conditioning (its subset encoding draws one mixture "
                "expert per batch); use per-subset Predictor endpoints."
            )
        super().__init__(model, gen_mod, batch_size, deterministic, seed)
        self.mods = list(model.encoders.keys())

    def warmup(self):
        """Run one call before the first request."""
        self({self.mods[0]: self._zeros(self.mods[0])})
        return self

    def __call__(self, data: Dict[str, np.ndarray],
                 masks: Dict[str, np.ndarray] = None) -> ModelOutput:
        masks = masks or {}
        unknown = (set(data) | set(masks)) - set(self.mods)
        if unknown:
            raise ValueError(
                f"Unknown modalities in the request: {sorted(unknown)}; "
                f"this model has {self.mods}.")
        orphan = set(masks) - set(data)
        if orphan:
            raise ValueError(
                f"masks provided for modalities absent from data: "
                f"{sorted(orphan)}. A mask qualifies rows of a provided "
                "modality; to mark a modality absent, omit it from data "
                "(and from masks).")
        n = _request_batch_size(data)
        for m, v in masks.items():
            if np.asarray(v).shape[0] != n:
                raise ValueError(
                    f"masks[{m!r}] has {np.asarray(v).shape[0]} rows but "
                    f"the request has {n}.")
        if n > self.batch_size:
            raise ValueError(
                f"Request batch {n} exceeds compiled batch_size "
                f"{self.batch_size}; split the request or build a bigger "
                "AnySubsetPredictor."
            )
        full_data, full_masks = {}, {}
        row_has_mod = np.zeros((n,), bool)
        for m in self.mods:
            if m in data:
                x = np.asarray(data[m], np.float32)
                mk = np.asarray(masks.get(m, np.ones((n,))), np.float32)
            else:
                x = np.zeros((n, *self.model.model_config.input_dims[m]), np.float32)
                mk = np.zeros((n,), np.float32)
            row_has_mod |= mk > 0
            # zero the data of the rows that lack the modality (the mask
            # already keeps them out of every product)
            x = x * mk.reshape((n,) + (1,) * (x.ndim - 1))
            full_data[m] = self._tensor(_pad_rows(x, self.batch_size))
            full_masks[m] = self._tensor(_pad_rows(mk, self.batch_size))
        if not row_has_mod.all():
            raise ValueError(
                "Every request row must have at least one available "
                f"modality; rows {np.nonzero(~row_has_mod)[0].tolist()} "
                "have none."
            )
        batch = MultimodalBatch(data=full_data, masks=full_masks,
                                weights=torch.ones(self.batch_size, device=self.device),
                                incomplete=True)
        return self._reply(batch, lambda bt: self.model.encode_per_sample(
            bt, N=1, return_mean=self.deterministic, flatten=True,
            generator=self.generator), n)
