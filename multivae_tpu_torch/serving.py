"""Serving: fixed-batch cross-modal generation endpoints.

Counterpart of ``multivae_tpu/serving.py``'s ``Predictor`` and
``AnySubsetPredictor``. An endpoint serves a trained model on the model's
device (the card unless the model was built on the CPU) at one batch
size:

- a request of up to ``batch_size`` rows is zero-padded to it and the
  padding rows are cut from the reply, so every call runs the same shapes;
- its body is one function, ``_predict_fn(params, data, draws)``
  (``AnySubsetPredictor``: ``(params, data, masks, draws)``), the
  counterpart of the JAX ``_predict_fn(params, data, rng)``: ``params`` is
  the model's ``state_dict``, bound to the model through
  ``torch.func.functional_call``; ``draws`` stands in for the JAX key: the
  tensors the model's draw hooks (``DRAW_HOOKS``: ``draw_noise``,
  ``draw_expert``, ...) would return, in the order the model draws them,
  handed to the hooks in their place. Their hooks, shapes and dtypes
  (``draw_specs``) are learned once, by a call on zeros that records them;
- a call fills ``draws`` from the endpoint's own ``torch.Generator``
  (seeded with ``seed``, advancing from call to call) through the same
  hooks in the same order, so a seeded endpoint replies as the model's
  ``_encode_subset`` given that generator would. ``deterministic=True``
  uses the posterior means; the list is then empty unless the model draws
  even so (CMVAE's expert);
- ``warmup()`` runs one call before the first request;
- ``export(path)`` traces ``_predict_fn`` at the fixed batch through
  ``torch.export`` (non-strict) and saves the program. As in the JAX
  package the weights are an input, not part of the artifact, and the
  program runs on the device it was traced on. ``load_exported(path)``
  returns a function running it that carries the draws' specs. The
  program needs ``torch`` alone:
  ``torch.export.load(path).module()(params, data, draws)`` with the
  dicts in the exported order (``state_dict``'s, the conditioning
  modalities').

Replies are numpy arrays in a ``ModelOutput``.

Example::

    pred = Predictor(model, cond_mod=["m0"], gen_mod="all", batch_size=64)
    pred.warmup()
    out = pred({"m0": images})
    pred.export("endpoint.pt2")
    call = Predictor.load_exported("endpoint.pt2")
    out = call(model.state_dict(), {"m0": x}, pred.draw(generator))
"""

from __future__ import annotations

import contextlib
import dataclasses
import inspect
import json
from typing import Dict, List, Union

import numpy as np
import torch
from torch import nn

from .data.batch import MultimodalBatch
from .utils.model_output import ModelOutput

# every hook through which a port model draws
DRAW_HOOKS = ("draw_noise", "draw_uniform", "draw_expert", "draw_experts", "draw_subsets",
              "draw_components", "draw_clusters", "draw_dropout")
# the exported program's side file: what ``load_exported`` needs to call it
_META = "multivae_endpoint.json"


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


@dataclasses.dataclass(frozen=True)
class DrawSpec:
    """One draw of an endpoint: the hook that makes it, the hook's
    arguments besides the generator, and the tensor's shape and dtype."""

    hook: str
    arguments: tuple    # ((name, value), ...)
    shape: tuple
    dtype: torch.dtype

    def draw(self, model, generator: torch.Generator) -> torch.Tensor:
        """The draw from ``generator`` through the model's hook."""
        x = torch.as_tensor(getattr(model, self.hook)(**dict(self.arguments),
                                                      generator=generator),
                            device=model.device)
        if tuple(x.shape) != self.shape or x.dtype != self.dtype:
            raise RuntimeError(
                f"{self.hook} drew a {x.dtype} tensor of shape {tuple(x.shape)}, where the "
                f"endpoint recorded {self.dtype} of shape {self.shape}.")
        return x

    def zeros(self, device) -> torch.Tensor:
        return torch.zeros(self.shape, dtype=self.dtype, device=device)


@contextlib.contextmanager
def _hooks_replaced(model, make):
    """The model's draw hooks replaced by ``make(name, hook)`` for the block;
    the hooks it had (a test's own among them) back after."""
    names = [n for n in DRAW_HOOKS if hasattr(model, n)]
    saved = {n: vars(model)[n] for n in names if n in vars(model)}
    for name in names:
        setattr(model, name, make(name, getattr(model, name)))
    try:
        yield
    finally:
        for name in names:
            if name in saved:
                setattr(model, name, saved[name])
            else:
                delattr(model, name)


def _recorder(specs: list, generator: torch.Generator, device):
    """Hooks that draw from ``generator`` and append each draw's spec to
    ``specs``. A draw made from a tensor (CMVAE's clusters from their
    logits) depends on the data and cannot be an input: it raises."""
    def make(name, hook):
        signature = inspect.signature(hook)

        def record(*args, **kwargs):
            arguments = signature.bind(*args, **kwargs).arguments
            arguments.pop("generator", None)
            for key, value in arguments.items():
                if isinstance(value, torch.Tensor):
                    raise ValueError(
                        f"{name} draws from the tensor {key!r}: a draw that depends on the "
                        "data cannot be an input of the endpoint.")
            x = torch.as_tensor(hook(**arguments, generator=generator), device=device)
            specs.append(DrawSpec(name, tuple(arguments.items()), tuple(x.shape), x.dtype))
            return x
        return record
    return make


def _feeder(specs: List[DrawSpec], draws):
    """Hooks that return ``draws`` in turn, each checked against its spec;
    the returned ``finish()`` checks that every draw was taken."""
    if len(draws) != len(specs):
        raise ValueError(f"The endpoint takes {len(specs)} draws "
                         f"({[s.hook for s in specs]}), got {len(draws)}.")
    queue = list(zip(specs, draws))[::-1]

    def make(name, hook):
        def feed(*args, **kwargs):
            if not queue:
                raise RuntimeError(f"{name} drew past the endpoint's {len(specs)} draws.")
            spec, x = queue.pop()
            if spec.hook != name or tuple(x.shape) != spec.shape or x.dtype != spec.dtype:
                raise ValueError(
                    f"{name} was handed a {x.dtype} draw of shape {tuple(x.shape)} where "
                    f"the endpoint recorded {spec.hook}: {spec.dtype} of shape {spec.shape}.")
            return x
        return feed

    def finish():
        if queue:
            raise RuntimeError(f"The model left {len(queue)} of the endpoint's draws.")
    return make, finish


def _check_whole(model):
    """Refuse a model whose modules hold a ``ShardedState``'s masters (and
    column forwards): inside ``train()``, before ``unshard``."""
    if any(getattr(p, "sharded_piece", False) for p in model.parameters()):
        raise RuntimeError(
            f"{type(model).__name__} holds the pieces of a ShardedState (fsdp or "
            "n_model_devices), not whole weights: export it once train() has ended "
            "(ShardedState.unshard).")


class _Bound(nn.Module):
    """The endpoint's encode and decode as the ``forward`` of a module that
    holds the model, which ``functional_call`` binds a ``state_dict`` to."""

    def __init__(self, endpoint):
        super().__init__()
        self.model = endpoint.model
        self.endpoint = endpoint

    def forward(self, *inputs):
        enc = self.endpoint._encode(*inputs)
        return self.model._decode_mods(enc["z"], self.endpoint.gen_mod,
                                       modalities_z=enc.get("modalities_z"))


class _Program(nn.Module):
    """``_predict_fn`` as the ``forward`` ``torch.export`` traces; it holds
    no weights."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


class ExportedEndpoint:
    """A loaded endpoint program: ``fn(params, data, draws)``, or
    ``fn(params, data, masks, draws)`` for an ``AnySubsetPredictor``'s,
    returning a dict of the generated modalities' tensors at the fixed
    batch. ``draws`` lists the (shape, dtype) of the tensors it takes, in
    order, and ``hooks`` the model hook that makes each. It runs on the
    device it was exported on."""

    def __init__(self, program, meta: dict):
        self.program = program
        self.module = program.module()
        self.kind, self.batch_size = meta["kind"], meta["batch_size"]
        self.gen_mod = tuple(meta["gen_mod"])
        self._keys = meta["keys"]
        self.hooks = [d["hook"] for d in meta["draws"]]
        self.draws = [(tuple(d["shape"]), getattr(torch, d["dtype"].split(".")[-1]))
                      for d in meta["draws"]]

    def __call__(self, params, data, *rest):
        *masks, draws = rest
        if len(masks) != len(self._keys) - 2:
            raise TypeError(f"A {self.kind} program takes (params, data"
                            + (", masks" if len(self._keys) == 3 else "") + ", draws).")
        dicts = [params, data, *masks]
        args = [{k: d[k] for k in keys} for d, keys in zip(dicts, self._keys)]
        return self.module(*args, list(draws))


def load_exported(path: str) -> ExportedEndpoint:
    """Load an endpoint saved by ``export``; returns ``fn(params, data,
    draws)`` (``fn(params, data, masks, draws)`` for an
    ``AnySubsetPredictor``)."""
    extra = {_META: ""}
    program = torch.export.load(path, extra_files=extra)
    return ExportedEndpoint(program, json.loads(extra[_META]))


class _Endpoint:
    """What both endpoints share: the model, the generated modalities, the
    batch size, the draws, the body, the export and the reply."""

    load_exported = staticmethod(load_exported)

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
        self._bound = _Bound(self)
        self._param_keys = set(model.state_dict())
        self._specs = None

    def _tensor(self, x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    def _zeros(self, mod):
        return np.zeros((self.batch_size, *self.model.model_config.input_dims[mod]),
                        np.float32)

    # ------------------------------------------------------------- the body
    def _run(self, params: dict, inputs: tuple, make_hook):
        """Encode ``inputs`` and decode with the model's weights ``params``
        and its draw hooks replaced by ``make_hook``."""
        if params.keys() != self._param_keys:
            raise ValueError(
                "params must be the model's state_dict: missing "
                f"{sorted(self._param_keys - params.keys())}, unknown "
                f"{sorted(params.keys() - self._param_keys)}.")
        with _hooks_replaced(self.model, make_hook):
            return torch.func.functional_call(
                self._bound, {"model." + k: v for k, v in params.items()}, inputs)

    def _fed(self, params, inputs, draws):
        make, finish = _feeder(self.draw_specs, draws)
        out = self._run(params, inputs, make)
        finish()
        return out

    @property
    def draw_specs(self) -> List[DrawSpec]:
        """The endpoint's draws in the order the model makes them, learned
        on the first use by a call on the example inputs."""
        if self._specs is None:
            specs = []
            generator = torch.Generator(device=self.device).manual_seed(0)
            with torch.no_grad():
                self._run(self.model.state_dict(), self._example_inputs(),
                          _recorder(specs, generator, self.device))
            self._specs = specs
        return self._specs

    def draw(self, generator: torch.Generator) -> List[torch.Tensor]:
        """The endpoint's draws from ``generator``, through the model's hooks
        in the model's order."""
        return [spec.draw(self.model, generator) for spec in self.draw_specs]

    # --------------------------------------------------------------- export
    def export(self, path: str) -> str:
        """Trace ``_predict_fn`` at the fixed batch with ``torch.export``
        (non-strict) on the endpoint's device and save the program to
        ``path``; ``load_exported(path)`` runs it. The artifact holds no
        weights (``params`` is an input) and bakes in the device and the
        fixed shapes. A model whose weights are a ``ShardedState``'s pieces
        is refused; an export that fails raises."""
        _check_whole(self.model)
        params = dict(self.model.state_dict())
        inputs = self._example_inputs()
        draws = [spec.zeros(self.device) for spec in self.draw_specs]
        with torch.no_grad():
            program = torch.export.export(_Program(self._predict_fn),
                                          (params, *inputs, draws), strict=False)
        program.example_inputs = None    # they hold the weights
        meta = dict(kind=type(self).__name__, batch_size=self.batch_size,
                    gen_mod=list(self.gen_mod),
                    keys=[list(params), *(list(d) for d in inputs)],
                    draws=[dict(hook=s.hook, shape=list(s.shape), dtype=str(s.dtype))
                           for s in self.draw_specs])
        torch.export.save(program, path, extra_files={_META: json.dumps(meta)})
        return path

    # ---------------------------------------------------------------- reply
    @torch.no_grad()
    def _reply(self, inputs: tuple, n: int) -> ModelOutput:
        out = self._predict_fn(self.model.state_dict(), *inputs, self.draw(self.generator))
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

    def _encode(self, data):
        ones = torch.ones(self.batch_size, device=self.device)
        batch = MultimodalBatch(data=data, masks={m: ones for m in data}, weights=ones)
        return self.model._encode_subset(batch, cond_mod=self.cond_mod, N=1,
                                         return_mean=self.deterministic, flatten=True,
                                         generator=None)

    def _predict_fn(self, params: dict, data: dict, draws: list) -> dict:
        """The generated modalities from the conditioning ``data`` (each
        ``batch_size`` rows) with the weights ``params`` and ``draws``."""
        return self._fed(params, (data,), draws)

    def _example_inputs(self) -> tuple:
        return ({m: self._tensor(self._zeros(m)) for m in self.cond_mod},)

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
        return self._reply(({m: self._tensor(_pad_rows(np.asarray(data[m], np.float32),
                                                       self.batch_size))
                             for m in self.cond_mod},), n)


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

    def _encode(self, data, masks):
        batch = MultimodalBatch(data=data, masks=masks,
                                weights=torch.ones(self.batch_size, device=self.device),
                                incomplete=True)
        return self.model.encode_per_sample(batch, N=1, return_mean=self.deterministic,
                                            flatten=True)

    def _predict_fn(self, params: dict, data: dict, masks: dict, draws: list) -> dict:
        """The generated modalities from every modality's ``data`` and
        ``masks`` (each ``batch_size`` rows) with the weights ``params`` and
        ``draws``."""
        return self._fed(params, (data, masks), draws)

    def _example_inputs(self) -> tuple:
        # a tensor of its own for each mask: export would trace aliased inputs as one
        return ({m: self._tensor(self._zeros(m)) for m in self.mods},
                {m: torch.ones(self.batch_size, device=self.device) for m in self.mods})

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
        return self._reply((full_data, full_masks), n)
