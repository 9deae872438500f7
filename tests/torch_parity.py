"""Helpers of the tests that hold a port model to its JAX counterpart: the
JAX package's noise as torch tensors, the port's trainer fed the JAX
trainer's noise, parameter trees as port ``state_dict``s, and (from
``torch_nets``) the torch copies of the MHVAE test blocks."""

import contextlib
import itertools
import math

import numpy as np
import torch

import jax
import jax.numpy as jnp

from multivae_tpu.trainers.base.callbacks import TrainingCallback
from multivae_tpu_torch.utils.convert import params_from_jax
from torch_nets import _MLP, mhvae_mlp_blocks  # noqa: F401  (re-exported)


LAPLACE_LOW = -0.5 + float(jnp.finfo(jnp.float32).eps)


def _draw(fn, key, shape, *args):
    """``fn(key, shape, *args)`` as a torch tensor. Under JAX's partitionable
    threefry (its default), entry i of a draw depends only on the key and
    on i, so the draw is the head of one of a longer flat shape: rounded up
    to a power of two (at least 1024), the many small shapes of the tests
    share a few compiles instead of one each."""
    shape = tuple(shape)
    if not jax.config.jax_threefry_partitionable:
        return torch.tensor(np.asarray(fn(key, shape, *args)))
    n = math.prod(shape)
    size = max(1024, 1 << (n - 1).bit_length())
    return torch.tensor(np.asarray(fn(key, (size,), *args))[:n].reshape(shape))


def normal(key, shape):
    """``jax.random.normal(key, shape)`` as a torch tensor."""
    return _draw(jax.random.normal, key, shape)


def uniform(key, shape, minval=0.0, maxval=1.0):
    """``jax.random.uniform(key, shape, float32, minval, maxval)`` as a torch
    tensor; the Laplace noise of the JAX package is ``uniform(key, shape,
    LAPLACE_LOW, 0.5)``."""
    return _draw(jax.random.uniform, key, shape, jnp.float32, minval, maxval)


def chain(key, n):
    """The keys ``iwae_log_marginal`` hands its chunks: the carry split once
    per chunk."""
    subs = []
    for _ in range(n):
        key, sub = jax.random.split(key)
        subs.append(sub)
    return subs


@contextlib.contextmanager
def compiled_init(cls, shapes: bool = False):
    """Inside the block, a JAX model of ``cls`` built by its constructor
    defers its parameter init; on exit each such model gets its params from
    the same init on the same key, compiled once by ``jax.jit`` instead of
    run op by op (the same values: the JAX package's host init would
    otherwise compile each op of a model's first build, 20 s for the CUB
    nets). With ``shapes`` each gets only its leaves' shapes and dtypes
    (``jax.eval_shape``): nothing is compiled or run."""
    own = "init_params" in cls.__dict__
    plain = cls.init_params
    deferred = []
    cls.init_params = lambda self, rng=None: deferred.append(self)
    try:
        yield
    finally:
        if own:
            cls.init_params = plain
        else:
            del cls.init_params
    for model in dict.fromkeys(deferred):
        init, rng = (lambda rng, model=model: plain(model, rng)), model.next_rng()
        model.params = jax.eval_shape(init, rng) if shapes else jax.jit(init)(rng)


def state_of(params):
    """A JAX parameter tree as the port's ``state_dict``."""
    return params_from_jax(jax.tree.map(np.asarray, params))


def port_model(jmodel, tmodel):
    """``tmodel`` with ``jmodel``'s weights."""
    tmodel.load_state_dict(state_of(jmodel.params))
    return tmodel


class Recorder(TrainingCallback):
    """The JAX trainer's logged epoch metrics."""

    def __init__(self):
        self.logs = []

    def on_log(self, training_config, logs, **kwargs):
        self.logs.append(dict(logs))


def feed_trainer_noise(trainer, model, draws_of_key, seed, first_step=0):
    """Make the port's ``trainer`` draw the JAX trainer's noise: a train
    step's loss gets ``draws_of_key(fold_in(key(seed), step))``, an eval
    step's ``draws_of_key(key(seed + 1000 + epoch))`` (the eval generator's
    seed), where ``draws_of_key(key)`` returns the ``draw_noise`` hook of
    one loss call. Returns the counter of train steps, which starts at
    ``first_step`` (a resumed JAX trainer's: its trained epochs times the
    steps an epoch) and goes on across an optimizer reset as the JAX
    trainer's step does."""
    steps = itertools.count(first_step)
    current = {}

    def noise(shape, generator=None):
        return current["hook"](shape, generator)

    def loss_function(batch, step=None, generator=None):
        if generator is trainer.generator:
            key = jax.random.fold_in(jax.random.key(seed), next(steps))
        else:
            key = jax.random.key(generator.initial_seed())
        current["hook"] = draws_of_key(key)
        return type(model).loss_function(model, batch, step, generator)

    model.loss_function = loss_function
    model.draw_noise = noise
    return steps


def assert_same_moves(ours: dict, ref: dict, start: dict, lr: float):
    """Weights ``ours`` and ``ref`` (``state_dict``s; ``ref`` the JAX
    package's), both trained from ``start`` at ``lr``: each tensor's move
    from ``start`` agrees with the JAX one to 1e-3 of its norm, and no entry
    differs by more than a tenth of an Adam step. Adam divides each gradient
    by its running RMS, so an entry whose gradient is ~0 moves in a
    direction float32 noise sets: an elementwise relative test would
    measure that noise."""
    assert set(ref) == set(ours)
    for name, v in ours.items():
        move, ref_move = (v - start[name]).double(), (ref[name] - start[name]).double()
        err = (move - ref_move).norm().item()
        assert err <= 1e-3 * ref_move.norm().item() + 1e-7, (name, err)
        assert (move - ref_move).abs().max().item() <= 0.1 * lr, name


def record_keys(jmodel):
    """Make ``jmodel.next_rng`` log the keys it hands out; returns the
    list they go into, in call order."""
    keys, draw = [], jmodel.next_rng

    def next_rng():
        key = draw()
        keys.append(key)
        return key

    jmodel.next_rng = next_rng
    return keys


def _split_chain(key):
    while True:
        key, sub = jax.random.split(key)
        yield sub


class JaxCallDraws:
    """Feed the port's ``tmodel`` the JAX draws of ``keys``, one key a
    public call (``encode``, and through it ``predict``;
    ``generate_from_prior``; the joint NLLs), as the JAX model's
    ``next_rng`` handed them to the same calls. MVTCAE draws its noise from
    the key itself (the NLL from the key's split chain); MMVAE
    (``mixture=True``, Laplace) its Uniform noise and its expert as the JAX
    package does: ``encode`` from ``split(key, 3)[1:]`` with the expert by
    ``categorical`` over the subset's indicator, the NLL's expert by
    ``randint`` from ``split(key)[1]`` and its noise from the first half's
    chain, the paper NLL from each chain key split once a modality."""

    CALLS = ("encode", "generate_from_prior", "compute_joint_nll",
             "compute_joint_nll_paper")

    def __init__(self, tmodel, keys, mixture=False):
        self.model, self.keys, self.mixture = tmodel, list(keys), mixture
        self.noise_keys, self.expert = iter(()), None
        for name in self.CALLS:
            if hasattr(tmodel, name):
                self._wrap(name)
        tmodel.draw_noise = self._noise
        tmodel.draw_expert = lambda n, generator=None: self.expert(n)

    def _wrap(self, name):
        call = getattr(self.model, name)

        def fed(*args, **kwargs):
            self._begin(name, self.keys.pop(0), args, kwargs)
            return call(*args, **kwargs)

        setattr(self.model, name, fed)

    def _begin(self, name, key, args, kwargs):
        mods = list(self.model.encoders)
        if not self.mixture:
            self.noise_keys = (_split_chain(key) if name == "compute_joint_nll"
                               else iter([key]))
        elif name == "encode":
            _, choice, sample = jax.random.split(key, 3)
            cond = self.model._normalize_cond_mod(
                kwargs.get("cond_mod", args[1] if len(args) > 1 else "all"))
            subset = jnp.asarray([float(m in cond) for m in mods])
            idx = int(jax.random.categorical(choice, jnp.log(subset)))
            self.expert = lambda n: cond.index(mods[idx])
            self.noise_keys = iter([sample])
        elif name == "compute_joint_nll":
            rest, choice = jax.random.split(key)
            self.expert = lambda n: int(jax.random.randint(choice, (), 0, n))
            self.noise_keys = _split_chain(rest)
        elif name == "compute_joint_nll_paper":
            self.noise_keys = (k for sub in _split_chain(key)
                               for k in jax.random.split(sub, len(mods)))
        else:
            self.noise_keys = iter([key])

    def _noise(self, shape, generator=None):
        key = next(self.noise_keys)
        if self.mixture:
            return uniform(key, shape, LAPLACE_LOW, 0.5)
        return normal(key, shape)
