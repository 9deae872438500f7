"""The port's endpoint export (``multivae_tpu_torch/serving.py``:
``export`` / ``load_exported``) on the CPU at a small size.

- Every family the ``Predictor`` serves, on ``torch_dp_cases``' tiny
  models (three modalities of 3, 4 and 2 features, latent 4), at a fixed
  batch of 8, deterministic and sampled: the loaded program bit-equal to
  the live ``_predict_fn`` on the same draws, and the endpoint's own reply
  equal to the program's on the draws of its seed; every
  ``AnySubsetPredictor`` family sampled. No graph reads a tensor on
  the host or holds a collective, and the artifact holds no weights.
- Against the JAX package's exported program (``Predictor.load_exported``)
  on ``test_torch_serving``'s models (two vectors and a 1x3x3 image,
  latent 4): posterior means of MVTCAE, MMVAE and DMVAE and the
  ``AnySubsetPredictor`` of MVTCAE and DMVAE, and MVTCAE and MMVAE sampled
  with the JAX draws of ``jax.random.key(0)`` fed as the port's draws,
  within 1e-5 (``test_torch_serving``'s tolerance).
- The mixture families' expert is an input of the program: expert 0 and 1
  give two replies from one loaded program.
- A program runs in a process where ``multivae_tpu_torch`` cannot be
  imported.
- A seeded endpoint's sampled reply is the model's own ``_encode_subset``
  given a generator of that seed, then ``_decode_mods``: the order of the
  draws is the model's.
- MoPoE's ``Predictor`` on a strict subset raises ``KeyError``, and Nexus's
  ``Predictor`` fails in its decode, in both packages.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

import torch_dp_cases as cases
from multivae_tpu import serving as jserving
from multivae_tpu.models import DMVAE as JDMVAE
from multivae_tpu.models import MMVAE as JMMVAE
from multivae_tpu.models import MVTCAE as JMVTCAE
from multivae_tpu.models import DMVAEConfig as JDMVAEConfig
from multivae_tpu.models import MMVAEConfig as JMMVAEConfig
from multivae_tpu.models import MoPoE as JMoPoE
from multivae_tpu.models import MoPoEConfig as JMoPoEConfig
from multivae_tpu.models import MVTCAEConfig as JMVTCAEConfig
from multivae_tpu.models import Nexus as JNexus
from multivae_tpu.models import NexusConfig as JNexusConfig
from multivae_tpu_torch import models, serving
from multivae_tpu_torch.data.batch import MultimodalBatch
from torch_parity import LAPLACE_LOW, normal, port_model, uniform

torch.set_num_threads(2)

BATCH, ROWS = 8, 5
# the conditioning set of each family the Predictor serves: two of the
# three modalities, where the family takes them (TELBO and JNF encode from
# one modality or all, two would take JNF's HMC; MoPoE's endpoint takes
# all three, see the last test)
COND = {name: ["a", "b"] for name in cases.FAMILIES if name not in ("CVAE", "Nexus")}
COND.update(TELBO=["a"], JNF=["a"], MoPoE=list(cases.DIMS))
ANY_SUBSET = ["MVTCAE", "MVAE", "CRMVAE", "DMVAE", "MHVAE"]
MODES = {"mean": True, "sampled": False}
# the ops a traced endpoint must not hold: a host read of a tensor, a collective
HOST_READS = ("aten.item", "aten._local_scalar_dense")

# the JAX side: test_torch_serving's models and tolerance
JDIMS = {"m0": (5,), "m1": (6,), "m2": (1, 3, 3)}
VALUE_TOL = dict(rtol=1e-5, atol=1e-5)
JAX = {"MVTCAE": (JMVTCAE, JMVTCAEConfig, {}),
       "MMVAE": (JMMVAE, JMMVAEConfig, dict(K=2)),
       "DMVAE": (JDMVAE, JDMVAEConfig,
                 dict(modalities_specific_dim={"m0": 1, "m1": 2, "m2": 2}))}


@pytest.fixture(scope="module")
def tiny():
    """Each family's tiny model, built once for the module."""
    return {name: cases.model_of(name) for name in COND}


@pytest.fixture(scope="module")
def pairs():
    """(JAX model, port model with its weights) of MVTCAE, MMVAE and DMVAE."""
    out = {}
    for name, (jcls, jconfig, extra) in JAX.items():
        cfg = dict(n_modalities=3, latent_dim=4, input_dims=JDIMS, **extra)
        jmodel = jcls(jconfig(**cfg), seed=0)
        tmodel = getattr(models, name)(getattr(models, name + "Config")(**cfg), device="cpu")
        out[name] = (jmodel, port_model(jmodel, tmodel))
    return out


def _data(dims, seed, n=BATCH):
    rng = np.random.default_rng(seed)
    return {m: rng.uniform(size=(n, *d)).astype(np.float32) for m, d in dims.items()}


def _tensors(arrays):
    return {m: torch.from_numpy(v) for m, v in arrays.items()}


def _masks(mods, n=BATCH):
    """Rows that each bring another nonempty subset of the modalities."""
    pattern = (np.arange(n) % (2 ** len(mods) - 1)) + 1
    return {m: ((pattern >> i) & 1).astype(np.float32) for i, m in enumerate(mods)}


def _ops(program) -> set:
    return {str(node.target) for node in program.graph.nodes if node.op == "call_function"}


def _assert_traceable(program, model):
    """No host read of a tensor, no collective, no weight in the artifact
    (its constants are the models' fixed tensors: MoPoE's subset masks,
    the MADE masks of JNF's flows)."""
    ops = _ops(program)
    assert not [o for o in ops if o.startswith(HOST_READS) or "c10d" in o], ops
    assert not program.state_dict
    weights = model.state_dict().values()
    for c in program.constants.values():
        assert not any(c.shape == w.shape and torch.equal(c, w) for w in weights)


def _assert_equal(ours, ref):
    assert list(ours) == list(ref)
    for m in ref:
        np.testing.assert_array_equal(np.asarray(ours[m]), np.asarray(ref[m]), err_msg=m)


@pytest.fixture(scope="module")
def exported(tiny, tmp_path_factory):
    """``exported(name, mode)``: the family's ``Predictor`` on ``COND`` (seed
    4) and its loaded program, exported once for the module."""
    cache, folder = {}, tmp_path_factory.mktemp("exported")

    def get(name, mode):
        if (name, mode) not in cache:
            pred = serving.Predictor(tiny[name], cond_mod=COND[name], batch_size=BATCH,
                                     deterministic=MODES[mode], seed=4)
            fn = serving.load_exported(pred.export(str(folder / f"{name}_{mode}.pt2")))
            _assert_traceable(fn.program, pred.model)
            cache[name, mode] = pred, fn
        return cache[name, mode]
    return get


def _round_trip(pred, fn, inputs, draws):
    """The loaded program's reply and the live ``_predict_fn``'s on the same
    inputs and draws."""
    assert fn.draws == [(s.shape, s.dtype) for s in pred.draw_specs]
    assert fn.hooks == [s.hook for s in pred.draw_specs]
    state = pred.model.state_dict()
    with torch.no_grad():
        live = pred._predict_fn(state, *inputs, draws)
    return fn(state, *inputs, draws), live


# ------------------------------------------------------- the round trip
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("name", list(COND))
def test_the_loaded_program_equals_the_live_endpoint(exported, name, mode):
    """The loaded program bit-equal to the live ``_predict_fn`` on the same
    draws; the endpoint's first reply to a request of 5 rows is the
    program's on the draws its seed gives, cut to 5 rows."""
    pred, fn = exported(name, mode)
    model = pred.model
    if MODES[mode] and name != "CMVAE":
        assert pred.draw_specs == []
    data = _tensors(_data({m: cases.DIMS[m] for m in COND[name]}, 1))
    ours, live = _round_trip(pred, fn, (data,), pred.draw(torch.Generator().manual_seed(2)))
    _assert_equal(ours, live)
    pred.generator.manual_seed(4)
    reply = pred({m: v[:ROWS].numpy() for m, v in data.items()})
    padded = {m: torch.cat([v[:ROWS], torch.zeros(BATCH - ROWS, *v.shape[1:])])
              for m, v in data.items()}
    ref = fn(model.state_dict(), padded, pred.draw(torch.Generator().manual_seed(4)))
    _assert_equal(reply, {m: v[:ROWS] for m, v in ref.items()})


@pytest.mark.parametrize("name", ANY_SUBSET)
def test_the_loaded_any_subset_program_equals_the_live_endpoint(tiny, tmp_path, name):
    """Sampled (posterior means: against JAX below): every row conditioned
    on another subset."""
    pred = serving.AnySubsetPredictor(tiny[name], batch_size=BATCH)
    data = _data(cases.DIMS, 3)
    masks = _masks(list(cases.DIMS))
    data = {m: v * masks[m].reshape(-1, *([1] * (v.ndim - 1))) for m, v in data.items()}
    fn = serving.load_exported(pred.export(str(tmp_path / "endpoint.pt2")))
    _assert_traceable(fn.program, pred.model)
    ours, live = _round_trip(pred, fn, (_tensors(data), _tensors(masks)),
                             pred.draw(torch.Generator().manual_seed(5)))
    _assert_equal(ours, live)


@pytest.mark.parametrize("name, mode", [("MMVAE", "sampled"), ("MMVAEPlus", "sampled"),
                                        ("CMVAE", "mean"), ("CMVAE", "sampled")])
def test_the_expert_is_an_input_of_the_program(exported, name, mode):
    """Conditioned on two modalities, expert draws 0 and 1 give two
    different replies from one loaded program, each the live endpoint's."""
    pred, fn = exported(name, mode)
    assert pred.cond_mod == ("a", "b") and pred.draw_specs[0].hook == "draw_expert"
    assert pred.draw_specs[0].shape == () and pred.draw_specs[0].dtype == torch.int64
    data = _tensors(_data({m: cases.DIMS[m] for m in ("a", "b")}, 6))
    rest = pred.draw(torch.Generator().manual_seed(7))[1:]
    replies = []
    for expert in (0, 1):
        draws = [torch.tensor(expert), *rest]
        with torch.no_grad():
            live = pred._predict_fn(pred.model.state_dict(), data, draws)
        replies.append(fn(pred.model.state_dict(), data, draws))
        _assert_equal(replies[-1], live)
    assert all(not torch.equal(replies[0][m], replies[1][m]) for m in cases.DIMS)


# ------------------------------------------------ the draws of the seed
@pytest.mark.parametrize("name", list(COND))
def test_a_seeded_reply_is_the_models_own_encode(tiny, name):
    """``__call__``'s draws come from its generator in the model's order:
    the reply equals ``_encode_subset`` with a generator of the seed, then
    ``_decode_mods``, on the padded batch."""
    model = tiny[name]
    pred = serving.Predictor(model, cond_mod=COND[name], batch_size=BATCH, seed=9)
    request = _data({m: cases.DIMS[m] for m in COND[name]}, 8, n=ROWS)
    reply = pred(request)
    data = {m: torch.cat([torch.from_numpy(v), torch.zeros(BATCH - ROWS, *v.shape[1:])])
            for m, v in request.items()}
    ones = torch.ones(BATCH)
    batch = MultimodalBatch(data=data, masks={m: ones for m in data}, weights=ones)
    with torch.no_grad():
        enc = model._encode_subset(batch, cond_mod=tuple(COND[name]), N=1, return_mean=False,
                                   flatten=True, generator=torch.Generator().manual_seed(9))
        ref = model._decode_mods(enc["z"], tuple(cases.DIMS),
                                 modalities_z=enc.get("modalities_z"))
    _assert_equal(reply, {m: v[:ROWS] for m, v in ref.items()})


# -------------------------------------------------------- against JAX
def _jax_draws(name, cond, key):
    """The draws ``jax.random`` makes from ``key`` in the JAX endpoint's
    ``_encode_subset`` (N=1), as the port's draws: MVTCAE's normal noise;
    MMVAE's expert by ``randint`` and its Laplace uniform from
    ``split(key, 3)``."""
    shape = (BATCH, 4)
    if name == "MVTCAE":
        return [normal(key, shape)]
    _, choice, sample = jax.random.split(key, 3)
    expert = torch.tensor(int(jax.random.randint(choice, (), 0, len(cond))))
    return [expert, uniform(sample, shape, LAPLACE_LOW, 0.5)]


@pytest.mark.parametrize("name, cond, mode", [
    ("MVTCAE", ["m0", "m2"], "mean"), ("MMVAE", ["m1"], "mean"),
    ("DMVAE", ["m0", "m1"], "mean"),
    ("MVTCAE", ["m0", "m2"], "sampled"), ("MMVAE", ["m0", "m2"], "sampled")])
def test_the_program_matches_the_jax_program(pairs, tmp_path, name, cond, mode):
    jmodel, tmodel = pairs[name]
    data = _data({m: JDIMS[m] for m in cond}, 10)
    key = jax.random.key(0)
    jpred = jserving.Predictor(jmodel, cond_mod=cond, batch_size=BATCH,
                               deterministic=MODES[mode])
    ref = jserving.Predictor.load_exported(jpred.export(str(tmp_path / "jax.bin")))(
        jmodel.params, data, key)
    pred = serving.Predictor(tmodel, cond_mod=cond, batch_size=BATCH,
                             deterministic=MODES[mode])
    draws = [] if MODES[mode] else _jax_draws(name, cond, key)
    assert [(s.shape, s.dtype) for s in pred.draw_specs] == [(tuple(d.shape), d.dtype)
                                                             for d in draws]
    fn = serving.Predictor.load_exported(pred.export(str(tmp_path / "endpoint.pt2")))
    ours = fn(tmodel.state_dict(), _tensors(data), draws)
    assert list(ours) == list(JDIMS)
    for m in JDIMS:
        np.testing.assert_allclose(ours[m].numpy(), np.asarray(ref[m]), err_msg=m,
                                   **VALUE_TOL)


@pytest.mark.parametrize("name", ["MVTCAE", "DMVAE"])
def test_the_any_subset_program_matches_the_jax_program(pairs, tmp_path, name):
    jmodel, tmodel = pairs[name]
    masks = _masks(list(JDIMS))
    data = {m: v * masks[m].reshape(-1, *([1] * (v.ndim - 1)))
            for m, v in _data(JDIMS, 11).items()}
    jpred = jserving.AnySubsetPredictor(jmodel, batch_size=BATCH, deterministic=True)
    ref = jserving.Predictor.load_exported(jpred.export(str(tmp_path / "jax.bin")))(
        jmodel.params, data, masks, jax.random.key(0))
    pred = serving.AnySubsetPredictor(tmodel, batch_size=BATCH, deterministic=True)
    fn = serving.AnySubsetPredictor.load_exported(pred.export(str(tmp_path / "ep.pt2")))
    ours = fn(tmodel.state_dict(), _tensors(data), _tensors(masks), [])
    for m in JDIMS:
        np.testing.assert_allclose(ours[m].numpy(), np.asarray(ref[m]), err_msg=m,
                                   **VALUE_TOL)


# ------------------------------------------------------ torch alone
RUN_ALONE = """
import importlib.abc, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in ("multivae_tpu_torch", "multivae_tpu"):
            raise ImportError(name + " is blocked")

sys.meta_path.insert(0, Block())
import torch

params, data, draws = torch.load(sys.argv[2])
reply = torch.export.load(sys.argv[1]).module()(params, data, draws)
torch.save(reply, sys.argv[3])
assert not [m for m in sys.modules if m.startswith("multivae_tpu")]
"""


def test_a_program_runs_with_torch_alone(tiny, tmp_path):
    """A sampled MMVAE program loaded and run by plain
    ``torch.export.load(path).module()`` in a process that cannot import
    the package: the live reply bit for bit."""
    model = tiny["MMVAE"]
    pred = serving.Predictor(model, cond_mod=["a", "c"], batch_size=BATCH)
    path = pred.export(str(tmp_path / "endpoint.pt2"))
    data = _tensors(_data({m: cases.DIMS[m] for m in ("a", "c")}, 12))
    draws = pred.draw(torch.Generator().manual_seed(13))
    params = dict(model.state_dict())
    torch.save((params, data, draws), tmp_path / "inputs.pt")
    subprocess.run([sys.executable, "-c", RUN_ALONE, path, str(tmp_path / "inputs.pt"),
                    str(tmp_path / "reply.pt")], cwd=tmp_path, check=True, timeout=120)
    with torch.no_grad():
        live = pred._predict_fn(params, data, draws)
    _assert_equal(torch.load(tmp_path / "reply.pt"), live)


def test_load_exported_checks_its_arguments(exported):
    pred, fn = exported("MVTCAE", "sampled")
    assert (fn.kind, fn.batch_size, fn.gen_mod) == ("Predictor", BATCH, tuple(cases.DIMS))
    assert fn.draws == [((BATCH, 4), torch.float32)] and fn.hooks == ["draw_noise"]
    data = {"a": torch.zeros(BATCH, 3), "b": torch.zeros(BATCH, 4)}
    with pytest.raises(TypeError, match=r"\(params, data, draws\)"):
        fn(pred.model.state_dict(), data, data, [])
    with pytest.raises(ValueError, match="takes 1 draws"):
        pred._predict_fn(pred.model.state_dict(), data, [])
    with pytest.raises(ValueError, match="state_dict"):
        pred._predict_fn({}, data, pred.draw(torch.Generator()))


def test_export_refuses_sharded_weights(tmp_path):
    """A model whose modules hold a ``ShardedState``'s pieces (``fsdp`` in
    one process keeps the layout over a data axis of one) cannot be
    exported until it is unsharded."""
    trainer = cases.trainer_of("MVTCAE", str(tmp_path / "train"), fsdp=True)
    state = trainer._state
    state.reshard()
    pred = serving.Predictor(trainer.model, cond_mod=["a"], batch_size=BATCH,
                             deterministic=True)
    with pytest.raises(RuntimeError, match="ShardedState"):
        pred.export(str(tmp_path / "endpoint.pt2"))
    state.unshard()
    fn = serving.load_exported(pred.export(str(tmp_path / "endpoint.pt2")))
    _assert_traceable(fn.program, trainer.model)


# --------------------------------------- the JAX package's own behaviour
def test_mopoe_and_nexus_predictors_fail_as_in_jax():
    """The JAX package's own refusals, which the port keeps: MoPoE's
    ``Predictor`` on a strict subset looks every modality up (``KeyError``
    of the first one absent), and Nexus's decodes its top code through the
    bottom decoders (a shape error)."""
    from flax.errors import ScopeParamShapeError

    dims = {"m0": (3,), "m1": (4,)}
    cfg = dict(n_modalities=2, latent_dim=4, input_dims=dims)
    request = {"m0": np.zeros((2, 3), np.float32)}
    jmodel = JMoPoE(JMoPoEConfig(**cfg), seed=0)
    tmodel = port_model(jmodel, models.MoPoE(models.MoPoEConfig(**cfg), device="cpu"))
    with pytest.raises(KeyError, match="m1") as jerr:
        jserving.Predictor(jmodel, cond_mod=["m0"], batch_size=BATCH)(request)
    with pytest.raises(KeyError, match="m1") as err:
        serving.Predictor(tmodel, cond_mod=["m0"], batch_size=BATCH)(request)
    assert err.value.args == jerr.value.args
    nexus = dict(cfg, modalities_specific_dim={"m0": 2, "m1": 2}, msg_dim=3)
    with pytest.raises(ScopeParamShapeError):
        jserving.Predictor(JNexus(JNexusConfig(**nexus), seed=0), cond_mod=["m0"],
                           batch_size=BATCH)(request)
    with pytest.raises(RuntimeError, match="cannot be multiplied"):
        serving.Predictor(models.Nexus(models.NexusConfig(**nexus), device="cpu"),
                          cond_mod=["m0"], batch_size=BATCH)(request)
