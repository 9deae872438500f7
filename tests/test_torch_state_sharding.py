"""The port's ``fsdp`` and ``n_model_devices`` (``parallel/mesh.py``'s leaf
rule, ``parallel/state.py``) against the JAX package's
``combined_state_sharding`` and against one process, on the CPU over gloo.

- The rule: on the JAX tests' leaf dicts, and on every leaf of a converted
  MVTCAE (MLP nets), a conv MMVAE (the PolyMNIST nets), a narrow MVTCAE on
  the CUB nets and the CUB example's full-width text encoder, the port's
  placements equal the JAX specs on meshes of 8 and 4 x 2 (the conftest's
  host devices), mapped to the torch axes through ``params_from_jax``
  itself (each leaf converted as an array of its own indices; a torch
  axis that merges JAX axes, as the CUB attention projections' do, takes
  the names of each). The JAX leaves are shapes only (``jax.eval_shape``):
  no JAX compile.
- Two gloo ranks and four (``torch_dp_worker.py --cases
  torch_state_sharding_cases``), spawned once for the module, the four
  once the two have ended; each test reads its job's result as it
  appears. The test
  process runs the one-process references. Over two ranks ``fsdp`` runs
  the same sums as the replicated run (gloo adds the two ranks' halves
  alike), so the two are bit-equal; against one process, the ranks' sums
  reorder float32 terms.
- An endpoint exported after ``fsdp`` training over two ranks runs in the
  test process, which has no group; an export inside ``train()`` raises.
"""

import functools
import json
import math
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_dp_cases as cases
import torch_state_sharding_cases as ss
from multivae_tpu.models import MMVAE as JMMVAE
from multivae_tpu.models import MMVAEConfig as JMMVAEConfig
from multivae_tpu.models import MVTCAE as JMVTCAE
from multivae_tpu.models import MVTCAEConfig as JMVTCAEConfig
from multivae_tpu.nn import BaseAEConfig as JAEConfig
from multivae_tpu.nn import cub as jcub
from multivae_tpu.nn import mmnist as jmmnist
from multivae_tpu.parallel.mesh import combined_state_sharding as jax_combined
from multivae_tpu.parallel.mesh import fsdp_state_sharding as jax_fsdp
from multivae_tpu.parallel.mesh import get_data_mesh as jax_data_mesh
from multivae_tpu.parallel.mesh import tp_state_sharding as jax_tp
from multivae_tpu_torch import serving
from multivae_tpu_torch.nn.cub import CubTextEncoder, TransformerEncoderLayer
from multivae_tpu_torch.parallel import get_data_mesh
from multivae_tpu_torch.parallel.mesh import (
    DataMesh,
    combined_state_sharding,
    fsdp_state_sharding,
    param_placements,
    tp_state_sharding,
)
from multivae_tpu_torch.parallel.state import ShardedState
from multivae_tpu_torch.trainers import BaseTrainer
from multivae_tpu_torch.trainers.base.callbacks import TrainingCallback
from multivae_tpu_torch.utils.convert import params_from_jax
from torch_parity import compiled_init

TIMEOUT = 150              # seconds a worker may run
TESTS = os.path.dirname(os.path.abspath(__file__))
# one process against the ranks: float32 sums in another order (the loss's
# halves, the gradients' all-reduce, a column layer's partial input
# gradients), over a few SGD steps
LOSS_RTOL = 1e-5
WEIGHT_TOL = dict(rtol=1e-4, atol=1e-6)
# the JAX tensor-parallel tests' own tolerance on the loss
JAX_TP_RTOL = 1e-4
# a reply of the ranks' weights against one process's (``chip_smoke.py``'s
# name): float32 noise of the weights through the decoders
DP_RTOL = 1e-4
MESHES = {"8": (8, 1), "4x2": (4, 2)}


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class _Workers:
    """The worker groups (two ranks, then four) and their result folders.
    A group starts once the one before it has ended, which keeps the
    processes on the host to four at a time."""

    WORLDS = (2, 4)

    def __init__(self, out):
        self.env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [os.path.dirname(TESTS), TESTS, os.environ.get("PYTHONPATH", "")]))
        self.out = str(out)
        self.procs, self.deadline, self.logs, self.outs = {}, {}, [], {}
        self._start(self.WORLDS[0])

    def _start(self, world: int):
        self.outs[world] = os.path.join(self.out, f"world{world}")
        os.makedirs(self.outs[world])
        port = str(_free_port())
        self.deadline[world] = time.monotonic() + TIMEOUT
        self.procs[world] = []
        for rank in range(world):
            log = os.path.join(self.outs[world], f"worker{rank}.log")
            self.logs.append(log)
            with open(log, "w") as f:
                self.procs[world].append(subprocess.Popen(
                    [sys.executable, os.path.join(TESTS, "torch_dp_worker.py"), str(rank),
                     str(world), port, self.outs[world], "none", "--cases",
                     "torch_state_sharding_cases"],
                    env=self.env, stdout=f, stderr=subprocess.STDOUT))

    def _started(self, world: int):
        """The group of ``world`` ranks, started where it was not, once the
        groups before it have ended."""
        if world not in self.procs:
            for earlier in self.WORLDS[:self.WORLDS.index(world)]:
                self.wait(earlier)
            self._start(world)
        return self.procs[world]

    def wait(self, world: int):
        """The group of ``world`` ranks, ended."""
        for p in self._started(world):
            try:
                p.wait(timeout=max(self.deadline[world] - time.monotonic(), 1))
            except subprocess.TimeoutExpired:
                self.close()
                pytest.fail(f"the group of {world} ranks did not end:\n{self.tail()}")
        return self.procs[world]

    def load(self, name: str, world: int = 2, rank: int = 0) -> dict:
        """Rank ``rank``'s result of ``name`` in the group of ``world``,
        waiting for it until the deadline; a job that raised fails with its
        traceback."""
        procs = self._started(world)
        path = os.path.join(self.outs[world], f"{name}_rank{rank}")
        while not os.path.exists(path + ".pt"):
            if os.path.exists(path + ".err"):
                with open(path + ".err") as f:
                    pytest.fail(f"rank {rank} of {world} failed {name}:\n{f.read()}")
            if time.monotonic() > self.deadline[world] or all(
                    p.poll() is not None for p in procs):
                self.close()
                pytest.fail(f"no result {name} of rank {rank} of {world}:\n{self.tail()}")
            time.sleep(0.05)
        return cases.load(self.outs[world], name, rank)

    def ranks(self, name: str, world: int = 2):
        return [self.load(name, world, r) for r in range(world)]

    def tail(self) -> str:
        out = []
        for log in self.logs:
            with open(log) as f:
                out.append(f.read()[-2000:])
        return "\n".join(out)

    def close(self):
        for procs in self.procs.values():
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()


@pytest.fixture(scope="module")
def workers(tmp_path_factory):
    handle = _Workers(tmp_path_factory.mktemp("state_sharding"))
    yield handle
    handle.close()


def _losses(res, key="train_epoch_loss"):
    return [h[key] for h in res["history"]]


def _same_run(ours: dict, ref: dict, exact: bool):
    """History and whole live and kept weights (the kept ones whole under
    every layout): equal, or within the tolerances."""
    assert set(ours["live"]) == set(ref["live"])
    assert (ours["best"] is None) == (ref["best"] is None)
    weights = [(ours["live"], ref["live"])]
    if ref["best"] is not None:
        assert set(ours["best"]) == set(ref["best"])
        weights.append((ours["best"], ref["best"]))
    if exact:
        assert ours["history"] == ref["history"]
        for got, want in weights:
            for k, v in want.items():
                assert got[k].shape == v.shape and torch.equal(got[k], v), k
        return
    for key in ref["history"][0]:
        if key.endswith("epoch_loss"):
            np.testing.assert_allclose(_losses(ours, key), _losses(ref, key), rtol=LOSS_RTOL)
    for got, want in weights:
        for k, v in want.items():
            torch.testing.assert_close(got[k], v, **WEIGHT_TOL, msg=k)


def _same_optimizer_state(ours: dict, ref: dict):
    """Whole optimizer states, key by key and bit for bit."""
    assert ours["param_groups"] == ref["param_groups"]
    assert set(ours["state"]) == set(ref["state"])
    for i, entry in ref["state"].items():
        assert set(ours["state"][i]) == set(entry)
        for k, v in entry.items():
            if isinstance(v, torch.Tensor):
                assert torch.equal(ours["state"][i][k], v), (i, k)
            else:
                assert ours["state"][i][k] == v


def _ranks_agree(ranks):
    for r in ranks[1:]:
        assert r["history"] == ranks[0]["history"]
        for k, v in ranks[0]["live"].items():
            assert torch.equal(r["live"][k], v), k


# ------------------------------------------------------------------ the rule
def _strip(spec) -> tuple:
    spec = tuple(spec)
    while spec and spec[-1] is None:
        spec = spec[:-1]
    return spec


def _port_mesh(name):
    n_data, n_model = MESHES[name]
    return DataMesh(n_data * n_model, 0, 0, torch.device("cpu"), False, n_model)


def _jax_mesh(name):
    n_data, n_model = MESHES[name]
    return jax_data_mesh(n_data, n_model_devices=n_model)


JAX_TEST_DICTS = {
    # tests/test_trainer.py::test_combined_state_sharding_rules
    "combined": dict(kernel=(512, 128), bias=(128,), odd=(7, 65), narrow=(8, 4),
                     ints=((512, 128), np.int32)),
    "wide": dict(kernel=(512, 2048), bias=(2048,)),
    "wide_1d": dict(v=(4096,)),
    # tests/test_perf_features.py::test_fsdp_state_sharding_odd_leaves
    "odd_leaves": dict(w_shardable=(16, 128), w_odd=(15, 128), w_small=(8, 4),
                       steps=((16, 128), np.int32), scalar=()),
}


def _arrays(spec: dict) -> dict:
    out = {}
    for k, v in spec.items():
        shape, dtype = v if isinstance(v, tuple) and len(v) == 2 and isinstance(
            v[0], tuple) else (v, np.float32)
        out[k] = np.zeros(shape, dtype)
    return out


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("leaves", list(JAX_TEST_DICTS))
@pytest.mark.parametrize("rule", ["combined_fsdp", "combined", "fsdp", "tp", "tp_min_dim"])
def test_the_rule_matches_jax_on_the_jax_tests_leaves(mesh, leaves, rule):
    """Each leaf of the JAX tests' dicts: the port's spec is the JAX
    function's, for the combined rule with and without ``fsdp``, each half,
    and a ``min_dim`` that turns the column rule off (the wide 1-D leaf then
    falls back to fsdp's); ``tp_state_sharding`` raises without a model
    axis in both."""
    state = _arrays(JAX_TEST_DICTS[leaves])
    jmesh, pmesh = _jax_mesh(mesh), _port_mesh(mesh)
    if rule.startswith("tp") and MESHES[mesh][1] == 1:
        with pytest.raises(ValueError):
            jax_tp(state, jmesh)
        with pytest.raises(ValueError, match="model"):
            tp_state_sharding(state, pmesh)
        return
    jax_fn, port_fn = {
        "combined_fsdp": (lambda s, m: jax_combined(s, m, fsdp=True),
                          lambda s, m: combined_state_sharding(s, m, fsdp=True)),
        "combined": (jax_combined, combined_state_sharding),
        "fsdp": (jax_fsdp, fsdp_state_sharding),
        "tp": (jax_tp, tp_state_sharding),
        "tp_min_dim": (lambda s, m: jax_combined(s, m, fsdp=True, min_dim=8000),
                       lambda s, m: combined_state_sharding(s, m, fsdp=True, min_dim=8000)),
    }[rule]
    jax_specs, port_specs = jax_fn(state, jmesh), port_fn(state, pmesh)
    assert set(port_specs) == set(jax_specs)
    for k, sharding in jax_specs.items():
        assert _strip(port_specs[k]) == _strip(sharding.spec), k


def _coded(tree):
    """A tree of float64 arrays shaped as ``tree``'s leaves (arrays or
    shape structs), each holding its own flat indices, offset so that
    every leaf's are distinct."""
    start = [0]

    def code(x):
        size = math.prod(x.shape)
        out = (np.arange(size, dtype=np.float64) + start[0]).reshape(x.shape)
        start[0] += size
        return out

    return jax.tree.map(code, tree)


def _entry(names) -> object:
    """A torch axis's spec entry: None, one axis name, or a tuple of two."""
    return names[0] if len(names) == 1 else (tuple(names) or None)


def _jax_specs_on_torch_axes(params, jmesh, fsdp, strip: str = "") -> dict:
    """{port state_dict key less ``strip``: the JAX spec of its leaf, on the
    torch axes}: each leaf of ``params`` (shapes suffice) converted by
    ``params_from_jax`` as its own indices. A torch axis takes the name of
    every JAX axis that moves along it, the slowest first (the order in
    which they are merged)."""
    coded = _coded(params)
    specs = jax_combined(params, jmesh, fsdp=fsdp)
    leaves = [(c, tuple(s.spec)) for c, s in zip(
        jax.tree_util.tree_leaves(coded), jax.tree_util.tree_leaves(
            specs, is_leaf=lambda x: hasattr(x, "spec")))]
    out = {}
    for key, tensor in params_from_jax(coded).items():
        t = tensor.numpy()
        first = t.reshape(-1)[0]
        leaf, jspec = next((c, s) for c, s in leaves if c.reshape(-1)[0] <= first
                           < c.reshape(-1)[0] + c.size)
        c0 = leaf.reshape(-1)[0]
        origin = np.unravel_index(int(t[(0,) * t.ndim] - c0), leaf.shape)
        groups, free = {}, set(range(leaf.ndim))
        for a in range(t.ndim):
            line = np.moveaxis(t, a, 0)[(slice(None),) + (0,) * (t.ndim - 1)]
            index = np.unravel_index((line - c0).astype(np.int64), leaf.shape)
            # JAX axis -> the first step along the torch axis that moves it
            first_move = {j: int(np.argmax(index[j] != origin[j])) for j in range(leaf.ndim)
                          if (index[j] != origin[j]).any()}
            groups[a] = sorted(first_move, key=first_move.get, reverse=True)
            free -= set(groups[a])
        for a in range(t.ndim):   # size-1 axes: a size-1 JAX axis left
            if not groups[a]:
                groups[a] = [next(j for j in sorted(free) if leaf.shape[j] == 1)]
                free.discard(groups[a][0])
        jspec = list(jspec) + [None] * (leaf.ndim - len(jspec))
        out[key[len(strip):]] = tuple(_entry([jspec[j] for j in groups[a] if jspec[j] is not None])
                                      for a in range(t.ndim))
    return out


def _shapes(make, cls):
    """The leaves' shapes of the JAX model ``make()`` of ``cls``."""
    with compiled_init(cls, shapes=True):
        model = make()
    return model.params


def _jax_mvtcae():
    return _shapes(lambda: JMVTCAE(JMVTCAEConfig(n_modalities=2, latent_dim=8,
                                                 input_dims=ss.TP_DIMS), seed=0), JMVTCAE)


def _jax_conv_mmvae():
    cfg = JAEConfig(latent_dim=ss.CONV_LATENT, input_dim=(3, 28, 28))
    return _shapes(lambda: JMMVAE(
        JMMVAEConfig(n_modalities=2, latent_dim=ss.CONV_LATENT, input_dims=ss.CONV_DIMS, K=2,
                     loss="dreg_looser"),
        encoders={m: jmmnist.EncoderConvMMNIST_adapted(cfg) for m in ss.CONV_DIMS},
        decoders={m: jmmnist.DecoderConvMMNIST(cfg) for m in ss.CONV_DIMS}, seed=0), JMMVAE)


class _JaxCubMVTCAE(JMVTCAE):
    """The JAX MVTCAE with a token-dict text modality: its init would feed
    every encoder a float array of ``input_dims``."""

    def _dummy_input(self, mod):
        if mod == "text":
            return {"tokens": jnp.zeros((1, ss.CUB_LEN), jnp.int32),
                    "padding_mask": jnp.ones((1, ss.CUB_LEN))}
        return super()._dummy_input(mod)


def _jax_cub_mvtcae():
    """``ss.cub_mvtcae``'s JAX leaves."""
    text = (ss.CUB_LEN, ss.CUB_VOCAB)
    return _shapes(lambda: _JaxCubMVTCAE(JMVTCAEConfig(
        n_modalities=2, latent_dim=ss.CUB_LATENT, input_dims={"image": (3, 64, 64), "text": text},
        decoders_dist={"image": "laplace", "text": "categorical"}, beta=5.0, alpha=0.9), seed=0,
        encoders={"image": jcub.CUB_Resnet_Encoder(latent_dim=ss.CUB_LATENT, **ss.CUB_NF),
                  "text": jcub.CubTextEncoder(latent_dim=ss.CUB_LATENT,
                                              max_sentence_length=ss.CUB_LEN,
                                              ntokens=ss.CUB_VOCAB, **ss.CUB_TEXT)},
        decoders={"image": jcub.CUB_Resnet_Decoder(latent_dim=ss.CUB_LATENT, **ss.CUB_NF),
                  "text": jcub.CubTextDecoderMLP(JAEConfig(latent_dim=ss.CUB_LATENT,
                                                           input_dim=text))}), JMVTCAE)


# the CUB example's text encoder (examples/mvtcae_cub.py): embed 512, 2 heads
# (head_dim 256), feed-forward 128, 2 layers; captions of 32 tokens, latent 64
CUB_FULL = dict(embed_size=512, nhead=2, ff_size=128, n_layers=2)
CUB_FULL_LEN, CUB_FULL_VOCAB, CUB_FULL_LATENT = 32, 64, 64


def _jax_cub_text_full():
    enc = jcub.CubTextEncoder(latent_dim=CUB_FULL_LATENT, max_sentence_length=CUB_FULL_LEN,
                              ntokens=CUB_FULL_VOCAB, **CUB_FULL)
    inputs = {"tokens": jnp.zeros((1, CUB_FULL_LEN), jnp.int32),
              "padding_mask": jnp.ones((1, CUB_FULL_LEN))}
    return {"encoders": {"x": jax.eval_shape(enc.init, jax.random.key(0), inputs)["params"]}}


# name -> (the JAX leaves' shapes, the port's model, the prefix of the
# converted keys that the port's model has not)
MODELS = {"mvtcae_mlp": (functools.cache(_jax_mvtcae), lambda: ss.tp_model(8, 0), ""),
          "conv_mmvae": (functools.cache(_jax_conv_mmvae), ss.conv_mmvae, ""),
          "cub_mvtcae": (functools.cache(_jax_cub_mvtcae), ss.cub_mvtcae, ""),
          "cub_text_full": (_jax_cub_text_full, lambda: CubTextEncoder(
              CUB_FULL_LATENT, CUB_FULL_LEN, CUB_FULL_VOCAB, **CUB_FULL), "encoders.x.")}
LAYER = "encoders.text.layers.0."


@pytest.mark.parametrize("fsdp", [True, False])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("model", list(MODELS))
def test_the_rule_matches_jax_on_every_leaf_of_a_converted_model(model, mesh, fsdp):
    """Every parameter of the port's model: its placement is the JAX spec of
    the leaf it converts from, on the torch axes; the conv model's conv,
    transposed-conv and dense kernels and their biases among the cut ones.
    The CUB text encoder's attention projections are judged on their
    per-head JAX leaves, where a Dense reading would cut otherwise: at
    head_dim 16 the query stays whole on the model axis, and at 2 heads the
    (heads, head_dim, out) kernel stays whole over data 4 and 8."""
    make_jax, make_port, strip = MODELS[model]
    tmodel = make_port()
    want = _jax_specs_on_torch_axes(make_jax(), _jax_mesh(mesh), fsdp, strip)
    got = param_placements(tmodel, _port_mesh(mesh), fsdp=fsdp)
    assert set(got) == set(want) == set(dict(tmodel.named_parameters()))
    for k, spec in want.items():
        assert _strip(got[k]) == _strip(spec), (k, got[k], spec)
    assert any(s for s in got.values()) == (fsdp or MESHES[mesh][1] > 1)
    if model == "conv_mmvae" and MESHES[mesh][1] > 1:
        assert got["encoders.m0.conv.1.weight"] == ("model", None, None, None)
        assert got["decoders.m0.deconv.0.weight"][1] == "model"
    if model == "cub_mvtcae" and MESHES[mesh][1] > 1:
        # a Dense reading of the (64, 4, 16) kernel would cut its 64 columns
        assert "model" not in got[LAYER + "query.weight"]
        assert got[LAYER + "out.weight"][0] == "model"
    if model == "cub_text_full" and fsdp:
        # (2, 256, 512): 2 heads do not divide over data 4 or 8; a Dense
        # reading (512 rows) would cut it
        assert "data" not in got["layers.0.out.weight"]
        assert got["layers.0.query.weight"][1] == "data"


def test_a_merged_axis_takes_both_names():
    """A (heads, head_dim) bias of 1024 entries on data 4 x model 2 with
    ``fsdp``: JAX cuts heads over "data" and head_dim over "model", so the
    port's one torch axis takes both names; its state keeps a column block
    of the query Linear (output rows) cut in flat pieces over "data", an
    eighth of the leaf a rank, as JAX's ``P(("data", "model"))``."""
    jlayer = jcub.TransformerEncoderLayer(1024, 4, 64)
    x, mask = jnp.zeros((1, 2, 1024)), jnp.ones((1, 2))
    params = {"encoders": {"x": {"TransformerEncoderLayer_0": jax.eval_shape(
        jlayer.init, jax.random.key(0), x, mask)["params"]}}}
    want = _jax_specs_on_torch_axes(params, _jax_mesh("4x2"), True, "encoders.x.layers.0.")
    layer = TransformerEncoderLayer(1024, 4, 64)
    got = param_placements(layer, _port_mesh("4x2"), fsdp=True)
    for k, spec in want.items():
        assert _strip(got[k]) == _strip(spec), (k, got[k], spec)
    assert got["query.bias"] == (("data", "model"),)
    assert got["query.weight"] == ("model", "data")
    leaves = {leaf.name: leaf for leaf in ShardedState(layer, _port_mesh("4x2"), True).leaves}
    for name in ("query.weight", "query.bias"):
        leaf = leaves[name]
        assert (leaf.column_dim, leaf.data_cut, leaf.model_cut) == (0, True, False), name
        assert leaf.master.numel() * 8 == math.prod(leaf.shape), name


def test_a_declared_leaf_that_does_not_merge_to_its_parameter_raises():
    """A module's declared JAX leaf must merge to its parameter's shape:
    a layout whose sizes do not (here the heads and head_dim of another
    width) raises, naming the parameter, instead of a wrong placement."""
    layer = TransformerEncoderLayer(64, 4, 64)
    layer.jax_leaves = lambda: {"query.weight": ((64, 2, 16), ((1, 2), (0,)))}
    with pytest.raises(ValueError, match=r"Linear.weight.*\(64, 2, 16\).*\[32, 64\]"):
        param_placements(layer, _port_mesh("4x2"), fsdp=True)


def test_the_mesh_counts_the_data_axis(monkeypatch):
    """Without a group a model axis raises, as ``n_devices`` above 1 does."""
    with pytest.raises(ValueError, match="n_model_devices=2.*no process group"):
        get_data_mesh(None, "cpu", n_model_devices=2)
    mesh = _port_mesh("4x2")
    assert (mesh.n_data, mesh.n_model, mesh.data_index, mesh.model_index) == (4, 2, 0, 0)
    assert DataMesh(8, 5, 5, torch.device("cpu"), True, 2).data_index == 2


def test_fsdp_alone_equals_the_replicated_run(tmp_path):
    """One process with ``fsdp``: its masters are flat pieces of one (the
    whole leaf), and the run is the replicated run bit for bit; outside
    ``train`` the model holds whole weights under the same keys, and a
    second ``train`` cuts them into the masters again."""
    runs = {}
    for fsdp in (False, True):
        trainer = cases.trainer_of("MMVAE", str(tmp_path / str(fsdp)), fsdp=fsdp,
                                   optimizer_cls="Adam", optimizer_params=None)
        runs[fsdp] = [ss.train(trainer)]
        trainer.training_config.num_epochs = 3
        runs[fsdp].append(ss.train(trainer))
        if fsdp:
            cut = [leaf for leaf in trainer._state.leaves if leaf.data_cut]
            assert cut and all(leaf.master.dim() == 1 for leaf in cut)
            assert not trainer._state.active
            assert all(p.shape == leaf.shape for p, leaf in zip(
                trainer.model.parameters(), trainer._state.leaves))
    for ours, ref in zip(runs[True], runs[False]):
        _same_run(ours, ref, exact=True)
        _same_optimizer_state(ours["optimizer"], ref["optimizer"])


class _Stop(Exception):
    pass


class _RaiseAtEpoch(TrainingCallback):
    def __init__(self, epoch):
        self.epoch = epoch

    def on_epoch_end(self, training_config, **kwargs):
        if len(self.trainer.history) + 1 == self.epoch:
            raise _Stop


def test_a_train_that_raises_leaves_whole_weights(tmp_path):
    """A ``train`` that raises inside a callback under ``fsdp`` leaves the
    modules holding whole weights, not the flat masters: the state_dict
    that a save would write has the replicated run's keys, shapes and
    values at the same point."""
    live = {}
    for fsdp in (False, True):
        trainer = cases.trainer_of("MMVAE", str(tmp_path / str(fsdp)), fsdp=fsdp,
                                   optimizer_cls="Adam", optimizer_params=None,
                                   num_epochs=3)
        stop = _RaiseAtEpoch(2)
        stop.trainer = trainer
        trainer.callback_handler.add_callback(stop)
        with pytest.raises(_Stop):
            trainer.train()
        assert len(trainer.history) == 1
        live[fsdp] = trainer.model.state_dict()
        if fsdp:
            assert trainer._state.cuts and not trainer._state.active
    assert list(live[True]) == list(live[False])
    for k, v in live[False].items():
        assert live[True][k].shape == v.shape and torch.equal(live[True][k], v), k


# ------------------------------------------------------------- two ranks
@pytest.mark.parametrize("name", list(ss.OPTIMIZERS))
def test_fsdp_over_two_ranks_equals_the_replicated_run(workers, tmp_path, name):
    """Every optimizer: two ranks with ``fsdp`` bit-equal to two ranks
    without (history, whole weights, whole optimizer state), both within
    float32 noise of one process on the global batch; each rank holds half
    the bytes of the cut leaves and their optimizer state."""
    runs = workers.load("optimizers")
    ours, replicated = runs[(name, True)], runs[(name, False)]
    _same_run(ours, replicated, exact=True)
    _same_optimizer_state(ours["optimizer"], replicated["optimizer"])
    _ranks_agree([r[(name, True)] for r in workers.ranks("optimizers")])
    cls, params = ss.OPTIMIZERS[name]
    alone = ss.train(cases.trainer_of(
        "MVTCAE", str(tmp_path), optimizer_cls=cls, optimizer_params=params,
        scheduler_cls=None, scheduler_params=None,
        per_device_train_batch_size=2 * cases.PER_DEVICE,
        per_device_eval_batch_size=2 * cases.PER_DEVICE))
    np.testing.assert_allclose(_losses(ours), _losses(alone), rtol=LOSS_RTOL)
    np.testing.assert_allclose(_losses(ours, "eval_epoch_loss"),
                               _losses(alone, "eval_epoch_loss"), rtol=LOSS_RTOL)
    if cls in ("SGD", "Adagrad"):   # no division by a running RMS near 0
        for k, v in alone["live"].items():
            torch.testing.assert_close(ours["live"][k], v, **WEIGHT_TOL, msg=k)
    cut = list(ours["cut"])
    assert cut
    whole = ss.replicated_nbytes(replicated, cut)
    uncut = replicated["nbytes"] - whole
    assert ours["nbytes"] - uncut == whole // 2


def _alone_conv(tmp_path, name):
    return ss.train(ss.conv_trainer(str(tmp_path), name))


@pytest.mark.parametrize("job", ["fsdp_conv", "tp_conv"])
def test_the_conv_mmvae_over_two_ranks_matches_one_process(workers, tmp_path, job):
    """``conv_mmvae`` (DReG: the mixture's forward and dz-only backward each
    step) with ``fsdp`` over data 2 and over model 2: losses, eval loss and
    every weight within float32 noise of one process. Over model 2 every
    conv, transposed conv and dense layer of 64 output channels or more
    computes its own channels: the output channels gathered, not a half
    labelled whole (the trap of DTensor's convolution)."""
    ranks = workers.ranks(job)
    _ranks_agree(ranks)
    ours = ranks[0]
    assert (ours["n_data"], ours["n_model"]) == ((2, 1) if job == "fsdp_conv" else (1, 2))
    _same_run(ours, _alone_conv(tmp_path, job), exact=False)
    cut = ours["placements"]
    if job == "tp_conv":
        assert cut["encoders.m0.conv.2.weight"] == ("model", None, None, None)
        assert cut["decoders.m1.deconv.0.weight"] == (None, "model", None, None)
        assert cut["decoders.m1.dense.0.weight"] == ("model", None)


def test_the_model_axis_matches_the_single_device_loss(workers, tmp_path):
    """The JAX ``test_tp_loss_matches_single_device`` model over model 2:
    the epoch loss within the JAX test's rel 1e-4 of one process (in fact
    within float32 noise), every weight too."""
    ours = workers.load("tp_mvtcae")
    alone = ss.tp_mvtcae_case(str(tmp_path))
    np.testing.assert_allclose(_losses(ours), _losses(alone), rtol=JAX_TP_RTOL)
    _same_run(ours, alone, exact=False)
    assert any("model" in s for s in ours["placements"].values())


def test_fsdp_with_mixed_precision_keeps_float32_masters(workers):
    """``mixed_precision`` with ``fsdp`` over two ranks: bit-equal to the
    replicated bf16 run; the cut leaves' masters and optimizer moments are
    float32 flat pieces."""
    runs = workers.load("fsdp_bf16")
    _same_run(runs[True], runs[False], exact=True)
    for name, (shape, dtype, moments) in runs[True]["cut"].items():
        assert dtype == torch.float32 and len(shape) == 1, name
        assert moments == [torch.float32], name


def test_a_sharded_checkpoint_resumes_in_one_process(workers, tmp_path):
    """The checkpoint of two ``fsdp`` ranks holds what a replicated run
    writes (the same files, keys and whole shapes, rank 0 alone); resumed
    from epoch 2 in one process, epoch 3 continues the two ranks' run, and
    resumed by the two ``fsdp`` ranks it repeats their epoch 3 bit for bit
    (the whole optimizer state cut into the masters' layout again)."""
    ranks = workers.ranks("fsdp_checkpoint")
    ours = ranks[0]
    checkpoint = os.path.join(ours["training_dir"], "checkpoint_epoch_2")
    reference = cases.trainer_of("MVTCAE", str(tmp_path / "ref"), num_epochs=1,
                                 steps_saving=1)
    reference.train()
    ref_dir = os.path.join(reference.training_dir, "checkpoint_epoch_1")
    assert sorted(os.listdir(checkpoint)) == sorted(os.listdir(ref_dir))
    for name in ("live_params.pt", "model.pt"):
        a, b = (torch.load(os.path.join(d, name), weights_only=True)
                for d in (checkpoint, ref_dir))
        assert {k: v.shape for k, v in a.items()} == {k: v.shape for k, v in b.items()}
    a, b = (torch.load(os.path.join(d, "optimizer.pt"), weights_only=True)
            for d in (checkpoint, ref_dir))
    assert {i: {k: getattr(v, "shape", None) for k, v in s.items()}
            for i, s in a["state"].items()} == {
        i: {k: getattr(v, "shape", None) for k, v in s.items()} for i, s in b["state"].items()}
    resumed = cases.trainer_of("MVTCAE", str(tmp_path / "resumed"), num_epochs=3,
                               checkpoint=checkpoint,
                               per_device_train_batch_size=2 * cases.PER_DEVICE,
                               per_device_eval_batch_size=2 * cases.PER_DEVICE)
    out = ss.train(resumed)
    assert ours["resumed"]["history"] == ours["history"][2:]
    for k, v in ours["live"].items():
        assert torch.equal(ours["resumed"]["live"][k], v), k
    assert len(out["history"]) == 1
    np.testing.assert_allclose(_losses(out), _losses(ours)[2:], rtol=LOSS_RTOL)
    for k, v in ours["live"].items():
        torch.testing.assert_close(out["live"][k], v, **WEIGHT_TOL, msg=k)


def _same_restore(got: dict, ref: dict):
    """Whole weights and whole optimizer state, bit for bit."""
    assert list(got["live"]) == list(ref["live"])
    for k, v in ref["live"].items():
        assert got["live"][k].shape == v.shape and torch.equal(got["live"][k], v), k
    _same_optimizer_state(got["optimizer"], ref["optimizer"])


def test_a_sharded_checkpoint_restores_into_any_layout(workers, tmp_path):
    """``checkpoint_backend="orbax"`` under ``fsdp`` over two ranks (JAX
    ``test_orbax_checkpoint_with_fsdp_sharded_state`` and
    ``test_orbax_restore_cross_topology``): each rank wrote its own half of
    every cut leaf, and of its optimizer state, and no rank a whole one;
    the whole leaves rank 0 alone; no ``optimizer.pt`` or
    ``live_params.pt``. The two ranks resumed from epoch 2 repeat their
    epoch 3 bit for bit. Epoch 3's checkpoint restores bit-equal, whole
    weights and optimizer state, into one process replicated, into one
    process with ``fsdp`` and into data 2 x model 2 with ``fsdp`` on four
    ranks, each then training a finite epoch; the four ranks' own sharded
    checkpoint restores bit-equal in one process."""
    ranks = workers.ranks("fsdp_orbax")
    _ranks_agree(ranks)
    ours = ranks[0]
    assert ours["resumed"]["history"] == ours["history"][2:]
    for k, v in ours["live"].items():
        assert torch.equal(ours["resumed"]["live"][k], v), k
    checkpoint = os.path.join(ours["training_dir"], "checkpoint_epoch_3")
    files = set(os.listdir(checkpoint))
    assert "train_state" in files
    assert not files & {"optimizer.pt", "live_params.pt", "generator.pt", "train_state.tmp"}
    state_dir = os.path.join(checkpoint, "train_state")
    assert sorted(os.listdir(state_dir)) == ["common.pt", "index.json", "rank_0.pt", "rank_1.pt"]
    with open(os.path.join(state_dir, "index.json")) as f:
        index = json.load(f)
    assert (index["world_size"], index["n_data"], index["n_model"], index["fsdp"]) == (
        2, 2, 1, True)
    held = [torch.load(os.path.join(state_dir, f"rank_{r}.pt"), weights_only=True)
            for r in (0, 1)]
    cut = set(ours["cut"])
    assert cut and cut <= {entry["name"] for entry in index["leaves"]}
    for entry in index["leaves"]:
        name, numel = entry["name"], int(np.prod(entry["shape"]))
        writers = [p["rank"] for p in entry["pieces"]]
        assert writers == ([0, 1] if name in cut else [0]), name
        for r in writers:
            pieces = held[r][name]
            assert set(pieces) == {"param", *entry["state_keys"]}, name
            for v in pieces.values():
                assert v.numel() == (numel // 2 if name in cut else numel), name
        assert name in cut or name not in held[1]
    per_device = dict(per_device_train_batch_size=2 * cases.PER_DEVICE,
                      per_device_eval_batch_size=2 * cases.PER_DEVICE)
    for fsdp in (False, True):
        trainer = cases.trainer_of("MVTCAE", str(tmp_path / f"fsdp_{fsdp}"), fsdp=fsdp,
                                   num_epochs=4, checkpoint=checkpoint, **per_device)
        assert (trainer._state is not None) is fsdp and trainer.trained_epochs == 3
        _same_restore(ss.restored(trainer), ours)
        out = ss.train(trainer)
        assert len(out["history"]) == 1 and np.isfinite(_losses(out)).all()
    fours = workers.ranks("orbax_2x2", world=4)
    for four in fours:
        assert (four["n_data"], four["n_model"]) == (2, 2)
        assert any("model" in s for s in four["placements"].values())
        _same_restore(four["restored"], ours)
        assert len(four["history"]) == 1 and np.isfinite(_losses(four)).all()
    # and back: the four ranks' epoch 4, saved in their layout (column
    # pieces, flat pieces of column blocks), restored in one process
    trainer = cases.trainer_of("MVTCAE", str(tmp_path / "from_2x2"), num_epochs=4, **per_device,
                               checkpoint=os.path.join(fours[0]["training_dir"],
                                                       "checkpoint_epoch_4"))
    _same_restore(ss.restored(trainer), fours[0])


def test_fsdp_chunks_equal_the_step_by_step_loop(workers):
    """MMVAE on the device cache with ``fsdp`` over two ranks: chunks of 3
    steps (the captured chunks' body, eager on the CPU) bit-equal to steps
    one by one."""
    runs = workers.load("fsdp_chunked")
    _same_run(runs[3], runs[1], exact=True)


def test_fsdp_through_the_multistage_trainer(workers):
    """TELBO with ``fsdp`` over two ranks: the optimizer reset (new
    optimizer over the masters, kept weights loaded into them) and stage
    2's frozen groups (their gradients None on every rank), bit-equal to
    the replicated run."""
    runs = workers.load("fsdp_telbo")
    _same_run(runs[True], runs[False], exact=True)


def test_fsdp_with_microbatches_equals_the_replicated_run(workers):
    """MMVAE at ``microbatch_steps=2`` with ``fsdp`` over two ranks: one
    gather a step, the chunks' gradients added up in the gathered tensors,
    bit-equal to the replicated run."""
    runs = workers.load("fsdp_microbatch")
    _same_run(runs[True], runs[False], exact=True)


def test_an_endpoint_exported_after_fsdp_training_holds_no_topology(workers, tmp_path):
    """Rank 0's deterministic ``Predictor``, exported after ``fsdp`` training
    over data 2, loaded and run in this process, which has no group: no
    collective in its graph, its reply within ``DP_RTOL`` of the one-process
    run's exported endpoint. An export inside ``train()``, while the
    modules held the masters, raised."""
    ours = workers.load("fsdp_export")
    assert ours["n_data"] == 2 and ours["cut"]
    assert "ShardedState" in ours["inside"], ours["inside"]
    fn = serving.load_exported(ours["path"])
    assert not [n.target for n in fn.program.graph.nodes if "c10d" in str(n.target)]
    trainer = cases.trainer_of("MVTCAE", str(tmp_path),
                               per_device_train_batch_size=2 * cases.PER_DEVICE,
                               per_device_eval_batch_size=2 * cases.PER_DEVICE)
    alone = ss.train(trainer)
    ref_fn = serving.load_exported(ss.export_predictor(trainer.model).export(
        str(tmp_path / "alone.pt2")))
    rng = np.random.default_rng(6)
    request = {m: torch.from_numpy(rng.uniform(size=(ss.EXPORT_BATCH, *cases.DIMS[m])).astype(
        np.float32)) for m in ss.EXPORT_COND}
    reply, ref = fn(ours["live"], request, []), ref_fn(alone["live"], request, [])
    assert list(reply) == list(cases.DIMS)
    for m in cases.DIMS:
        np.testing.assert_allclose(reply[m].numpy(), ref[m].numpy(), rtol=DP_RTOL,
                                   atol=1e-6, err_msg=m)


@pytest.mark.parametrize("job", ["cub_fsdp", "cub_tp"])
def test_the_cub_mvtcae_over_two_ranks(workers, tmp_path, job):
    """MVTCAE on the CUB nets, whose text encoder's attention projections
    are judged on their per-head JAX leaves: with ``fsdp`` over data 2
    bit-equal to the replicated two ranks (history, whole weights, whole
    optimizer state); over model 2 within float32 noise of one process,
    the query Linears whole (head_dim 16) and the out Linears computing
    their own columns."""
    ranks = workers.ranks(job)
    if job == "cub_fsdp":
        _ranks_agree([r[True] for r in ranks])
        ours, replicated = ranks[0][True], ranks[0][False]
        _same_run(ours, replicated, exact=True)
        _same_optimizer_state(ours["optimizer"], replicated["optimizer"])
        assert ours["n_data"] == 2
        assert ours["placements"][LAYER + "query.weight"] == (None, "data")
        assert ours["placements"][LAYER + "out.weight"] == (None, "data")
        return
    _ranks_agree(ranks)
    ours = ranks[0]
    assert (ours["n_data"], ours["n_model"]) == (1, 2)
    # one thread, as each rank: the Laplace image loss's gradient flips a
    # pixel's sign where float32 rounding crosses its target, and the
    # thread count alone moves one process's second epoch loss by 1e-5
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        alone = ss.train(ss.cub_trainer(str(tmp_path), "alone"))
    finally:
        torch.set_num_threads(threads)
    _same_run(ours, alone, exact=False)
    assert ours["placements"][LAYER + "query.weight"] == ()
    assert ours["placements"][LAYER + "out.weight"] == ("model", None)


# ------------------------------------------------------------ four ranks
def test_fsdp_and_the_model_axis_together(workers, tmp_path):
    """The JAX ``test_tp_composes_with_fsdp`` layout: data 2 x model 2 with
    ``fsdp`` on four ranks equals one process on the global batch; a
    kernel cut on both axes holds a quarter of its bytes."""
    ranks = workers.ranks("both", world=4)
    _ranks_agree(ranks)
    ours = ranks[0]
    assert (ours["n_data"], ours["n_model"]) == (2, 2)
    alone = ss.train(BaseTrainer(ss.tp_model(8, 7), ss.tp_data(), device="cpu",
                                 training_config=ss.config(str(tmp_path), "alone",
                                                           per_device_train_batch_size=16,
                                                           seed=13)))
    _same_run(ours, alone, exact=False)
    both = [k for k, s in ours["placements"].items() if set(s) >= {"data", "model"}]
    assert both
    for k in both:
        assert np.prod(ours["cut"][k][0]) * 4 == alone["live"][k].numel()


def test_the_cub_mvtcae_sharded_checkpoint_restores_whole(workers, tmp_path):
    """``cub_fsdp``'s ``"orbax"`` checkpoint (two ``fsdp`` ranks) restores
    bit-equal, whole weights and optimizer state, into one process and into
    data 2 x model 2 with ``fsdp``, where the out Linears are cut on both
    axes."""
    ours = workers.load("cub_fsdp")[True]
    trainer = ss.cub_trainer(str(tmp_path), "restored", checkpoint=os.path.join(
        ours["training_dir"], "checkpoint_epoch_2"))
    _same_restore(ss.restored(trainer), ours)
    for four in workers.ranks("cub_2x2", world=4):
        _same_restore(four, ours)
        assert four["placements"][LAYER + "out.weight"] == ("model", "data")


def test_the_sharded_cache_on_a_2x2_mesh_shards_rows_over_data_only(workers):
    """The ``"sharded"`` cache on data 2 x model 2: the two ranks of a data
    index hold the same block of ceil(37 / 2) = 19 rows (replicated over
    "model"), each rank's batches are its data index's host columns bit for
    bit, and the four ranks train alike."""
    ranks = workers.ranks("cache_2x2", world=4)
    starts = [r["block"]["start"] for r in ranks]
    assert starts == [0, 0, 19, 19]
    assert all(r["block"]["block"] == 19 and r["block"]["kind"] == "ShardedDeviceDataCache"
               for r in ranks)
    for r in ranks:
        assert len(r["batches"]) == len(r["host"])
        for ours, host in zip(r["batches"], r["host"]):
            for m in host:
                assert torch.equal(ours[m], host[m]), m
    _ranks_agree(ranks)


def test_the_workers_end_cleanly(workers):
    """Every job of both groups ran without an error and left its group."""
    procs = [p for world in workers.WORLDS for p in workers.wait(world)]
    assert all(p.returncode == 0 for p in procs), workers.tail()
    for out in workers.outs.values():
        assert not [f for f in os.listdir(out) if f.endswith(".err")]
