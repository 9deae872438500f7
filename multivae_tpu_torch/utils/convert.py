"""Weight transfer from the JAX package's parameter tree.

``params_from_jax`` maps the nested dict ``jax.tree.map(np.asarray,
model.params)`` of a ``multivae_tpu`` model to a ``state_dict`` of the
port's model of the same class and config. The port's nets keep their
layers in the ModuleLists ``dense``, ``conv``, ``deconv`` and ``blocks``
in the order Flax creates them, so ``<group>/<m>/Dense_i``, ``Conv_i``,
``ConvTranspose_i`` and ``ResnetBlock_i`` become ``<group>.<m>.dense.<i>``,
``.conv.<i>``, ``.deconv.<i>`` and ``.blocks.<i>`` (group: ``encoders`` or
``decoders``), and a ``ResnetBlock_i``'s own ``Conv_j`` becomes
``.blocks.<i>.conv.<j>``:

- a Dense kernel (in, out) becomes a Linear weight (out, in);
- a Conv kernel (kh, kw, in, out) becomes a Conv2d weight (out, in, kh,
  kw). Flax's Conv and torch's conv2d both cross-correlate: no flip;
- a ConvTranspose kernel (kh, kw, in, out) becomes a ConvTranspose2d
  weight (in, out, kh, kw) flipped in both spatial axes: Flax's transposed
  conv cross-correlates the dilated input with the kernel as stored, torch's
  with the kernel flipped (the padding side is the net's business, see
  ``nn/mmnist.DecoderConvMMNIST``);
- in an encoder whose Dense layers read a flattened conv map, Flax
  flattened an NHWC map in (h, w, c) order and torch flattens NCHW in (c,
  h, w) order, so those layers' input rows are permuted to match (the map
  is square). With top-level convs only (``EncoderConvMMNIST``) that is
  ``Dense_0``, after the last conv; in an encoder built of
  ``ResnetBlock_i`` (``EncoderResnetMMNIST``) every Dense is a head on a
  flattened branch, whose channels are those of the last block. A decoder
  reshapes its Dense output channels-first, as the port's does: no
  permutation there;
- ``model/<name>`` (e.g. ``prior_log_var``) becomes the top-level
  parameter ``<name>``;
- a single net's group (``joint_encoder``; CVAE's ``encoder``,
  ``decoder`` and ``prior_network``) maps as one net: ``<group>/Dense_i``
  becomes ``<group>.dense.<i>``. Inside it, a joint encoder's copies of the
  unimodal encoders, ``dict_encoders_<m>``, become ``.dict_encoders.<m>``
  and take the encoder rules (the row permutation above), and a
  conditional decoder's ``Decoder_AE_MLP_0`` becomes ``.network``;
- Nexus's ``top_encoders/<m>`` and ``top_decoders/<m>`` map like
  ``encoders`` and ``decoders``;
- MHVAE's blocks: ``bottom_up/<m>/<i>`` becomes ``bottom_up_blocks.<m>.<i>``,
  ``top_down/<i>`` and ``prior/<i>`` become ``top_down_blocks.<i>`` and
  ``prior_blocks.<i>``, and ``posterior/<i>`` becomes
  ``posterior_blocks.<i>`` (shared) or, holding a net per modality,
  ``posterior/<i>/<m>`` becomes ``posterior_blocks.<m>.<i>``. Each block
  maps as a decoder (no row permutation): the port's MHVAE nets flatten and
  unflatten their maps in Flax's (h, w, c) order themselves
  (``tools/mhvae_nets.py``);
- a flow (``flows/<m>``, JNF's; or one of a sampler's ``flow_params``,
  through ``flow_from_jax``): ``blocks_<i>/{hidden_<j>,mu,alpha}`` becomes
  ``.blocks.<i>.{hidden.<j>,mu,alpha}``, kernels transposed like a Dense's.
  The MADE masks are buffers built from the flow's shape, not weights.

Two evaluation nets have maps of their own:

- ``classifier_from_jax``: the JAX package's PolyMNIST classifier
  (``conv1``, ``conv2``, ``fc1``, ``fc2``) becomes the port's
  ``encoder.0``, ``.3``, ``.7`` and ``.10``. Its Flax model transposes the
  conv map to NCHW before flattening, so ``fc1`` needs no row permutation;
- ``inception_from_jax``: the Flax InceptionV3's ``{"params",
  "batch_stats"}`` become pytorch-fid's names: ``<path>/conv/kernel``
  becomes ``<path>.conv.weight``, ``<path>/bn/{scale,bias}`` and
  ``batch_stats`` ``<path>/bn/{mean,var}`` become ``<path>.bn.{weight,
  bias,running_mean,running_var}`` (``num_batches_tracked`` 0).

Only numpy goes in; the JAX side of the conversion is the caller's.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

# modality -> net, and whether it is an encoder
_NET_GROUPS = {"encoders": True, "decoders": False, "top_encoders": True,
               "top_decoders": False}
_BLOCK_LISTS = {"top_down": "top_down_blocks", "prior": "prior_blocks"}
_SINGLE_NETS = ("joint_encoder", "encoder", "decoder", "prior_network")
_MADE_LAYERS = ("mu", "alpha")
_LAYER_LISTS = {"Dense": "dense", "Conv": "conv", "ConvTranspose": "deconv",
                "ResnetBlock": "blocks"}


def _is_layer(name: str) -> bool:
    kind, _, idx = name.rpartition("_")
    return kind in _LAYER_LISTS and idx.isdigit()


def _layer_key(name: str):
    if not _is_layer(name):
        raise KeyError(f"Unsupported Flax layer {name!r}: only Dense_i, Conv_i, "
                       "ConvTranspose_i and ResnetBlock_i are mapped.")
    kind, _, idx = name.rpartition("_")
    return kind, int(idx)


def _hwc_rows_to_chw(kernel: np.ndarray, channels: int) -> np.ndarray:
    """Permute a Dense kernel's input rows from (h, w, c) to (c, h, w)."""
    side = math.isqrt(kernel.shape[0] // channels)
    if side * side * channels != kernel.shape[0]:
        raise ValueError(f"Dense input {kernel.shape[0]} is not a square "
                         f"map of {channels} channels")
    return (kernel.reshape(side, side, channels, -1).transpose(2, 0, 1, 3)
            .reshape(kernel.shape))


def _flat_map_channels(layers: dict, keys: dict) -> Dict[int, int]:
    """Encoder: Dense index -> channels of the flattened map it reads."""
    blocks = sorted(i for kind, i in keys.values() if kind == "ResnetBlock")
    if blocks:
        last = layers[f"ResnetBlock_{blocks[-1]}"]["Conv_1"]["kernel"]
        return {i: np.shape(last)[-1] for kind, i in keys.values() if kind == "Dense"}
    convs = sorted(i for kind, i in keys.values() if kind == "Conv")
    if convs and "Dense_0" in layers:
        return {0: np.shape(layers[f"Conv_{convs[-1]}"]["kernel"])[-1]}
    return {}


def _submodule(name: str):
    """(torch attribute path, encoder?) of a nested Flax module, or None."""
    if name.startswith("dict_encoders_"):
        return f"dict_encoders.{name[len('dict_encoders_'):]}", True
    if name == "Decoder_AE_MLP_0":
        return "network", False
    return None


def _net_state(prefix: str, layers: dict, encoder: bool) -> Dict[str, torch.Tensor]:
    state, own = {}, {}
    for name, leaf in layers.items():
        sub = _submodule(name)
        if sub is None:
            own[name] = leaf
        else:
            state.update(_net_state(f"{prefix}.{sub[0]}", leaf, encoder=sub[1]))
    layers = own
    keys = {name: _layer_key(name) for name in layers}
    flat = _flat_map_channels(layers, keys) if encoder else {}
    for name, leaf in layers.items():
        kind, i = keys[name]
        key = f"{prefix}.{_LAYER_LISTS[kind]}.{i}"
        if kind == "ResnetBlock":
            state.update(_net_state(key, leaf, encoder=False))
            continue
        kernel = np.asarray(leaf["kernel"])
        if kind == "Dense":
            if i in flat:
                kernel = _hwc_rows_to_chw(kernel, flat[i])
            weight = kernel.T
        elif kind == "Conv":
            weight = kernel.transpose(3, 2, 0, 1)
        else:
            weight = kernel[::-1, ::-1].transpose(2, 3, 0, 1)
        state[key + ".weight"] = torch.tensor(weight.copy())
        if "bias" in leaf:
            state[key + ".bias"] = torch.tensor(np.asarray(leaf["bias"]))
    return state


def flow_from_jax(params: dict) -> Dict[str, torch.Tensor]:
    """One flow's numpy parameter tree (``{"params": ...}`` as ``init``
    returns it, or its content) -> the ``state_dict`` of the port's MAF or
    IAF."""
    params = params.get("params", params)
    state = {}
    for block, layers in params.items():
        kind, _, i = block.rpartition("_")
        if kind != "blocks" or not i.isdigit():
            raise KeyError(f"Unsupported flow module {block!r}")
        for name, leaf in layers.items():
            kind, _, j = name.rpartition("_")
            if name in _MADE_LAYERS:
                key = f"blocks.{i}.{name}"
            elif kind == "hidden" and j.isdigit():
                key = f"blocks.{i}.hidden.{j}"
            else:
                raise KeyError(f"Unsupported MADE layer {name!r}")
            state[key + ".weight"] = torch.tensor(np.asarray(leaf["kernel"]).T.copy())
            state[key + ".bias"] = torch.tensor(np.asarray(leaf["bias"]))
    return state


def params_from_jax(params: dict) -> Dict[str, torch.Tensor]:
    """Nested numpy parameter tree -> torch ``state_dict``."""
    unknown = (set(params) - set(_NET_GROUPS) - set(_SINGLE_NETS) - set(_BLOCK_LISTS)
               - {"model", "flows", "bottom_up", "posterior"})
    if unknown:
        raise KeyError(f"Unsupported parameter groups: {sorted(unknown)}")
    state = {}
    for group, encoder in _NET_GROUPS.items():
        for mod, layers in params.get(group, {}).items():
            state.update(_net_state(f"{group}.{mod}", layers, encoder=encoder))
    for mod, blocks in params.get("bottom_up", {}).items():
        for i, layers in blocks.items():
            state.update(_net_state(f"bottom_up_blocks.{mod}.{i}", layers, encoder=False))
    for group, attr in _BLOCK_LISTS.items():
        for i, layers in params.get(group, {}).items():
            state.update(_net_state(f"{attr}.{i}", layers, encoder=False))
    for i, layers in params.get("posterior", {}).items():
        if all(_is_layer(k) for k in layers):
            state.update(_net_state(f"posterior_blocks.{i}", layers, encoder=False))
        else:
            for mod, mod_layers in layers.items():
                state.update(_net_state(f"posterior_blocks.{mod}.{i}", mod_layers,
                                        encoder=False))
    for group in _SINGLE_NETS:
        if group in params:
            state.update(_net_state(group, params[group], encoder=group != "decoder"))
    for mod, flow in params.get("flows", {}).items():
        state.update({f"flows.{mod}.{k}": v for k, v in flow_from_jax(flow).items()})
    for name, leaf in params.get("model", {}).items():
        state[name] = torch.tensor(np.asarray(leaf))
    return state


def _conv_weight(kernel) -> torch.Tensor:
    """Flax HWIO conv kernel -> torch OIHW weight."""
    return torch.tensor(np.asarray(kernel).transpose(3, 2, 0, 1).copy())


def classifier_from_jax(params: dict) -> Dict[str, torch.Tensor]:
    """The JAX package's ``ClassifierPolyMNIST`` parameters (``{"params":
    ...}`` or their content) -> the port's ``state_dict``."""
    params = params.get("params", params)
    state = {}
    for name, index in (("conv1", 0), ("conv2", 3), ("fc1", 7), ("fc2", 10)):
        kernel = params[name]["kernel"]
        state[f"encoder.{index}.weight"] = (
            _conv_weight(kernel) if name.startswith("conv")
            else torch.tensor(np.asarray(kernel).T.copy()))
        state[f"encoder.{index}.bias"] = torch.tensor(np.asarray(params[name]["bias"]))
    return state


def inception_from_jax(variables: dict) -> Dict[str, torch.Tensor]:
    """The JAX package's ``InceptionV3FID`` variables ``{"params": ...,
    "batch_stats": ...}`` -> the port's (pytorch-fid's) ``state_dict``."""
    state = {}

    def walk(tree, path, leaf_map):
        for name, node in tree.items():
            if isinstance(node, dict):
                walk(node, path + [name], leaf_map)
            else:
                key = ".".join(path) + "." + leaf_map[name]
                state[key] = (_conv_weight(node) if name == "kernel"
                              else torch.tensor(np.asarray(node)))

    walk(variables["params"], [], {"kernel": "weight", "scale": "weight", "bias": "bias"})
    walk(variables["batch_stats"], [], {"mean": "running_mean", "var": "running_var"})
    for key in [k for k in state if k.endswith(".bn.running_mean")]:
        state[key.replace("running_mean", "num_batches_tracked")] = torch.tensor(0)
    return state
