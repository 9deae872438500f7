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
- the CUB nets (``nn/cub.py``): a ``PreActResnetBlock_i`` maps as a
  ``ResnetBlock_i`` (``.blocks.<i>``, its convs ``.conv.<j>``, the heads of
  the resnet encoder permuted as above); ``Embed_0``'s table becomes
  ``.embed.weight``; a ``TransformerEncoderLayer_i`` becomes
  ``.layers.<i>``, its ``LayerNorm_j`` (``scale``, ``bias``) ``.norm.<j>``,
  its ``Dense_j`` ``.dense.<j>``, and its attention's per-head projections
  ``query``, ``key`` and ``value`` (kernel (in, heads, head_dim), bias
  (heads, head_dim)) and ``out`` (kernel (heads, head_dim, out)) become
  Linear layers over the heads laid side by side;
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
                "ResnetBlock": "blocks", "PreActResnetBlock": "blocks",
                "TransformerEncoderLayer": "layers"}
_BLOCKS = ("ResnetBlock", "PreActResnetBlock")


def _is_layer(name: str) -> bool:
    kind, _, idx = name.rpartition("_")
    return kind in _LAYER_LISTS and idx.isdigit()


def _layer_key(name: str):
    if not _is_layer(name):
        raise KeyError(f"Unsupported Flax layer {name!r}: only Embed_0, Dense_i, "
                       "Conv_i, ConvTranspose_i, (PreAct)ResnetBlock_i and "
                       "TransformerEncoderLayer_i are mapped.")
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
    blocks = sorted((i, kind) for kind, i in keys.values() if kind in _BLOCKS)
    if blocks:
        i, kind = blocks[-1]
        last = layers[f"{kind}_{i}"]["Conv_1"]["kernel"]
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


def _linear(kernel, bias) -> Dict[str, torch.Tensor]:
    """A Flax kernel (in, out) and bias (out,) as a Linear's weight and bias."""
    return {"weight": torch.tensor(np.asarray(kernel).T.copy()),
            "bias": torch.tensor(np.asarray(bias))}


def merge_jax_axes(leaf, groups) -> np.ndarray:
    """A JAX leaf in a torch parameter's layout: ``groups`` holds, for each
    torch axis, the JAX axes merged into it, in order."""
    leaf = np.asarray(leaf)
    order = [j for group in groups for j in group]
    return np.ascontiguousarray(leaf.transpose(order)).reshape(
        [math.prod(leaf.shape[j] for j in group) for group in groups])


def _transformer_state(prefix: str, layer: dict) -> Dict[str, torch.Tensor]:
    """One ``TransformerEncoderLayer_i`` of the CUB text encoder: its
    attention's leaves by the layer's ``JAX_LAYOUT``."""
    from ..nn.cub import TransformerEncoderLayer

    attn = layer["MultiHeadDotProductAttention_0"]
    state = {}
    for name in ("query", "key", "value", "out"):
        for k, jax_name in (("weight", "kernel"), ("bias", "bias")):
            leaf = np.asarray(attn[name][jax_name])
            # a leaf the layout leaves out is a Dense one: its axes reversed
            _, groups = TransformerEncoderLayer.JAX_LAYOUT.get(
                f"{name}.{k}", (None, tuple((j,) for j in reversed(range(leaf.ndim)))))
            state[f"{prefix}.{name}.{k}"] = torch.tensor(merge_jax_axes(leaf, groups))
    for j in range(2):
        state.update({f"{prefix}.dense.{j}.{k}": v for k, v in _linear(
            layer[f"Dense_{j}"]["kernel"], layer[f"Dense_{j}"]["bias"]).items()})
    for j in range(2):
        norm = layer[f"LayerNorm_{j}"]
        state[f"{prefix}.norm.{j}.weight"] = torch.tensor(np.asarray(norm["scale"]))
        state[f"{prefix}.norm.{j}.bias"] = torch.tensor(np.asarray(norm["bias"]))
    return state


def _net_state(prefix: str, layers: dict, encoder: bool) -> Dict[str, torch.Tensor]:
    state, own = {}, {}
    for name, leaf in layers.items():
        sub = _submodule(name)
        if name == "Embed_0":
            state[f"{prefix}.embed.weight"] = torch.tensor(np.asarray(leaf["embedding"]))
        elif sub is None:
            own[name] = leaf
        else:
            state.update(_net_state(f"{prefix}.{sub[0]}", leaf, encoder=sub[1]))
    layers = own
    keys = {name: _layer_key(name) for name in layers}
    flat = _flat_map_channels(layers, keys) if encoder else {}
    for name, leaf in layers.items():
        kind, i = keys[name]
        key = f"{prefix}.{_LAYER_LISTS[kind]}.{i}"
        if kind in _BLOCKS:
            state.update(_net_state(key, leaf, encoder=False))
            continue
        if kind == "TransformerEncoderLayer":
            state.update(_transformer_state(key, leaf))
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
