"""The port's model registry, ``AutoConfig`` and ``AutoModel`` against the
JAX package's, on the CPU at a small size: each of the 14 model families
(two modalities of 3 and 4 features, latent 4, default nets; MHVAE on the
MLP test blocks), saved by the port and read back by
``AutoModel.load_from_folder(..., device="cpu")``: the same class, the
same weights, and the same loss from the same draws, exactly (the same
CPU kernels on the same numbers). MoPoE is held by its encode from every
modality instead, within float32 noise: its subsets come back in sorted
order, which moves rows between subsets in its loss, in both packages
(ROADMAP Queue C), and its sums over subsets in another order.
"""

import json
import os

import numpy as np
import pytest
import torch

from multivae_tpu import models as jmodels
from multivae_tpu.models import AutoConfig as JAutoConfig
from multivae_tpu.models import AutoModel as JAutoModel
from multivae_tpu.models.base.base_model import model_registry as jax_registry
from multivae_tpu_torch import models
from multivae_tpu_torch.data import batch_from_arrays
from multivae_tpu_torch.models import AutoConfig, AutoModel
from multivae_tpu_torch.models.base.base_model import get_model_class, model_registry
from multivae_tpu_torch.models.base.step import StepInfo
from torch_parity import mhvae_mlp_blocks

torch.set_num_threads(2)

DIMS = {"a": (3,), "b": (4,)}
BASE = dict(n_modalities=2, latent_dim=4, input_dims=DIMS)
# the families, each with its config's extra fields
FAMILIES = {
    "MMVAE": dict(K=2),
    "MMVAEPlus": dict(K=2, modalities_specific_dim=2),
    "CMVAE": dict(modalities_specific_dim=2, number_of_clusters=3),
    "MVTCAE": {},
    "MVAE": {},
    "MoPoE": {},
    "CRMVAE": {},
    "DMVAE": dict(modalities_specific_dim={"a": 1, "b": 2}),
    "JMVAE": {},
    "TELBO": {},
    "JNF": {},
    "CVAE": None,
    "MHVAE": dict(n_latent=3),
    "Nexus": dict(modalities_specific_dim={"a": 2, "b": 2}, msg_dim=3),
}


def _model(name):
    cls, config_cls = getattr(models, name), getattr(models, name + "Config")
    if name == "CVAE":
        return cls(config_cls(main_modality="a", conditioning_modalities=["b"],
                              input_dims=DIMS, latent_dim=4), device="cpu")
    config = config_cls(**BASE, **FAMILIES[name])
    if name == "MHVAE":
        names = ("encoders", "decoders", "bottom_up_blocks", "top_down_blocks",
                 "posterior_blocks", "prior_blocks")
        return cls(config, **dict(zip(names, mhvae_mlp_blocks(DIMS, 4))), device="cpu")
    return cls(config, device="cpu")


def _loss(model, batch):
    torch.manual_seed(0)
    with torch.no_grad():
        return model.loss_function(batch, StepInfo(epoch=1, dataset_size=8),
                                   generator=torch.Generator().manual_seed(0))["loss"].item()


@pytest.mark.parametrize("name", list(FAMILIES))
def test_every_family_comes_back_through_automodel(tmp_path, name):
    model = _model(name)
    rng = np.random.default_rng(0)
    batch = batch_from_arrays({m: rng.uniform(size=(8, *d)).astype(np.float32)
                               for m, d in DIMS.items()})
    model.save(str(tmp_path))
    reloaded = AutoModel.load_from_folder(str(tmp_path), device="cpu")
    assert type(reloaded) is type(model) and reloaded.device == torch.device("cpu")
    state = reloaded.state_dict()
    assert set(state) == set(model.state_dict())
    for k, v in model.state_dict().items():
        assert torch.equal(state[k], v), k
    if name == "MoPoE":
        assert sorted(map(sorted, reloaded.subsets)) == sorted(map(sorted, model.subsets))
        with torch.no_grad():
            z = model.encode(batch, "all", return_mean=True).z
            np.testing.assert_allclose(
                reloaded.encode(batch, "all", return_mean=True).z.numpy(), z.numpy(),
                rtol=1e-6, atol=1e-7)
    else:
        value = _loss(model, batch)
        assert np.isfinite(value) and _loss(reloaded, batch) == value
    config = AutoConfig.from_json_file(str(tmp_path / "model_config.json"))
    assert type(config) is type(model.model_config)


def test_automodel_defaults_to_cuda(tmp_path, monkeypatch):
    models.MVTCAE(models.MVTCAEConfig(**BASE), device="cpu").save(str(tmp_path))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        AutoModel.load_from_folder(str(tmp_path))


def test_auto_config_reads_a_jax_config(tmp_path):
    """A ``model_config.json`` written by the JAX package loads here as the
    port's config of the same name and fields."""
    jconfig = jmodels.MMVAEConfig(**BASE, K=3)
    jconfig.save_json(str(tmp_path), "model_config")
    config = AutoConfig.from_json_file(str(tmp_path / "model_config.json"))
    assert type(config) is models.MMVAEConfig
    assert config.to_dict() == jconfig.to_dict()


@pytest.mark.parametrize("name", ["NotAModelConfig", "NotAModel"])
def test_unknown_names_raise_name_error_like_jax(tmp_path, name):
    """An unregistered config name, and one without the "Config" suffix:
    NameError from both packages' AutoConfig and AutoModel."""
    with open(tmp_path / "model_config.json", "w") as f:
        json.dump({"name": name}, f)
    for auto_config, auto_model in ((AutoConfig, AutoModel), (JAutoConfig, JAutoModel)):
        with pytest.raises(NameError):
            auto_config.from_json_file(str(tmp_path / "model_config.json"))
        with pytest.raises(NameError) as err:
            auto_model.load_from_folder(str(tmp_path))
        expected = ("Unknown model name" if name.endswith("Config")
                    else "Cannot infer the model class")
        assert str(err.value).startswith(expected)
    with pytest.raises(NameError, match="is unknown"):
        get_model_class("NotAModel")


def test_the_registry_names_every_jax_family():
    """Every model class the JAX package registers (its own modules only)
    is registered here under the same name, as a port model."""
    jax_names = {name for name, cls in jax_registry().items()
                 if cls.__module__.startswith("multivae_tpu.")}
    ours = model_registry()
    assert set(FAMILIES) <= jax_names <= set(ours)
    for name in jax_names:
        assert ours[name].__module__.startswith("multivae_tpu_torch."), name
        assert os.path.basename(ours[name].__module__.replace(".", "/")) == os.path.basename(
            jax_registry()[name].__module__.replace(".", "/")), name
