"""The port's measurement tools on the CPU: the step profiler's kernel
classes and device-time sums (fed stand-in profiler events), and the
full-width workloads' shapes (built at a small depth)."""

import types

import numpy as np
import pytest
import torch

from multivae_tpu_torch.nn import mmnist
from multivae_tpu_torch.ops.flows import MAF
from multivae_tpu_torch.tools import profile_mmvae, workloads
from multivae_tpu_torch.trainers import MultistageTrainer

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU


@pytest.mark.parametrize("name,label", [
    ("mixture_kernel<true, 5, 4, 0, false>", "mixture"),
    ("void cudnn::detail::dgrad_engine<float, 512, 6, 5, 3, 3, 3, false>", "conv"),
    ("sm80_xmma_fprop_implicit_gemm_f32f32_f32f32_f32_nchwkcrs_nchw", "conv"),
    ("sm80_xmma_wgrad_implicit_gemm_indexed_f32f32_f32f32_f32_nhwckrsc", "conv"),
    ("void implicit_convolve_sgemm<float, float, 1024, 5, 5, 3, 3, 3, 1>", "conv"),
    ("sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize32x32x8_stage3", "matmul"),
    ("void cutlass::Kernel2<cutlass_80_simt_sgemm_128x64_8x5_nn_align1>", "matmul"),
    ("void at::native::multi_tensor_apply_kernel<TensorListMetadata<4>>", "optimizer"),
    ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float>>", "reduction"),
    ("void at::native::vectorized_elementwise_kernel<4, CUDAFunctor_add<float>>",
     "elementwise/other"),
])
def test_kernel_classes(name, label):
    assert profile_mmvae._kernel_class(name) == label


def test_device_times_leave_out_annotations_and_host_events():
    def evt(name, device_type, us, annotation=False):
        return types.SimpleNamespace(name=name, device_type=device_type,
                                     device_time_total=us,
                                     is_user_annotation=annotation)

    events = [evt("Optimizer.step#Adam.step", CUDA, 2000.0, annotation=True),
              evt("multi_tensor_apply_kernel", CUDA, 100.0),
              evt("multi_tensor_apply_kernel", CUDA, 20.0),
              evt("aten::add", CPU, 0.0),
              evt("Memcpy HtoD (Pageable -> Device)", CUDA, 50.0)]
    by_kernel, launches = profile_mmvae.device_times(events)
    assert by_kernel == {"multi_tensor_apply_kernel": 120.0,
                         "Memcpy HtoD (Pageable -> Device)": 50.0}
    assert launches["multi_tensor_apply_kernel"] == 2


def _check_small_published_workload(name, w):
    """DMVAE's MNIST-SVHN run and the CVAE tutorial: their own shapes, no
    eval set."""
    model = w.model
    assert w.eval is None and w.trainer_cls is None
    assert w.trainer_kwargs["learning_rate"] == 1e-3
    if name == "dmvae_mnist_svhn":
        assert {k: tuple(v) for k, v in model.input_dims.items()} == {
            "mnist": (1, 28, 28), "svhn": (3, 32, 32)}
        assert (model.latent_dim, model.style_dims) == (10, {"mnist": 1, "svhn": 4})
        assert model.rescale_factors == {"mnist": 50, "svhn": 1}
        assert model.decoders["svhn"].latent_dim == 14
        assert model.encoders["mnist"].dense[0].out_features == 512
        assert w.trainer_kwargs["per_device_train_batch_size"] == 256
        return
    assert (model.main_modality, model.conditioning_modalities) == ("target",
                                                                    ["cond_a", "cond_b"])
    assert model.latent_dim == 8 and model.prior_network is not None
    assert model.decoder.network.dense[0].in_features == 8 + 6 + 16
    assert w.trainer_kwargs["per_device_train_batch_size"] == 64
    assert model.model_config.custom_architectures == ["prior_network"]


def _check_hierarchical_workload(name, w):
    """MHVAE at the PolyMNIST example's widths and the repo's Nexus: their
    own shapes, no eval set, a finite loss on 2 rows."""
    model = w.model
    assert w.eval is None and w.trainer_cls is None
    if name == "mhvae_polymnist":
        assert {k: tuple(v) for k, v in model.input_dims.items()} == {
            f"m{i}": (3, 28, 28) for i in range(5)}
        assert (model.n_latent, model.beta, model.latent_dim) == (3, 1.0, 64)
        assert model.share_posterior_weights and len(model.subsets) == 31
        assert model.model_config.decoder_dist_params["m0"] == {"scale": 0.75}
        assert model.bottom_up_blocks["m0"][1].dense[0].in_features == 4 * 4 * 128
        assert model.top_down_blocks[1].dense[1].out_features == 7 * 7 * 64
        assert model.posterior_blocks[0].conv[0].in_channels == 64
        assert model.posterior_blocks[1].conv[0].in_channels == 128
        assert w.trainer_kwargs["per_device_train_batch_size"] == 128
        assert w.trainer_kwargs["learning_rate"] == 1e-3
        with torch.no_grad():
            enc = model.encode(w.train.get_batch(np.arange(2)), N=3)
        assert {k: tuple(v.shape) for k, v in enc.all_z.items()} == {
            "z_3": (3, 2, 64), "z_2": (3, 2, 64, 7, 7), "z_1": (3, 2, 32, 14, 14)}
    else:
        cfg = model.model_config
        assert {k: tuple(v) for k, v in model.input_dims.items()} == {"a": (8,), "b": (12,)}
        assert (model.latent_dim, cfg.msg_dim, cfg.warmup, cfg.dropout_rate) == (8, 8, 5, 0.5)
        assert cfg.modalities_specific_dim == {"a": 8, "b": 8}
        assert (cfg.top_beta, model.bottom_betas, model.gammas) == (
            0.1, {"a": 0.1, "b": 0.1}, {"a": 10.0, "b": 10.0})
        assert cfg.decoder_dist_params["a"] == {"scale": 0.05}
        assert model.start_keep_best_epoch == 6
        assert w.trainer_kwargs["per_device_train_batch_size"] == 100
        assert w.trainer_kwargs["learning_rate"] == 2e-3
        # the synthetic classes: the features stay near their centres
        assert 0.0 < w.train.data["a"].min() and w.train.data["b"].max() < 1.0
    with torch.no_grad():
        loss = model(w.train.get_batch(np.arange(2))).loss
    assert torch.isfinite(loss)


@pytest.mark.parametrize("name", workloads.NAMES)
def test_workloads_have_the_published_widths(name):
    w = workloads.build(name, n=8, n_eval=4, device="cpu")
    model = w.model
    if name in ("dmvae_mnist_svhn", "cvae_tutorial"):
        _check_small_published_workload(name, w)
        return
    if name in ("mhvae_polymnist", "nexus_e2e"):
        _check_hierarchical_workload(name, w)
        return
    assert (w.trainer_cls is MultistageTrainer) == (name in ("telbo_conv", "jnf_conv"))
    plus = name.startswith("mmvaeplus")
    small = name.startswith(("mmvaeplus", "cmvae"))
    assert model.latent_dim == (32 if small else 512)
    assert w.trainer_kwargs["per_device_train_batch_size"] == (32 if small else 256)
    assert w.trainer_kwargs["learning_rate"] == (5e-4 if name == "crmvae_resnet" else 1e-3)
    dims = {k: tuple(v) for k, v in model.input_dims.items()}
    if name == "mvtcae_mlp":
        assert dims == {"m0": (1, 28, 28), "m1": (3, 32, 32)}
        assert set(model.model_config.decoders_dist.values()) == {"bernoulli"}
        assert (model.alpha, model.beta) == (0.1, 2.5) and w.eval is None
        return
    assert dims == {f"m{i}": (3, 28, 28) for i in range(5)}
    if name == "mmvae":
        assert model.K == 10 and w.eval is None
        return
    assert model.model_config.decoder_dist_params["m0"] == {"scale": 0.75}
    if name == "cmvae_polymnist":
        cfg = model.model_config
        assert (model.modalities_specific_dim, model.beta, model.n_clusters) == (32, 2.5, 40)
        assert (model.K, model.objective, cfg.learn_modality_prior) == (1, "iwae_looser", True)
        assert isinstance(model.encoders["m0"], mmnist.EncoderResnetMMNIST)
        assert model.decoders["m0"].dense[0].in_features == 64
        assert w.trainer_kwargs["optimizer_params"] == {"amsgrad": True}
        assert w.eval is None and not hasattr(w.train, "masks")
        return
    assert len(w.eval) == 4
    if name == "crmvae_resnet":
        assert (model.beta, model.use_likelihood_rescaling) == (0.1, False)
        assert model.encoders["m0"].style_dim == 0
        assert model.decoders["m0"].dense[0].in_features == 512
        assert model.encoders["m0"].dense[0].in_features == 256 * 7 * 7   # nf 64, 2 doublings
        assert w.trainer_kwargs["drop_last"] and "scheduler_cls" not in w.trainer_kwargs
        assert not hasattr(w.train, "masks")
        return
    if plus:
        cfg = model.model_config
        assert (model.modalities_specific_dim, model.beta) == (32, 2.5)
        assert isinstance(model.encoders["m0"], mmnist.EncoderResnetMMNIST)
        assert model.decoders["m0"].dense[0].in_features == 64
        assert model.decoders["m0"].blocks[-1].conv[0].in_channels == 64   # nf
        assert (cfg.learn_modality_prior, cfg.learn_shared_prior) == (True, False)
        if name.startswith("mmvaeplus_k10"):
            # the microbatched run trades remat for 2 chunks a step
            micro = name == "mmvaeplus_k10_micro"
            assert (model.K, model.objective, cfg.use_remat) == (10, "iwae_looser", not micro)
            assert w.trainer_kwargs["optimizer_params"] == {"amsgrad": True}
            assert w.trainer_kwargs.get("microbatch_steps", 1) == (2 if micro else 1)
            assert not hasattr(w.train, "masks")
        else:
            assert (model.K, model.objective) == (1, "dreg_looser")
            assert hasattr(w.train, "masks") and hasattr(w.eval, "masks")
        return
    assert isinstance(model.decoders["m0"], mmnist.DecoderConvMMNIST)
    if name == "mmvae_conv":
        assert (model.K, model.learn_prior, model.objective) == (10, False, "dreg_looser")
    elif name == "mvae_conv":
        # --missing_ratio 0: sub-sampling on complete data, 1 + 5 subset ELBOs
        assert (model.subsampling, model.k, model.warmup, model.beta) == (True, 0, 0, 2.5)
        assert not hasattr(w.train, "masks")
    elif name == "mopoe_conv":
        assert model.beta == 2.5 and len(model.subsets) == 31
        assert w.trainer_kwargs["drop_last"] and hasattr(w.train, "masks")
    elif name in ("jmvae_conv", "telbo_conv", "jnf_conv"):
        # complete data; the joint encoder fuses copies of the 5 conv encoders
        assert not hasattr(w.train, "masks")
        assert isinstance(model.joint_encoder.dict_encoders["m0"],
                          mmnist.EncoderConvMMNIST_adapted)
        assert model.joint_encoder.dense[0].in_features == 5 * 512
        assert model.model_config.custom_architectures == ["encoders", "decoders"]
        if name == "jmvae_conv":
            assert (model.alpha, model.warmup, model.start_keep_best_epoch) == (0.1, 200, 201)
        elif name == "jnf_conv":
            # the optimizer reset and the stage flip at epoch 2; default MAF
            # flows over the 512 latents; no eval set unless one is asked for
            assert (model.warmup, model.reset_optimizer_epochs) == (1, [2])
            flow = model.flows["m0"]
            assert isinstance(flow, MAF) and flow.input_dim == 512
            assert len(flow.blocks) == 2 and len(flow.blocks[0].hidden) == 3
            assert flow.blocks[0].hidden[1].in_features == 128
            assert workloads.build(name, n=8, device="cpu").eval is None
        else:
            assert (model.warmup, model.reset_optimizer_epochs) == (2, [2])
    else:
        assert (model.alpha, model.beta) == (5.0 / 6.0, 2.5)
    assert w.trainer_kwargs["scheduler_cls"] == "ReduceLROnPlateau"
    assert w.trainer_kwargs["scheduler_params"] == {"patience": 30}
    assert not hasattr(w.eval, "masks")


def test_conv_workload_is_incomplete_with_dead_rows():
    w = workloads.build("mvtcae_conv", n=1024, n_eval=0, device="cpu")
    avail = np.stack([w.train.masks[m] for m in w.train.data])    # (M, n)
    dead = workloads.dead_rows(1024)
    assert 5 in dead and not avail[:, dead].any()
    assert 0.15 < 1 - avail.mean() < 0.25
    for m, mask in w.train.masks.items():
        assert (w.train.data[m][~mask] == 0).all()
    # the conv nets were seeded: two builds give the same weights
    again = workloads.build("mvtcae_conv", n=8, n_eval=0, device="cpu")
    for (k, p), q in zip(w.model.state_dict().items(), again.model.state_dict().values()):
        assert torch.equal(p, q), k


def test_moe_workloads_share_the_partial_protocol():
    """mmvae_conv trains on mvtcae_conv's incomplete data and nets (same
    seeded weights); mmvaeplus_partial's eval split is cut from its own
    incomplete rows."""
    conv = workloads.build("mvtcae_conv", n=64, n_eval=8, device="cpu")
    moe = workloads.build("mmvae_conv", n=64, n_eval=8, device="cpu")
    for m in conv.train.data:
        assert np.array_equal(conv.train.data[m], moe.train.data[m])
        assert np.array_equal(conv.train.masks[m], moe.train.masks[m])
    for k, v in conv.model.encoders.state_dict().items():
        assert torch.equal(moe.model.encoders.state_dict()[k], v), k
    plus = workloads.build("mmvaeplus_partial", n=1024, device="cpu")
    assert (len(plus.train), len(plus.eval)) == (1024, 102)
    avail = np.stack([plus.train.masks[m] for m in plus.train.data])
    assert 0.15 < 1 - avail.mean() < 0.25 and not avail[:, 5].any()
