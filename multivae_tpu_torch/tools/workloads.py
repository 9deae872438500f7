"""The full-width training configurations the port runs on the card, with
random data in the real datasets' shapes, made from a seed.

- ``mmvae``: the repo's full-width MMVAE (``bench.py:299-318``): 5
  modalities of 3x28x28, latent 512, K=10, default MLP nets, Laplace
  decoders, ``laplace_with_softmax`` posteriors, DReG.
- ``mvtcae_mlp``: ``bench.py``'s ``bench_jax`` (``bench.py:24-26, 68-76``):
  ``m0`` (1,28,28) and ``m1`` (3,32,32), default MLP-512 nets, Bernoulli
  decoders, latent 512, alpha 0.1, beta 2.5.
- ``mvtcae_conv``: the partial-PolyMNIST protocol (``bench.py:375-388``,
  ``examples/case_studies/partial_polymnist/global_config.py:55-84``): 5
  modalities of 3x28x28, ``EncoderConvMMNIST_adapted`` /
  ``DecoderConvMMNIST``, latent 512, Laplace decoders of scale 0.75, beta
  2.5, alpha 5/6, ReduceLROnPlateau(patience=30) on an eval set.
- ``mmvae_conv``: MMVAE on the same protocol
  (``examples/case_studies/partial_polymnist/mmvae.py``): the same nets and
  decoders, latent 512, K=10, ``laplace_with_softmax`` posteriors, a fixed
  prior (``learn_prior=False``), DReG.
- ``mmvaeplus_partial``: MMVAE+ on partial PolyMNIST
  (``examples/case_studies/mmvae_plus_partial/train.py:68-134``):
  ``EncoderResnetMMNIST`` / ``DecoderResnetMMNIST`` at their paper widths
  (nf 64), latent 32 plus private 32, Laplace decoders of scale 0.75, K=1,
  beta 2.5, learned modality priors, a fixed shared prior, ``joint_prior``,
  DReG; batch 32, ReduceLROnPlateau(patience=30) on a 10% eval split.
- ``mmvaeplus_k10``: the paper's MMVAE+ run (``examples/mmvae_plus_polymnist.py:39-91``
  with ``--K 10``): the same model with K=10, ``iwae_looser`` and
  ``use_remat``, batch 32, Adam with ``amsgrad=True``, on complete data
  with a 10% eval split.
- ``mmvaeplus_k10_micro``: the same run with ``use_remat`` off and each
  step's gradient accumulated over two 16-row chunks
  (``microbatch_steps=2``), the JAX package's alternative to remat
  (``multivae_tpu/trainers/base/base_trainer_config.py:68-79``).

- ``cmvae_polymnist``: the paper's CMVAE run (``examples/cmvae_polymnist.py:42-79``):
  the resnet nets, latent 32 plus private 32, 40 clusters, K=1,
  ``iwae_looser``, beta 2.5, learned modality priors, Laplace decoders of
  scale 0.75; batch 32, Adam with ``amsgrad=True``, complete data, no eval
  set.
- ``mvae_conv``: MVAE on the partial-PolyMNIST conv protocol
  (``examples/case_studies/partial_polymnist/mvae.py`` with
  ``--missing_ratio 0``): ``use_subsampling``, k 0, no warm-up, beta 2.5 on
  complete data (6 subset ELBOs a step).
- ``mopoe_conv``: MoPoE on that protocol (``.../mopoe.py``, 20% missing and
  kept): beta 2.5, a subset drawn per row, ``drop_last``.
- ``crmvae_resnet``: CRMVAE on Translated PolyMNIST
  (``examples/crmvae_translated_polymnist.py:37-75``; the data here are
  random in the 3x28x28 shape): the resnet nets without private branch,
  latent 512, beta 0.1, Laplace decoders of scale 0.75, no likelihood
  rescaling; Adam 5e-4, ``drop_last``, a 15% eval split.

- ``dmvae_mnist_svhn``: DMVAE's published MNIST-SVHN run
  (``examples/dmvae_mnist_svhn.py:33-57``): MNIST 1x28x28 and SVHN
  3x32x32, shared latent 10, private dims {mnist 1, svhn 4}, likelihood
  rescaling {mnist 50, svhn 1}, the default multi-latent MLP nets, Normal
  decoders; complete data, no eval set.
- ``jmvae_conv``: JMVAE on the partial-PolyMNIST conv protocol
  (``examples/case_studies/partial_polymnist/jmvae.py``): alpha 0.1,
  warm-up 200, the conv nets with the default joint encoder over copies of
  them; complete data (JMVAE refuses masks).
- ``telbo_conv``: TELBO on the same protocol and nets (the repo has no
  published TELBO run: the case study's base config), trained by the
  ``MultistageTrainer`` with warm-up 2 instead of the config's 10, so that
  a 3-epoch run crosses the optimizer reset and the stage flip.
- ``jnf_conv``: JNF on the same protocol and nets
  (``examples/case_studies/partial_polymnist/jnf.py``): the default joint
  encoder over copies of the conv encoders and the default MAF flows (2
  MADE blocks of 3 hidden layers of 128), trained by the
  ``MultistageTrainer`` on complete data (JNF refuses masks) with no eval
  set, as the script passes none; warm-up 1 instead of the script's
  ``num_epochs // 2``, so that a 3-epoch run resets the optimizer and flips
  to stage 2 at epoch 2.
- ``cvae_tutorial``: the repo's only CVAE configuration
  (``examples/tutorials/training_a_cvae_model.py:24-54``): a target of 12
  conditioned on 6 and 1x4x4, latent 8, the default nets and a
  ``MultipleHeadJointEncoder`` prior network; batch 64, no eval set.
- ``mhvae_polymnist``: the MHVAE PolyMNIST example
  (``examples/mhvae_polymnist.py:102-131``): 5 modalities of 3x28x28, 3
  latent levels (z_3 a vector of 64, z_2 a 64x7x7 map, z_1 a 32x14x14
  map) on the example's nets (``tools/mhvae_nets.py``) with shared
  posterior heads, Laplace decoders of scale 0.75, beta 1; batch 128,
  complete data, no eval set.
- ``nexus_e2e``: the one Nexus configuration the repo trains
  (``tests/test_end_to_end_learning.py:244-253``): features ``a`` (8) and
  ``b`` (12), top latent 8, bottom codes of 8, messages of 8, warm-up 5,
  dropout rate 0.5, top beta 0.1, bottom betas 0.1, gammas 10, Normal
  decoders of scale 0.05, the default MLP nets; batch 100 at lr 2e-3 as
  that test trains it, on its synthetic data (3 classes: fixed centres in
  [0.1, 0.9] plus noise of 0.03).

``mvtcae_cub`` (``cub_workload``) trains on ``CUB`` datasets, read from
files: the CUB example (``examples/mvtcae_cub.py:37-75``): images of
(3, 64, 64) through ``CUB_Resnet_Encoder`` / ``CUB_Resnet_Decoder`` at their
defaults, captions of 32 tokens through ``CubTextEncoder`` (embed 512,
feed-forward 128, 2 layers, 2 heads), the ``CubTextDecoderMLP`` logits
under a categorical decoder, latent 64, beta 5.0, alpha 0.9, batch 64,
Adam 1e-3. Cut: the vocabulary is the one ``CUBSentences`` builds from the
given captions (the real CUB archive is not in the repo); on the synthetic
captions of ``chip_smoke.py``'s ``datasets`` phase
(``tools/dataset_files.write_cub`` with ``CUB_SYNTHETIC``) it holds
1,538 words.

The train sets of ``mvtcae_conv``, ``mmvae_conv``, ``mmvaeplus_partial``
and ``mopoe_conv`` are ``IncompleteDataset``s: each (row, modality) is
missing with probability 0.2, and a few rows have no modality at all. The
eval sets of the conv protocols are complete, as PolyMNIST's test set is;
the MMVAE+ eval split is cut from the same incomplete data.

``labelled_polymnist`` makes the evaluation phase's sets: complete random
PolyMNIST rows with digit labels in [0, 10), the shape of PolyMNIST's test
set (10,000 rows there).

All: Adam 1e-3, float32, seed 0; batch 256 unless stated. Only depth is
cut (rows, epochs). ``Workload.trainer_cls`` names the trainer a workload
needs (the ``MultistageTrainer`` for ``telbo_conv`` and ``jnf_conv``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

NAMES = ("mmvae", "mvtcae_mlp", "mvtcae_conv", "mmvae_conv", "mmvaeplus_partial",
         "mmvaeplus_k10", "mmvaeplus_k10_micro", "cmvae_polymnist", "mvae_conv",
         "mopoe_conv", "crmvae_resnet",
         "dmvae_mnist_svhn", "jmvae_conv", "telbo_conv", "jnf_conv", "cvae_tutorial",
         "mhvae_polymnist", "nexus_e2e")
BATCH = {name: (32 if name.startswith(("mmvaeplus", "cmvae"))
                else {"cvae_tutorial": 64, "mhvae_polymnist": 128, "nexus_e2e": 100}.get(
                    name, 256)) for name in NAMES}
CLUSTERS = 40   # CMVAE's clusters
POLYMNIST = (3, 28, 28)
LATENT = 512
PLUS_LATENT = 32   # MMVAE+: shared and private latent dims
MISSING = 0.2   # partial PolyMNIST: share of (row, modality) pairs missing
SEED = 0
CUB_BATCH = 64
CUB_LATENT = 64
# the datasets phase's CUB files: 113 train images (1,130 captions, 1,017 in
# the train split: 16 steps of 64), 12 test images, 1,500 made-up words
CUB_SYNTHETIC = dict(n_train=113, n_test=12, seed=SEED, n_words=1500)


@dataclasses.dataclass
class Workload:
    model: torch.nn.Module
    train: object                 # a MultimodalBaseDataset
    eval: Optional[object]        # None: no eval set
    trainer_kwargs: dict          # BaseTrainerConfig fields besides epochs/seed
    trainer_cls: Optional[type] = None   # None: BaseTrainer


def _images(rng, n, dims):
    return {m: rng.random((n, *d), dtype=np.float32) for m, d in dims.items()}


def _trainer_kwargs(name, **extra):
    kwargs = dict(per_device_train_batch_size=BATCH[name],
                  per_device_eval_batch_size=BATCH[name], learning_rate=1e-3,
                  optimizer_cls="Adam")
    kwargs.update(extra)
    return kwargs


def _seeded(encoders: dict, decoders: dict):
    """User nets keep their weights: seed them here (per modality, the
    encoder, then the decoder)."""
    generator = torch.Generator().manual_seed(SEED)
    for m in encoders:
        encoders[m].reset_parameters(generator)
        decoders[m].reset_parameters(generator)
    return encoders, decoders


def _incomplete(rng, n, dims):
    """(data, masks) of partial PolyMNIST: each (row, modality) missing with
    probability ``MISSING``, the ``dead_rows`` with no modality, missing
    entries zeroed."""
    data = _images(rng, n, dims)
    available = rng.random((n, len(dims))) >= MISSING
    available[dead_rows(n)] = False
    masks = {m: available[:, i] for i, m in enumerate(dims)}
    for m in dims:
        data[m][~masks[m]] = 0.0
    return data, masks


def build(name: str, n: int = 2048, n_eval: Optional[int] = None,
          device="cuda") -> Workload:
    """The workload ``name`` (one of ``NAMES``) with ``n`` train rows and
    ``n_eval`` eval rows (default: 512 for the conv protocols but
    ``jnf_conv``, a tenth of ``n`` for MMVAE+, 15% of ``n`` for CRMVAE, none
    for the others; 0 for none)."""
    from ..data import IncompleteDataset, MultimodalBaseDataset
    from ..models import (
        CMVAE,
        CRMVAE,
        CVAE,
        DMVAE,
        JMVAE,
        JNF,
        MHVAE,
        MMVAE,
        MVAE,
        MVTCAE,
        TELBO,
        CMVAEConfig,
        CRMVAEConfig,
        CVAEConfig,
        DMVAEConfig,
        JMVAEConfig,
        JNFConfig,
        MHVAEConfig,
        MMVAEConfig,
        MMVAEPlus,
        MMVAEPlusConfig,
        MoPoE,
        MoPoEConfig,
        MVAEConfig,
        MVTCAEConfig,
        Nexus,
        NexusConfig,
        TELBOConfig,
    )
    from ..nn import (
        BaseAEConfig,
        BaseDictEncoders,
        DecoderConvMMNIST,
        DecoderResnetMMNIST,
        EncoderConvMMNIST_adapted,
        EncoderResnetMMNIST,
        MultipleHeadJointEncoder,
    )
    from ..trainers import MultistageTrainer

    if name not in NAMES:
        raise ValueError(f"unknown workload {name!r}; expected one of {NAMES}")
    rng = np.random.default_rng(SEED)
    poly = {f"m{i}": POLYMNIST for i in range(5)}
    laplace = dict(decoders_dist={m: "laplace" for m in poly},
                   decoder_dist_params={m: {"scale": 0.75} for m in poly})
    if name == "mmvae":
        model = MMVAE(MMVAEConfig(
            n_modalities=5, latent_dim=LATENT, K=10, input_dims=poly,
            decoders_dist={m: "laplace" for m in poly},
            prior_and_posterior_dist="laplace_with_softmax", loss="dreg_looser"),
            seed=SEED, device=device)
        return Workload(model, MultimodalBaseDataset(_images(rng, n, poly)), None,
                        _trainer_kwargs(name))
    if name == "mvtcae_mlp":
        dims = {"m0": (1, 28, 28), "m1": (3, 32, 32)}
        model = MVTCAE(MVTCAEConfig(
            n_modalities=2, latent_dim=LATENT, input_dims=dims,
            decoders_dist={m: "bernoulli" for m in dims}), seed=SEED, device=device)
        return Workload(model, MultimodalBaseDataset(_images(rng, n, dims)), None,
                        _trainer_kwargs(name))

    if name.startswith("mmvaeplus"):
        k10 = name.startswith("mmvaeplus_k10")
        micro = name == "mmvaeplus_k10_micro"
        encoders, decoders = _seeded(
            {m: EncoderResnetMMNIST(PLUS_LATENT, PLUS_LATENT) for m in poly},
            {m: DecoderResnetMMNIST(2 * PLUS_LATENT) for m in poly})
        model = MMVAEPlus(MMVAEPlusConfig(
            n_modalities=5, latent_dim=PLUS_LATENT, modalities_specific_dim=PLUS_LATENT,
            input_dims=poly, K=10 if k10 else 1,
            prior_and_posterior_dist="laplace_with_softmax", learn_shared_prior=False,
            learn_modality_prior=True, beta=2.5, reconstruction_option="joint_prior",
            loss="iwae_looser" if k10 else "dreg_looser", use_remat=k10 and not micro,
            **laplace),
            encoders=encoders, decoders=decoders, seed=SEED, device=device)
        n_eval = n // 10 if n_eval is None else n_eval
        if k10:
            train = MultimodalBaseDataset(_images(rng, n, poly))
            eval_set = MultimodalBaseDataset(_images(rng, n_eval, poly)) if n_eval else None
            return Workload(model, train, eval_set, _trainer_kwargs(
                name, optimizer_params={"amsgrad": True},
                **({"microbatch_steps": 2} if micro else {})))
        data, masks = _incomplete(rng, n + n_eval, poly)
        rows = {"train": slice(0, n), "eval": slice(n, n + n_eval)}
        split = {k: IncompleteDataset({m: v[s] for m, v in data.items()},
                                      {m: v[s] for m, v in masks.items()})
                 for k, s in rows.items()}
        return Workload(model, split["train"], split["eval"] if n_eval else None,
                        _trainer_kwargs(name, scheduler_cls="ReduceLROnPlateau",
                                        scheduler_params={"patience": 30}))

    if name == "cmvae_polymnist":
        encoders, decoders = _seeded(
            {m: EncoderResnetMMNIST(PLUS_LATENT, PLUS_LATENT) for m in poly},
            {m: DecoderResnetMMNIST(2 * PLUS_LATENT) for m in poly})
        model = CMVAE(CMVAEConfig(
            n_modalities=5, latent_dim=PLUS_LATENT, modalities_specific_dim=PLUS_LATENT,
            input_dims=poly, K=1, number_of_clusters=CLUSTERS,
            prior_and_posterior_dist="laplace_with_softmax", learn_modality_prior=True,
            beta=2.5, loss="iwae_looser", **laplace),
            encoders=encoders, decoders=decoders, seed=SEED, device=device)
        return Workload(model, MultimodalBaseDataset(_images(rng, n, poly)), None,
                        _trainer_kwargs(name, optimizer_params={"amsgrad": True}))
    if name == "dmvae_mnist_svhn":
        dims = {"mnist": (1, 28, 28), "svhn": (3, 32, 32)}
        model = DMVAE(DMVAEConfig(
            n_modalities=2, latent_dim=10, input_dims=dims,
            modalities_specific_dim={"mnist": 1, "svhn": 4},
            rescale_factors={"mnist": 50, "svhn": 1}, uses_likelihood_rescaling=True),
            seed=SEED, device=device)
        return Workload(model, MultimodalBaseDataset(_images(rng, n, dims)), None,
                        _trainer_kwargs(name))
    if name == "cvae_tutorial":
        dims = {"target": (12,), "cond_a": (6,), "cond_b": (1, 4, 4)}
        cond = {m: dims[m] for m in ("cond_a", "cond_b")}
        prior = MultipleHeadJointEncoder(BaseDictEncoders(cond, 8), BaseAEConfig(latent_dim=8))
        prior.reset_parameters(torch.Generator().manual_seed(SEED))
        model = CVAE(CVAEConfig(main_modality="target", conditioning_modalities=list(cond),
                                input_dims=dims, latent_dim=8, beta=1.0),
                     prior_network=prior, seed=SEED, device=device)
        data = {"target": rng.normal(size=(n, 12)).astype(np.float32),
                "cond_a": rng.normal(size=(n, 6)).astype(np.float32),
                "cond_b": rng.random((n, 1, 4, 4), dtype=np.float32)}
        return Workload(model, MultimodalBaseDataset(data), None, _trainer_kwargs(name))
    if name == "mhvae_polymnist":
        from .mhvae_nets import build_blocks, reset_blocks

        blocks = build_blocks(list(poly), latent=64)
        reset_blocks(blocks, torch.Generator().manual_seed(SEED))
        names = ("encoders", "decoders", "bottom_up_blocks", "top_down_blocks",
                 "posterior_blocks", "prior_blocks")
        model = MHVAE(MHVAEConfig(n_modalities=5, latent_dim=64, input_dims=poly, n_latent=3,
                                  beta=1.0, **laplace),
                      **dict(zip(names, blocks)), seed=SEED, device=device)
        return Workload(model, MultimodalBaseDataset(_images(rng, n, poly)), None,
                        _trainer_kwargs(name))
    if name == "nexus_e2e":
        dims = {"a": (8,), "b": (12,)}
        model = Nexus(NexusConfig(
            n_modalities=2, latent_dim=8, modalities_specific_dim={"a": 8, "b": 8}, msg_dim=8,
            warmup=5, dropout_rate=0.5, top_beta=0.1, bottom_betas={"a": 0.1, "b": 0.1},
            gammas={"a": 10.0, "b": 10.0}, input_dims=dims,
            decoders_dist={m: "normal" for m in dims},
            decoder_dist_params={m: {"scale": 0.05} for m in dims}), seed=SEED, device=device)
        labels = rng.integers(0, 3, n)
        centres = np.random.default_rng(42)
        data = {m: (centres.uniform(0.1, 0.9, size=(3, d[0]))[labels]
                    + rng.normal(size=(n, d[0])) * 0.03).astype(np.float32)
                for m, d in dims.items()}
        return Workload(model, MultimodalBaseDataset(data), None,
                        _trainer_kwargs(name, learning_rate=2e-3))
    if name == "crmvae_resnet":
        encoders, decoders = _seeded(
            {m: EncoderResnetMMNIST(0, LATENT) for m in poly},
            {m: DecoderResnetMMNIST(LATENT) for m in poly})
        model = CRMVAE(CRMVAEConfig(n_modalities=5, latent_dim=LATENT, input_dims=poly,
                                    uses_likelihood_rescaling=False, beta=0.1, **laplace),
                       encoders=encoders, decoders=decoders, seed=SEED, device=device)
        n_eval = int(0.15 * n) if n_eval is None else n_eval
        eval_set = MultimodalBaseDataset(_images(rng, n_eval, poly)) if n_eval else None
        return Workload(model, MultimodalBaseDataset(_images(rng, n, poly)), eval_set,
                        _trainer_kwargs(name, learning_rate=5e-4, drop_last=True))

    # the partial-PolyMNIST conv protocol: mvtcae_conv, mmvae_conv, mvae_conv,
    # mopoe_conv, jmvae_conv, telbo_conv, jnf_conv
    cfg = BaseAEConfig(latent_dim=LATENT, input_dim=POLYMNIST)
    encoders, decoders = _seeded({m: EncoderConvMMNIST_adapted(cfg) for m in poly},
                                 {m: DecoderConvMMNIST(cfg) for m in poly})
    base = dict(n_modalities=5, latent_dim=LATENT, input_dims=poly, **laplace)
    nets = dict(encoders=encoders, decoders=decoders, seed=SEED, device=device)
    extra = {}
    if name == "mvtcae_conv":
        model = MVTCAE(MVTCAEConfig(beta=2.5, alpha=5.0 / 6.0, **base), **nets)
    elif name == "mmvae_conv":
        model = MMVAE(MMVAEConfig(K=10, prior_and_posterior_dist="laplace_with_softmax",
                                  learn_prior=False, loss="dreg_looser", **base), **nets)
    elif name == "mvae_conv":
        model = MVAE(MVAEConfig(use_subsampling=True, k=0, warmup=0, beta=2.5, **base),
                     **nets)
    elif name == "jmvae_conv":
        model = JMVAE(JMVAEConfig(alpha=0.1, warmup=200, **base), **nets)
    elif name == "telbo_conv":
        model = TELBO(TELBOConfig(warmup=2, **base), **nets)
        extra["trainer_cls"] = MultistageTrainer
    elif name == "jnf_conv":
        model = JNF(JNFConfig(warmup=1, **base), **nets)
        extra["trainer_cls"] = MultistageTrainer
    else:
        model = MoPoE(MoPoEConfig(beta=2.5, **base), **nets)
        extra["drop_last"] = True
    # complete data: --missing_ratio 0 (MVAE), masks refused (JMVAE, TELBO, JNF)
    if name in ("mvae_conv", "jmvae_conv", "telbo_conv", "jnf_conv"):
        train = MultimodalBaseDataset(_images(rng, n, poly))
    else:
        train = IncompleteDataset(*_incomplete(rng, n, poly))
    if n_eval is None:
        n_eval = 0 if name == "jnf_conv" else 512
    eval_set = MultimodalBaseDataset(_images(rng, n_eval, poly)) if n_eval else None
    trainer_cls = extra.pop("trainer_cls", None)
    return Workload(model, train, eval_set,
                    _trainer_kwargs(name, scheduler_cls="ReduceLROnPlateau",
                                    scheduler_params={"patience": 30}, **extra),
                    trainer_cls)


def dead_rows(n: int) -> np.ndarray:
    """Rows of the incomplete train sets with no modality (row 5 among them,
    so the first 8 rows hold one)."""
    return np.arange(5, n, 509)


def labelled_polymnist(n: int, seed: int):
    """``n`` complete random PolyMNIST rows (5 modalities of 3x28x28, as the
    conv protocols name them) with labels in [0, 10), from ``seed``."""
    from ..data import MultimodalBaseDataset

    rng = np.random.default_rng(seed)
    data = _images(rng, n, {f"m{i}": POLYMNIST for i in range(5)})
    return MultimodalBaseDataset(data, labels=rng.integers(0, 10, n))


def cub_workload(train, eval_set=None, device="cuda") -> Workload:
    """``mvtcae_cub`` on ``CUB(..., output_type="tokens")`` datasets: the
    caption length and the vocabulary are the train set's."""
    from ..models import MVTCAE, MVTCAEConfig
    from ..nn import BaseAEConfig
    from ..nn.cub import CUB_Resnet_Decoder, CUB_Resnet_Encoder, CubTextDecoderMLP, CubTextEncoder

    length, vocab = train.text_data.max_sequence_length, train.vocab_size
    text = (length, vocab)
    encoders = {"image": CUB_Resnet_Encoder(CUB_LATENT),
                "text": CubTextEncoder(CUB_LATENT, length, vocab, embed_size=512, ff_size=128,
                                       n_layers=2, nhead=2, dropout=0.1)}
    decoders = {"image": CUB_Resnet_Decoder(CUB_LATENT),
                "text": CubTextDecoderMLP(BaseAEConfig(latent_dim=CUB_LATENT, input_dim=text))}
    encoders, decoders = _seeded(encoders, decoders)
    model = MVTCAE(MVTCAEConfig(
        n_modalities=2, latent_dim=CUB_LATENT, input_dims={"image": (3, 64, 64), "text": text},
        decoders_dist={"image": "laplace", "text": "categorical"}, beta=5.0, alpha=0.9),
        encoders=encoders, decoders=decoders, seed=SEED, device=device)
    return Workload(model, train, eval_set, dict(
        per_device_train_batch_size=CUB_BATCH, per_device_eval_batch_size=CUB_BATCH,
        learning_rate=1e-3, optimizer_cls="Adam"))
