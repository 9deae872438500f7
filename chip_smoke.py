"""Smoke test of the PyTorch/CUDA port (``multivae_tpu_torch``) on one GPU.

Run from the root of a checkout, on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. the card's name and power limit (nvidia-smi), torch and CUDA versions;
2. build every CUDA kernel of the port from ``multivae_tpu_torch/csrc``
   with nvcc (into ``build/kernels/``) and, beside them, the threaded
   native gather (``csrc/gather.cpp``) with g++ (into ``build/native/``),
   printing the build time and the compiler's register/shared-memory
   report;
3. kernels: the mixture log-density forward and its three gradients
   (full backward kernel), and dz alone with ``mus``/``sigmas`` detached
   (dz-only backward kernel), against the plain PyTorch version on the
   card, at the MMVAE slice shapes, at ragged shapes (B=37 with D=100, and
   with D=101, which takes the scalar path), with every expert count from
   1 to 8 (each register instance and its padding) and with MQ=11 (more
   than the largest register instance), and with rows longer than one
   register tile (D=2600 and, scalar, D=2301), at the MMVAE+ shapes (B=32,
   D=32, R=5 and 50), at the K=1000 NLLs' shapes (R=500 with B=64, D=512
   and with B=32, D=32), and with rows of D=4096 and 8192 at MQ=5 and of
   D=4099 at MQ=11 (the streaming chunked path), for Laplace
   and Normal, with a masked expert on some columns and one fully masked
   column, which must get exactly zero dz, dmu and dsig; torch.profiler
   must see exactly one device kernel in one forward call; then the time of
   the forward, the full backward and the dz-only backward at the slice
   shapes and at ``mmvaeplus_k10``'s, each through the public op
   (``tools/mixture_sweep.time_ms``: CUDA events, median of 20 calls, the
   L2 flushed before each by writing 256 MB, host time kept out of the
   window), beside the plain version's time, the bound and the share of it;
   at the slice, where a call's time goes (``fixed_cost``): the yardstick,
   the same after a read-only flush (the L2 left clean), the kernel's own
   duration from torch.profiler and the event window around an empty
   kernel launched through the same ctypes path; then the same for the bf16
   mixture kernels (``bf16_kernels``, ``csrc/mixture_bf16.cu``) at every
   shape above, each shape's route printed, against the plain version in
   float64 on the same bf16 values (output float32, gradients bf16 within
   ``BF16_GRAD_RTOL``); the slice, ``mmvaeplus_k10`` and
   ``cmvae_polymnist`` (R=5, B=32, D=32) shapes must take the tensor-copy
   forward, dz-only backward and full backward (``bf16_routes``: the
   plan's route and the one device kernel torch.profiler sees a call); two
   full backward calls must give bit-equal dz, dmu and dsig at the slice,
   ``mmvaeplus_k10`` and R=500 shapes (``bf16_determinism``); their times
   and bf16 bounds at those three shapes, and the slice's fixed cost;
4. slice: the full-width MMVAE (5 modalities of 3x28x28, latent 512,
   K=10, default MLP nets, Laplace decoders, DReG) trained by
   ``BaseTrainer.train()`` for 2 epochs of 2048 random samples (16 steps of
   batch 256, Adam 1e-3, float32); every epoch loss must be finite, the
   mixture kernels must launch exactly twice (forward) and once (dz-only
   backward) per step, and the trained model's loss on 8 rows must agree
   between the card (kernel path) and the CPU (plain path) on the same
   noise (a float64 CPU value is printed beside both); then the same model
   with the IWAE objective for 2 steps, the path of the full backward
   kernel (once forward, once backward a step);
5. ``mvtcae_mlp``: MVTCAE at ``bench.py``'s ``bench_jax`` configuration
   (``tools/workloads.py``: two image modalities, MLP-512 nets, Bernoulli
   decoders, latent 512) trained by ``BaseTrainer.train()`` for 2 epochs of
   2048 random rows (16 steps of batch 256, Adam 1e-3, float32); every
   epoch loss must be finite, no mixture kernel may launch, and the trained
   model's loss on 8 rows with injected noise must agree between the card
   and the CPU (a float64 CPU value is printed beside both);
6. ``mvtcae_conv``: the same for the partial-PolyMNIST configuration (5
   modalities of 3x28x28, the PolyMNIST conv nets, Laplace decoders of
   scale 0.75, ReduceLROnPlateau on a 512-row eval set) on an
   ``IncompleteDataset`` with 20% of the (row, modality) pairs missing and
   a few rows with no modality (the PoE's dead-row fallback; the 8 rows of
   the loss check hold one);
7. ``mvtcae_inference`` on the two trained models: encode (N=10, flatten),
   predict, generate_from_prior(64) + decode, the refusal to encode an
   incomplete conditioning subset; the K=1000 joint NLL (``bench.py``'s
   ``bench_nll_jax`` setting: 512 complete rows, ``batch_size_K=100``, on
   the MLP model; 256 rows on the conv model), wall seconds as the median
   of 3 after a warm-up, and its peak memory; the joint NLL of 8 rows with
   K=20 and injected noise, card vs CPU; no mixture kernel may launch;
8. the mixture-of-experts workloads of ``tools/workloads.py``, each trained
   by ``BaseTrainer.train()`` for 2 epochs: ``mmvae_conv`` (MMVAE on the
   partial-PolyMNIST conv protocol, 1024 incomplete rows, DReG),
   ``mmvaeplus_partial`` (MMVAE+ with the resnet nets, K=1, DReG, 1024
   incomplete rows), ``mmvaeplus_k10`` (K=10, IWAE, AMSGrad, 512 rows) and
   ``cmvae_polymnist`` (CMVAE, 40 clusters, K=1, IWAE, AMSGrad, 256 rows);
   every epoch loss must be finite, the mixture kernels must launch
   exactly as the objective says on every train and eval step (DReG: two
   forwards and one dz-only backward a step; IWAE: one forward and one full
   backward; eval: the forwards), and the trained model's loss on 8 rows
   must agree between the card and the CPU on the same noise;
9. ``moe_inference`` on the trained ``mmvae_conv``, ``mmvaeplus_k10`` and
   ``cmvae_polymnist``: encode (N=10, with the private codes for MMVAE+ and
   CMVAE), predict, generate_from_prior(64) + decode, the refusal to encode
   an incomplete subset; K=1000 joint NLL wall seconds (median of 3 after a
   warm-up) and peak memory: MMVAE's ``compute_joint_nll`` on 256 rows and
   ``compute_joint_nll_paper`` on 64, MMVAE+'s and CMVAE's
   ``compute_joint_nll`` on 32; the forward kernel's launches per call on
   the paths that run it; each NLL of 8 rows with K=20 card vs CPU; CMVAE's
   ``predict_clusters`` and ``prune_clusters`` on 256 rows;
10. the PoE-family workloads, each trained 16 steps: ``mvae_conv`` (MVAE on
    the conv protocol, complete data, 6 subset ELBOs a step),
    ``mopoe_conv`` (MoPoE, 20% missing, a subset drawn per row) and
    ``crmvae_resnet`` (CRMVAE, the resnet nets, latent 512); finite losses,
    the 8-row loss card vs CPU, no mixture launch; then ``poe_inference``:
    the same inference checks, K=1000 NLL seconds and peak memory (MVAE and
    MoPoE on 256 rows, MoPoE's paper form too, CRMVAE on 64), 8-row K=20
    NLLs card vs CPU;
11. the joint-encoder family and DMVAE: ``dmvae_mnist_svhn`` (DMVAE's
    published MNIST-SVHN run, 16 steps), ``jmvae_conv`` (JMVAE on the conv
    protocol, complete data, 16 steps), ``telbo_conv`` (TELBO, warm-up 2,
    3 epochs of 4 steps through the ``MultistageTrainer``: the optimizer
    reset at epoch 2 and the stage flip at epoch 3; the 8-row loss in
    stage 1 too) and ``cvae_tutorial``
    (the CVAE tutorial, 3 epochs of 4 steps); finite losses, the 8-row loss
    card vs CPU, no mixture launch; then ``joint_inference`` on the first
    three: encode, predict, prior, K=1000 NLL seconds and peak memory
    (DMVAE on 512 rows, JMVAE and TELBO on 256), 8-row K=20 NLLs card vs
    CPU; and CVAE's predict (from all modalities and from the prior of the
    conditioning ones) and generate_from_prior;
12. ``jnf_conv``: JNF on the conv protocol (complete data, no eval set,
    warm-up 1), 3 epochs of 8 steps through the ``MultistageTrainer``: the
    optimizer reset and the stage flip both at epoch 2, exactly one reset,
    steps/s for each stage, the 8-row loss card vs CPU in stage 1 and in
    stage 2, no mixture launch;
13. ``jnf_inference``: the K=1000 joint NLL on 256 rows (seconds, peak,
    8 rows with K=20 card vs CPU), encode from one modality on 256 rows
    (2 x 512 sequential MADE passes) and from two modalities by HMC at the
    defaults (100 steps of 10 leapfrog steps) on 64 rows, timed, predict
    from those two; card vs CPU on 8 rows with the same draws: the
    one-modality encode, and HMC at 5 steps, whose accept decisions must
    agree (the smallest |u - alpha| is printed);
14. ``samplers``: on the trained JNF's latents of 20,480 random PolyMNIST
    rows, ``MAFSampler`` (20 epochs, batch 256, lr 1e-3), ``IAFSampler``
    (1 epoch on 2,048 rows: its density pass is sequential) and a
    10-component full-covariance ``GaussianMixtureSampler``, each then
    drawing 256 latents; ``MAFSampler`` and ``GaussianMixtureSampler`` on
    the trained DMVAE (shared 10, private 1 and 4); fit and sample seconds,
    EM iterations and lower bounds, peaks; the seconds of one EM iteration
    on the JNF latents (20 iterations from fixed labels against one, so
    that the fit's time scales to the iterations other latents need);
    finite samples; card vs CPU:
    one EM iteration from the same labels, one MAF fit step (loss and
    gradients), the MAF's inverse of a fixed u;
15. ``mhvae_polymnist``: MHVAE at the PolyMNIST example's widths (5
    modalities of 3x28x28, 3 latent levels: z_3 a vector of 64, z_2 a
    64x7x7 map, z_1 a 32x14x14 map, shared posterior heads, Laplace
    decoders of scale 0.75), 2 epochs of 16 steps of batch 128; finite
    losses, steps/s, peak memory, the 8-row loss card vs CPU, no mixture
    launch;
16. ``nexus_e2e``: the repo's Nexus configuration (``a`` 8 and ``b`` 12
    features, warm-up 5, forced dropout 0.5), 2 epochs of 6 steps; the
    8-row loss card vs CPU on the dropout branch (a fixed dropout injected);
17. ``hierarchical_inference``: MHVAE's encode (N=10, every level),
    predict from one modality and the per-row encode of an incomplete batch
    (and ``encode``'s refusal of it), timed, the per-row encode of 8 rows
    card vs CPU; Nexus's encode, predict and decode both ways, and its
    8-row loss on the incomplete branch card vs CPU;
18. ``samplers_incomplete``: the GMM (2 components) and MAF samplers fitted
    on ``mvtcae_conv``'s incomplete train set through the per-row encode:
    the collection's, fits' and samples' seconds, the collected latents of
    64 rows card vs CPU, and ``mmvae_conv``'s refusal;
19. ``evaluation``: every evaluator of ``multivae_tpu_torch.metrics`` on
    the trained ``mvtcae_conv`` and ``mmvae_conv``, on 2,048 labelled random
    PolyMNIST test rows (and 2,048 train rows for the clustering), with five
    random-init PolyMNIST classifiers: the K=1000 joint NLL (MVTCAE on 256
    rows; MMVAE's paper estimator on 64, 10 mixture forwards), the
    coherences at the case study's settings (batch 512, 10,000 joint
    samples), SSIM and MSE reconstruction, the clustering (4 runs), the
    grids (PNGs), the FIDs of ``m0`` from all 15 subsets embedded by a
    classifier's 128 features and, on MVTCAE, the FID of ``m0`` from the
    other four through a random-init InceptionV3 at 299x299 read from a
    state-dict file (4,096 images; the embedding and the 2048x2048 Fréchet
    step timed apart); each evaluator's seconds and peak; every evaluator
    card vs CPU on 64 rows with the same noise (the classifiers'
    predictions equal but on near-ties, whose count is printed), and the
    Inception embeddings of 8 rows card vs CPU;
20. ``trainer_lifecycle``: ``mmvae_conv`` (1024 incomplete rows, 512 eval
    rows, DReG) trained 2 epochs by ``BaseTrainer`` with a checkpoint and
    the prediction grids every epoch, ``StepTimingCallback`` and a callback
    that records every event: the events in the JAX loop's order, each
    checkpoint's files, bytes and save seconds, the PNG grids, the mixture
    launches of the sanity check's forward (2) and of every step; two
    trainers resumed from ``checkpoint_epoch_1`` run epoch 2, whose train
    and eval losses must agree with the uninterrupted run's within
    ``RESUME_RTOL`` and whose weights' moves over the epoch within
    ``RESUME_MOVE_RTOL`` (the spread of the two printed), while a resume
    without the generator's state must miss the latter; ``AutoModel.load_from_folder`` reads
    ``final_model`` onto the card (the kept weights, exactly; the 8-row loss
    on the same draws within ``RELOAD_RTOL``); a deterministic
    ``Predictor`` (batch 64, a request of 50 rows of ``m0``) on the reloaded
    MMVAE and an ``AnySubsetPredictor`` on the reloaded ``mvtcae_conv``
    (every row its own subset) card vs CPU, each one's ms a request at
    batch 64 and 256, MMVAE refused by the latter; their export
    (``lifecycle_export``): MMVAE's deterministic and sampled ``Predictor``
    and MVTCAE's deterministic ``AnySubsetPredictor`` at batch 64 and a
    deterministic MMVAE ``Predictor`` at 256 through ``torch.export``,
    loaded and run in a fresh python that imports only torch and numpy,
    each reply bit-equal to the live ``_predict_fn``'s on the same draws,
    no graph with a host read, a collective or a weight; export and load
    seconds, artifact bytes beside the state dicts', ms a request live
    and loaded at batch 64 and 256; ``mmvaeplus_k10_micro``
    (``use_remat`` off, ``microbatch_steps=2``: 2 mixture forwards and 2
    full backwards a step) trained 2 epochs, its steps/s and peak beside
    ``mmvaeplus_k10``'s, its 8-row microbatched gradient card vs CPU; and
    ``telbo_conv``'s boundary checkpoint ``checkpoint_epoch_1`` reloaded by
    ``AutoModel``. Every trainer above runs the sanity check's forward at
    its construction; the phases that count launches per step reset the
    counts after it;
21. ``datasets``: each dataset's files written in their real formats
    (``tools/dataset_files.py``) under ``build/chip_smoke`` and read by the
    port's dataset classes, each step a JSON line with its seconds:
    PolyMNIST's test split (10,000 rows x 5 modalities of 3x28x28 float32,
    470 MB, four ``.npy`` and one ``.pt``) loaded by ``MMNISTDataset`` with
    20% of the rows missing (MAR), its load seconds a GB; ``mvtcae_conv``
    (4,096 rows) and ``mmvaeplus_partial`` (512 rows: the exact mixture
    launches a train and eval step) trained 16 steps from it, on 512 eval
    rows; MNIST's gzipped idx files (10,000 rows) and SVHN's
    ``test_32x32.mat`` (26,032 rows) paired by ``MnistSvhn``,
    ``dmvae_mnist_svhn`` trained 16 steps from the pairs; CUB's captions and
    64x64 PNGs read by ``CUB(output_type="tokens")`` without importing PIL,
    ``mvtcae_cub`` trained 16 steps at the example's widths (the 8-row loss
    card vs CPU); each beside the same workload's run on random arrays
    earlier in the call (steps/s, peak above held); then a Translated
    PolyMNIST tree of 2,048 rows x 5 PNGs and the seconds to read a batch
    of 256 rows;
22. ``resident_data``: the device cache (``data/device_cache.py``)
    against the host path (``data/prefetch.py``, the native gather), under
    cuDNN's deterministic algorithms: partial PolyMNIST's train split at
    its real size (60,000 rows x 5 x 3x28x28 float32 with the MAR masks of
    ``tools/workloads._incomplete``, 2.82 GB) cached on the card, the
    build's seconds and bytes, one epoch of cached batches against the
    host loader's bit for bit, a 256-row gather on the card against the
    host gather plus a pageable copy and plus a pinned one, the native
    gather against numpy's (by thread count, at 256 and 4,096 rows), and
    ``mvtcae_conv`` trained one epoch each
    way; then ``mvtcae_conv``, ``mmvaeplus_partial`` (exact mixture
    launches on every cached step; 512 rows) and ``dmvae_mnist_svhn`` on
    2,048 rows, 2 epochs each way: steps/s and peaks above held side by side, every
    cache built, the first epoch losses within ``RESIDENT_LOSS_RTOL``; the
    coherences of the cached ``mvtcae_conv`` cached against host (equal
    metrics); a GMM fitted through the trainer's cache, whose collected
    latents equal the host loop's, with no second upload (device memory
    grows by the latents only);
23. ``graphed_steps``: ``steps_per_execution`` as CUDA graphs, under
    cuDNN's deterministic algorithms: ``mmvaeplus_partial`` (384 rows;
    the mixture kernels inside the graphs), ``mvtcae_conv``,
    ``dmvae_mnist_svhn``, ``mvae_conv`` (the warm-up from ``batch_ratio``,
    the random subsets; 2,048 rows each) and ``telbo_conv`` (3,072 rows;
    the optimizer reset and the stage flip drop the graphs; 4 epochs, so
    that stage 2 replays), each on its cached rows for 3 epochs: eager,
    with ``steps_per_execution`` 8, and with the epoch's batch count and
    ``pipeline_epochs``; beside them the eager run with the capturable
    optimizer the graphs use, the eager run twice with cuDNN free (the
    card's own spread) and the 8-step run resumed from its checkpoint of
    the epoch before the last. Each graphed run must replay train and eval
    graphs and equal the capturable eager run within ``GRAPHED_RTOL`` on
    every epoch's train and eval loss and on the weights' moves, as must
    the resume the uninterrupted graphed run; each kind of every run's gap
    to the plain eager run (first-epoch, later-epoch and eval losses, the
    moves) lies within ten times the spread of that kind (no tighter than
    the resume gates), and the mixture
    launches are their count a step on every train and eval step. One
    replay of ``mmvaeplus_partial``'s 8-step graph under torch.profiler
    must launch the mixture kernels the counters add for it. ``dmvae_mnist_svhn`` (the one workload the
    pipelined finalization takes) then runs 12 epochs under a StepLR,
    keeping the best weights on the train loss, whole-epoch graphs with
    ``pipeline_epochs`` off, on, off, on, each within ``GRAPHED_RTOL`` of
    the capturable eager run, its kept weights too; their walls and peaks
    are printed. Steps/s over the steady epochs come from CUDA events
    at each train pass's start and after its last step; capture seconds and
    the growth of reserved memory (the graphs' pools);
24. ``data_parallel``: training through a ``torch.distributed`` process
    group (``parallel/mesh.py``), under cuDNN's deterministic algorithms:
    ``mmvae_conv`` (1,024 incomplete rows, DReG: the mixture kernels in
    every rank's step) and ``mvtcae_conv`` (1,000 rows: the last batch's 24
    padding rows on rank 1; ReduceLROnPlateau on the global eval loss), 1
    epoch at the global batch of 256, each (a) in one process with no
    group, (b) in a group of one process over NCCL opened in this process,
    equal to (a) bit for bit (every epoch's losses, the weights), and (c) by
    two ranks on the one card over gloo, spawned (``--dp-rank``), at 128
    rows each: within ``DP_RTOL`` of (a) on every epoch's train and eval
    loss and ``DP_MOVE_RTOL`` on the weights' moves, the ranks' replicas
    bit-equal, each rank's own counters at 2 mixture forwards and 1 dz-only
    backward a step (and the forwards of each eval step); with more than one
    card, also by min(cards, 4) ranks over NCCL, one card each. Steps/s of
    each, the gradient bytes all-reduced a step and the all-reduce's ms a
    step (CUDA events around it) under NCCL and gloo. Then the rest of the
    JAX package's data-parallel surface: ``mmvae_conv`` (1,024 cached rows)
    as CUDA graphs of 4 steps alone and in a one-process NCCL group, bit
    for bit, with the collectives the captures issued and one profiled
    replay's mixture kernels (8 forwards and 4 dz-only backwards) and
    NCCL activities; the spawned ranks cache ``mmvae_conv``'s 2,048 rows
    replicated, row-sharded and "auto" under a budget only the sharded
    layout fits (an epoch's batches bit-equal, half the bytes a rank, the
    exchange's ms and bytes a step) and train from the replicated and the
    sharded cache, bit-equal; the evaluators (likelihoods, coherence,
    reconstruction, clustering, the FID with the classifiers' features) on
    seeded ``mmvae_conv`` and ``mvtcae_conv`` over 2,048 labelled rows
    alone, in the one-process NCCL group (bit-equal) and over the ranks
    (each rank the same metrics, within ``DP_EVAL_RTOL`` /
    ``DP_EVAL_COUNT_ATOL`` of alone, each counting the paper NLL's mixture
    forwards); the phase's seconds;
25. ``mixed_precision``: the trainer's bfloat16 mode (its mixture kernels
    are checked in phase 3): ``mmvae_conv``, ``crmvae_resnet``, ``mvae_conv`` and ``mvtcae_conv`` on
    1,024 rows and ``cmvae_polymnist`` on 256 (IWAE: the full bf16
    backward), 2 epochs each in float32 and in bf16: steps/s, peaks, every
    epoch's train and eval loss within ``MIXED_LOSS_RTOL`` of the f32 run,
    the bf16 train steps' exact launches of the bf16 kernels and none of
    the float32 ones; ``mmvae_conv`` in bf16 as CUDA graphs of 8 steps
    equal to its eager bf16 run with the capturable optimizer within
    ``GRAPHED_RTOL``, and in a one-process NCCL group equal to no group bit
    for bit; the phase's seconds;
26. ``state_sharding``: the JAX package's ``fsdp`` and ``n_model_devices``
    (``parallel/state.py``) on ``mmvae_conv``, cuDNN deterministic: (a)
    4-step CUDA graphs on 1,024 cached rows in a one-process NCCL group,
    ``fsdp`` off and on, bit-equal (else within ``GRAPHED_RTOL``, the
    reason printed), their steps/s ratio, the collectives each train and
    eval capture issues (all-gathers, reduce-scatters, all-reduces, bytes),
    a replay's mixture kernels and NCCL activities, the bytes at rest; (b)
    two gloo ranks on the one card, spawned (``--ss-rank``), one eager
    epoch of 512 rows at the global batch of 256, ``fsdp`` over data 2 and
    data 1 x model 2, each within ``DP_RTOL`` / ``DP_MOVE_RTOL`` of one
    process, the replicas bit-equal, each rank's bytes at rest of
    parameters and optimizer state, and with the whole weights best-model
    tracking keeps, beside one process's, 2 mixture forwards
    and 1 dz-only backward a rank a step; then ``mvtcae_cub`` (the CUB
    example's widths on synthetic CUB files written once into the phase's
    folder, its text encoder's attention projections placed by their
    per-head JAX leaves) one epoch of 4 steps at the global batch of 64 in
    the same two layouts, against one process within ``DP_RTOL`` /
    ``DP_MOVE_RTOL``, no mixture launch, steps/s alone and in each layout,
    each rank's bytes at rest and the text encoder's cut leaves, the
    ``fsdp`` ranks' sharded checkpoint restored in one process bit-equal;
    (c) with four cards, four NCCL ranks as data 2 x model 2 with
    ``fsdp``, graphed, against (a)'s replicated run, and ``mvtcae_cub``
    with ``fsdp`` over data 4, where 2 heads do not divide over 4 and each
    rank keeps the out projections whole (4x a query projection's bytes at
    rest), against one process (``python3 chip_smoke.py
    --state-sharding-four`` runs (b) and (c) and those runs alone); and the
    checkpoints of
    ``checkpoint_backend="orbax"``, asynchronous: (a)'s ``fsdp`` run saves
    every epoch, each epoch's ``train_state/`` restored bit-equal to the
    masters and moments copied at its save, and a run resumed from epoch 1
    bit-equal to the final weights with the same launches a step; (b)'s
    ``fsdp`` ranks save sharded (each rank's file about its bytes at rest),
    restored whole in one process bit-equal to their final weights, and
    with four cards by (c)'s ranks in their layout; one ``crmvae_resnet``
    trainer after one step saves with "msgpack" and twice with "orbax",
    each restored to the saved state bit for bit; a line a save with the
    seconds the loop was blocked, to the files written and to the commit,
    the bytes a rank and the restore's seconds, beside the card's name and
    power limit; the phase's seconds;
27. the seconds the whole run took, a ``kernels`` JSON line (launches
    summed over every training and inference phase that runs the kernels,
    each kernel at least once), then the last line
    ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

It imports nothing of JAX and nothing of the JAX package.
"""

import contextlib
import copy
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth and f32 without
# tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
# Operations per (row, expert, batch column, coordinate) term: forward
# sub, mul, abs (or square), add; the dz-only backward recomputes that and
# adds ~6 for dz; the full backward adds ~12 for the three gradients.
FWD_OPS_PER_TERM = 4
DZ_OPS_PER_TERM = 10
BWD_OPS_PER_TERM = 16

# Kernel vs plain tolerances. The output is compared elementwise: both sum D
# float32 terms in a different order, so they differ by a few ulps of the
# output's magnitude (~10^3 at D=512). The gradients are compared normwise
# (max abs err <= GRAD_ATOL + GRAD_RTOL * max|plain|): each entry is a sum of
# terms weighted by exp(lq - out), whose relative error is the absolute
# error of lq (~1e-4 at D=512), and where large terms cancel an elementwise
# relative test would measure the cancellation, not the kernel.
OUT_RTOL, OUT_ATOL = 1e-5, 1e-4
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-3
# Trained-model loss on the card vs on the CPU: same weights and noise,
# different matmul and reduction order over ~10^4-sized log-weights.
# The same holds for the MVTCAE losses and the 8-row joint NLL.
LOSS_RTOL = 1e-4
# JNF's encode (2 x 512 sequential MADE passes, or HMC's leapfrog through
# the flows' gradients), a MAF's inverse and the GMM means, card vs CPU on
# the same draws: float32 differences carried through many dependent
# passes, compared to the output's largest entry.
ENCODE_RTOL = 1e-4

SLICE_SHAPE = dict(mz=5, k=10, b=256, d=512, mq=5)
RAGGED_SHAPE = dict(mz=3, k=4, b=37, d=100, mq=3)
ODD_D_SHAPE = dict(mz=3, k=4, b=37, d=101, mq=3)   # D % 4 != 0: scalar path
MANY_EXPERTS_SHAPE = dict(mz=2, k=3, b=40, d=64, mq=11)  # above the MQ=8 kernels
# the register instances (MQ rounded up to 2, 5 or 8) and their padding
EXPERT_SHAPES = tuple(dict(mz=2, k=3, b=40, d=64, mq=q) for q in range(1, 9))
# rows longer than one register tile (256 threads of 8 coordinates)
LONG_ROW_SHAPES = (dict(mz=2, k=2, b=9, d=2600, mq=2),
                   dict(mz=1, k=3, b=5, d=2301, mq=3))   # scalar path
# MMVAE+ (latent 32, batch 32): K=1 (mmvaeplus_partial) and K=10 (mmvaeplus_k10)
PLUS_SHAPES = (dict(mz=5, k=1, b=32, d=32, mq=5), dict(mz=5, k=10, b=32, d=32, mq=5))
K10_SHAPE = PLUS_SHAPES[1]
# the K=1000 NLLs of moe_inference: MMVAE's paper estimator (100 samples of
# each of 5 experts, 64 rows) and MMVAE+'s (200 of 5 split in chunks of 100,
# 32 rows)
NLL_SHAPES = (dict(mz=5, k=100, b=64, d=512, mq=5), dict(mz=5, k=100, b=32, d=32, mq=5))
# rows wider than whole rows and staged parameters fit in shared memory:
# the streaming chunked path (float4 at MQ=5; scalar, in chunks of experts,
# at D=4099 and MQ=11)
WIDE_SHAPES = (dict(mz=2, k=2, b=8, d=4096, mq=5), dict(mz=1, k=2, b=4, d=8192, mq=5),
               dict(mz=1, k=2, b=3, d=4099, mq=11))
CHECK_SHAPES = (SLICE_SHAPE, RAGGED_SHAPE, ODD_D_SHAPE, MANY_EXPERTS_SHAPE,
                *EXPERT_SHAPES, *LONG_ROW_SHAPES, *PLUS_SHAPES, *NLL_SHAPES,
                *WIDE_SHAPES)
KERNELS = ("fwd", "bwd", "bwd_dz", "fwd_bf16", "bwd_bf16", "bwd_dz_bf16")
# bf16 inputs (the trainer's mixed_precision): the kernels read bf16 and
# compute in float32; the plain version runs in float64 on the same bf16
# values. The output is float32 and compared as above; the gradients are
# written in bf16, so each entry carries up to half a bf16 ulp of rounding,
# 2^-8 of itself at most (7 stored bits), beside the float32 error.
BF16_GRAD_RTOL = 2 ** -8 + GRAD_RTOL
# the joint NLLs' importance samples and chunk (the reference's K=1000)
NLL_K, NLL_CHUNK = 1000, 100
# the evaluation phase: labelled test and train rows (PolyMNIST's test set
# has 10,000), the rows of its card-vs-CPU checks, and the top-two logit
# margin under which a classifier's prediction may differ between the two
EVAL_ROWS, EVAL_CHECK_ROWS = 2048, 64
TIE_MARGIN = 1e-4


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def counts(**n):
    """Launch counts of every kernel: those given, 0 for the rest."""
    return {k: n.get(k, 0) for k in KERNELS}


def masked_expert(mq):
    return min(1, mq - 1)


def mixture_inputs(mz, k, b, d, mq, seed=0):
    rng = np.random.default_rng(seed)
    mask = np.ones((mq, b), np.float32)
    mask[masked_expert(mq), : max(b // 3, 2)] = 0.0   # on some columns
    mask[:, 0] = 0.0                                   # a fully masked column
    arrays = (rng.normal(size=(mz, k, b, d)), rng.normal(size=(mq, b, d)),
              rng.uniform(0.5, 1.5, size=(mq, b, d)), mask,
              rng.normal(size=(mz, k, b)))
    return [torch.tensor(np.asarray(a, np.float32), device="cuda") for a in arrays]


def mixture_case(mx, shape, dist):
    """Kernels vs plain on one shape; returns the max abs error of each
    kernel ('fwd', 'bwd', 'bwd_dz') against the plain float32 version."""
    z, mus, sig, mask, g = mixture_inputs(**shape)
    results = {}
    before = dict(mx.launches)
    for name, fn, dtype in (("kernel", mx.mixture_log_density, torch.float32),
                            ("plain", mx.mixture_log_density_plain, torch.float32),
                            ("plain64", mx.mixture_log_density_plain, torch.float64)):
        leaves = [t.to(dtype, copy=True).requires_grad_() for t in (z, mus, sig)]
        out = fn(*leaves, mask.to(dtype), dist)
        grads = torch.autograd.grad(out, leaves, g.to(dtype))
        results[name] = (out.detach(), grads)
    # dz alone (mus and sigmas detached): the dz-only backward kernel
    z_leaf = z.clone().requires_grad_()
    (dz_only,) = torch.autograd.grad(
        mx.mixture_log_density(z_leaf, mus, sig, mask, dist), [z_leaf], g)
    torch.cuda.synchronize()
    check(mx.launches == {**before, "fwd": before["fwd"] + 2, "bwd": before["bwd"] + 1,
                          "bwd_dz": before["bwd_dz"] + 1},
          f"launch counters did not move as expected for {shape} {dist}: "
          f"{before} -> {mx.launches}")
    out_k, grads_k = results["kernel"]
    out_p, grads_p = results["plain"]
    _, grads_64 = results["plain64"]
    check(out_k.shape == out_p.shape, "forward shape differs")
    fwd_err = (out_k - out_p)[..., 1:].abs().max().item()
    names = ("dz", "dmu", "dsig")
    errs = {n: (gk - gp).abs().max().item()
            for n, gk, gp in zip(names, grads_k, grads_p)}
    errs["dz_only"] = (dz_only - grads_p[0]).abs().max().item()
    scale = {n: gp.abs().max().item() for n, gp in zip(names, grads_p)}
    scale["dz_only"] = scale["dz"]
    err64 = {n: ((gk.double() - g64).abs().max().item(),
                 (gp.double() - g64).abs().max().item())
             for n, gk, gp, g64 in zip(names, grads_k, grads_p, grads_64)}
    print(f"  mixture {dist:7s} {shape}: fwd max abs err {fwd_err:.3e} "
          "(fully masked column excluded); grads max abs err / max|plain|: "
          + ", ".join(f"{n} {errs[n]:.3e}/{scale[n]:.3e}" for n in errs)
          + "; vs float64, kernel (plain f32): "
          + ", ".join(f"{n} {a:.2e} ({b:.2e})" for n, (a, b) in err64.items()))
    check(torch.allclose(out_k, out_p, rtol=OUT_RTOL, atol=OUT_ATOL),
          f"forward differs for {shape} {dist}")
    for n, gk in zip(names + ("dz_only",), grads_k + (dz_only,)):
        check(bool(torch.isfinite(gk).all()), f"{n} not finite ({shape} {dist})")
        check(errs[n] <= GRAD_ATOL + GRAD_RTOL * scale[n],
              f"{n} differs for {shape} {dist}")
    dz, dmu, dsig = grads_k
    n_masked = max(shape["b"] // 3, 2)   # columns where one expert is masked
    qm = masked_expert(shape["mq"])
    check(bool((dz[..., 0, :] == 0).all() and (dz_only[..., 0, :] == 0).all()),
          "a fully masked column must get zero dz")
    check(bool((dmu[:, 0] == 0).all() and (dsig[:, 0] == 0).all()),
          "a fully masked column must get zero dmu and dsig")
    check(bool((dmu[qm, :n_masked] == 0).all() and (dsig[qm, :n_masked] == 0).all()),
          "a masked expert must get zero dmu and dsig")
    return {"fwd": fwd_err, "bwd": max(errs[n] for n in names),
            "bwd_dz": errs["dz_only"]}


def mixture_case_bf16(mx, shape, dist):
    """The bf16 kernels on one shape against the plain version in float64 on
    the same bf16 values; returns the max abs error of each ('fwd_bf16',
    'bwd_bf16', 'bwd_dz_bf16'). The output must be float32 and the
    gradients bf16, from the bf16 launches alone."""
    z, mus, sig, mask, g = mixture_inputs(**shape)
    z, mus, sig, mask = (t.bfloat16() for t in (z, mus, sig, mask))
    before = dict(mx.launches)
    leaves = [t.clone().requires_grad_() for t in (z, mus, sig)]
    out_k = mx.mixture_log_density(*leaves, mask, dist)
    grads_k = torch.autograd.grad(out_k, leaves, g)
    z_leaf = z.clone().requires_grad_()
    (dz_only,) = torch.autograd.grad(
        mx.mixture_log_density(z_leaf, mus, sig, mask, dist), [z_leaf], g)
    torch.cuda.synchronize()
    check(mx.launches == {**before, "fwd_bf16": before["fwd_bf16"] + 2,
                          "bwd_bf16": before["bwd_bf16"] + 1,
                          "bwd_dz_bf16": before["bwd_dz_bf16"] + 1},
          f"bf16 launch counters did not move as expected for {shape} {dist}: "
          f"{before} -> {mx.launches}")
    check(out_k.dtype == torch.float32 and all(
        t.dtype == torch.bfloat16 for t in (*grads_k, dz_only)),
        f"bf16 kernels: out {out_k.dtype}, grads {[t.dtype for t in grads_k]}")
    l64 = [t.double().requires_grad_() for t in (z, mus, sig)]
    out_p = mx.mixture_log_density_plain(*l64, mask.double(), dist)
    grads_p = torch.autograd.grad(out_p, l64, g.double())
    # against float64 rounded to float32 (the masked value -1e30 is not a
    # float32 number)
    fwd_err = (out_k - out_p.float())[..., 1:].abs().max().item()
    names = ("dz", "dmu", "dsig")
    errs = {n: (gk.double() - gp).abs().max().item()
            for n, gk, gp in zip(names, grads_k, grads_p)}
    errs["dz_only"] = (dz_only.double() - grads_p[0]).abs().max().item()
    scale = {n: gp.abs().max().item() for n, gp in zip(names, grads_p)}
    scale["dz_only"] = scale["dz"]
    vec = mx._vectorized(shape["d"], z, mus, sig)
    routes = "/".join(mx.route(torch.bfloat16, k, shape["d"], shape["mq"], vec)
                      for k in ("fwd", "bwd_dz", "bwd"))
    print(f"  mixture bf16 {dist:7s} {shape} (route fwd/bwd_dz/bwd {routes}): fwd max "
          f"abs err vs float64 {fwd_err:.3e}; grads max abs err / max|plain|: "
          + ", ".join(f"{n} {errs[n]:.3e}/{scale[n]:.3e}" for n in errs))
    check(torch.allclose(out_k.double(), out_p, rtol=OUT_RTOL, atol=OUT_ATOL),
          f"bf16 forward differs for {shape} {dist}")
    for n, gk in zip(names + ("dz_only",), grads_k + (dz_only,)):
        check(bool(torch.isfinite(gk).all()), f"bf16 {n} not finite ({shape} {dist})")
        check(errs[n] <= GRAD_ATOL + BF16_GRAD_RTOL * scale[n],
              f"bf16 {n} differs for {shape} {dist}")
    dz, dmu, dsig = grads_k
    n_masked = max(shape["b"] // 3, 2)
    qm = masked_expert(shape["mq"])
    check(bool((dz[..., 0, :] == 0).all() and (dz_only[..., 0, :] == 0).all()
               and (dmu[:, 0] == 0).all() and (dsig[:, 0] == 0).all()),
          "bf16: a fully masked column must get zero gradients")
    check(bool((dmu[qm, :n_masked] == 0).all() and (dsig[qm, :n_masked] == 0).all()),
          "bf16: a masked expert must get zero dmu and dsig")
    return {"fwd_bf16": fwd_err, "bwd_bf16": max(errs[n] for n in names),
            "bwd_dz_bf16": errs["dz_only"]}


def forward_kernel_names(mx):
    """The device kernels torch.profiler sees in one CUDA forward call."""
    from torch.profiler import ProfilerActivity, profile

    z, mus, sig, mask, _ = mixture_inputs(**SLICE_SHAPE)
    mx.mixture_log_density(z, mus, sig, mask, "laplace")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        mx.mixture_log_density(z, mus, sig, mask, "laplace")
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def mixture_timing(mx, s=SLICE_SHAPE, dtype=torch.float32):
    """Kernel, plain and bound times at the shapes ``s`` (Laplace), with z,
    mu, sigma and the mask in ``dtype`` (float32, or bfloat16: the keys then
    end in '_bf16')."""
    from multivae_tpu_torch.tools.mixture_sweep import flush_buffer, op_times

    z, mus, sig, mask, g = mixture_inputs(**s)
    z, mus, sig, mask = (t.to(dtype) for t in (z, mus, sig, mask))
    r, b, d, mq = s["mz"] * s["k"], s["b"], s["d"], s["mq"]
    flush = flush_buffer()
    # Each op is one launch of its kernel: the forward reads sigma itself.
    kernel = op_times(mx.mixture_log_density, z, mus, sig, mask, g, flush)
    plain = op_times(mx.mixture_log_density_plain, z, mus, sig, mask, g, flush)
    e = z.element_size()   # z, mu, sigma, mask, dz, dmu, dsig; the rest float32
    big, small = r * b * d, mq * b * d        # z (and dz); mu, sigma (dmu, dsig)
    fwd_bytes = e * (big + 2 * small + mq * b) + 4 * (mq * b + r * b)  # + logc, out
    dz_bytes = e * (2 * big + 2 * small + mq * b) + 4 * (mq * b + 2 * r * b)  # + g
    bwd_bytes = dz_bytes + e * 2 * small      # + dmu, dsig
    terms = r * b * mq * d

    def bound(nbytes, ops):
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        t_ops = ops / PEAK_F32_OPS_PER_S * 1e3
        return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")

    work = {"fwd": (fwd_bytes, FWD_OPS_PER_TERM * terms),
            "bwd": (bwd_bytes, BWD_OPS_PER_TERM * terms),
            "bwd_dz": (dz_bytes, DZ_OPS_PER_TERM * terms)}
    suffix = "" if dtype == torch.float32 else "_bf16"
    return {k + suffix: (kernel[k], plain[k], *bound(*work[k])) for k in work}


def _profiled_ms(fn, flush, reps=20):
    """Median device duration (ms) of the mixture kernel that one call of
    ``fn`` launches, from torch.profiler over ``reps`` calls, each after a
    ``zero_()`` flush; None where the profiler saw no such kernel."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA and "mixture" in e.name]
    return statistics.median(us) / 1e3 if len(us) == reps else None


def fixed_cost(mx, dtype=torch.float32, s=SLICE_SHAPE):
    """Where a timed call of each mixture kernel goes at the shapes ``s``
    (Laplace): the yardstick (``time_ms``: events around one call after a
    256 MB ``zero_()`` flush, which leaves the L2 full of dirty lines), the
    same after a read-only flush (a sum over the buffer: the L2 clean), the
    kernel's own duration from torch.profiler, and the event window around
    an empty kernel launched through the same ctypes path, after either
    flush. Keys end in '_bf16' for bf16."""
    from multivae_tpu_torch.tools.mixture_sweep import flush_buffer, op_calls, time_ms

    z, mus, sig, mask, g = mixture_inputs(**s)
    z, mus, sig, mask = (t.to(dtype) for t in (z, mus, sig, mask))
    flush = flush_buffer()
    lib = mx._lib(torch.bfloat16)

    def empty():
        mx._raise_on(lib.mixture_empty(torch.cuda.current_stream().cuda_stream),
                     "mixture_empty")

    suffix = "" if dtype == torch.float32 else "_bf16"
    record = {"empty_kernel": {"zero_flush_ms": time_ms(empty, flush),
                               "read_flush_ms": time_ms(empty, flush, read_only=True)}}
    for k, fn in op_calls(mx.mixture_log_density, z, mus, sig, mask, g).items():
        record[k + suffix] = {"yardstick_ms": time_ms(fn, flush),
                              "read_flush_ms": time_ms(fn, flush, read_only=True),
                              "profiler_kernel_ms": _profiled_ms(fn, flush)}
    print(f"  fixed cost at the slice ({dtype}): empty kernel "
          f"{record['empty_kernel']['zero_flush_ms']:.4f} ms after the zero_() flush, "
          f"{record['empty_kernel']['read_flush_ms']:.4f} ms after the read-only one")
    for k, v in record.items():
        if k != "empty_kernel":
            print(f"    mixture_{k}: yardstick {v['yardstick_ms']:.4f} ms, read-only flush "
                  f"{v['read_flush_ms']:.4f} ms, kernel alone (profiler) "
                  + ("not measured" if v["profiler_kernel_ms"] is None
                     else f"{v['profiler_kernel_ms']:.4f} ms"))
    return record


def bf16_routes(mx):
    """The bf16 forward, dz-only and full backward at the slice,
    ``mmvaeplus_k10`` and ``cmvae_polymnist`` (``PLUS_SHAPES[0]``) shapes
    must take the tensor-copy design: by the plan (``launch_shape``'s
    route) and by the device kernel torch.profiler sees in one call
    (exactly one, ``mixture_tma_kernel``)."""
    from torch.profiler import ProfilerActivity, profile

    from multivae_tpu_torch.tools.mixture_sweep import op_calls

    for label, sh in (("slice", SLICE_SHAPE), ("mmvaeplus_k10", K10_SHAPE),
                      ("cmvae_polymnist", PLUS_SHAPES[0])):
        z, mus, sig, mask, g = (t.bfloat16() if i < 4 else t
                                for i, t in enumerate(mixture_inputs(**sh)))
        calls = op_calls(mx.mixture_log_density, z, mus, sig, mask, g)
        for mode in ("fwd", "bwd_dz", "bwd"):
            plan = mx.launch_shape(sh["mz"] * sh["k"], sh["b"], sh["d"], sh["mq"], mode,
                                   dtype=torch.bfloat16)
            names = []
            for _ in range(3):  # a profile that saw no device activity at all is taken again
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    calls[mode]()
                    torch.cuda.synchronize()
                names = [e.name for e in prof.events()
                         if e.device_type == torch.autograd.DeviceType.CUDA]
                if names:
                    break
            print(f"  bf16 {mode} at the {label} shape: {json.dumps(plan)}; kernels {names}")
            check(plan["route"] == "tma",
                  f"bf16 {mode} at the {label} shape takes the {plan['route']} route")
            check(len(names) == 1 and "mixture_tma_kernel" in names[0],
                  f"bf16 {mode} at the {label} shape ran {names}, not the tma kernel")


# the full backward's bit-equal reruns: the slice (one block a column),
# mmvaeplus_k10 (a column over a cluster of 7 blocks) and the R=500 NLL
# shape (clusters of 3 blocks, each in two rounds of 84 rows)
DETERMINISM_SHAPES = (SLICE_SHAPE, K10_SHAPE, NLL_SHAPES[0])


def bf16_determinism(mx):
    """Two bf16 full backward calls on the same inputs give bit-equal dz,
    dmu and dsig, Laplace and Normal, at each of ``DETERMINISM_SHAPES``;
    returns the plan of each shape."""
    plans = {}
    for sh in DETERMINISM_SHAPES:
        z, mus, sig, mask, g = (t.bfloat16() if i < 4 else t
                                for i, t in enumerate(mixture_inputs(**sh, seed=5)))
        plan = mx.launch_shape(sh["mz"] * sh["k"], sh["b"], sh["d"], sh["mq"], "bwd",
                               dtype=torch.bfloat16)
        plans[f"R={sh['mz'] * sh['k']},B={sh['b']},D={sh['d']}"] = plan
        for dist in ("laplace", "normal"):
            leaves = [t.clone().requires_grad_() for t in (z, mus, sig)]
            out = mx.mixture_log_density(*leaves, mask, dist)
            first = torch.autograd.grad(out, leaves, g, retain_graph=True)
            second = torch.autograd.grad(out, leaves, g)
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in zip(first, second)),
                  f"bf16 full backward reruns differ at {sh} {dist} (plan {plan})")
        print(f"  bf16 full backward bit-equal on a rerun at {sh}: plan {json.dumps(plan)}")
    return plans


def bf16_kernels(mx):
    """The bf16 kernels against the plain version in float64 at every
    checked shape, their routes, the full backward's reruns, their times at
    the slice, ``mmvaeplus_k10`` and ``cmvae_polymnist`` shapes and the
    fixed cost at the slice, printed. Returns (their max abs errors, their
    times at the slice)."""
    errs = {"fwd_bf16": 0.0, "bwd_bf16": 0.0, "bwd_dz_bf16": 0.0}
    failures = []
    for shape in CHECK_SHAPES:
        for dist_name in ("laplace", "normal"):
            try:
                case = mixture_case_bf16(mx, shape, dist_name)
            except SmokeFailure as e:
                failures.append(str(e))
                continue
            errs = {k: max(errs[k], v) for k, v in case.items()}
    check(not failures, "; ".join(failures))
    bf16_routes(mx)
    bf16_determinism(mx)
    timing = mixture_timing(mx, SLICE_SHAPE, torch.bfloat16)
    for label, shape, times in (("slice", SLICE_SHAPE, timing),
                                ("mmvaeplus_k10", K10_SHAPE,
                                 mixture_timing(mx, K10_SHAPE, torch.bfloat16)),
                                ("cmvae_polymnist", PLUS_SHAPES[0],
                                 mixture_timing(mx, PLUS_SHAPES[0], torch.bfloat16))):
        print(f"  bf16 at the {label} shape {shape}:")
        for kname, (ms, plain_ms, bound_ms, bound_by) in times.items():
            print(f"    mixture_{kname}: {ms:.4f} ms (plain {plain_ms:.4f} ms, "
                  f"bound {bound_ms:.4f} ms by {bound_by}, {100 * bound_ms / ms:.1f}% of bound)")
    fixed_cost(mx, torch.bfloat16)
    return errs, timing


def ptxas_summary(report):
    """(kernel instance, registers, spill store bytes, spill load bytes) from
    the compiler's -Xptxas -v report: mixture.cu's kernels and the bf16
    tensor-copy kernels of mixture_bf16.cu."""
    pat = re.compile(r"mixture_kernelI(f|13__nv_bfloat16)Lb(\d)ELi(\d+)ELi(\d+)ELi(\d)"
                     r"ELb(\d)ELb(\d)E")
    tma = re.compile(r"mixture_tma_kernelILb(\d)ELi(\d+)ELi(\d)E")
    modes = ("fwd", "bwd_dz", "bwd")
    rows, name, spill = [], None, (0, 0)
    for line in report.splitlines():
        m, mt = pat.search(line), tma.search(line)
        if "Function properties for" in line and m:
            elem, lap, q, w, mode, chunked, stream = m.groups()
            name = (f"{'laplace' if lap == '1' else 'normal'} {modes[int(mode)]} "
                    f"MQ={'chunks of ' if chunked == '1' else ''}{q} "
                    f"{'16-byte' if w != '1' else 'scalar'}"
                    f"{' streaming' if stream == '1' else ''}"
                    f"{'' if elem == 'f' else ' bf16'}")
        elif "Function properties for" in line and mt:
            lap, q, mode = mt.groups()
            name = (f"{'laplace' if lap == '1' else 'normal'} {modes[int(mode)]} "
                    f"MQ={q} bf16 tensor-copy")
        elif name and "spill stores" in line:
            nums = re.findall(r"(\d+) bytes spill", line)
            spill = (int(nums[0]), int(nums[1]))
        elif name and "Used" in line and "registers" in line:
            regs = int(re.search(r"Used (\d+) registers", line).group(1))
            rows.append((name, regs, *spill))
            name, spill = None, (0, 0)
    return rows


def slice_run(mx, n_mods=5, shape=(3, 28, 28), n=2048, latent_dim=512, K=10,
              batch_size=256, epochs=2, device="cuda", loss="dreg_looser"):
    """Train the MMVAE slice with BaseTrainer (defaults: full width, DReG).

    DReG evaluates the mixture twice a step with the posteriors detached:
    two forward launches and one dz-only backward. IWAE evaluates it once
    with gradients to the posteriors: one forward and one full backward."""
    from multivae_tpu_torch.data import MultimodalBaseDataset, batch_from_arrays
    from multivae_tpu_torch.models import MMVAE, MMVAEConfig
    from multivae_tpu_torch.ops.kdist import dist_rsample_k, sample_noise
    from multivae_tpu_torch.trainers import BaseTrainer, BaseTrainerConfig

    rng = np.random.default_rng(0)
    data = {f"m{i}": rng.random((n, *shape), dtype=np.float32)
            for i in range(n_mods)}
    config = MMVAEConfig(
        n_modalities=n_mods, latent_dim=latent_dim, K=K,
        input_dims={m: shape for m in data},
        decoders_dist={m: "laplace" for m in data},
        prior_and_posterior_dist="laplace_with_softmax", loss=loss)
    model = MMVAE(config, seed=0, device=device)
    trainer = BaseTrainer(model, MultimodalBaseDataset(data), device=device,
                          training_config=BaseTrainerConfig(
                              output_dir=os.path.join(ROOT, "build", "chip_smoke"),
                              per_device_train_batch_size=batch_size,
                              num_epochs=epochs, learning_rate=1e-3,
                              optimizer_cls="Adam", seed=0))
    step_ends = []

    def on_step(*_):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        step_ends.append(ev)

    trainer.optimizer.register_step_post_hook(on_step)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mx.reset_launches()
    t0 = time.perf_counter()
    trainer.train()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = dict(mx.launches)

    steps = len(step_ends)
    losses = [h["train_epoch_loss"] for h in trainer.history]
    expected_steps = epochs * -(-n // batch_size)
    check(steps == expected_steps, f"expected {expected_steps} steps, ran {steps}")
    check(all(np.isfinite(losses)), f"non-finite epoch loss: {losses}")
    expected = (counts(fwd=2 * steps, bwd_dz=steps) if loss == "dreg_looser"
                else counts(fwd=steps, bwd=steps))
    check(launches == expected,
          f"{loss}: expected {expected} launches, got {launches}")
    steps_per_s = (steps - 1) / (step_ends[0].elapsed_time(step_ends[-1]) / 1e3)
    peak_bytes = torch.cuda.max_memory_allocated()

    # The trained model's loss on 8 rows: card (kernel) vs CPU (plain).
    rows = {m: v[:8] for m, v in data.items()}
    noise_gen = torch.Generator().manual_seed(1)
    u = {m: sample_noise(model.dist_name, (K, 8, latent_dim), generator=noise_gen)
         for m in data}

    def small_loss(net, device, dtype=torch.float32):
        batch = batch_from_arrays(
            {m: v.astype(np.float64 if dtype == torch.float64 else np.float32)
             for m, v in rows.items()}).to(device)
        with torch.no_grad():
            post = net._posterior_params(batch)
            zs = {m: dist_rsample_k(net.dist_name, mu, sig, K,
                                    u=u[m].to(device, dtype))
                  for m, (mu, sig) in post.items()}
            return getattr(net, f"_{loss}")(batch, post, zs)["loss"].item()

    loss_card = small_loss(model, device)
    loss_cpu = small_loss(copy.deepcopy(model).to("cpu"), "cpu")
    # float64 on the CPU: the yardstick for both float32 evaluations
    loss_cpu64 = small_loss(copy.deepcopy(model).to("cpu").double(), "cpu",
                            torch.float64)
    check(np.isfinite(loss_card), "small-input loss is not finite")
    check(abs(loss_card - loss_cpu) <= LOSS_RTOL * abs(loss_cpu),
          f"small-input loss card {loss_card} vs cpu {loss_cpu}")
    return {"steps": steps, "epoch_losses": losses, "steps_per_s": steps_per_s,
            "peak_mem_bytes": peak_bytes, "wall_s": wall_s,
            "small_loss_card": loss_card, "small_loss_cpu": loss_cpu,
            "small_loss_cpu_float64": loss_cpu64}, launches


@contextlib.contextmanager
def injected_noise(model, draws, dtype=torch.float32):
    """Make ``model.draw_noise`` return ``draws`` in order (on the model's
    device, in ``dtype``), checking each shape, and the model's other draw
    hooks return fixed choices."""
    queue = list(draws)

    def draw(shape, generator=None):
        u = queue.pop(0)
        check(tuple(u.shape) == tuple(shape), f"noise {tuple(u.shape)} != {shape}")
        return u.to(model.device, dtype)

    # the other random choices, made the same on both sides: the last
    # expert, the most likely subset of each row (MoPoE), the first
    # candidate subsets (MVAE), clusters in turn (CMVAE) and a fixed forced
    # dropout (Nexus)
    def dropout(n_mods, n_rows, generator=None):
        # Nexus's forced dropout: every other row drops out and keeps
        # 1 .. M-1 messages, chosen by fixed scores
        rows, mods = torch.arange(n_rows), torch.arange(n_mods)
        scores = ((mods[:, None] * 7 + rows[None]) % n_mods).float() / n_mods
        return ((rows % 2 == 0).to(model.device), (1 + rows % max(n_mods - 1, 1)).to(
            model.device), scores.to(model.device, dtype))

    hooks = {"draw_noise": draw, "draw_expert": lambda n, generator=None: n - 1,
             "draw_dropout": dropout,
             "draw_components": lambda logits, generator=None: logits.argmax(-1),
             "draw_subsets": lambda n, k, generator=None: torch.arange(k, device=model.device),
             "draw_clusters": lambda logits, n, generator=None: (
                 torch.arange(n, device=model.device) % logits.shape[-1])}
    for k, v in hooks.items():
        setattr(model, k, v)
    try:
        yield
    finally:
        for k in hooks:
            delattr(model, k)
    check(not queue, f"{len(queue)} noise draws left unused")


def recorded_draws(model, fn, seed):
    """Noise of the shapes and the distribution ``fn(model, float32)``
    draws on the card (a dry run), made on the CPU from ``seed``."""
    from multivae_tpu_torch.ops.kdist import sample_noise

    shapes = []

    def record(shape, generator=None):
        shapes.append(tuple(shape))
        return type(model).draw_noise(model, shape)

    model.draw_noise = record
    try:
        with torch.no_grad():
            fn(model, torch.float32)
    finally:
        del model.draw_noise
    gen = torch.Generator().manual_seed(seed)
    dist = getattr(model, "dist_name", "normal")
    return [sample_noise(dist, shape, generator=gen) for shape in shapes]


def card_vs_cpu(model, fn, draws):
    """``fn(net, dtype)`` on the card, on a float32 CPU copy and on a
    float64 CPU copy of ``model``, each fed ``draws`` as its noise."""
    values = {}
    for key, device, dtype in (("card", None, torch.float32),
                               ("cpu", "cpu", torch.float32),
                               ("cpu_float64", "cpu", torch.float64)):
        net = model if device is None else copy.deepcopy(model).to(device, dtype)
        check(net.device.type == (device or "cuda"), f"{key} model on {net.device}")
        with injected_noise(net, draws, dtype), torch.no_grad():
            values[key] = float(fn(net, dtype))
    check(np.isfinite(values["card"]), f"card value is not finite: {values}")
    check(abs(values["card"] - values["cpu"]) <= LOSS_RTOL * abs(values["cpu"]),
          f"card {values['card']} vs cpu {values['cpu']}")
    return values


def rows_batch(dataset, idx, dtype=torch.float32):
    from multivae_tpu_torch.data import batch_from_arrays
    from multivae_tpu_torch.data.batch import map_leaves

    raw = dataset.get_batch(idx)
    np_dtype = np.float64 if dtype == torch.float64 else np.float32

    def cast(v):   # floats to ``dtype``; a text modality's tokens stay integers
        return v.astype(np_dtype) if np.issubdtype(v.dtype, np.floating) else v

    return batch_from_arrays({m: map_leaves(cast, v) for m, v in raw["data"].items()},
                             masks=raw.get("masks"))


def workload_run(mx, name, n=2048, epochs=2, device="cuda", per_step=None,
                 eval_fwd=None, workload=None, small_check=True):
    """Train a workload of ``tools/workloads.py`` (or ``workload``, built
    already, named ``name``) with its trainer (BaseTrainer unless it names
    another); returns (the phase's JSON record, the workload, the mixture
    launches). The kernels must launch
    ``per_step`` times (forward, full and dz-only backward) on each train
    step and ``eval_fwd`` forwards (default: the train step's) on each eval
    step: none on the MVTCAE workloads.
    The steps are counted by a hook on the optimizer, set again on the new
    optimizer of a ``MultistageTrainer`` reset; a two-stage model's steps/s
    are also given for each stage, and its 8-row loss is checked card vs CPU
    in stage 1 too (``small_check=False``: no card-vs-CPU check)."""
    from multivae_tpu_torch.tools import workloads
    from multivae_tpu_torch.trainers import BaseTrainer, BaseTrainerConfig

    per_step = per_step or {}
    w = workload or workloads.build(name, n=n, device=device)
    trainer = (w.trainer_cls or BaseTrainer)(
        w.model, w.train, w.eval, device=device,
        training_config=BaseTrainerConfig(
            output_dir=os.path.join(ROOT, "build", "chip_smoke"),
            num_epochs=epochs, seed=0, **w.trainer_kwargs))
    step_ends = []   # (epoch, CUDA event after the optimizer step)
    optimizers = []  # each optimizer the run stepped with

    def on_step(*_):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        step_ends.append((len(trainer.history), ev))

    def hook_optimizer():
        if not optimizers or optimizers[-1] is not trainer.optimizer:
            trainer.optimizer.register_step_post_hook(on_step)
            optimizers.append(trainer.optimizer)

    prepare = trainer.prepare_train_step

    def prepare_and_hook(*args):
        out = prepare(*args)
        hook_optimizer()
        return out

    hook_optimizer()
    trainer.prepare_train_step = prepare_and_hook
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()   # earlier phases' models, this model
    mx.reset_launches()
    t0 = time.perf_counter()
    trainer.train()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = dict(mx.launches)

    losses = [h["train_epoch_loss"] for h in trainer.history]
    expected_steps = epochs * len(trainer.train_loader)
    check(len(step_ends) == expected_steps,
          f"expected {expected_steps} steps, ran {len(step_ends)}")
    eval_steps = 0 if w.eval is None else epochs * len(trainer.eval_loader)
    expected = {k: per_step.get(k, 0) * expected_steps for k in KERNELS}
    expected["fwd"] += (per_step.get("fwd", 0) if eval_fwd is None else eval_fwd) * eval_steps
    check(launches == expected, f"{name}: expected {expected} launches, got {launches}")
    check(all(np.isfinite(losses)), f"non-finite epoch loss: {losses}")
    resets = [e for e in getattr(w.model, "reset_optimizer_epochs", []) if e <= epochs]
    check(len(optimizers) == 1 + len(resets),
          f"{name}: {len(optimizers) - 1} optimizer resets, expected {resets}")
    # time between consecutive steps of one epoch: the first step and the
    # epoch ends (eval pass, loss fetch) stay out
    gaps = [(ea, a.elapsed_time(b)) for (ea, a), (eb, b) in zip(step_ends, step_ends[1:])
            if ea == eb]
    record = {"phase": name, "steps": len(step_ends), "eval_steps": eval_steps,
              "epoch_losses": losses,
              "steps_per_s": len(gaps) / (sum(g for _, g in gaps) / 1e3),
              "peak_mem_bytes": torch.cuda.max_memory_allocated(),
              "peak_above_held_bytes": torch.cuda.max_memory_allocated() - held,
              "wall_s": wall_s, "launches": launches,
              "training_dir": trainer.training_dir}
    if resets:
        record.update(optimizer_resets=resets, final_stage=w.model.current_stage)
        by_stage = {}
        for epoch, gap in gaps:   # epoch: 0-based
            by_stage.setdefault(w.model.stage_for_epoch(epoch + 1), []).append(gap)
        record["steps_per_s_by_stage"] = {
            stage: len(g) / (sum(g) / 1e3) for stage, g in sorted(by_stage.items())}
    if w.eval is not None:
        record["eval_losses"] = [h["eval_epoch_loss"] for h in trainer.history]
        record["lr"] = trainer.optimizer.param_groups[0]["lr"]
    if trainer.training_config.cache_on_device:
        record["device_cache"] = {"train": trainer._train_cache is not None,
                                  "eval": trainer._eval_cache is not None}

    if not small_check:
        return record, w, launches

    # the trained model's loss on 8 rows (incomplete sets: row 5 has no modality)
    def small_loss(net, dtype):
        return net.loss_function(rows_batch(w.train, np.arange(8), dtype)
                                 .to(net.device))["loss"]

    loss = card_vs_cpu(w.model, small_loss, recorded_draws(w.model, small_loss, 1))
    record.update({f"small_loss_{k}": v for k, v in loss.items()})
    if resets:
        final = w.model.current_stage
        w.model.set_stage(1)
        try:
            loss = card_vs_cpu(w.model, small_loss, recorded_draws(w.model, small_loss, 1))
        finally:
            w.model.set_stage(final)
        record.update({f"small_loss_stage1_{k}": v for k, v in loss.items()})
    return record, w, launches


def timed(fn, repeats):
    """(value of the last call, median wall seconds of ``repeats`` calls
    after a warm-up call, the warm-up's seconds); each call ends in a host
    fetch of its value."""
    times = []
    for _ in range(repeats + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        value = fn().sum().item()
        times.append(time.perf_counter() - t0)
        check(np.isfinite(value), f"non-finite value {value}")
    return value, float(np.median(times[1:])), times[0]


def inference_surface(name, model, rows):
    """encode (N=10, flatten; the private codes too), predict (N=10),
    generate_from_prior(64) + decode, all finite and of the right shapes,
    and the refusal to encode a subset missing in a row. The conditioning
    subset is the first two modalities (the first alone for TELBO, which
    encodes no other proper subset)."""
    from multivae_tpu_torch.data import IncompleteDataset

    dims = model.input_dims
    mods = list(dims)
    cond = mods[:1] if model.model_name == "TELBO" else mods[:2]
    n = len(rows["data"][mods[0]])
    with torch.no_grad():
        enc = model.encode(rows, cond_mod=cond, N=10, flatten=True)
        check(enc.z.shape == (10 * n, model.latent_dim), f"{name} encode {enc.z.shape}")
        outputs = [enc.z]
        if model.multiple_latent_spaces:
            for m in dims:
                check(enc.modalities_z[m].shape == (10 * n, model.style_dims[m]),
                      f"{name} encode private {m}")
            outputs += list(enc.modalities_z.values())
        pred = model.predict(rows, cond_mod=cond, gen_mod="all", N=10)
        prior = model.generate_from_prior(64)
        # MMVAE+ samples the full (shared, private) code from its prior
        width = model.latent_dim + (model.modalities_specific_dim
                                    if model.model_name == "MMVAEPlus" else 0)
        check(prior.z.shape == (64, width), f"{name} prior {prior.z.shape}")
        decoded = model.decode(prior)
        for m, d in dims.items():
            check(pred[m].shape == (10, n, *d), f"{name} predict {m} {pred[m].shape}")
            check(decoded[m].shape == (64, *d), f"{name} prior {m} {decoded[m].shape}")
        check(all(bool(torch.isfinite(t).all()) for t in
                  [*outputs, *pred.values(), *decoded.values()]), f"{name}: non-finite")
    masks = {m: np.ones(n, bool) for m in dims}
    masks[mods[0]][0] = False
    try:
        model.encode(IncompleteDataset(rows["data"], masks), cond_mod=mods[0])
        check(False, f"{name}: encode accepted an incomplete subset")
    except AttributeError:
        pass


def nll_phase(mx, name, model, complete, method, n_rows, per_call, K, batch_size_K,
              repeats):
    """Time ``model.compute_<method>`` on ``n_rows`` rows of ``complete``
    (median of ``repeats`` after a warm-up), with its peak device memory;
    the mixture forward must launch ``per_call`` times a call and nothing
    else; then the same estimator on 8 rows with K=20, card vs CPU on the
    same noise. Returns (the record, the launches)."""
    from multivae_tpu_torch.data import MultimodalBaseDataset

    fn = getattr(model, f"compute_{method}")
    data = MultimodalBaseDataset(complete.get_batch(np.arange(n_rows))["data"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    mx.reset_launches()
    value, seconds, warmup = timed(lambda: fn(data, K=K, batch_size_K=batch_size_K),
                                   repeats)
    launches = dict(mx.launches)
    peak = torch.cuda.max_memory_allocated()
    expected = counts(fwd=(repeats + 1) * per_call)
    check(launches == expected, f"{name} {method}: expected {expected}, got {launches}")
    # 8 rows, K=20, the same noise (and choices) on both sides
    eight = MultimodalBaseDataset(complete.get_batch(np.arange(8))["data"])

    def small(net, dtype):
        return getattr(net, f"compute_{method}")(rows_batch(eight, np.arange(8), dtype),
                                                  K=20, batch_size_K=8).sum()

    return {"rows": n_rows, "nll": value, "seconds": seconds, "warmup_s": warmup,
            "peak_mem_bytes": peak, "peak_above_held_bytes": peak - held,
            "fwd_launches_per_call": per_call,
            **{f"small_{k}": v for k, v in card_vs_cpu(
                model, small, recorded_draws(model, small, 2)).items()}}, launches


def inference_phase(mx, phase, trained, nll_plan, K=None, batch_size_K=None, repeats=3,
                    cluster_rows=256):
    """On each trained workload: the inference surface (no mixture launch),
    then each joint NLL of ``nll_plan[name]``, a list of (estimator, rows,
    forward launches per call), timed with its peak memory and checked card
    vs CPU on 8 rows (``nll_phase``); CMVAE's cluster calls on
    ``cluster_rows`` rows. Returns (the JSON record, the mixture launches
    of the NLL calls)."""
    from multivae_tpu_torch.data import MultimodalBaseDataset

    K, batch_size_K = K or NLL_K, batch_size_K or NLL_CHUNK
    record = {"phase": phase, "K": K, "batch_size_K": batch_size_K}
    total = {k: 0 for k in KERNELS}
    for name, w in trained.items():
        model = w.model
        complete = w.eval if w.eval is not None else w.train
        mx.reset_launches()
        inference_surface(name, model, complete.get_batch(np.arange(min(256, len(complete)))))
        check(not any(mx.launches.values()), f"{name} encode/predict launched {mx.launches}")
        record[name] = {}
        for method, n_rows, per_call in nll_plan[name]:
            record[name][method], launches = nll_phase(
                mx, name, model, complete, method, n_rows, per_call, K, batch_size_K,
                repeats)
            total = {k: total[k] + launches[k] for k in KERNELS}
        if name.startswith("cmvae"):
            record[name].update(cluster_phase(mx, model, MultimodalBaseDataset(
                complete.get_batch(np.arange(cluster_rows))["data"])))
    return record, total


def cluster_phase(mx, model, data):
    """CMVAE's ``predict_clusters`` and ``prune_clusters`` (batches of 128)
    on ``data``: valid clusters, posteriors that sum to 1, a kept count in
    [2, C] with -inf on exactly the removed clusters, no mixture launch."""
    C = model.model_config.number_of_clusters
    mx.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pred = model.predict_clusters(data.get_batch(np.arange(len(data))), compute_lliks=True)
    clusters = pred.clusters.cpu().numpy()
    predict_s = time.perf_counter() - t0
    check(clusters.shape == (len(data),) and ((0 <= clusters) & (clusters < C)).all(),
          f"predict_clusters gave {clusters}")
    for m, pc_z in pred.pc_zs.items():
        check(bool(torch.allclose(pc_z.sum(0), torch.ones_like(pc_z[0]), atol=1e-5)),
              f"q(c|z) of {m} does not sum to 1")
    check(bool(torch.isfinite(pred.norm_lliks).all()), "norm_lliks not finite")
    t0 = time.perf_counter()
    entropies = model.prune_clusters(data, batch_size=128)
    prune_s = time.perf_counter() - t0
    pc = model.pc_params.detach().cpu().numpy()
    check(2 <= model.n_clusters <= C and np.isinf(pc).sum() == C - model.n_clusters,
          f"prune_clusters kept {model.n_clusters}, pc_params {pc}")
    check(not any(mx.launches.values()), f"cluster calls launched {mx.launches}")
    return {"predict_clusters": {"rows": len(data), "seconds": predict_s,
                                 "n_distinct": int(len(np.unique(clusters)))},
            "prune_clusters": {"rows": len(data), "seconds": prune_s,
                               "n_clusters": model.n_clusters,
                               "entropy_kept": entropies[model.n_clusters]}}


def cvae_surface(w):
    """The trained CVAE: predict from all modalities (N=10) and from the
    prior of the conditioning ones, generate_from_prior (N=3, flatten) +
    decode; finite, of the right shapes. Returns its JSON record."""
    model = w.model
    rows = w.train.get_batch(np.arange(64))
    cond = {m: rows["data"][m] for m in model.conditioning_modalities}
    target = tuple(model.model_config.input_dims[model.main_modality])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        from_all = model.predict(rows, cond_mod="all", N=10)[model.main_modality]
        from_prior = model.predict(rows, cond_mod=list(cond))[model.main_modality]
        decoded = model.decode(model.generate_from_prior(cond, N=3, flatten=True))
    outputs = (from_all, from_prior, decoded.reconstruction)
    check([tuple(t.shape) for t in outputs] == [(10, 64, *target), (64, *target),
                                                (3 * 64, *target)],
          f"cvae shapes {[tuple(t.shape) for t in outputs]}")
    check(all(bool(torch.isfinite(t).all()) for t in outputs), "cvae: non-finite")
    return {"rows": 64, "seconds": time.perf_counter() - t0}


def _hmc_hooks(net, expert, noise, uniform):
    """Feed ``net`` (JNF) the given draws in order."""
    queues = {"noise": list(noise), "uniform": list(uniform)}

    def draw(kind, shape):
        u = queues[kind].pop(0)
        check(tuple(u.shape) == tuple(shape), f"{kind} {tuple(u.shape)} != {shape}")
        return u.to(net.device)

    hooks = {"draw_noise": lambda shape, generator=None: draw("noise", shape),
             "draw_uniform": lambda shape, generator=None: draw("uniform", shape),
             "draw_experts": lambda n, rows, generator=None: expert.to(net.device)}
    for k, v in hooks.items():
        setattr(net, k, v)
    return hooks, queues


def jnf_encode_card_vs_cpu(model, batch, cond, mcmc_steps=0):
    """JNF's encode of ``batch`` from ``cond`` on the card and on a float32
    CPU copy, fed the same draws (the expert per row, the start's noise,
    each HMC step's momentum and uniforms): the largest difference of z
    beside max|z|, and for HMC both runs' accept decisions, which must
    agree, and the smallest |u - alpha| of the CPU run (alpha: the chain's
    Metropolis ratios, ``last_hmc_ratios``)."""
    gen = torch.Generator().manual_seed(3)
    n, d = batch.n_samples, model.latent_dim
    expert = torch.randint(len(cond), (n,), generator=gen)
    noise = [torch.randn(n, d, generator=gen) for _ in range(1 + mcmc_steps)]
    uniform = [torch.rand(n, generator=gen) for _ in range(mcmc_steps)]
    out = {}
    for key, net in (("card", model), ("cpu", copy.deepcopy(model).to("cpu"))):
        hooks, queues = _hmc_hooks(net, expert, noise, uniform)
        try:
            z = net.encode(batch, cond_mod=list(cond), mcmc_steps=mcmc_steps).z.cpu()
        finally:
            for k in hooks:
                delattr(net, k)
        check(not any(queues.values()), f"draws left unused: {queues}")
        tests = list(zip(uniform, net.last_hmc_ratios.cpu())) if mcmc_steps else []
        out[key] = (z, tests)
    (z_card, t_card), (z_cpu, t_cpu) = out["card"], out["cpu"]
    err, scale = (z_card - z_cpu).abs().max().item(), z_cpu.abs().max().item()
    record = {"rows": n, "cond_mod": list(cond), "max_abs_err": err, "max_abs_z": scale}
    check(bool(torch.isfinite(z_card).all()), "jnf encode: non-finite z")
    check(err <= ENCODE_RTOL * scale, f"jnf encode {cond}: card vs cpu {err} (max|z| {scale})")
    if mcmc_steps:
        accepts = [torch.equal(uc < ac, up < ap) for (uc, ac), (up, ap) in zip(t_card, t_cpu)]
        check(len(t_card) == len(t_cpu) == mcmc_steps and all(accepts),
              "jnf HMC: the card and the CPU decided an accept test differently")
        record.update(mcmc_steps=mcmc_steps,
                      accepted=int(sum((u < a).sum().item() for u, a in t_cpu)),
                      tests=mcmc_steps * n,
                      min_margin=min((u - a).abs().min().item() for u, a in t_cpu))
    return record


def jnf_inference(mx, w, rows=256, hmc_rows=64, repeats=3):
    """The trained JNF: the K=1000 joint NLL on ``rows`` rows (seconds,
    peak, and 8 rows with K=20 card vs CPU); encode from one modality on
    ``rows`` rows (2 x 512 sequential MADE passes) and from two modalities
    by HMC at the defaults (100 steps of 10 leapfrog steps) on
    ``hmc_rows`` rows, timed, and predict from those two; card vs CPU on
    8 rows with the draws injected: the one-modality encode, and the HMC at
    5 steps, whose accept decisions must agree. No mixture launch."""
    model, data = w.model, w.train
    mods = list(model.input_dims)
    record = {"phase": "jnf_inference"}
    record["joint_nll"], _ = nll_phase(mx, "jnf_conv", model, data, "joint_nll", rows, 0,
                                       NLL_K, NLL_CHUNK, repeats)
    mx.reset_launches()
    batch = rows_batch(data, np.arange(rows))
    sub = rows_batch(data, np.arange(hmc_rows))
    for label, rows_, cond, reps in (("encode_one", batch, mods[:1], repeats),
                                     ("encode_hmc", sub, mods[:2], 1)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        _, seconds, warmup = timed(lambda: model.encode(rows_, cond_mod=cond).z, reps)
        record[label] = {"rows": rows_.n_samples, "cond_mod": cond, "seconds": seconds,
                         "warmup_s": warmup,
                         "peak_above_held_bytes": torch.cuda.max_memory_allocated() - held}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pred = model.predict(sub, cond_mod=mods[:2], gen_mod="all")
    torch.cuda.synchronize()
    record["predict_hmc"] = {"rows": hmc_rows, "seconds": time.perf_counter() - t0}
    for m, d in model.input_dims.items():
        check(pred[m].shape == (hmc_rows, *d) and bool(torch.isfinite(pred[m]).all()),
              f"jnf predict {m}: {tuple(pred[m].shape)}")
    eight = rows_batch(data, np.arange(8))
    record["encode_one_card_vs_cpu"] = jnf_encode_card_vs_cpu(model, eight, mods[:1])
    record["hmc_card_vs_cpu"] = jnf_encode_card_vs_cpu(model, eight, mods[:2], mcmc_steps=5)
    check(not any(mx.launches.values()), f"jnf inference launched {mx.launches}")
    return record


def _sampler_stub(dim, device):
    """What a flow sampler reads of a model: one latent space of ``dim``."""
    import types

    return types.SimpleNamespace(model_config=types.SimpleNamespace(latent_dim=dim),
                                 multiple_latent_spaces=False, device=torch.device(device))


def sampler_run(mx, sampler, dataset, n_samples, **fit_kwargs):
    """Fit ``sampler`` on ``dataset`` (the fit encodes it), then draw
    ``n_samples``: seconds of each, the peak above what was held, finite
    samples of the shapes of ``model.encode``'s, no mixture launch."""
    model = sampler.model
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    mx.reset_launches()
    t0 = time.perf_counter()
    sampler.fit(dataset, **fit_kwargs)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = sampler.sample(n_samples)
    torch.cuda.synchronize()
    record = {"rows": len(dataset), "fit_s": fit_s, "sample_s": time.perf_counter() - t0,
              "n_samples": n_samples,
              "peak_above_held_bytes": torch.cuda.max_memory_allocated() - held}
    shapes = {"z": (out.z, model.latent_dim)}
    if model.multiple_latent_spaces:
        shapes.update({m: (out.modalities_z[m], d) for m, d in model.style_dims.items()})
    for key, (z, d) in shapes.items():
        check(tuple(z.shape) == (n_samples, d) and bool(torch.isfinite(z).all()),
              f"{sampler.name} {key}: {tuple(z.shape)}, finite {bool(torch.isfinite(z).all())}")
    check(out.one_latent_space is not model.multiple_latent_spaces, "one_latent_space")
    if hasattr(sampler, "last_loss"):
        record["last_loss"] = dict(sampler.last_loss)
    if hasattr(sampler, "gmm"):
        gmms = {"shared": sampler.gmm, **getattr(sampler, "mod_gmms", {})}
        record["gmm"] = {k: {"n_iter": g.n_iter, "lower_bound": g.lower_bound.item()}
                         for k, g in gmms.items()}
    check(not any(mx.launches.values()), f"{sampler.name} launched {mx.launches}")
    return record


def samplers_card_vs_cpu(maf, z, n_components=10):
    """On the latents ``z`` (card): one EM iteration from the same labels,
    one MAF fit step (the first 256 latents, one batch of the plan) from the
    fitted MAF's weights (its loss, and its gradients normwise), and that
    MAF's inverse of a fixed u, each on the card and on the CPU."""
    from multivae_tpu_torch.ops import gmm
    from multivae_tpu_torch.samplers import MAFSampler

    devices = {"card": z.device, "cpu": torch.device("cpu")}
    record = {}
    labels = torch.arange(z.shape[0]) % n_components
    fits = {k: gmm.fit_gmm(z.to(dev), n_components, labels=labels, max_iter=1)
            for k, dev in devices.items()}
    lb = {k: f.lower_bound.item() for k, f in fits.items()}
    means_err = (fits["card"].means.cpu() - fits["cpu"].means).abs().max().item()
    means_scale = fits["cpu"].means.abs().max().item()
    record["em_iteration"] = {"rows": z.shape[0], "lower_bound_card": lb["card"],
                              "lower_bound_cpu": lb["cpu"], "means_max_abs_err": means_err}
    check(abs(lb["card"] - lb["cpu"]) <= LOSS_RTOL * abs(lb["cpu"]),
          f"EM lower bound card {lb['card']} vs cpu {lb['cpu']}")
    check(means_err <= ENCODE_RTOL * means_scale, f"EM means card vs cpu {means_err}")

    flow = maf.flows_models["shared"]
    start = {k: v.detach().cpu().clone() for k, v in flow.state_dict().items()}
    grads, losses = {}, {}
    for k, dev in devices.items():
        stub = MAFSampler(_sampler_stub(z.shape[1], dev), maf.sampler_config)
        stub.flows_models["shared"].load_state_dict(start)
        stub._fit_one_flow("shared", z[:256].to(dev), 1, 256, 1e-3)
        losses[k] = stub.last_loss["shared"]
        # the gradients of the step (the sign of an Adam step on a gradient
        # within float32 noise of 0 is noise itself)
        grads[k] = {name: p.grad.cpu()
                    for name, p in stub.flows_models["shared"].named_parameters()}
    grad_err = max((grads["card"][name] - g).norm().item() / g.norm().item()
                   for name, g in grads["cpu"].items() if g.any())
    record["maf_fit_step"] = {"loss_card": losses["card"], "loss_cpu": losses["cpu"],
                              "max_relative_grad_err": grad_err}
    check(abs(losses["card"] - losses["cpu"]) <= LOSS_RTOL * abs(losses["cpu"]),
          f"MAF fit step loss card {losses['card']} vs cpu {losses['cpu']}")
    check(grad_err <= GRAD_RTOL, f"MAF fit step gradients card vs cpu {grad_err}")

    u = torch.randn(8, z.shape[1], generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        x_card = flow.inverse(u.to(z.device))["out"].cpu()
        x_cpu = copy.deepcopy(flow).cpu().inverse(u)["out"]
    err, scale = (x_card - x_cpu).abs().max().item(), x_cpu.abs().max().item()
    record["maf_inverse"] = {"rows": 8, "max_abs_err": err, "max_abs_x": scale}
    check(err <= ENCODE_RTOL * scale, f"MAF inverse card vs cpu {err} (max|x| {scale})")
    return record


def em_iterations(z, n_components, n_iter=20):
    """EM on the latents ``z`` from fixed labels, run to ``n_iter``
    iterations whatever its convergence (tol 0), against one iteration:
    the seconds of an EM iteration, which scale the converged fit's time to
    the iterations other latents need."""
    from multivae_tpu_torch.ops import gmm

    labels = torch.arange(z.shape[0]) % n_components
    seconds = {}
    for iters in (1, 1 + n_iter):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fit = gmm.fit_gmm(z, n_components, labels=labels, max_iter=iters, tol=0.0)
        torch.cuda.synchronize()
        seconds[iters] = time.perf_counter() - t0
        check(fit.n_iter == iters and bool(torch.isfinite(fit.means).all()),
              f"EM ran {fit.n_iter} of {iters} iterations")
    return {"rows": z.shape[0], "n_components": n_components, "one_iteration_fit_s":
            seconds[1], f"fit_{1 + n_iter}_iterations_s": seconds[1 + n_iter],
            "s_per_iteration": (seconds[1 + n_iter] - seconds[1]) / n_iter}


def samplers_phase(mx, jnf, dmvae, n_rows=20480, iaf_rows=2048, n_samples=256,
                   n_components=10):
    """The three samplers on the trained JNF's latents of ``n_rows`` random
    PolyMNIST rows (the case study's settings: MAF 20 epochs of batch 256
    at lr 1e-3, a 10-component full-covariance GMM; IAF 1 epoch on
    ``iaf_rows``), then MAF and GMM on the trained DMVAE (shared 10, private
    1 and 4); then the card-vs-CPU checks of ``samplers_card_vs_cpu``.
    ``n_components`` (10) is the GMMs' and the EM check's."""
    from multivae_tpu_torch.data import MultimodalBaseDataset
    from multivae_tpu_torch.samplers import (
        GaussianMixtureSampler,
        GaussianMixtureSamplerConfig,
        IAFSampler,
        MAFSampler,
    )

    rng = np.random.default_rng(1)
    data = MultimodalBaseDataset({m: rng.random((n_rows, *d), dtype=np.float32)
                                  for m, d in jnf.model.input_dims.items()})
    small = MultimodalBaseDataset(data.get_batch(np.arange(iaf_rows))["data"])
    record = {"phase": "samplers"}
    maf = MAFSampler(jnf.model)
    flow_fit = dict(num_epochs=20, batch_size=256, learning_rate=1e-3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    z, _ = maf._collect_latents(data, batch_size=256)
    torch.cuda.synchronize()
    record["jnf_collect_latents"] = {"rows": n_rows, "seconds": time.perf_counter() - t0}
    record["jnf_maf"] = sampler_run(mx, maf, data, n_samples, **flow_fit)
    record["jnf_iaf"] = sampler_run(mx, IAFSampler(jnf.model), small, n_samples,
                                    **{**flow_fit, "num_epochs": 1})
    gmm_config = GaussianMixtureSamplerConfig(n_components=n_components)
    record["jnf_gmm"] = sampler_run(mx, GaussianMixtureSampler(jnf.model, gmm_config), data,
                                    n_samples)
    record["jnf_em_iterations"] = em_iterations(z, n_components)
    record["dmvae_maf"] = sampler_run(mx, MAFSampler(dmvae.model), dmvae.train, n_samples,
                                      **flow_fit)
    record["dmvae_gmm"] = sampler_run(mx, GaussianMixtureSampler(dmvae.model, gmm_config),
                                      dmvae.train, n_samples)
    record["card_vs_cpu"] = samplers_card_vs_cpu(maf, z, n_components)
    return record


def _incomplete_rows(data, n, seed):
    """The first ``n`` rows of ``data`` (a complete dataset) as an
    ``IncompleteDataset``: each (row, modality) missing with probability
    0.2, row 1 with no modality, missing entries zeroed."""
    from multivae_tpu_torch.data import IncompleteDataset

    raw = data.get_batch(np.arange(n))["data"]
    rng = np.random.default_rng(seed)
    masks = {m: rng.random(n) >= 0.2 for m in raw}
    for m in raw:
        masks[m][1] = False
    return IncompleteDataset({m: np.where(masks[m].reshape(-1, *(1,) * (v.ndim - 1)), v,
                                          0.0).astype(np.float32) for m, v in raw.items()},
                             masks)


def hierarchical_inference(mx, mhvae, nexus, rows=256, repeats=3):
    """The trained MHVAE: encode from every modality (N=10, flatten;
    every level's latent), predict from one modality (N=10), the per-row
    encode of an incomplete batch (20% of the (row, modality) pairs
    missing, a row with none) and ``encode``'s refusal of it, each timed
    (median of ``repeats`` after a warm-up); the per-row encode of 8 of
    those rows card vs CPU on the same noise (the sum of z_1 squared). The
    trained Nexus: encode from one modality (N=10), predict, decode from
    the bottom codes and through the top decoders; its loss on 8 rows of
    the incomplete branch card vs CPU. All finite, of the right shapes, no
    mixture launch."""
    record = {"phase": "hierarchical_inference"}
    mx.reset_launches()
    model, mods = mhvae.model, list(mhvae.model.input_dims)
    batch = rows_batch(mhvae.train, np.arange(rows))
    incomplete = _incomplete_rows(mhvae.train, rows, seed=5)
    inc_batch = rows_batch(incomplete, np.arange(rows))
    n = 10 * rows
    shapes = {"z_3": (n, model.latent_dim), "z_2": (n, 64, 7, 7), "z_1": (n, 32, 14, 14)}
    calls = {"encode_all": lambda: model.encode(batch, N=10, flatten=True),
             "predict_one": lambda: model.predict(batch, cond_mod=mods[0], N=10),
             "encode_per_sample": lambda: model.encode_per_sample(inc_batch)}
    for label, call in calls.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        with torch.no_grad():
            _, seconds, warmup = timed(lambda: next(iter(call().values())), repeats)
            out = call()
        record[label] = {"rows": rows, "seconds": seconds, "warmup_s": warmup,
                         "peak_above_held_bytes": torch.cuda.max_memory_allocated() - held}
        if label == "encode_all":
            got = {k: tuple(v.shape) for k, v in out.all_z.items()}
            tensors = list(out.all_z.values())
            check(got == shapes, f"mhvae encode levels {got}")
        elif label == "predict_one":
            tensors = [out[m] for m in mods]
            check(all(tuple(t.shape) == (10, rows, 3, 28, 28) for t in tensors),
                  f"mhvae predict {[tuple(t.shape) for t in tensors]}")
        else:
            tensors = [out.z]
            check(tuple(out.z.shape) == (rows, 32, 14, 14), f"per-sample z {out.z.shape}")
        check(all(bool(torch.isfinite(t).all()) for t in tensors), f"mhvae {label}: non-finite")
    try:
        model.encode(inc_batch)
        check(False, "mhvae encode accepted an incomplete batch")
    except AttributeError:
        pass

    def per_sample(net, dtype):
        return (net.encode_per_sample(rows_batch(incomplete, np.arange(8), dtype)
                                      .to(net.device)).z ** 2).sum()

    record["encode_per_sample_card_vs_cpu"] = card_vs_cpu(
        model, per_sample, recorded_draws(model, per_sample, 4))

    model, data = nexus.model, nexus.train
    b = rows_batch(data, np.arange(rows))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        enc = model.encode(b, cond_mod="a", N=10)
        pred = model.predict(b, cond_mod="a", gen_mod="all", N=10)
        decoded = {k: model.decode(enc, use_bottom_z_for_recon=k == "bottom")
                   for k in ("bottom", "top")}
    torch.cuda.synchronize()
    tensors = [enc.z, enc.modalities_z["a"], *pred.values(),
               *(v for d in decoded.values() for v in d.values())]
    check(tuple(enc.z.shape) == (10, rows, 8) and all(
        tuple(pred[m].shape) == (10, rows, *d) for m, d in model.input_dims.items()),
        f"nexus shapes {tuple(enc.z.shape)}")
    check(all(bool(torch.isfinite(t).all()) for t in tensors), "nexus inference: non-finite")
    nexus_incomplete = _incomplete_rows(data, 8, seed=6)

    def masked_loss(net, dtype):
        return net.loss_function(rows_batch(nexus_incomplete, np.arange(8), dtype)
                                 .to(net.device))["loss"]

    record["nexus"] = {"rows": rows, "encode_predict_decode_s": time.perf_counter() - t0,
                       **{f"masked_loss_{k}": v for k, v in card_vs_cpu(
                           model, masked_loss, recorded_draws(model, masked_loss, 5)).items()}}
    check(not any(mx.launches.values()), f"hierarchical inference launched {mx.launches}")
    return record


def samplers_incomplete(mx, mvtcae, mmvae, n_components=2, check_rows=64):
    """The GMM and MAF samplers fitted on ``mvtcae_conv``'s incomplete
    train set (each row encoded from the modalities it has): the
    collection's seconds, each fit's and sample's (``sampler_run``); the
    collected latents of ``check_rows`` rows card vs CPU on the same noise;
    the refusal of a mixture model (``mmvae_conv``). ``n_components`` is 2:
    a component needs more rows than the 512 latent dimensions for a full
    covariance that factors (2,048 rows here)."""
    from multivae_tpu_torch.data import IncompleteDataset
    from multivae_tpu_torch.samplers import (
        GaussianMixtureSampler,
        GaussianMixtureSamplerConfig,
        MAFSampler,
    )

    model, data = mvtcae.model, mvtcae.train
    avail = np.stack([np.asarray(v) for v in data.masks.values()])
    check(not avail.all(), "mvtcae_conv's train set is complete")
    record = {"phase": "samplers_incomplete", "rows": len(data),
              "missing_share": float(1 - avail.mean()),
              "rows_with_no_modality": int((~avail.any(0)).sum())}
    mx.reset_launches()
    sampler = GaussianMixtureSampler(model, GaussianMixtureSamplerConfig(
        n_components=n_components))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    z, _ = sampler._collect_latents(data, batch_size=256)
    torch.cuda.synchronize()
    record["collect_latents"] = {"seconds": time.perf_counter() - t0,
                                 "shape": list(z.shape)}
    check(bool(torch.isfinite(z).all()), "collected latents not finite")
    record["gmm"] = sampler_run(mx, sampler, data, 256)
    record["maf"] = sampler_run(mx, MAFSampler(model), data, 256, num_epochs=20,
                                batch_size=256, learning_rate=1e-3)
    raw = data.get_batch(np.arange(check_rows))
    sub = IncompleteDataset(raw["data"], raw["masks"])
    draws = [torch.randn(check_rows, model.latent_dim,
                         generator=torch.Generator().manual_seed(7))]
    got = {}
    for key, net in (("card", model), ("cpu", copy.deepcopy(model).to("cpu"))):
        with injected_noise(net, draws), torch.no_grad():
            got[key] = GaussianMixtureSampler(net)._collect_latents(
                sub, batch_size=check_rows)[0].cpu()
    err, scale = (got["card"] - got["cpu"]).abs().max().item(), got["cpu"].abs().max().item()
    record["collect_card_vs_cpu"] = {"rows": check_rows, "max_abs_err": err,
                                     "max_abs_z": scale}
    check(err <= ENCODE_RTOL * scale, f"collected latents card vs cpu {err} (max|z| {scale})")
    try:
        GaussianMixtureSampler(mmvae.model).fit(data)
        check(False, "mmvae_conv fitted a sampler on incomplete data")
    except AttributeError as e:
        record["mmvae_conv_refusal"] = str(e)
    check(not any(mx.launches.values()), f"samplers_incomplete launched {mx.launches}")
    return record



class _RecordedClassifier:
    """A classifier that keeps each call's predicted classes and the margin
    between its top two logits."""

    def __init__(self, clf):
        self.clf, self.preds, self.margins = clf, [], []

    def __call__(self, x):
        logits = self.clf(x)
        top2 = logits.topk(2, dim=-1).values
        self.preds.append(logits.argmax(-1).cpu())
        self.margins.append((top2[:, 0] - top2[:, 1]).cpu())
        return logits


def random_classifiers(device, seed=0):
    """Five random-init ``ClassifierPolyMNIST`` on ``device`` (the
    pretrained weights are not in the repository)."""
    from multivae_tpu_torch.metrics import ClassifierPolyMNIST

    gen = torch.Generator().manual_seed(seed)
    return {f"m{i}": ClassifierPolyMNIST().reset_parameters(gen).to(device)
            for i in range(5)}


def _head(dataset, n):
    from multivae_tpu_torch.data import ResampleDataset

    return ResampleDataset(dataset, np.arange(n))


def evaluator_calls(model, clfs, test, train, out_dir, inception_path=None, small=False,
                    n_devices=1, joint_samples=None, cluster_runs=None):
    """The evaluators on ``model``, each a call returning its metrics:
    ``LikelihoodsEvaluator`` (K=1000 in chunks of 100 on 256 rows; MMVAE's
    paper estimator on 64, which runs the mixture forward kernel),
    ``CoherenceEvaluator`` (the case study's settings: batch 512, 10
    classes, 10,000 joint samples), ``Reconstruction`` (SSIM, then MSE),
    ``Clustering`` (4 runs, k-means++ from a seeded CPU generator),
    ``Visualization`` (unconditional and from ``m1``, PNGs in ``out_dir``),
    the FIDs of ``m0`` from every subset of the others embedded by the
    ``m0`` classifier's 128 features, and, with ``inception_path``, the FID
    of ``m0`` from the other four through that InceptionV3 at 299x299 (its
    embedding and Fréchet seconds apart). ``small``: the card-vs-CPU
    settings (64 rows, K=20 in chunks of 10, 64 joint samples, one
    clustering run, the FIDs embedded by the classifier's 10 logits: a
    128-feature covariance of 64 rows would be singular). ``n_devices``
    evaluates over the process group's ranks (``EvaluatorConfig.n_devices``);
    ``joint_samples`` and ``cluster_runs`` cut the coherence's joint samples
    and the clustering's runs."""
    from multivae_tpu_torch.metrics import (
        Clustering,
        ClusteringConfig,
        CoherenceEvaluator,
        CoherenceEvaluatorConfig,
        FIDEvaluator,
        FIDEvaluatorConfig,
        LikelihoodsEvaluator,
        LikelihoodsEvaluatorConfig,
        Reconstruction,
        ReconstructionConfig,
        Visualization,
    )

    paper = model.model_name == "MMVAE"
    if small:
        test = _head(test, min(len(test), EVAL_CHECK_ROWS))
        train = _head(train, min(len(train), EVAL_CHECK_ROWS))
    nll_set = _head(test, min(len(test), EVAL_CHECK_ROWS if small or paper else 256))
    K, chunk = (20, 10) if small else (NLL_K, NLL_CHUNK)
    mods = list(model.encoders)

    def finished(ev, value):
        ev.finish()
        return value

    dp = dict(n_devices=n_devices)

    def likelihoods():
        ev = LikelihoodsEvaluator(model, nll_set, eval_config=LikelihoodsEvaluatorConfig(
            num_samples=K, batch_size_k=chunk, unified_implementation=not paper, **dp))
        return finished(ev, dict(ev.eval(), rows=len(nll_set)))

    def coherence():
        joint = 64 if small else joint_samples
        ev = CoherenceEvaluator(model, clfs, test, eval_config=CoherenceEvaluatorConfig(
            batch_size=512, num_classes=10, **dp,
            **({} if joint is None else {"nb_samples_for_joint": joint})))
        return finished(ev, dict(ev.eval()))

    def reconstruction():
        out = {}
        for metric in ("SSIM", "MSE"):
            ev = Reconstruction(model, test, eval_config=ReconstructionConfig(metric=metric,
                                                                              **dp))
            out.update(finished(ev, ev.eval()))
        return out

    def clustering():
        runs = 1 if small else cluster_runs or 4
        ev = Clustering(model, test, train, eval_config=ClusteringConfig(
            number_of_runs=runs, **dp), generator=torch.Generator().manual_seed(0))
        return finished(ev, dict(ev.eval()))

    def visualization():
        ev = Visualization(model, test, output=out_dir)
        return finished(ev, {"unconditional": ev.eval().unconditional_generation,
                             "from_m1": ev.conditional_samples_subset(["m1"])})

    def fid_subsets():
        embed = {m: clfs[m] if small else clfs[m].features for m in mods}
        ev = FIDEvaluator(model, test, custom_encoders=embed,
                          eval_config=FIDEvaluatorConfig(batch_size=256, **dp))
        return finished(ev, dict(ev.compute_all_conditional_fids("m0")))

    def fid_inception():
        ev = FIDEvaluator(model, test, eval_config=FIDEvaluatorConfig(
            batch_size=256, inception_weights_path=inception_path))
        frechet = ev.calculate_frechet_distance
        spent = []

        def timed_frechet(*args):
            t0 = time.perf_counter()
            value = frechet(*args)
            spent.append(time.perf_counter() - t0)
            return value

        ev.calculate_frechet_distance = timed_frechet
        t0 = time.perf_counter()
        fd = ev.compute_fid_from_conditional_generation(mods[1:], "m0")
        total = time.perf_counter() - t0
        return finished(ev, {"fd": fd, "embedded_images": 2 * len(test),
                             "embed_and_decode_s": total - sum(spent),
                             "frechet_s": sum(spent)})

    calls = {"likelihoods": likelihoods, "coherence": coherence,
             "reconstruction": reconstruction, "clustering": clustering,
             "visualization": visualization, "fid_subsets": fid_subsets}
    if inception_path is not None:
        calls["fid_inception"] = fid_inception
    return calls


def _check_metrics(name, label, value, test):
    """Finite metrics in their ranges; grids of the right size."""
    if label == "visualization":
        for key, image in value.items():
            check(image.dtype == np.uint8 and image.ndim == 3 and image.shape[2] == 3,
                  f"{name} {key} grid {image.dtype} {image.shape}")
        return
    numbers = {k: float(v) for k, v in value.items()}
    check(all(np.isfinite(list(numbers.values()))), f"{name} {label}: non-finite {numbers}")
    if label in ("coherence", "clustering"):
        check(all(0 <= v <= 1 for k, v in numbers.items() if not k.startswith("std")),
              f"{name} {label} out of [0, 1]")
    if label == "reconstruction":
        check(all(-1 <= v <= 1 for k, v in numbers.items() if "SSIM" in k),
              f"{name} SSIM out of [-1, 1]")


def _summary(label, value):
    """The printed part of an evaluator's metrics."""
    if label == "visualization":
        return {k: list(v.shape) for k, v in value.items()}
    if label == "coherence":
        return {k: v for k, v in value.items()
                if k.startswith(("mean_coherence", "joint_coherence"))}
    if label == "fid_subsets":
        return {k: v for k, v in value.items() if k.startswith("Mean FD")}
    return value


def evaluators_card_vs_cpu(model, clfs, test, train, out_dir, seed):
    """Every evaluator at the ``small`` settings of ``evaluator_calls`` on
    the card and on a CPU copy of ``model`` and of the classifiers, both fed
    the same noise (and the last expert for MMVAE): values within
    ``LOSS_RTOL``; the classifiers' predictions equal but where the top two
    logits are closer than ``TIE_MARGIN`` on either side, and the
    coherences equal unless such a prediction differs; cluster accuracy
    equal; grid pixels within one level. Returns the record."""
    cpu_clfs = {m: copy.deepcopy(c).to("cpu") for m, c in clfs.items()}

    def run(net):
        recorded = {m: _RecordedClassifier(c) for m, c in
                    (clfs if net.device.type == "cuda" else cpu_clfs).items()}
        calls = evaluator_calls(net, recorded, test, train, out_dir, small=True)
        return {label: call() for label, call in calls.items()}, recorded

    draws = recorded_draws(model, lambda net, dtype: run(net), seed)
    got, clf_calls = {}, {}
    for key, net in (("card", model), ("cpu", copy.deepcopy(model).to("cpu"))):
        with injected_noise(net, draws), torch.no_grad():
            got[key], clf_calls[key] = run(net)
    preds = {k: torch.cat([p for c in clf_calls[k].values() for p in c.preds])
             for k in got}
    margins = torch.minimum(*(torch.cat([q for c in clf_calls[k].values() for q in c.margins])
                              for k in got))
    differ = preds["card"] != preds["cpu"]
    check(bool((margins[differ] < TIE_MARGIN).all()),
          f"a prediction with margin >= {TIE_MARGIN} differs card vs cpu")
    record = {"rows": min(len(test), EVAL_CHECK_ROWS), "predictions": len(margins),
              "near_tie_predictions": int((margins < TIE_MARGIN).sum()),
              "differing_predictions": int(differ.sum())}
    for label in got["card"]:
        card, cpu = got["card"][label], got["cpu"][label]
        if label == "visualization":
            diff = max(int(np.abs(card[k].astype(int) - cpu[k].astype(int)).max())
                       for k in card)
            check(diff <= 1, f"grids card vs cpu differ by {diff} levels")
            record[label] = {"max_level_diff": diff}
            continue
        exact = label == "clustering" or (label == "coherence" and not differ.any())
        for k, v in cpu.items():
            ok = (card[k] == v) if exact else abs(card[k] - v) <= LOSS_RTOL * abs(v)
            check(label == "coherence" and differ.any() or ok,
                  f"{label} {k}: card {card[k]} vs cpu {v}")
        record[label] = {"max_rel_err": max(abs(card[k] - v) / max(abs(v), 1e-30)
                                            for k, v in cpu.items())}
    return record


def _measured(mx, fn):
    """``fn()``'s value, its seconds (to a synchronised end) and peak
    device memory above what was held before it, and the mixture launches
    it made."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    mx.reset_launches()
    t0 = time.perf_counter()
    with torch.no_grad():
        value = fn()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return value, {"seconds": seconds,
                   "peak_above_held_bytes": torch.cuda.max_memory_allocated() - held}, dict(
                       mx.launches)


def evaluation_phase(mx, models, rows=EVAL_ROWS, inception_model="mvtcae_conv"):
    """Every evaluator of ``multivae_tpu_torch.metrics`` on each trained
    model of ``models`` (``evaluator_calls``), on ``rows`` labelled random
    PolyMNIST test rows and as many train rows (``workloads.labelled_polymnist``),
    with five random-init classifiers on the card and, on
    ``inception_model``, a random-init InceptionV3 read from a state-dict
    file as a user's pytorch-fid weights would be: each evaluator's seconds
    and peak, exact mixture launches (10 forwards for MMVAE's paper NLL, none
    elsewhere); card vs CPU on 64 rows (``evaluators_card_vs_cpu``) and the
    Inception embeddings of 8 rows within ``ENCODE_RTOL`` of their largest.
    Returns (the record, the launches)."""
    from multivae_tpu_torch.metrics import AdaptShapeFID, InceptionV3FID
    from multivae_tpu_torch.tools.workloads import labelled_polymnist

    device = next(iter(models.values())).device
    test, train = labelled_polymnist(rows, 11), labelled_polymnist(rows, 12)
    clfs = random_classifiers(device)
    record = {"phase": "evaluation", "rows": rows, "train_rows": rows}
    total = {k: 0 for k in KERNELS}
    with tempfile.TemporaryDirectory() as tmp:
        inception = InceptionV3FID().reset_parameters(torch.Generator().manual_seed(3))
        inception_path = os.path.join(tmp, "pt_inception.pth")
        torch.save(inception.state_dict(), inception_path)
        for seed, (name, model) in enumerate(models.items()):
            out_dir = os.path.join(tmp, name)
            calls = evaluator_calls(model, clfs, test, train, out_dir,
                                    inception_path if name == inception_model else None)
            record[name] = {}
            for label, call in calls.items():
                value, stats, launches = _measured(mx, call)
                paper_nll = label == "likelihoods" and model.model_name == "MMVAE"
                expected = counts(fwd=-(-NLL_K // NLL_CHUNK) if paper_nll else 0)
                check(launches == expected,
                      f"{name} {label}: expected {expected} launches, got {launches}")
                total = {k: total[k] + launches[k] for k in KERNELS}
                _check_metrics(name, label, value, test)
                record[name][label] = {**stats, **_summary(label, value)}
            check(sorted(os.listdir(out_dir)) == [
                "conditional_from_subset_['m1'].png", "metrics.log", "unconditional.png"],
                f"{name}: wrote {os.listdir(out_dir)}")
            t0 = time.perf_counter()
            record[name]["card_vs_cpu"] = evaluators_card_vs_cpu(
                model, clfs, test, train, os.path.join(tmp, "check"), seed=20 + seed)
            record[name]["card_vs_cpu"]["seconds"] = time.perf_counter() - t0
        x = AdaptShapeFID()(torch.tensor(test.get_batch(np.arange(8))["data"]["m0"]))
        with torch.no_grad():
            card = inception.to(device)(x.to(device)).embedding.cpu()
            cpu = inception.to("cpu")(x).embedding
        err, scale = (card - cpu).abs().max().item(), cpu.abs().max().item()
        check(err <= ENCODE_RTOL * scale, f"inception card vs cpu {err} (max {scale})")
        record["inception_card_vs_cpu"] = {"rows": 8, "max_abs_err": err,
                                           "max_abs_embedding": scale}
    return record, total


# trainer_lifecycle. Seeded training is not bit-reproducible on the card
# (cuDNN's weight-gradient kernels sum with atomics), so a resumed epoch
# is held to the uninterrupted one within tolerances set from the card's
# own spread. In runs of this phase (NVIDIA H100 80GB HBM3, 700 W) two
# resumes from one checkpoint differed by 1.5e-6 to 2.8e-6 (train epoch
# loss) and 4.7e-6 to 6.3e-6 (eval), relative, and the moves of their
# weights over the epoch by 6.4e-4 to 7.1e-4 of the move's norm over all
# the weights (1.7e-3 to 3.4e-3 in the worst tensor). The epoch losses
# within RESUME_RTOL (16x that spread); but a mean over 1,024 rows of
# K=10 draws hardly moves with the noise (a resume without the
# generator's state moved them 1.3e-5 to 2.1e-5), so the weights decide:
# their moves within RESUME_MOVE_RTOL (about 30x the spread), which a
# resume without the generator's state (0.40) must miss. The phase prints
# both spreads. On the CPU the tests hold the resumed run exactly equal.
RESUME_RTOL = 1e-4
RESUME_MOVE_RTOL = 2e-2
# The reloaded model's 8-row loss against the kept model's: the same
# weights on the same draws, but the card's forward is not bit-reproducible
# either (9.4e-7 relative between the two in an earlier run of this phase,
# NVIDIA H100 80GB HBM3, 700 W): 10x that. Both run on cuDNN's
# deterministic algorithms.
RELOAD_RTOL = 1e-5
# A microbatched 8-row gradient card vs CPU, normwise over every
# parameter: float32 sums of the conv weight gradients in another order,
# through the IWAE weights at K=10. In two runs of this phase the two
# differed by 4.4e-5 and 4.0e-4, and each stood 0.7e-4 to 4.2e-4 from the
# float64 gradient on the CPU, which the phase prints: 5e-3 is 12x the
# larger.
MICRO_GRAD_RTOL = 5e-3
# ms a request: median of this many calls after a warm-up
SERVE_REPEATS = 20
# the endpoints ``lifecycle_export`` exports: (name, model, batch,
# deterministic); the MMVAE ones condition on m0, the MVTCAE one is an
# AnySubsetPredictor; the deterministic MMVAE ones are timed loaded
EXPORTED = (("mmvae_mean_64", "mmvae", 64, True), ("mmvae_sampled_64", "mmvae", 64, False),
            ("mvtcae_any_mean_64", "mvtcae", 64, True), ("mmvae_mean_256", "mmvae", 256, True))
# what a traced endpoint must not hold: a host read of a tensor, a collective
EXPORT_FORBIDDEN = ("aten.item", "aten._local_scalar_dense")
# run by ``lifecycle_export`` in a fresh python that cannot import the
# package (``python3 -c LOADED_RUN FOLDER DEVICE TIMEOUT``): it starts while
# the parent exports, warms ``torch.export``'s loader up on a Linear and the
# device, waits for the parent's ``endpoints.json``, then loads each exported
# endpoint by plain ``torch.export.load``, reports its graph's ops, runs it
# on its saved inputs (its reply saved) and times the timed ones a request
# (numpy in, numpy out, as the live endpoint's ``_request_ms``)
LOADED_RUN = r"""
import importlib.abc, io, json, os, sys, time


class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in ("multivae_tpu_torch", "multivae_tpu"):
            raise ImportError(name + " is blocked")


sys.meta_path.insert(0, Block())
import numpy as np
import torch

folder, device, timeout = sys.argv[1], sys.argv[2], float(sys.argv[3])
start = time.perf_counter()
buf = io.BytesIO()
torch.export.save(torch.export.export(torch.nn.Linear(2, 2), (torch.zeros(1, 2),)), buf)
buf.seek(0)
torch.export.load(buf).module()(torch.zeros(1, 2))
torch.zeros(1, device=device).sum().item()
out = {"warm_s": time.perf_counter() - start, "load_s": {}, "ms": {}, "graphs": {}}
deadline = time.monotonic() + timeout
while not os.path.exists(folder + "/endpoints.json"):
    if time.monotonic() > deadline:
        sys.exit("no endpoints.json")
    time.sleep(0.05)
with open(folder + "/endpoints.json") as f:
    spec = json.load(f)
for module, name, value in spec["flags"]:
    setattr(getattr(torch.backends, module) if module != "matmul" else
            torch.backends.cuda.matmul, name, value)
torch.set_num_threads(spec["threads"])
sync = torch.cuda.synchronize if device.startswith("cuda") else (lambda: None)
params = {k: torch.load(f"{folder}/{k}.state.pt") for k in spec["models"]}
for name, e in spec["endpoints"].items():
    t0 = time.perf_counter()
    exported = torch.export.load(f"{folder}/{name}.pt2")
    program = exported.module()
    out["load_s"][name] = time.perf_counter() - t0
    out["graphs"][name] = {
        "ops": sorted({str(n.target) for n in exported.graph.nodes if n.op == "call_function"}),
        "state_dict": len(exported.state_dict)}
    args = torch.load(f"{folder}/{name}.inputs.pt")
    with torch.no_grad():
        reply = program(params[e["model"]], *args)
        torch.save({m: v.cpu() for m, v in reply.items()}, f"{folder}/{name}.reply.pt")
        if e["timed"]:
            request = {m: v.cpu().numpy() for m, v in args[0].items()}
            times = []
            for _ in range(spec["repeats"] + 1):
                sync()
                t0 = time.perf_counter()
                data = {m: torch.from_numpy(v).to(device) for m, v in request.items()}
                reply = {m: v.cpu().numpy() for m, v in
                         program(params[e["model"]], data, *args[1:]).items()}
                times.append(time.perf_counter() - t0)
                assert all(np.isfinite(v).all() for v in reply.values())
            out["ms"][name] = 1e3 * float(np.median(times[1:]))
out["modules"] = sorted(m for m in sys.modules if m.startswith("multivae"))
print(json.dumps(out))
"""
CHECKPOINT_FILES = {"environment.json", "generator.pt", "info_checkpoint.json",
                    "live_params.pt", "model.pt", "model_config.json", "optimizer.pt",
                    "training_config.json"}


def _checkpoint_files(model):
    """The files of a checkpoint of ``model`` trained with a scheduler: one
    pickle a custom architecture beside ``CHECKPOINT_FILES``."""
    return (CHECKPOINT_FILES | {"scheduler.json"}
            | {f"{a}.pkl" for a in model.model_config.custom_architectures})


def _event_recorder():
    """A callback that logs (event, host seconds) of every event."""
    from multivae_tpu_torch.trainers.base.callbacks import TrainingCallback

    class Events(TrainingCallback):
        def __init__(self):
            self.log = []

        def __getattribute__(self, name):
            if name.startswith("on_"):
                log = object.__getattribute__(self, "log")
                return lambda training_config, **kwargs: log.append(
                    (name, time.perf_counter()))
            return object.__getattribute__(self, name)

    return Events()


def expected_events(first, last, steps, eval_steps):
    """The JAX synchronous loop's event order for epochs ``first`` ..
    ``last``, with an eval set, grids and a checkpoint every epoch."""
    events = ["on_init_end", "on_train_begin"]
    for _ in range(first, last + 1):
        events += (["on_epoch_begin", "on_train_step_begin"]
                   + ["on_train_step_end"] * steps
                   + ["on_eval_step_begin"] + ["on_eval_step_end"] * eval_steps
                   + ["on_prediction_step", "on_epoch_end", "on_save_checkpoint",
                      "on_log"])
    return events + ["on_save", "on_train_end"]


def _png_size(path):
    with open(path, "rb") as f:
        head = f.read(24)
    check(head[:8] == b"\x89PNG\r\n\x1a\n", f"{path} is not a PNG")
    return int.from_bytes(head[16:20], "big"), int.from_bytes(head[20:24], "big")


def _rel(a, b):
    return abs(a - b) / abs(b)


def _request_ms(pred, request, masks=None, repeats=SERVE_REPEATS):
    """Median ms of a request (the reply fetched to the host) after a
    warm-up call."""
    times = []
    for _ in range(repeats + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = pred(request) if masks is None else pred(request, masks)
        times.append(time.perf_counter() - t0)
        check(all(np.isfinite(v).all() for v in out.values()), "non-finite reply")
    return 1e3 * float(np.median(times[1:]))


def _same_reply(card, cpu, label):
    """Every generated modality of two replies within LOSS_RTOL of the
    largest entry; returns the largest such error."""
    err = 0.0
    check(set(card) == set(cpu), f"{label}: modalities {set(card)} vs {set(cpu)}")
    for m in cpu:
        check(card[m].shape == cpu[m].shape, f"{label}: {m} {card[m].shape} vs {cpu[m].shape}")
        e = float(np.abs(card[m] - cpu[m]).max() / np.abs(cpu[m]).max())
        check(e <= LOSS_RTOL, f"{label}: {m} card vs cpu {e}")
        err = max(err, e)
    return err


def lifecycle_training(mx, out, n, device):
    """Steps 1-3 of ``trainer_lifecycle`` on ``mmvae_conv``: train with every
    lifecycle feature, resume, reload. Returns (record, reloaded model,
    eval set, launches)."""
    import shutil

    from multivae_tpu_torch.models import AutoModel
    from multivae_tpu_torch.tools import workloads
    from multivae_tpu_torch.trainers import BaseTrainer, BaseTrainerConfig
    from multivae_tpu_torch.trainers.base.callbacks import StepTimingCallback

    w = workloads.build("mmvae_conv", n=n, device=device)
    launches = {k: 0 for k in KERNELS}
    record = {}

    def run(model, name, checkpoint=None):
        events, timing = _event_recorder(), StepTimingCallback()
        mx.reset_launches()
        trainer = BaseTrainer(
            model, w.train, w.eval, callbacks=[events, timing], checkpoint=checkpoint,
            device=device, training_config=BaseTrainerConfig(
                output_dir=os.path.join(out, name), num_epochs=2, seed=0, steps_saving=1,
                steps_predict=1, **w.trainer_kwargs))
        # the sanity check's forward: DReG's two mixture forwards, no backward
        check(mx.launches == counts(fwd=2),
              f"{name}: sanity check launched {mx.launches}")
        trainer.train()
        torch.cuda.synchronize()
        steps, eval_steps = len(trainer.train_loader), len(trainer.eval_loader)
        first = 1 if checkpoint is None else 2
        epochs = 3 - first
        expected = counts(fwd=2 + epochs * 2 * (steps + eval_steps), bwd_dz=epochs * steps)
        check(mx.launches == expected, f"{name}: expected {expected}, got {mx.launches}")
        for k in KERNELS:
            launches[k] += mx.launches[k]
        names = [e for e, _ in events.log]
        check(names == expected_events(first, 2, steps, eval_steps),
              f"{name}: events {names}")
        check(len(trainer.history) == epochs and all(
            np.isfinite(h["train_epoch_loss"]) for h in trainer.history),
            f"{name}: history {trainer.history}")
        return trainer, events, timing

    full, events, timing = run(w.model, "full")
    record["events"] = len(events.log)
    record["epoch_time_s"] = [h["epoch_time_s"] for h in timing.history]
    stamps = [t for e, t in events.log if e in ("on_epoch_end", "on_save_checkpoint")]
    checkpoints = {}
    for epoch in (1, 2):
        path = os.path.join(full.training_dir, f"checkpoint_epoch_{epoch}")
        files = set(os.listdir(path))
        check(files == _checkpoint_files(w.model), f"checkpoint {epoch}: {files}")
        with open(os.path.join(path, "info_checkpoint.json")) as f:
            info = json.load(f)
        check(info["trained_epochs"] == epoch, f"checkpoint {epoch}: {info}")
        checkpoints[epoch] = {
            "bytes": sum(os.path.getsize(os.path.join(path, f)) for f in files),
            "save_s": stamps[2 * epoch - 1] - stamps[2 * epoch - 2]}
    record["checkpoints"] = checkpoints
    grids = {}
    for key in list(w.train.data) + ["all"]:
        grids[key] = _png_size(os.path.join(full.training_dir, f"recon_from_{key}.png"))
    record["grids_wh"] = grids
    print(f"  lifecycle: checkpoints {checkpoints}, grids {grids}", flush=True)

    # resume twice from checkpoint 1, and once without the generator's state
    ckpt = os.path.join(full.training_dir, "checkpoint_epoch_1")
    bare = os.path.join(out, "without_generator")
    shutil.copytree(ckpt, bare)
    os.remove(os.path.join(bare, "generator.pt"))
    resumed = {}
    for name, path in (("resumed", ckpt), ("resumed_again", ckpt),
                       ("without_generator", bare)):
        model = workloads.build("mmvae_conv", n=8, n_eval=0, device=device).model
        trainer = run(model, name, checkpoint=path)[0]
        resumed[name] = (trainer.history[0], trainer.model.state_dict())
        del trainer
    trainer = BaseTrainer(workloads.build("mmvae_conv", n=8, n_eval=0, device=device).model,
                          w.train, w.eval, training_config=BaseTrainerConfig(
                              output_dir=os.path.join(out, "timing"), seed=0,
                              **w.trainer_kwargs), device=device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer._resume_from_checkpoint(ckpt)
    torch.cuda.synchronize()
    record["resume_s"] = time.perf_counter() - t0
    del trainer
    # each weight tensor's move over epoch 2, from the checkpoint's live weights
    start = torch.load(os.path.join(ckpt, "live_params.pt"), map_location=device,
                       weights_only=True)
    moved = {k: v - start[k] for k, v in full.model.state_dict().items()}

    def move_diff(state):
        """(the moves' difference over all the weights, over the worst
        tensor), each relative to the uninterrupted move's norm."""
        diffs = {k: float((state[k] - start[k] - m).norm()) for k, m in moved.items()}
        norms = {k: float(m.norm()) for k, m in moved.items()}
        total = (sum(d * d for d in diffs.values()) / sum(n * n for n in norms.values())) ** 0.5
        return total, max(diffs[k] / norms[k] for k in moved if norms[k] > 0)

    for key in ("train_epoch_loss", "eval_epoch_loss"):
        u, r = full.history[1][key], resumed["resumed"][0][key]
        record[f"{key}_uninterrupted"], record[f"{key}_resumed"] = u, r
        record[f"{key}_rel_diff"] = _rel(r, u)
        record[f"{key}_spread"] = _rel(resumed["resumed_again"][0][key], r)
        record[f"{key}_without_generator_rel_diff"] = _rel(
            resumed["without_generator"][0][key], u)
    for name in resumed:
        (record[f"{name}_move_rel_diff"],
         record[f"{name}_move_rel_diff_worst_tensor"]) = move_diff(resumed[name][1])
    print("  lifecycle resume: " + json.dumps(
        {k: v for k, v in record.items() if "resume" in k or "generator" in k
         or "spread" in k or "uninterrupted" in k or "move" in k}), flush=True)
    for key in ("train_epoch_loss", "eval_epoch_loss"):
        check(record[f"{key}_rel_diff"] <= RESUME_RTOL,
              f"resumed {key} {record[f'{key}_resumed']} vs uninterrupted "
              f"{record[f'{key}_uninterrupted']}")
    check(record["resumed_move_rel_diff"] <= RESUME_MOVE_RTOL,
          f"resumed weights moved {record['resumed_move_rel_diff']} off the uninterrupted run")
    check(record["without_generator_move_rel_diff"] > RESUME_MOVE_RTOL,
          "a resume without the generator's state moves the weights as the "
          "uninterrupted run did")

    # reload the final model and hold its 8-row loss to the kept model's
    final = os.path.join(full.training_dir, "final_model")
    t0 = time.perf_counter()
    reloaded = AutoModel.load_from_folder(final, device=device)
    torch.cuda.synchronize()
    record["reload_s"] = time.perf_counter() - t0
    kept = full.best_model
    check(type(reloaded) is type(kept) and reloaded.device.type == torch.device(device).type,
          f"reloaded {type(reloaded)} on {reloaded.device}")
    state = reloaded.state_dict()
    check(all(torch.equal(state[k], v) for k, v in kept.state_dict().items()),
          "reloaded weights differ from the kept ones")

    def small_loss(net, dtype):
        return net.loss_function(rows_batch(w.eval, np.arange(8), dtype)
                                 .to(net.device))["loss"]

    draws = recorded_draws(kept, small_loss, 1)
    values = []
    # deterministic cuDNN algorithms: the decoders' transposed convs may
    # otherwise take a data-gradient algorithm that sums with atomics, and
    # two forwards of the same weights then differ by float32 noise (3.2e-5
    # relative seen on an H100, more than this check is about)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for net in (kept, reloaded):
            with injected_noise(net, draws), torch.no_grad():
                values.append(float(small_loss(net, torch.float32)))
    finally:
        torch.backends.cudnn.deterministic = deterministic
    record["reload_loss_live"], record["reload_loss_reloaded"] = values
    check(_rel(values[1], values[0]) <= RELOAD_RTOL, f"reloaded loss {values}")
    return record, reloaded, w.eval, launches


def lifecycle_serving(mmvae, mvtcae, eval_set, out, device, rows=50):
    """Step 4 of ``trainer_lifecycle``: a ``Predictor`` on the reloaded
    MMVAE and an ``AnySubsetPredictor`` on the reloaded MVTCAE, card vs CPU
    (posterior means) and timed at batch 64 and 256; then their export
    (``lifecycle_export``), whose torch-only process starts first and warms
    up meanwhile."""
    from multivae_tpu_torch.models import AutoModel
    from multivae_tpu_torch.serving import AnySubsetPredictor, Predictor

    exported = os.path.join(out, "exported")
    loaded_run = _start_loaded_run(exported, device)
    try:
        record = {}
        data = {m: v[:256] for m, v in eval_set.data.items()}
        mods = list(data)
        cpu = copy.deepcopy(mmvae).to("cpu")
        request = {"m0": data["m0"][:rows]}
        card_out = Predictor(mmvae, cond_mod="m0", batch_size=64,
                             deterministic=True).warmup()(request)
        cpu_out = Predictor(cpu, cond_mod="m0", batch_size=64, deterministic=True)(request)
        record["predictor_card_vs_cpu"] = _same_reply(card_out, cpu_out, "Predictor")
        check(all(v.shape == (rows, 3, 28, 28) for v in card_out.values()), "reply shapes")
        sampled = Predictor(mmvae, cond_mod="m0", batch_size=64)
        first, second = sampled(request), sampled(request)
        check(any(not np.array_equal(first[m], second[m]) for m in first),
              "two sampled replies are equal: the noise did not advance")
        for b in (64, 256):
            record[f"predictor_ms_batch_{b}"] = _request_ms(
                Predictor(mmvae, cond_mod="m0", batch_size=b), {"m0": data["m0"][:b]})

        folder = os.path.join(out, "mvtcae_conv")
        mvtcae.save(folder)
        poe = AutoModel.load_from_folder(folder, device=device)
        check(type(poe).__name__ == "MVTCAE" and poe.device.type == torch.device(device).type,
              "MVTCAE reload")
        # every row brings a nonempty subset of the modalities, all 31 in turn
        pattern = (np.arange(256) % 31) + 1
        masks = {m: ((pattern >> i) & 1).astype(np.float32) for i, m in enumerate(mods)}
        card_out = AnySubsetPredictor(poe, batch_size=64, deterministic=True).warmup()(
            {m: v[:rows] for m, v in data.items()}, {m: v[:rows] for m, v in masks.items()})
        cpu_out = AnySubsetPredictor(copy.deepcopy(poe).to("cpu"), batch_size=64,
                                     deterministic=True)(
            {m: v[:rows] for m, v in data.items()}, {m: v[:rows] for m, v in masks.items()})
        record["any_subset_card_vs_cpu"] = _same_reply(card_out, cpu_out, "AnySubsetPredictor")
        for b in (64, 256):
            record[f"any_subset_ms_batch_{b}"] = _request_ms(
                AnySubsetPredictor(poe, batch_size=b), {m: v[:b] for m, v in data.items()},
                {m: v[:b] for m, v in masks.items()})
        try:
            AnySubsetPredictor(mmvae)
            check(False, "AnySubsetPredictor took MMVAE")
        except TypeError:
            pass
        record.update(lifecycle_export({"mmvae": mmvae, "mvtcae": poe}, data, masks,
                                       exported, loaded_run, device))
    finally:
        _stop(loaded_run)
    return record


def _start_loaded_run(folder, device):
    """``LOADED_RUN`` started on ``folder`` (made here), waiting for its
    ``endpoints.json``."""
    os.makedirs(folder, exist_ok=True)
    return subprocess.Popen([sys.executable, "-c", LOADED_RUN, folder, str(device), "600"],
                            cwd=folder, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _stop(proc):
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


def _numeric_flags():
    """The backends' flags that choose a kernel's arithmetic, as
    ``LOADED_RUN`` sets them: (module, flag, value)."""
    return [("matmul", "allow_tf32", torch.backends.cuda.matmul.allow_tf32),
            ("cudnn", "allow_tf32", torch.backends.cudnn.allow_tf32),
            ("cudnn", "deterministic", torch.backends.cudnn.deterministic),
            ("cudnn", "benchmark", torch.backends.cudnn.benchmark)]


def lifecycle_export(models_, data, masks, folder, loaded_run, device,
                     repeats=SERVE_REPEATS):
    """Step 4b of ``trainer_lifecycle``: the ``EXPORTED`` endpoints of the
    reloaded MMVAE and MVTCAE exported (``torch.export``) into ``folder``
    beside their state dicts, inputs and draws, then loaded and run by
    ``loaded_run`` (``_start_loaded_run(folder, device)``: ``LOADED_RUN`` in
    a fresh python that imports only torch and numpy, which warms up while
    the exports run), each reply bit-equal to the live
    ``_predict_fn``'s on the same inputs and draws (cuDNN deterministic in
    both processes); no graph holds a host read, a collective or a weight.
    Export and load seconds, the artifacts' bytes beside the state dicts',
    ms a request live and loaded at batch 64 and 256, on a line of its own
    with the card."""
    from multivae_tpu_torch.serving import AnySubsetPredictor, Predictor

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    start = time.perf_counter()
    try:
        spec = {"models": list(models_), "repeats": repeats, "flags": _numeric_flags(),
                "threads": torch.get_num_threads(), "endpoints": {}}
        record = {"state_dict_bytes": {}, "export_s": {}, "artifact_bytes": {}, "draws": {}}
        for key, model in models_.items():
            path = os.path.join(folder, f"{key}.state.pt")
            torch.save(dict(model.state_dict()), path)
            record["state_dict_bytes"][key] = os.path.getsize(path)
        live = {}
        for i, (name, key, batch, det) in enumerate(EXPORTED):
            model = models_[key]
            if key == "mvtcae":
                pred = AnySubsetPredictor(model, batch_size=batch, deterministic=det)
                mk = {m: torch.from_numpy(v[:batch]).to(device) for m, v in masks.items()}
                args = ({m: torch.from_numpy(v[:batch]).to(device)
                         * mk[m].reshape(-1, *[1] * (v.ndim - 1)) for m, v in data.items()}, mk)
            else:
                pred = Predictor(model, cond_mod="m0", batch_size=batch, deterministic=det)
                args = ({"m0": torch.from_numpy(data["m0"][:batch]).to(device)},)
            draws = pred.draw(torch.Generator(device=device).manual_seed(i))
            t0 = time.perf_counter()
            path = pred.export(os.path.join(folder, name + ".pt2"))
            record["export_s"][name] = time.perf_counter() - t0
            record["artifact_bytes"][name] = os.path.getsize(path)
            check(record["artifact_bytes"][name] < record["state_dict_bytes"][key] // 2,
                  f"{name}: an artifact of {record['artifact_bytes'][name]} B holds weights")
            record["draws"][name] = [list(s.shape) for s in pred.draw_specs]
            torch.save([*args, draws], os.path.join(folder, name + ".inputs.pt"))
            with torch.no_grad():
                live[name] = {m: v.cpu() for m, v in
                              pred._predict_fn(dict(model.state_dict()), *args, draws).items()}
            spec["endpoints"][name] = {"model": key, "timed": key == "mmvae" and det}
        with open(os.path.join(folder, "endpoints.part"), "w") as f:
            json.dump(spec, f)
        os.replace(os.path.join(folder, "endpoints.part"), os.path.join(folder, "endpoints.json"))
        stdout, stderr = loaded_run.communicate(timeout=600)
        record["loaded_run_s"] = time.perf_counter() - start
        check(loaded_run.returncode == 0, f"the loaded endpoints failed:\n{stderr[-3000:]}")
        loaded = json.loads(stdout.strip().splitlines()[-1])
        check(loaded["modules"] == [], f"the loaded run imported {loaded['modules']}")
        for name, ref in live.items():
            graph = loaded["graphs"][name]
            bad = [o for o in graph["ops"] if o.startswith(EXPORT_FORBIDDEN) or "c10d" in o]
            check(not bad and not graph["state_dict"],
                  f"{name}: the exported graph holds {bad} and {graph['state_dict']} weights")
            reply = torch.load(os.path.join(folder, name + ".reply.pt"))
            check(list(reply) == list(ref) and all(torch.equal(reply[m], ref[m]) for m in ref),
                  f"{name}: the loaded program's reply differs from the live endpoint's")
        record["loaded_warm_s"], record["load_s"] = loaded["warm_s"], loaded["load_s"]
        for b in (64, 256):
            record[f"live_ms_mean_batch_{b}"] = _request_ms(
                Predictor(models_["mmvae"], cond_mod="m0", batch_size=b, deterministic=True),
                {"m0": data["m0"][:b]}, repeats=repeats)
            record[f"loaded_ms_mean_batch_{b}"] = loaded["ms"][f"mmvae_mean_{b}"]
    finally:
        torch.backends.cudnn.deterministic = deterministic
        _stop(loaded_run)
    record["seconds"] = time.perf_counter() - start
    print(json.dumps({"phase": "serving_export",
                      "card": card_line() if str(device).startswith("cuda") else "cpu",
                      **record}), flush=True)
    return {"serving_export": record}


def lifecycle_microbatch(mx, remat_record, device, n=512):
    """Step 5 of ``trainer_lifecycle``: ``mmvaeplus_k10_micro`` beside the
    ``use_remat`` run of ``mmvaeplus_k10``, and its 8-row microbatched
    gradient card vs CPU on the same draws."""
    from multivae_tpu_torch.ops.microbatch import microbatched_backward, split_batch

    record, w, launches = workload_run(mx, "mmvaeplus_k10_micro", n=n, device=device,
                                       per_step={"fwd": 2, "bwd": 2}, eval_fwd=1)
    print(json.dumps(record), flush=True)
    model = w.model

    def chunk_losses(net, dtype):
        batch = rows_batch(w.train, np.arange(8), dtype).to(net.device)
        return sum(net.loss_function(c)["loss"] for c in split_batch(batch, 2))

    draws = recorded_draws(model, chunk_losses, 2)
    grads = {}
    for key, device_, dtype in (("card", None, torch.float32), ("cpu", "cpu", torch.float32),
                                ("cpu_float64", "cpu", torch.float64)):
        net = model if device_ is None else copy.deepcopy(model).to(device_, dtype)
        net.zero_grad(set_to_none=True)
        batch = rows_batch(w.train, np.arange(8), dtype).to(net.device)
        with injected_noise(net, draws, dtype):
            out = microbatched_backward(lambda c: net.loss_function(c), batch, 2)
        grads[key] = (float(out["loss"]), torch.cat([
            p.grad.detach().double().cpu().flatten() for p in net.parameters()
            if p.grad is not None]))
        net.zero_grad(set_to_none=True)
    ref = grads["cpu"][1]
    err = float((grads["card"][1] - ref).norm() / ref.norm())
    check(err <= MICRO_GRAD_RTOL, f"microbatched gradient card vs cpu {err}")
    check(_rel(grads["card"][0], grads["cpu"][0]) <= LOSS_RTOL,
          f"microbatched loss card {grads['card'][0]} vs cpu {grads['cpu'][0]}")
    f64 = grads["cpu_float64"][1]
    summary = {
        "micro_steps_per_s": record["steps_per_s"],
        "remat_steps_per_s": remat_record["steps_per_s"],
        "micro_peak_above_held_bytes": record["peak_above_held_bytes"],
        "remat_peak_above_held_bytes": remat_record["peak_above_held_bytes"],
        "micro_grad_card_vs_cpu": err,
        "micro_grad_card_vs_float64": float((grads["card"][1] - f64).norm() / f64.norm()),
        "micro_grad_cpu_vs_float64": float((ref - f64).norm() / f64.norm()),
        "micro_loss_card": grads["card"][0], "micro_loss_cpu": grads["cpu"][0]}
    return summary, launches


def lifecycle_boundary(telbo_dir, device):
    """Step 6 of ``trainer_lifecycle``: the ``MultistageTrainer``'s
    checkpoint of epoch ``warmup - 1`` from the ``telbo_conv`` run, reloaded
    by ``AutoModel``."""
    from multivae_tpu_torch.models import AutoModel

    path = os.path.join(telbo_dir, "checkpoint_epoch_1")
    files = set(os.listdir(path))
    model = AutoModel.load_from_folder(path, device=device)
    check(files == _checkpoint_files(model), f"TELBO boundary checkpoint: {files}")
    with open(os.path.join(path, "info_checkpoint.json")) as f:
        info = json.load(f)
    check(info["trained_epochs"] == 1, f"TELBO boundary checkpoint: {info}")
    saved = torch.load(os.path.join(path, "model.pt"), map_location=device, weights_only=True)
    state = model.state_dict()
    check(type(model).__name__ == "TELBO" and all(
        torch.equal(state[k], v) for k, v in saved.items()), "TELBO boundary reload")
    return {"telbo_boundary_checkpoint": os.path.basename(path),
            "telbo_boundary_bytes": sum(os.path.getsize(os.path.join(path, f))
                                        for f in files)}


def trainer_lifecycle(mx, mvtcae, remat_record, telbo_dir, n=1024, micro_n=512,
                      device="cuda"):
    """The ``trainer_lifecycle`` phase: train ``mmvae_conv`` with callbacks,
    checkpoints and grids, resume, reload, serve, the microbatched
    ``mmvaeplus_k10``, and the ``MultistageTrainer``'s boundary checkpoint.
    Returns (record, mixture launches of its training runs)."""
    import shutil

    start = time.perf_counter()
    out = os.path.join(ROOT, "build", "chip_smoke", "lifecycle")
    shutil.rmtree(out, ignore_errors=True)
    record = {"phase": "trainer_lifecycle"}
    try:
        training, reloaded, eval_set, launches = lifecycle_training(mx, out, n, device)
        record.update(training)
        record.update(lifecycle_serving(reloaded, mvtcae, eval_set, out, device))
        micro, counts = lifecycle_microbatch(mx, remat_record, device, n=micro_n)
        record.update(micro)
        for k in KERNELS:
            launches[k] += counts[k]
        record.update(lifecycle_boundary(telbo_dir, device))
    finally:
        shutil.rmtree(out, ignore_errors=True)
    record["launches"] = launches
    record["seconds"] = time.perf_counter() - start
    return record, launches


# the datasets phase: PolyMNIST's test split (rows of 5 x 3x28x28 float32),
# MNIST's and SVHN's test splits, the Translated PolyMNIST rows, and the
# rows a host read of Translated PolyMNIST takes
POLYMNIST_TEST_ROWS = 10_000
MNIST_TEST_ROWS, SVHN_TEST_ROWS = 10_000, 26_032
TRANSLATED_ROWS, TRANSLATED_BATCH = 2048, 256
FILE_STEPS = 16


def _tree_bytes(path):
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, files in os.walk(path)
               for f in files)


def _file_step(step, start, **values):
    line = {"phase": "datasets", "step": step, "seconds": time.perf_counter() - start}
    line.update(values)
    print(json.dumps(line))
    return line


def datasets_phase(mx, random_records, device="cuda", polymnist_rows=POLYMNIST_TEST_ROWS,
                   mnist_rows=MNIST_TEST_ROWS, svhn_rows=SVHN_TEST_ROWS,
                   translated_rows=TRANSLATED_ROWS, eval_rows=512, steps=FILE_STEPS):
    """The ``datasets`` phase: write each dataset's files in their real
    formats (``tools/dataset_files.py``) under ``build/chip_smoke``, load
    them with the port's dataset classes and train from them:
    ``mvtcae_conv`` and ``mmvaeplus_partial`` (the mixture kernels on file
    data, the exact launches a step) from PolyMNIST's test split with 20%
    of the rows missing, ``dmvae_mnist_svhn`` from MNIST-SVHN's pairs and
    ``mvtcae_cub`` from CUB's captions and PNGs (no PIL import), each for
    ``steps`` steps, beside ``random_records``, the runs of the same
    workloads on random arrays in this call; then the seconds to read a
    batch of Translated PolyMNIST's PNGs. Each step prints a JSON line of
    its own. Returns (record, mixture launches)."""
    import dataclasses
    import shutil

    from multivae_tpu_torch.data import ResampleDataset
    from multivae_tpu_torch.data.datasets import CUB, MMNISTDataset, MnistSvhn, TranslatedMMNIST
    from multivae_tpu_torch.tools import dataset_files, workloads

    start = time.perf_counter()
    parent = os.path.join(ROOT, "build", "chip_smoke")
    os.makedirs(parent, exist_ok=True)
    root = tempfile.mkdtemp(prefix="datasets_", dir=parent)
    launches = {k: 0 for k in KERNELS}
    record = {"phase": "datasets"}

    def train(name, dataset, n_train, n_eval, per_step=None, workload=None):
        """``name`` for ``steps`` steps on the first ``n_train`` rows of
        ``dataset``, its last ``n_eval`` rows the eval set."""
        w = workload or workloads.build(name, n=8, n_eval=0, device=device)
        n = len(dataset)
        w = dataclasses.replace(
            w, train=ResampleDataset(dataset, np.arange(n_train)),
            eval=ResampleDataset(dataset, np.arange(n - n_eval, n)) if n_eval else None)
        run, _, counts = workload_run(mx, name, epochs=1, device=device, per_step=per_step,
                                      workload=w)
        check(run["steps"] == steps, f"{name}: {run['steps']} steps, expected {steps}")
        for k in KERNELS:
            launches[k] += counts[k]
        random = random_records.get(name, {})
        out = {k: run[k] for k in ("steps", "eval_steps", "epoch_losses", "steps_per_s",
                                   "peak_above_held_bytes", "wall_s", "launches")}
        out.update({k: v for k, v in run.items() if k.startswith("small_loss")})
        out["random_arrays"] = {k: random.get(k) for k in ("steps_per_s",
                                                           "peak_above_held_bytes")}
        return out

    try:
        t0 = time.perf_counter()
        dataset_files.write_polymnist(root, "test", polymnist_rows, seed=0, pt=("m2",))
        nbytes = _tree_bytes(os.path.join(root, "MMNIST"))
        write = _file_step("polymnist_write", t0, rows=polymnist_rows, bytes=nbytes)
        t0 = time.perf_counter()
        poly = MMNISTDataset(root, split="test", missing_ratio=0.2, keep_incomplete=True)
        check(len(poly) == polymnist_rows and poly.masks["m0"].all()
              and not poly.masks["m1"].all(), "PolyMNIST's MAR masks")
        load = _file_step("polymnist_load", t0, rows=len(poly), bytes=nbytes,
                          s_per_gb=(time.perf_counter() - t0) / (nbytes / 1e9))
        record["polymnist_write"], record["polymnist_load"] = write, load
        batch = workloads.BATCH
        t0 = time.perf_counter()
        record["mvtcae_conv"] = _file_step(
            "mvtcae_conv", t0, **train("mvtcae_conv", poly, steps * batch["mvtcae_conv"],
                                       eval_rows))
        t0 = time.perf_counter()
        record["mmvaeplus_partial"] = _file_step("mmvaeplus_partial", t0, **train(
            "mmvaeplus_partial", poly, steps * batch["mmvaeplus_partial"], eval_rows,
            per_step={"fwd": 2, "bwd_dz": 1}))
        del poly

        t0 = time.perf_counter()
        dataset_files.write_mnist(root, 16, mnist_rows, seed=1, gz=True)
        dataset_files.write_svhn(root, "test", svhn_rows, seed=2)
        write = _file_step("mnist_svhn_write", t0, mnist_rows=mnist_rows, svhn_rows=svhn_rows,
                           bytes=_tree_bytes(root) - nbytes)
        t0 = time.perf_counter()
        pairs = MnistSvhn(root, split="test")
        load = _file_step("mnist_svhn_load", t0, rows=len(pairs))
        check(len(pairs) >= steps * batch["dmvae_mnist_svhn"], f"{len(pairs)} MNIST-SVHN pairs")
        t0 = time.perf_counter()
        record["mnist_svhn_write"], record["mnist_svhn_load"] = write, load
        record["dmvae_mnist_svhn"] = _file_step("dmvae_mnist_svhn", t0, **train(
            "dmvae_mnist_svhn", pairs, steps * batch["dmvae_mnist_svhn"], 0))
        del pairs

        t0 = time.perf_counter()
        dataset_files.write_cub(root, **workloads.CUB_SYNTHETIC)
        cub_train = CUB(root, "train", output_type="tokens")
        cub_eval = CUB(root, "eval", output_type="tokens")
        check("PIL" not in sys.modules, "the CUB dataset imported PIL")
        load = _file_step("cub_load", t0, rows=len(cub_train), eval_rows=len(cub_eval),
                          vocab_size=cub_train.vocab_size)
        t0 = time.perf_counter()
        w = workloads.cub_workload(cub_train, cub_eval, device=device)
        run, _, counts = workload_run(mx, "mvtcae_cub", epochs=1, device=device, workload=w)
        check(run["steps"] == steps, f"mvtcae_cub: {run['steps']} steps, expected {steps}")
        check(not any(counts.values()), f"mvtcae_cub launched {counts}")
        check("PIL" not in sys.modules, "training on CUB imported PIL")
        record["cub_load"] = load
        record["mvtcae_cub"] = _file_step(
            "mvtcae_cub", t0, vocab_size=cub_train.vocab_size,
            parameters=sum(p.numel() for p in w.model.parameters()),
            **{k: run[k] for k in run if k not in ("phase", "training_dir")})
        del w, cub_train, cub_eval

        t0 = time.perf_counter()
        dataset_files.write_translated_polymnist(root, translated_rows, seed=3)
        write = _file_step("translated_write", t0, rows=translated_rows, modalities=5)
        translated = TranslatedMMNIST(root, 0.75, True, 5)
        check(len(translated) == translated_rows, f"{len(translated)} Translated rows")
        n_read = min(TRANSLATED_BATCH, translated_rows)
        idx = np.random.default_rng(4).permutation(translated_rows)[:n_read]
        t0 = time.perf_counter()
        rows = translated.get_batch(idx)
        read_s = time.perf_counter() - t0
        check(rows["data"]["m4"].shape == (n_read, 3, 28, 28), "Translated batch")
        record["translated_write"] = write
        record["translated_read"] = _file_step(
            "translated_read", t0, batch=n_read, read_s=read_s,
            pngs_per_s=5 * n_read / read_s)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    # the steps printed their lines: the phase's line sums them up
    summary = {"phase": "datasets", "seconds": time.perf_counter() - start,
               "launches": launches, "steps_per_s_files_vs_random": {
                   name: [record[name]["steps_per_s"],
                          record[name].get("random_arrays", {}).get("steps_per_s")]
                   for name in ("mvtcae_conv", "mmvaeplus_partial", "dmvae_mnist_svhn",
                                "mvtcae_cub")},
               "step_seconds": {k: v["seconds"] for k, v in record.items()
                                if isinstance(v, dict) and "seconds" in v}}
    return summary, launches


# resident_data: the device cache against the host path (now prefetched).
# Host and cached runs of one workload start from the same weights and
# seed and, with cuDNN's deterministic algorithms, take the same steps on
# the same batches: their first epoch losses must agree within
# RESIDENT_LOSS_RTOL (the phase prints the gap).
RESIDENT_ROWS = 60_000            # partial PolyMNIST's train split
RESIDENT_SMALL_ROWS = 2048
RESIDENT_LOSS_RTOL = 1e-5
GATHER_ROWS = 256
GATHER_REPEATS = 20


def _median_s(fn, repeats=GATHER_REPEATS):
    """Median wall seconds of ``repeats`` calls of ``fn`` after a warm-up,
    each to a synchronised end."""
    times = []
    for _ in range(repeats + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return float(np.median(times[1:]))


def _resident_workload(name, train, n_eval=0, device="cuda"):
    """``name`` of ``tools/workloads.py`` (seeded weights) on ``train``."""
    import dataclasses

    from multivae_tpu_torch.tools import workloads

    w = workloads.build(name, n=8, n_eval=n_eval, device=device)
    return dataclasses.replace(w, train=train)


def _host_vs_cached(mx, name, make, epochs, device, per_step=None):
    """``name`` trained through the host path and with ``cache_on_device``
    from the same weights (``make()`` builds the workload anew), under
    cuDNN's deterministic algorithms: steps/s, peaks above held and the
    first epoch losses of both; the caches must build and the losses agree
    within ``RESIDENT_LOSS_RTOL``. Returns (record, mixture launches)."""
    import dataclasses

    runs, launches = {}, {k: 0 for k in KERNELS}
    for path in ("host", "cached"):
        w = make()
        if path == "cached":
            w = dataclasses.replace(w, trainer_kwargs=dict(w.trainer_kwargs,
                                                           cache_on_device=True))
        run, w, counts = workload_run(mx, name, epochs=epochs, device=device,
                                      per_step=per_step, workload=w)
        if path == "cached":
            check(run["device_cache"] == {"train": True, "eval": w.eval is not None},
                  f"{name}: a cache came back None: {run['device_cache']}")
            runs["workload"] = w
        for k in KERNELS:
            launches[k] += counts[k]
        runs[path] = run
    host, cached = runs["host"], runs["cached"]
    gap = abs(cached["epoch_losses"][0] - host["epoch_losses"][0]) / abs(host["epoch_losses"][0])
    check(gap <= RESIDENT_LOSS_RTOL,
          f"{name}: first epoch loss cached {cached['epoch_losses'][0]} vs host "
          f"{host['epoch_losses'][0]} (rel {gap})")
    record = {"rows": len(runs["workload"].train), "epochs": epochs, "steps": host["steps"],
              "first_epoch_loss_rel_gap": gap, "launches": launches}
    for path in ("host", "cached"):
        record[path] = {k: runs[path][k] for k in ("steps_per_s", "peak_above_held_bytes",
                                                   "epoch_losses", "wall_s", "launches")}
    record["cached_over_host_steps_per_s"] = cached["steps_per_s"] / host["steps_per_s"]
    return record, runs["workload"], launches


def _check_epoch_batches(cache, loader, device):
    """One epoch of ``cache``'s batches against the host loader's, bit for
    bit: data, masks, weights, labels and the incomplete flag."""
    from multivae_tpu_torch.data.batch import map_tensors
    from multivae_tpu_torch.data.device_cache import upload_plan

    def tensors(batch):
        out = []
        map_tensors(lambda t: out.append(t) or t, batch)
        return out

    idx, weights = upload_plan(loader, device)
    n = 0
    for i, host in enumerate(loader):
        got, want = cache.gather(idx[i], weights[i]), host.to(device)
        a, b = tensors(got), tensors(want)
        check(got.incomplete == want.incomplete and len(a) == len(b)
              and all(torch.equal(x, y) for x, y in zip(a, b)),
              f"cached batch {i} differs from the host loader's")
        n += 1
    check(n == len(loader), f"checked {n} of {len(loader)} batches")
    return n


def resident_data(mx, device="cuda", rows=RESIDENT_ROWS, small_rows=RESIDENT_SMALL_ROWS,
                  eval_rows=RESIDENT_SMALL_ROWS):
    """The ``resident_data`` phase: the device cache (``data/device_cache.py``)
    against the host path (``data/prefetch.py`` and the native gather).

    1. partial PolyMNIST's train split at ``rows`` rows (5 x 3x28x28
       float32 and the MAR masks of ``tools/workloads._incomplete``): the
       cache's build seconds and bytes, one epoch of its batches against
       the host loader's bit for bit, a 256-row gather on the card against
       the host gather plus a pageable copy and plus a pinned one, the
       native gather against numpy's, and ``mvtcae_conv`` trained one epoch
       through each path;
    2. ``mvtcae_conv``, ``mmvaeplus_partial`` (the exact mixture launches,
       on a quarter of the rows) and ``dmvae_mnist_svhn`` on ``small_rows``
       rows, 2 epochs each way;
    3. the coherences of the cached ``mvtcae_conv`` on ``eval_rows``
       labelled rows, cached against host: equal metrics;
    4. a GMM fitted on that ``mvtcae_conv``'s train set through the
       trainer's cache (no second upload), its latents equal to the host
       loop's.

    Returns (record, mixture launches)."""
    from multivae_tpu_torch.data import DataLoader, IncompleteDataset, batch_from_arrays
    from multivae_tpu_torch.data import native_gather
    from multivae_tpu_torch.data.device_cache import build_device_cache, cache_per_device_nbytes
    from multivae_tpu_torch.metrics import CoherenceEvaluator, CoherenceEvaluatorConfig
    from multivae_tpu_torch.ops import cuda_build
    from multivae_tpu_torch.samplers import GaussianMixtureSampler, GaussianMixtureSamplerConfig
    from multivae_tpu_torch.tools import workloads

    start = time.perf_counter()
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    launches = {k: 0 for k in KERNELS}
    record = {"phase": "resident_data", "rows": rows, "cpu_count": os.cpu_count()}
    try:
        # 1. the full-size cache
        t0 = time.perf_counter()
        poly = {f"m{i}": workloads.POLYMNIST for i in range(5)}
        data, masks = workloads._incomplete(np.random.default_rng(workloads.SEED), rows, poly)
        ds = IncompleteDataset(data, masks)
        record["make_data_s"] = time.perf_counter() - t0
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        cache = build_device_cache(ds, device, int(8e9))
        torch.cuda.synchronize()
        record["cache_build_s"] = time.perf_counter() - t0
        check(cache is not None, "the full-size cache came back None")
        record["cache_bytes"] = cache_per_device_nbytes(cache)
        record["cache_allocated_bytes"] = torch.cuda.memory_allocated() - held
        record["dataset_bytes"] = sum(v.nbytes for v in data.values())
        loader = DataLoader(ds, workloads.BATCH["mvtcae_conv"], shuffle=True, seed=0)
        t0 = time.perf_counter()
        record["batches_checked"] = _check_epoch_batches(cache, loader, device)
        record["batch_check_s"] = time.perf_counter() - t0

        idx = np.random.default_rng(1).permutation(rows)[:GATHER_ROWS]
        idx_dev = torch.from_numpy(idx.astype(np.int64)).to(device)
        weights = torch.ones(GATHER_ROWS, device=device)

        def host_batch():
            raw = ds.get_batch(idx)
            return batch_from_arrays(raw["data"], masks=raw["masks"])

        gather = {"rows": GATHER_ROWS,
                  "batch_bytes": GATHER_ROWS * sum(v[0].nbytes for v in data.values()),
                  "card_ms": 1e3 * _median_s(lambda: cache.gather(idx_dev, weights)),
                  "host_gather_ms": 1e3 * _median_s(host_batch),
                  "host_gather_pageable_copy_ms": 1e3 * _median_s(
                      lambda: host_batch().to(device, non_blocking=True))}
        if torch.device(device).type == "cuda":
            from multivae_tpu_torch.data.prefetch import _PinnedSlot

            slot = _PinnedSlot()

            def pinned():
                staged = slot.stage(host_batch(), ())
                moved = staged.to(device, non_blocking=True)
                slot.copied = torch.cuda.Event()
                slot.copied.record()
                return moved

            gather["host_gather_pinned_copy_ms"] = 1e3 * _median_s(pinned)
        record["gather_256"] = gather
        print(json.dumps({"phase": "resident_data", "step": "gather", **gather}))

        check(native_gather.native_available(), "the native gather did not build")
        src = data["m0"]
        native = native_gather.gather_rows(src, idx)
        check(np.array_equal(native, src[idx]), "native gather vs numpy")
        record["native_gather_256"] = {
            "modality_bytes": int(native.nbytes),
            "native_ms": 1e3 * _median_s(lambda: native_gather.gather_rows(src, idx), 50),
            "numpy_ms": 1e3 * _median_s(lambda: src[idx], 50),
            "library": cuda_build.library_path("gather").name}
        # the gather's time by thread count, at a batch and at a cache chunk
        by_threads = {}
        for n_rows in (GATHER_ROWS, 4096):
            rows_idx = np.random.default_rng(2).permutation(rows)[:n_rows]
            by_threads[n_rows] = {"numpy_ms": 1e3 * _median_s(lambda: src[rows_idx], 20)}
            for n_threads in (1, 2, 4, 8):
                by_threads[n_rows][f"threads_{n_threads}_ms"] = 1e3 * _median_s(
                    lambda: native_gather.gather_rows(src, rows_idx, n_threads=n_threads), 20)
        record["native_gather_by_threads"] = by_threads
        del cache
        t0 = time.perf_counter()
        full, _, counts = _host_vs_cached(
            mx, "mvtcae_conv", lambda: _resident_workload("mvtcae_conv", ds, device=device),
            1, device)
        check(not any(counts.values()), f"mvtcae_conv launched {counts}")
        full["seconds"] = time.perf_counter() - t0
        record["mvtcae_conv_full"] = full
        print(json.dumps({"phase": "resident_data", "step": "mvtcae_conv_full", **full}))
        del ds, data, masks

        # 2. cached against host at the workloads' size
        trained = {}
        # MMVAE+ (batch 32) on a quarter of the rows: 16 steps an epoch, as
        # in graphed_steps (all of them until the serving export needed the time)
        for name, per_step, n in (("mvtcae_conv", None, small_rows),
                                  ("mmvaeplus_partial", {"fwd": 2, "bwd_dz": 1}, small_rows // 4),
                                  ("dmvae_mnist_svhn", None, small_rows)):
            t0 = time.perf_counter()
            rec, trained[name], counts = _host_vs_cached(
                mx, name, lambda name=name, n=n: workloads.build(name, n=n, device=device),
                2, device, per_step=per_step)
            rec["seconds"] = time.perf_counter() - t0
            for k in KERNELS:
                launches[k] += counts[k]
            if name != "mmvaeplus_partial":
                check(not any(counts.values()), f"{name} launched {counts}")
            record[name] = rec
            print(json.dumps({"phase": "resident_data", "step": name, **rec}))

        # 3. an evaluator cached against host
        w = trained["mvtcae_conv"]
        test = workloads.labelled_polymnist(eval_rows, 11)
        clfs = random_classifiers(device)
        coherence = {}
        for cached in (False, True):
            ev = CoherenceEvaluator(w.model, clfs, test, eval_config=CoherenceEvaluatorConfig(
                batch_size=512, num_classes=10, cache_on_device=cached),
                generator=torch.Generator(device=device).manual_seed(3))
            check(type(ev.test_loader).__name__ == ("DeviceCachedLoader" if cached
                                                    else "PrefetchLoader"),
                  f"coherence loader {type(ev.test_loader).__name__}")
            value, stats, counts = _measured(mx, ev.eval)
            ev.finish()
            coherence["cached" if cached else "host"] = dict(stats, metrics=dict(value))
        check(coherence["cached"]["metrics"] == coherence["host"]["metrics"],
              "coherences cached vs host differ")
        record["coherence"] = {"rows": eval_rows, **{
            k: {"seconds": v["seconds"], "peak_above_held_bytes": v["peak_above_held_bytes"]}
            for k, v in coherence.items()},
            "mean_coherence_1": coherence["cached"]["metrics"]["mean_coherence_1"]}

        # 4. a sampler through the trainer's cache
        ds = w.train
        shared = getattr(ds, "_sampler_device_cache", None)
        check(shared is not None, "the trainer left no cache on its train set")
        sampler = GaussianMixtureSampler(w.model, GaussianMixtureSamplerConfig(n_components=2))
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        z, _ = sampler._collect_latents(ds, batch_size=256, device=True,
                                        generator=torch.Generator(device=device).manual_seed(5))
        torch.cuda.synchronize()
        collect_s = time.perf_counter() - t0
        grew = torch.cuda.memory_allocated() - before
        check(ds._sampler_device_cache is shared, "the sampler built a cache of its own")
        check(grew < cache_per_device_nbytes(shared) // 2,
              f"device memory grew {grew} bytes: a second upload?")
        t0 = time.perf_counter()
        z_host, _ = sampler._collect_latents(
            ds, batch_size=256, generator=torch.Generator(device=device).manual_seed(5))
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t0
        check(torch.equal(z, z_host), "device-collected latents differ from the host loop's")
        _, stats, counts = _measured(mx, lambda: sampler.fit(ds))
        check(sampler.is_fitted and not any(counts.values()), f"the GMM fit launched {counts}")
        record["sampler"] = {"rows": len(ds), "collect_device_s": collect_s,
                             "collect_host_s": host_s, "memory_growth_bytes": grew,
                             "shared_cache_bytes": cache_per_device_nbytes(shared),
                             "gmm_fit": stats}
    finally:
        torch.backends.cudnn.deterministic = deterministic
    record["seconds"] = time.perf_counter() - start
    record["launches"] = launches
    return record, launches



GRAPHED_ROWS = 2048
GRAPHED_EPOCHS = 3
GRAPHED_CHUNK = 8
# The graphed runs against the eager run with the capturable optimizer the
# graphs use: the same steps on the same draws, batches and arithmetic,
# each epoch's train and eval loss and the weights' moves over the run
# (equal in earlier runs of this phase). Against the plain eager run the
# capturable optimizer's bias corrections, in float32 on the card where
# the eager one takes them in float64 on the host, move the weights by an
# ulp a step, which the later gates below allow for.
GRAPHED_RTOL = 1e-6
# Every epoch's train and eval loss and the weights' moves over the run
# against the eager run's: each kind of gap (the first epoch's train loss,
# the later epochs', the eval losses', the moves) within ten times the
# card's own spread of that kind, and never tighter than the resume gates
# RESUME_RTOL and RESUME_MOVE_RTOL, which an MLP-only workload,
# deterministic either way, would otherwise set to 0. The spread of a kind
# is its largest gap among the eager run and two more runs of it with
# cuDNN free to pick nondeterministic algorithms, taken pair by pair: a gap
# of one pair is a signed sum over the epoch's batches and may fall near 0
# by chance (on an H100, mmvaeplus_partial's later-epoch gap came out at
# 5.5e-5 to 1.1e-4 in five runs and below 1e-5 in a sixth), while the
# capturable optimizer's gap is fixed by its arithmetic. A kind is held to
# its own spread: the eval losses' spread (4.7e-4 on mmvaeplus_partial)
# would let the train losses drift 18 times further than theirs.
GRAPHED_SPREAD_FACTOR = 10.0
GRAPHED_SPREAD_RUNS = ("eager_nondeterministic", "eager_nondeterministic_2")
# (workload, rows, mixture launches a train step, epochs). MMVAE+ (batch
# 32) on 384 rows: 12 steps an epoch, a chunk of 8 and one of 4, as its
# whole-epoch graph's capture takes ~0.2 s a step (1,024 rows until the
# state_sharding phase needed the time, then 512 until its checkpoints
# did); TELBO takes 12 steps an epoch, so that graphs are
# captured within each stage around its reset, and a fourth epoch: its
# reset (epoch 2) and stage flip (3) drop the graphs, so the whole-epoch
# run replays only in epoch 4
GRAPHED_WORKLOADS = (("mmvaeplus_partial", GRAPHED_ROWS * 3 // 16, {"fwd": 2, "bwd_dz": 1},
                      GRAPHED_EPOCHS),
                     ("mvtcae_conv", GRAPHED_ROWS, None, GRAPHED_EPOCHS),
                     ("dmvae_mnist_svhn", GRAPHED_ROWS, None, GRAPHED_EPOCHS),
                     ("mvae_conv", GRAPHED_ROWS, None, GRAPHED_EPOCHS),
                     ("telbo_conv", GRAPHED_ROWS * 3 // 2, None, GRAPHED_EPOCHS + 1))
# The pipelined finalization on and off: dmvae_mnist_svhn (no
# ReduceLROnPlateau, no eval set) for 12 epochs of whole-epoch graphs under
# a StepLR that halves the rate every 4 epochs, so that two rate changes
# must reach the replayed graphs, keeping the best weights on the train
# loss, so that the pipelined window's candidate copy is made on the card
PIPELINE_WORKLOAD = "dmvae_mnist_svhn"
PIPELINE_EPOCHS = 12
PIPELINE_SETTINGS = dict(scheduler_cls="StepLR", scheduler_params={"step_size": 4, "gamma": 0.5},
                         keep_best_on_train=True)


def _graphed_run(mx, name, rows, epochs, device, steps, pipeline, out, checkpoint=None,
                 steps_saving=None, capturable=False, overrides=None, callbacks=(),
                 on_trainer=None):
    """``name`` of ``tools/workloads.py`` on ``rows`` cached rows (seeded
    weights and data), trained ``epochs`` epochs with ``steps_per_execution``
    = ``steps`` (0: the epoch's batch count), its optimizer made
    ``capturable`` on request, ``overrides`` of its trainer settings,
    ``callbacks`` beside its own, ``on_trainer`` called with the trainer
    once it is built.
    Returns (record, trainer, the live weights
    before training, the final ones). The train steps' span
    of each epoch comes from CUDA events at the start of its train pass and
    after its last step (replay): the optimizer's step hook would fire only
    at a capture."""
    from multivae_tpu_torch.tools import workloads
    from multivae_tpu_torch.trainers import BaseTrainer, BaseTrainerConfig
    from multivae_tpu_torch.trainers.base.callbacks import TrainingCallback

    class Spans(TrainingCallback):
        def __init__(self):
            self.spans, self.count, self.start = [], 0, None

        def graph_state(self):
            return (self.graphs.captures, self.graphs.warm)

        def on_train_step_begin(self, training_config, **kwargs):
            self.start = torch.cuda.Event(enable_timing=True)
            self.start.record()
            self.count = 0
            self.state = self.graph_state()

        def on_train_step_end(self, training_config, **kwargs):
            self.count += 1
            if self.count == self.n_batches:
                end = torch.cuda.Event(enable_timing=True)
                end.record()
                # steady: no capture and no eager warm-up chunk in the span
                steady = self.graph_state() == self.state and (
                    self.state[1] or training_config.steps_per_execution == 1)
                self.spans.append((self.start, end, steady))

    w = workloads.build(name, n=rows, device=device)
    spans = Spans()
    spans.graphs = None
    n_batches = -(-rows // w.trainer_kwargs["per_device_train_batch_size"])
    spans.n_batches = n_batches
    cfg = BaseTrainerConfig(output_dir=out, num_epochs=epochs, seed=0, cache_on_device=True,
                            steps_per_execution=steps or n_batches, pipeline_epochs=pipeline,
                            steps_saving=steps_saving,
                            **{**w.trainer_kwargs, **(overrides or {})})
    trainer = (w.trainer_cls or BaseTrainer)(w.model, w.train, w.eval, training_config=cfg,
                                             callbacks=[spans, *callbacks],
                                             checkpoint=checkpoint,
                                             device=device)
    check(trainer._train_cache is not None and (w.eval is None or trainer._eval_cache is not None),
          f"{name}: a cache came back None")
    spans.graphs = trainer._graphs["train"]
    if on_trainer is not None:
        on_trainer(trainer)
    if capturable and torch.device(device).type == "cuda":
        from multivae_tpu_torch.trainers.base.optim import make_capturable

        build = trainer._build_optimizer

        def build_capturable():   # a MultistageTrainer's reset builds anew
            build()
            make_capturable(trainer.optimizer)

        trainer._build_optimizer = build_capturable
        make_capturable(trainer.optimizer)
    start = {k: v.detach().clone() for k, v in w.model.state_dict().items()}
    trainer_start = len(trainer.history)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved, held = torch.cuda.memory_reserved(), torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    mx.reset_launches()   # the sanity check's forward at construction stays out
    t0 = time.perf_counter()
    trainer.train()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    ms = [a.elapsed_time(b) for a, b, _ in spans.spans]
    # the first epoch holds the cuDNN and allocator warm-up; a graphed epoch
    # with a capture or an eager chunk is no steady state either
    steady = [t for i, (t, (_, _, ok)) in enumerate(zip(ms, spans.spans)) if i and ok]
    graphs = trainer._graphs
    record = {
        "steps_per_execution": cfg.steps_per_execution, "pipeline_epochs": pipeline,
        "pipelined": trainer._pipeline_epochs_eligible(),
        "cudnn_deterministic": torch.backends.cudnn.deterministic,
        "n_batches": n_batches, "epochs_run": len(trainer.history) - trainer_start,
        "eval_batches": 0 if w.eval is None else len(trainer.eval_loader),
        "epoch_losses": [h["train_epoch_loss"] for h in trainer.history],
        "eval_losses": [h["eval_epoch_loss"] for h in trainer.history if "eval_epoch_loss" in h],
        "train_span_ms": ms, "steady_epochs": len(steady),
        "steps_per_s": (len(steady) * n_batches / (sum(steady) / 1e3)) if steady else None,
        "wall_s": wall_s, "launches": dict(mx.launches),
        "captures": {k: g.captures for k, g in graphs.items()},
        "replays": {k: g.replays for k, g in graphs.items()},
        "capture_s": sum(g.capture_s for g in graphs.values()),
        "reserved_growth_bytes": torch.cuda.memory_reserved() - reserved,
        "peak_above_held_bytes": torch.cuda.max_memory_allocated() - held}
    check(all(np.isfinite(record["epoch_losses"])), f"{name}: non-finite losses {record}")
    end = {k: v.detach().clone() for k, v in w.model.state_dict().items()}
    return record, trainer, start, end


def _move_gap(start, ours, ref):
    """The weights' moves from ``start`` to ``ours`` against those to
    ``ref``: their difference's norm over the reference move's, over every
    floating tensor."""
    num = den = 0.0
    for k, s in start.items():
        if not s.is_floating_point():
            continue
        move = (ref[k] - s).double()
        num += float((ours[k] - s - move).double().norm()) ** 2
        den += float(move.norm()) ** 2
    return (num / den) ** 0.5 if den else 0.0


def _replayed_kernels(trainer, n):
    """(the mixture kernels one replay of ``trainer``'s ``n``-step train
    graph launches, as torch.profiler sees them, by the kernel's mode; the
    launches the counters add for each replay of that graph). The replay
    goes to the graph itself, so the counters do not move."""
    from torch.profiler import ProfilerActivity, profile

    (graph, captured), = [v for k, v in trainer._graphs["train"].graphs.items() if k[0] == n]
    # the chunk's first plan row: the epoch's last chunk may have been a
    # shorter remainder, whose start would take this graph past the plan
    trainer._chunk_start["train"].fill_(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        graph.replay()
        torch.cuda.synchronize()
    modes = {"0": "fwd", "1": "bwd_dz", "2": "bwd"}   # csrc/mixture.cu's Mode
    seen = {k: 0 for k in KERNELS}
    for e in prof.events():
        found = (e.device_type == torch.autograd.DeviceType.CUDA
                 and re.search(r"mixture_kernel<([^>]*)>", e.name))
        if found:
            args = found.group(1).split(",")
            mode = modes[args[4].strip()]
            seen[mode + ("_bf16" if "bfloat16" in args[0] else "")] += 1
    return seen, {k: captured.get(k, 0) for k in KERNELS}


def _loss_gaps(run, ref, start, ours_end, ref_end):
    """``run``'s train losses (first epoch, later ones), eval losses and
    weights' moves from ``start`` against ``ref``'s: relative gaps."""
    check(len(run["epoch_losses"]) == len(ref["epoch_losses"])
          and len(run["eval_losses"]) == len(ref["eval_losses"]),
          f"runs of unequal length: {run['epoch_losses']} {ref['epoch_losses']}")
    train = [_rel(a, b) for a, b in zip(run["epoch_losses"], ref["epoch_losses"])]
    return {"first_epoch_rel_gap": train[0], "later_epochs_rel_gap": max(train[1:], default=0.0),
            "eval_epochs_rel_gap": max((_rel(a, b) for a, b in zip(
                run["eval_losses"], ref["eval_losses"])), default=0.0),
            "move_rel_gap": _move_gap(start, ours_end, ref_end)}


# the kinds of loss gap the spread gate holds apart
LOSS_GAP_KINDS = ("first_epoch_rel_gap", "later_epochs_rel_gap", "eval_epochs_rel_gap")


def _tight(gaps):
    return max(gaps.values()) <= GRAPHED_RTOL


def graphed_steps(mx, device="cuda", workloads_=GRAPHED_WORKLOADS, chunk=GRAPHED_CHUNK):
    """The ``graphed_steps`` phase: each workload on its cached rows for its
    epochs, under cuDNN's deterministic algorithms, eager
    (``steps_per_execution=1``, ``pipeline_epochs=False``), then as CUDA
    graphs of ``chunk`` steps, then of the epoch's batch count with
    ``pipeline_epochs=True``. Beside them: the eager run with the
    capturable optimizer the graphs use (the graphs' arithmetic without
    the graphs), which every graphed run must equal, the eager run with
    cuDNN free (the card's own spread) and, from the ``chunk`` run's
    checkpoint of the epoch before its last, a resumed graphed run. Then
    the pipelined finalization off and on under a StepLR. Every run's
    record is printed before the checks. Returns (record, mixture
    launches)."""
    import shutil

    t_phase = time.perf_counter()
    out = os.path.join(ROOT, "build", "chip_smoke", "graphed")
    shutil.rmtree(out, ignore_errors=True)
    deterministic = torch.backends.cudnn.deterministic
    launches = {k: 0 for k in KERNELS}
    record = {"phase": "graphed_steps", "chunk": chunk}
    graphed = (f"graphed_{chunk}", "graphed_epoch")
    cuda = torch.device(device).type == "cuda"
    try:
        for name, rows, per_step, epochs in workloads_:
            t0 = time.perf_counter()
            runs, weights = {}, {}
            # label: steps a chunk (0: the epoch), pipelined, deterministic
            # cuDNN, checkpoint epoch, capturable optimizer at N = 1
            for label, steps, pipeline, det, saving, capturable in (
                    ("eager", 1, False, True, None, False),
                    ("eager_capturable", 1, False, True, None, True),
                    *((label, 1, False, False, None, False) for label in GRAPHED_SPREAD_RUNS),
                    (graphed[0], chunk, False, True, epochs - 1, False),
                    (graphed[1], 0, True, True, None, False)):
                torch.backends.cudnn.deterministic = det
                run, trainer, start, end = _graphed_run(
                    mx, name, rows, epochs, device, steps, pipeline,
                    os.path.join(out, name, label), steps_saving=saving,
                    capturable=capturable)
                runs[label], weights[label] = run, (start, end)
                if saving:
                    ckpt = os.path.join(trainer.training_dir, f"checkpoint_epoch_{epochs - 1}")
                if label == graphed[0] and per_step and cuda:
                    run["replayed_kernels"], run["counted_a_replay"] = _replayed_kernels(
                        trainer, chunk)
                del trainer
            # the graphed run resumed from its checkpoint: the last epoch again
            torch.backends.cudnn.deterministic = True
            runs["resumed"], _, _, resumed_end = _graphed_run(
                mx, name, rows, epochs, device, chunk, False,
                os.path.join(out, name, "resumed"), checkpoint=ckpt)
            ckpt_live = torch.load(os.path.join(ckpt, "live_params.pt"), map_location=device,
                                   weights_only=True)
            for run in runs.values():
                for k in KERNELS:
                    launches[k] += run["launches"][k]

            eager = runs["eager"]
            start = weights["eager"][0]

            def gaps(label, ref="eager"):
                return _loss_gaps(runs[label], runs[ref], start, weights[label][1],
                                  weights[ref][1])

            pairs = [gaps(a, b) for i, a in enumerate(GRAPHED_SPREAD_RUNS)
                     for b in ("eager",) + GRAPHED_SPREAD_RUNS[:i]]
            spread = {k: max(p[k] for p in pairs) for k in pairs[0]}
            loss_tols = {k: max(GRAPHED_SPREAD_FACTOR * spread[k], RESUME_RTOL)
                         for k in LOSS_GAP_KINDS}
            move_tol = max(GRAPHED_SPREAD_FACTOR * spread["move_rel_gap"], RESUME_MOVE_RTOL)
            rec = {"rows": rows, "epochs": epochs, "n_batches": eager["n_batches"],
                   "spread": spread, "loss_tols": loss_tols, "move_tol": move_tol,
                   "capturable_optimizer_vs_eager": gaps("eager_capturable")}
            keys = ("steps_per_execution", "pipelined", "steps_per_s", "steady_epochs",
                    "wall_s", "captures", "replays", "capture_s", "reserved_growth_bytes",
                    "peak_above_held_bytes", "launches", "epoch_losses", "eval_losses",
                    "train_span_ms")
            for label, run in runs.items():
                rec[label] = {k: run[k] for k in keys}
            for label in graphed:
                rate = runs[label]["steps_per_s"]
                rec[label].update(gaps(label), vs_eager_capturable=gaps(label, "eager_capturable"),
                                  steps_per_s_over_eager=rate and rate / eager["steps_per_s"])
            if "replayed_kernels" in runs[graphed[0]]:
                rec[graphed[0]].update({k: runs[graphed[0]][k] for k in (
                    "replayed_kernels", "counted_a_replay")})
            # the resumed last epoch against the uninterrupted graphed run's
            last = {k: runs[graphed[0]][k][-1:] for k in ("epoch_losses", "eval_losses")}
            resume = _loss_gaps(runs["resumed"], last, ckpt_live, resumed_end,
                                weights[graphed[0]][1])
            rec["resumed"].update(resume)
            rec["seconds"] = time.perf_counter() - t0
            record[name] = rec
            print(json.dumps({"phase": "graphed_steps", "workload": name, **rec}), flush=True)

            # the mixture kernels: their count a step on every train and eval
            # step, whichever way the steps ran
            per_step = per_step or {}
            for label, run in runs.items():
                expected = {k: per_step.get(k, 0) * run["epochs_run"] * run["n_batches"]
                            for k in KERNELS}
                expected["fwd"] += per_step.get("fwd", 0) * run["epochs_run"] * run["eval_batches"]
                check(run["launches"] == expected,
                      f"{name} {label}: expected {expected} launches, got {run['launches']}")
            if per_step and cuda:
                # what a replay launches, seen by the profiler, is what the
                # counters add for it
                want = {k: per_step.get(k, 0) * chunk for k in KERNELS}
                got = runs[graphed[0]]
                check(got["replayed_kernels"] == got["counted_a_replay"] == want,
                      f"{name}: one replay of the {chunk}-step graph launched "
                      f"{got['replayed_kernels']}, counted {got['counted_a_replay']}, "
                      f"expected {want}")
            check(runs["resumed"]["epochs_run"] == 1,
                  f"{name}: the resume ran {runs['resumed']['epochs_run']} epochs")
            for label in graphed:
                replays = runs[label]["replays"]
                check(not cuda or (replays["train"] > 0 and (
                    runs[label]["eval_batches"] == 0 or replays["eval"] > 0)),
                      f"{name} {label}: a kind of graph never replayed {replays}")
                tight = rec[label]["vs_eager_capturable"]
                check(_tight(tight), f"{name} {label}: off the eager run with the capturable "
                      f"optimizer by {tight} > {GRAPHED_RTOL}")
            check(_tight(resume), f"{name}: the resumed graphed run is off the "
                  f"uninterrupted one by {resume} > {GRAPHED_RTOL}")
            for label in graphed + ("eager_capturable",):
                got = gaps(label)
                for k in LOSS_GAP_KINDS:
                    check(got[k] <= loss_tols[k], f"{name} {label}: {k} {got[k]} off the "
                          f"eager run's > {loss_tols[k]} (all gaps {got})")
                check(got["move_rel_gap"] <= move_tol,
                      f"{name} {label}: moves off the eager run's by {got} > {move_tol}")
            del runs, weights
        record["pipeline"] = _pipeline_runs(mx, device, os.path.join(out, "pipeline"))
    finally:
        torch.backends.cudnn.deterministic = deterministic
        shutil.rmtree(out, ignore_errors=True)
    record["seconds"] = time.perf_counter() - t_phase
    record["launches"] = launches
    return record, launches


def _pipeline_runs(mx, device, out):
    """``PIPELINE_WORKLOAD`` under ``PIPELINE_SETTINGS`` for
    ``PIPELINE_EPOCHS`` epochs: eager with the capturable optimizer, then
    whole-epoch graphs with ``pipeline_epochs`` off, on, off, on, each of
    which must replay and equal the eager run within ``GRAPHED_RTOL``, its
    kept weights too. Prints and returns the walls and peaks of each."""
    t0 = time.perf_counter()
    torch.backends.cudnn.deterministic = True
    args = (mx, PIPELINE_WORKLOAD, GRAPHED_ROWS, PIPELINE_EPOCHS, device)
    ref, trainer, start, ref_end = _graphed_run(
        *args, 1, False, os.path.join(out, "eager_capturable"), capturable=True,
        overrides=PIPELINE_SETTINGS)
    ref_kept = trainer._best_state
    del trainer
    keys = ("pipelined", "wall_s", "steps_per_s", "captures", "replays",
            "peak_above_held_bytes", "reserved_growth_bytes")
    runs = []
    for i, pipeline in enumerate((False, True, False, True)):
        run, trainer, _, end = _graphed_run(
            *args, 0, pipeline, os.path.join(out, str(i)), overrides=PIPELINE_SETTINGS)
        gaps = _loss_gaps(run, ref, start, end, ref_end)
        gaps["kept_move_rel_gap"] = _move_gap(start, trainer._best_state, ref_kept)
        del trainer
        runs.append({**{k: run[k] for k in keys}, "vs_eager_capturable": gaps})
    wall = {p: sum(r["wall_s"] for r in runs if r["pipelined"] == p) for p in (False, True)}
    rec = {"workload": PIPELINE_WORKLOAD, "rows": GRAPHED_ROWS, "epochs": PIPELINE_EPOCHS,
           "settings": PIPELINE_SETTINGS, "eager_capturable_wall_s": ref["wall_s"],
           "runs": runs, "pipelined_over_sync_wall": wall[True] / wall[False] if wall[False] else None,
           "seconds": time.perf_counter() - t0}
    print(json.dumps({"phase": "graphed_steps", "pipeline": rec}), flush=True)
    for pipeline, run in zip((False, True, False, True), runs):
        check(run["pipelined"] == pipeline, f"pipeline_epochs={pipeline} ran {run['pipelined']}")
        check(torch.device(device).type != "cuda" or run["replays"]["train"] > 0,
              f"no train graph replayed {run['replays']}")
        check(_tight(run["vs_eager_capturable"]),
              f"{PIPELINE_WORKLOAD} whole-epoch graphs (pipeline_epochs={pipeline}) off the "
              f"eager run by {run['vs_eager_capturable']} > {GRAPHED_RTOL}")
    return rec

# ---------------------------------------------------------- data_parallel
# (workload, train rows, mixture launches a train step). mmvae_conv's 1,024
# rows make 4 full global batches of 256; mvtcae_conv's 1,000 leave a last
# batch of 232 rows and 24 padding rows, which fall on rank 1 of 2.
DP_WORKLOADS = (("mmvae_conv", 1024, {"fwd": 2, "bwd_dz": 1}), ("mvtcae_conv", 1000, {}))
DP_EPOCHS = 1
DP_BATCH = 256                 # the global train and eval batch
DP_RANK_TIMEOUT = 480          # seconds a spawned rank may take
DP_GROUP_TIMEOUT = 120         # seconds a collective may wait for its partners
# N ranks against one process on the global batch, under cuDNN's
# deterministic algorithms on both sides: the same steps on the same draws
# and batches, but each rank sums its half of every batch reduction (the
# loss, the convolutions' weight gradients) before the all-reduce adds the
# halves. On the CPU the tests (tests/test_torch_data_parallel.py: the 14
# families at small widths under SGD) find that order moves the epoch
# losses by at most 1.4e-5 relative and the weights by 3e-7. A CPU
# rehearsal of this phase (batch 16 over 2 gloo ranks, 64 and 60 rows, 32
# eval rows, 2 epochs, Adam) found gaps of 9.3e-6 (train) and 5.5e-6
# (eval) in the epoch losses and 1.6e-2 in the weights' moves for
# mmvae_conv, 1.3e-7, 2.1e-7 and 1.0e-3 for mvtcae_conv: Adam turns a
# gradient entry near 0 into a step of the rate's size in a direction that
# float32 noise sets, and MMVAE's DReG gradients hold many. The gates: the
# losses within DP_RTOL (10x the larger loss gap), the moves within
# DP_MOVE_RTOL (6x), which the wrong noise misses (a resume without the
# generator's state moved mmvae_conv's weights by 0.40 in trainer_lifecycle).
DP_RTOL = 1e-4
DP_MOVE_RTOL = 0.1


class _TimedReducer:
    """The trainer's gradient reducer, each call bracketed by CUDA events
    (and host time), counting its calls."""

    def __init__(self, reducer):
        self.reducer, self.events, self.host_s = reducer, [], []

    def __call__(self):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        self.reducer()
        b.record()
        self.host_s.append(time.perf_counter() - t0)
        self.events.append((a, b))

    def summary(self) -> dict:
        ms = [a.elapsed_time(b) for a, b in self.events]
        return {"calls": len(ms), "ms_per_step": float(np.median(ms)),
                "host_ms_per_step": 1e3 * float(np.median(self.host_s)),
                "bytes_per_step": self.reducer.bytes_reduced}


def _pass_launches(mx):
    """A callback that counts the mixture launches of the train passes and
    of the eval passes apart, reading the counters at the start of each
    pass and at ``close``."""
    from multivae_tpu_torch.trainers.base.callbacks import TrainingCallback

    class PassLaunches(TrainingCallback):
        def __init__(self):
            self.current, self.mark = None, None
            self.launches = {"train": {k: 0 for k in KERNELS},
                             "eval": {k: 0 for k in KERNELS}}

        def _switch(self, which):
            if self.current is not None:
                for k in KERNELS:
                    self.launches[self.current][k] += mx.launches[k] - self.mark[k]
            self.current, self.mark = which, dict(mx.launches)

        def on_train_step_begin(self, training_config, **kwargs):
            self._switch("train")

        def on_eval_step_begin(self, training_config, **kwargs):
            self._switch("eval")

        def close(self):
            self._switch(None)

    return PassLaunches()


def _dp_run(mx, name, rows, per_step, per_device, device="cuda", epochs=DP_EPOCHS,
            eval_step=None, overrides=None, output_dir=None, workload=None):
    """``name`` of ``tools/workloads.py`` on ``rows`` seeded rows (or the
    built ``workload``), trained ``epochs`` epochs by ``BaseTrainer`` at
    ``per_device`` rows a device (``overrides`` of its trainer settings),
    alone or as this rank of the process group that exists; returns (its
    record, the start and final weights on the host). The mixture kernels
    must launch ``per_step`` times on each train step and ``eval_step``
    (default: its forwards) on each eval step, on this process's counters.
    The training folder is removed at the end, unless it is under
    ``output_dir``; the record holds its checkpoints' ``checkpoint_times``,
    and where a leaf is cut the placements of the cut leaves and every
    leaf's bytes at rest with its optimizer state."""
    from multivae_tpu_torch.parallel.state import state_nbytes
    from multivae_tpu_torch.tools import workloads
    from multivae_tpu_torch.trainers import BaseTrainer, BaseTrainerConfig

    w = workload if workload is not None else workloads.build(name, n=rows, device=device)
    kwargs = dict(w.trainer_kwargs, per_device_train_batch_size=per_device,
                  per_device_eval_batch_size=per_device, **(overrides or {}))
    passes = _pass_launches(mx)
    trainer = BaseTrainer(w.model, w.train, w.eval, device=device, callbacks=[passes],
                          training_config=BaseTrainerConfig(
                              output_dir=output_dir or os.path.join(ROOT, "build", "chip_smoke",
                                                                    "dp"),
                              num_epochs=epochs, seed=0, **kwargs))
    start = {k: v.detach().cpu().clone() for k, v in w.model.state_dict().items()}
    timer = None
    if trainer._reducer is not None:
        timer = trainer._reducer = _TimedReducer(trainer._reducer)
    step_ends = []

    def on_step(*_):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        step_ends.append((len(trainer.history), ev))

    trainer.optimizer.register_step_post_hook(on_step)
    torch.cuda.synchronize()
    mx.reset_launches()
    t0 = time.perf_counter()
    trainer.train()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    passes.close()
    launches = dict(mx.launches)
    steps = epochs * len(trainer.train_loader)
    eval_steps = 0 if w.eval is None else epochs * len(trainer.eval_loader)
    check(len(step_ends) == steps, f"{name}: expected {steps} steps, ran {len(step_ends)}")
    who = f"{name} (rank {trainer.mesh.rank} of {trainer.mesh.world_size})"
    for which, n, want in (("train", steps, per_step),
                           ("eval", eval_steps, eval_step or {"fwd": per_step.get("fwd", 0)})):
        expected = {k: want.get(k, 0) * n for k in KERNELS}
        check(passes.launches[which] == expected,
              f"{who}: expected {expected} launches in the {which} passes, "
              f"got {passes.launches[which]}")
    losses = [h["train_epoch_loss"] for h in trainer.history]
    check(all(np.isfinite(losses)), f"{name}: non-finite epoch loss {losses}")
    gaps = [a.elapsed_time(b) for (ea, a), (eb, b) in zip(step_ends, step_ends[1:]) if ea == eb]
    record = {"world": trainer.mesh.world_size, "rank": trainer.mesh.rank,
              "backend": trainer.mesh.backend, "device": str(trainer.device),
              "per_device_batch": per_device, "steps": steps, "eval_steps": eval_steps,
              "epoch_losses": losses, "eval_losses": [h["eval_epoch_loss"] for h in trainer.history],
              "lr": trainer.optimizer.param_groups[0]["lr"],
              "steps_per_s": len(gaps) / (sum(gaps) / 1e3), "wall_s": wall_s,
              "launches": launches, "launches_per_step": {
                  which: {k: v / n for k, v in passes.launches[which].items()}
                  for which, n in (("train", steps), ("eval", eval_steps)) if n}}
    if timer is not None:
        record["all_reduce"] = timer.summary()
        check(record["all_reduce"]["calls"] == steps,
              f"{name}: {record['all_reduce']['calls']} gradient all-reduces in {steps} steps")
    if trainer._state is not None:
        record["mesh"] = {"n_data": trainer.mesh.n_data, "n_model": trainer.mesh.n_model}
        if trainer._state.cuts:
            record["placements"] = {k: v for k, v in trainer._state.placements.items() if v}
            record["leaf_bytes"] = {leaf.name: state_nbytes([leaf.master], trainer.optimizer)
                                    for leaf in trainer._state.leaves}
    record["state_bytes"] = _state_bytes(trainer)
    if trainer._train_cache is not None:
        from multivae_tpu_torch.data.device_cache import cache_per_device_nbytes

        record["train_cache"] = {"kind": type(trainer._train_cache).__name__,
                                 "bytes": cache_per_device_nbytes(trainer._train_cache)}
    if trainer.checkpoint_times:
        record["checkpoint"] = dict(trainer.checkpoint_times, training_dir=trainer.training_dir)
    final = {k: v.detach().cpu().clone() for k, v in w.model.state_dict().items()}
    # every rank has left train(): the final model is written
    if trainer.is_main_process and output_dir is None:
        shutil.rmtree(trainer.training_dir, ignore_errors=True)
    del trainer, w
    torch.cuda.empty_cache()
    return record, start, final


def _state_bytes(trainer) -> dict:
    """This rank's bytes at rest on the card: its parameters and optimizer
    state (the cut leaves' apart), the whole weights best-model tracking
    keeps (the kept state and a pipelined window's candidate where that is
    another buffer: whole under every layout), and their sum."""
    from multivae_tpu_torch.parallel.state import state_nbytes

    if trainer._state is not None:
        out = trainer._state.nbytes(trainer.optimizer)
    else:
        out = {"params_and_optimizer": state_nbytes(trainer.model.parameters(),
                                                    trainer.optimizer)}
    kept = [trainer._best_state]
    if trainer._candidate is not None and trainer._candidate["state"] is not kept[0]:
        kept.append(trainer._candidate["state"])
    out["kept_whole"] = sum(v.numel() * v.element_size()
                            for state in kept if state is not None for v in state.values())
    out["with_kept"] = out["params_and_optimizer"] + out["kept_whole"]
    return out


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dp_rank_main(argv, device="cuda"):
    """A spawned rank: ``--dp-rank R WORLD PORT BACKEND OUT``. Joins the
    group at ``tcp://127.0.0.1:PORT`` and runs every workload of
    ``DP_WORKLOADS`` at its share of ``DP_BATCH``, saving each record and
    final weights under ``OUT``; then ``dp_sharded`` and ``dp_evaluators``
    over the group (and the likelihoods' control, ``_draws_per_rank``), and
    over NCCL ``dp_graphed_rank``, saving their records."""
    import datetime

    import torch.distributed as dist

    rank, world, port, backend, out = int(argv[0]), int(argv[1]), argv[2], argv[3], argv[4]
    from multivae_tpu_torch.ops import mixture as mx

    if device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.deterministic = True
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}", world_size=world,
                            rank=rank, timeout=datetime.timedelta(seconds=DP_GROUP_TIMEOUT))
    try:
        for name, rows, per_step in DP_WORKLOADS:
            record, _, final = _dp_run(mx, name, rows, per_step, DP_BATCH // world, device)
            torch.save(final, os.path.join(out, f"{name}_rank{rank}.pt"))
            with open(os.path.join(out, f"{name}_rank{rank}.json"), "w") as f:
                json.dump(record, f)
        with open(os.path.join(out, f"sharded_rank{rank}.json"), "w") as f:
            json.dump(dp_sharded(mx, device), f)
        record, _ = dp_evaluators(mx, device, n_devices=world)
        with open(os.path.join(out, f"evaluators_rank{rank}.json"), "w") as f:
            json.dump(record, f)
        with _draws_per_rank():
            record, _ = dp_evaluators(mx, device, n_devices=world, labels=DP_EVAL_CONTROL)
        with open(os.path.join(out, f"control_rank{rank}.json"), "w") as f:
            json.dump(record, f)
        if backend in DP_GRAPHED_BACKENDS:
            record, final = dp_graphed_rank(mx, device)
            torch.save(final, os.path.join(out, f"graphed_rank{rank}.pt"))
            with open(os.path.join(out, f"graphed_rank{rank}.json"), "w") as f:
                json.dump(record, f)
    finally:
        dist.destroy_process_group()
    return 0


def _spawn_ranks(world, backend, out, command, extra=(), timeout=None):
    """``world`` ranks of ``command`` (``dp_rank_main``'s, or
    ``ss_rank_main``'s with its ``extra`` arguments) over ``backend``; each
    must exit 0 within ``timeout`` (default ``DP_RANK_TIMEOUT``), or the
    phase fails (every rank is killed), with the end of every rank's log."""
    os.makedirs(out, exist_ok=True)
    port = str(_free_port())
    logs = [open(os.path.join(out, f"rank{r}.log"), "w") for r in range(world)]
    procs = [subprocess.Popen(command + [str(r), str(world), port, backend, out, *extra],
                              cwd=ROOT, stdout=logs[r], stderr=subprocess.STDOUT)
             for r in range(world)]
    deadline = time.monotonic() + (timeout or DP_RANK_TIMEOUT)

    def tails():
        for f in logs:
            f.flush()
        return "".join(f"\n--- rank {q}:\n" + open(os.path.join(out, f"rank{q}.log")).read()[-4000:]
                       for q in range(world))

    try:
        for r, p in enumerate(procs):
            try:
                p.wait(timeout=max(deadline - time.monotonic(), 1))
            except subprocess.TimeoutExpired:
                raise SmokeFailure(f"{backend} rank {r} of {world} timed out:{tails()}")
            if p.returncode:
                with open(os.path.join(out, f"rank{r}.log")) as f:
                    tail = f.read()[-3000:]
                raise SmokeFailure(f"{backend} rank {r} of {world} exited {p.returncode}:\n{tail}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()


def _dp_compare(label, ref, ref_start, ref_final, run, final, exact):
    """``run`` (record, final weights) against the one-process ``ref``: gap 0
    (``exact``) or within DP_RTOL / DP_MOVE_RTOL."""
    gaps = {"train_rel_gap": max(_rel(a, b) for a, b in zip(run["epoch_losses"],
                                                             ref["epoch_losses"])),
            "eval_rel_gap": max(_rel(a, b) for a, b in zip(run["eval_losses"],
                                                            ref["eval_losses"])),
            "move_rel_gap": _move_gap(ref_start, final, ref_final)}
    if exact:
        same = all(torch.equal(final[k], v) for k, v in ref_final.items())
        check(same and run["epoch_losses"] == ref["epoch_losses"]
              and run["eval_losses"] == ref["eval_losses"],
              f"{label}: not equal to the run with no group: {gaps}")
    else:
        check(gaps["train_rel_gap"] <= DP_RTOL and gaps["eval_rel_gap"] <= DP_RTOL
              and gaps["move_rel_gap"] <= DP_MOVE_RTOL,
              f"{label}: beyond {DP_RTOL} / {DP_MOVE_RTOL} of the run with no group: {gaps}")
    check(run["lr"] == ref["lr"], f"{label}: rate {run['lr']} against {ref['lr']}")
    return gaps


# The data-parallel paths that finish the JAX package's surface: graphed
# chunks in an NCCL group, the row-sharded device cache over ranks and the
# evaluators over ranks.
# (workload, rows, epochs, steps a chunk): mmvae_conv's DReG step (partial
# PolyMNIST, batch 256) on 1,024 cached rows, 4 steps an epoch: epoch 1 runs
# the eager chunk, epoch 2 captures, epoch 3 replays (2,048 rows and 8 steps
# until the state_sharding phase's mvtcae_cub needed the time)
DP_GRAPHED = ("mmvae_conv", 1024, 3, 4)
# (workload, rows): the two gloo ranks' sharded-cache runs; "auto" gets a
# budget of DP_AUTO_BUDGET of the set's bytes, which only the sharded layout
# (half a set a rank) fits
DP_SHARDED = ("mmvae_conv", 2048)
DP_AUTO_BUDGET = 0.75
# the evaluators over ranks: these models (seeded, untrained) on EVAL_ROWS
# labelled rows; the coherence's joint samples and the clustering's runs cut
DP_EVAL_MODELS = ("mmvae_conv", "mvtcae_conv")
DP_EVAL_LABELS = ("likelihoods", "coherence", "reconstruction", "clustering", "fid_subsets")
DP_EVAL_JOINT, DP_EVAL_CLUSTER_RUNS = 512, 1
# the sharded-cache runs' epochs
DP_SHARDED_EPOCHS = 1


@contextlib.contextmanager
def _captured_collectives():
    """Counts the ``torch.distributed.all_reduce`` calls made while a CUDA
    graph captures (the gradient all-reduce, a loss's normalizers, the
    sharded cache's exchange all go through it): a list whose length is
    the count."""
    import torch.distributed as dist

    calls, plain = [], dist.all_reduce

    def counting(*args, **kwargs):
        if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
            calls.append(args[0].numel() * args[0].element_size())
        return plain(*args, **kwargs)

    dist.all_reduce = counting
    try:
        yield calls
    finally:
        dist.all_reduce = plain


def _replay_profile(trainer, n):
    """``_replayed_kernels`` of the ``n``-step train graph, and of another
    replay of it the device-side activities whose names say NCCL, their
    count, and every activity's count by name."""
    from torch.profiler import ProfilerActivity, profile

    seen, counted = _replayed_kernels(trainer, n)
    (graph, _), = [v for k, v in trainer._graphs["train"].graphs.items() if k[0] == n]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        graph.replay()
        torch.cuda.synchronize()
    names = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            names[e.name] = names.get(e.name, 0) + 1
    nccl = {k: v for k, v in names.items() if "nccl" in k.lower()}
    return seen, counted, nccl, sum(names.values()), names


def dp_graphed(mx, device="cuda", backend="nccl"):
    """``DP_GRAPHED`` graphed (cached, ``steps_per_execution`` 8) alone and
    in a one-process ``backend`` group opened here, cuDNN deterministic,
    each with the capturable optimizer the graphs use: bit-equal losses and
    weights, exact mixture launches, the collectives issued inside the
    captures, and one replay of the 4-step graph profiled (its mixture
    kernels, and what NCCL launched). Returns (record, launches)."""
    import datetime

    import torch.distributed as dist

    name, rows, epochs, chunk = DP_GRAPHED
    t0 = time.perf_counter()
    out = os.path.join(ROOT, "build", "chip_smoke", "dp_graphed")
    shutil.rmtree(out, ignore_errors=True)
    cuda = torch.device(device).type == "cuda"
    alone, trainer, start, end = _graphed_run(mx, name, rows, epochs, device, chunk, False,
                                              os.path.join(out, "alone"))
    alone_profile = _replay_profile(trainer, chunk) if cuda else None
    del trainer
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{_free_port()}",
                            world_size=1, rank=0,
                            timeout=datetime.timedelta(seconds=DP_GROUP_TIMEOUT))
    try:
        with _captured_collectives() as captured:
            group, trainer, group_start, group_end = _graphed_run(
                mx, name, rows, epochs, device, chunk, False, os.path.join(out, "group"))
        check(trainer._reducer is not None, "the trainer in the group has no gradient reducer")
        bytes_reduced = trainer._reducer.bytes_reduced
        profiled = _replay_profile(trainer, chunk) if cuda else None
        del trainer
    finally:
        dist.destroy_process_group()
        shutil.rmtree(out, ignore_errors=True)
    per_step, eval_fwd = {"fwd": 2, "bwd_dz": 1}, 2
    launches = {k: 0 for k in KERNELS}
    for run in (alone, group):
        expected = {k: per_step.get(k, 0) * run["epochs_run"] * run["n_batches"]
                    for k in KERNELS}
        expected["fwd"] += eval_fwd * run["epochs_run"] * run["eval_batches"]
        check(run["launches"] == expected,
              f"dp_graphed: expected {expected} launches, got {run['launches']}")
        check(not cuda or (run["replays"]["train"] > 0 and run["replays"]["eval"] > 0),
              f"dp_graphed: a kind of graph never replayed {run['replays']}")
        for k in KERNELS:
            launches[k] += run["launches"][k]
    record = {"workload": name, "rows": rows, "epochs": epochs, "steps_per_execution": chunk,
              "backend": backend, "alone_steps_per_s": alone["steps_per_s"],
              "group_steps_per_s": group["steps_per_s"],
              "group_over_alone": (group["steps_per_s"] / alone["steps_per_s"]
                                   if alone["steps_per_s"] else None),
              "captures": group["captures"], "replays": group["replays"],
              "collectives_captured": len(captured), "bytes_captured": sum(captured),
              "gradient_bytes_a_step": bytes_reduced,
              "epoch_losses": group["epoch_losses"], "eval_losses": group["eval_losses"]}
    if profiled is not None:
        seen, counted, nccl, device_events, _ = profiled
        record.update(replayed_kernels=seen, counted_a_replay=counted,
                      nccl_in_a_replay=nccl, device_activities_in_a_replay=device_events,
                      device_activities_in_a_replay_alone=alone_profile[3])
        # what the group's replay runs beyond the replay alone: the
        # reducer's copies into its flat buffer, and NCCL's one-rank work
        names = set(profiled[4]) | set(alone_profile[4])
        record["replay_activities_group_minus_alone"] = {
            k: profiled[4].get(k, 0) - alone_profile[4].get(k, 0) for k in sorted(names)
            if profiled[4].get(k, 0) != alone_profile[4].get(k, 0)}
        want = {k: per_step.get(k, 0) * chunk for k in KERNELS}
        check(seen == counted == want, f"dp_graphed: a replay launched {seen}, counted "
              f"{counted}, expected {want}")
    print(json.dumps({"phase": "data_parallel", "graphed": record}), flush=True)
    same = all(torch.equal(group_start[k], v) for k, v in start.items()) and all(
        torch.equal(group_end[k], v) for k, v in end.items())
    check(same and group["epoch_losses"] == alone["epoch_losses"]
          and group["eval_losses"] == alone["eval_losses"],
          "dp_graphed: the graphed run in the group is not bit-equal to the one alone")
    # one gradient all-reduce a step of every captured chunk at least
    check(not cuda or len(captured) >= chunk,
          f"dp_graphed: {len(captured)} collectives captured, expected at least {chunk}")
    record["seconds"] = time.perf_counter() - t0
    return record, launches, (alone, start, end)


# the backends whose spawned ranks also run DP_GRAPHED's graphed chunks
# (gloo collectives cannot be captured)
DP_GRAPHED_BACKENDS = ("nccl",)


def dp_graphed_rank(mx, device="cuda"):
    """In a rank of the process group: ``DP_GRAPHED`` as CUDA graphs at this
    rank's share of the global batch of ``DP_BATCH``, from row-sharded
    caches (so that each captured step also exchanges its batch), with
    exact mixture launches on this rank's counters and one replay of the
    4-step graph profiled on every rank at once (its mixture kernels and
    what NCCL launched). Returns (record, final weights on the host)."""
    import torch.distributed as dist

    name, rows, epochs, chunk = DP_GRAPHED
    world, rank = dist.get_world_size(), dist.get_rank()
    out = os.path.join(ROOT, "build", "chip_smoke", f"dp_graphed_rank{rank}")
    per_device = DP_BATCH // world
    run, trainer, _, end = _graphed_run(mx, name, rows, epochs, device, chunk, False, out,
                                        overrides=dict(per_device_train_batch_size=per_device,
                                                       per_device_eval_batch_size=per_device,
                                                       device_cache_layout="sharded"))
    check(type(trainer._train_cache).__name__ == "ShardedDeviceDataCache",
          f"dp_graphed rank {rank}: cached {type(trainer._train_cache).__name__}")
    profiled = _replay_profile(trainer, chunk) if torch.device(device).type == "cuda" else None
    del trainer
    dist.barrier()
    shutil.rmtree(out, ignore_errors=True)
    expected = {k: {"fwd": 2, "bwd_dz": 1}.get(k, 0) * run["epochs_run"] * run["n_batches"]
                for k in KERNELS}
    expected["fwd"] += 2 * run["epochs_run"] * run["eval_batches"]
    check(run["launches"] == expected,
          f"dp_graphed rank {rank}: expected {expected} launches, got {run['launches']}")
    record = {k: run[k] for k in ("steps_per_s", "captures", "replays", "launches",
                                  "epoch_losses", "eval_losses", "eval_batches")}
    record.update(rank=rank, world=world, per_device_batch=per_device)
    if profiled is not None:
        record.update(replayed_kernels=profiled[0], nccl_in_a_replay=profiled[2],
                      device_activities_in_a_replay=profiled[3])
    return record, {k: v.detach().cpu() for k, v in end.items()}


def _batches_equal(a, b):
    """Two ``MultimodalBatch``es bit for bit (data leaves, masks, labels on
    the host, weights)."""
    from multivae_tpu_torch.data.batch import map_leaves

    leaves = []
    for m in a.data:
        map_leaves(leaves.append, a.data[m])
    other = []
    for m in b.data:
        map_leaves(other.append, b.data[m])
    pairs = list(zip(leaves, other)) + [(a.masks[m], b.masks[m]) for m in a.masks]
    pairs.append((a.weights.cpu(), b.weights.cpu()))
    if a.labels is not None or b.labels is not None:
        pairs.append((a.labels.cpu(), b.labels.cpu()))
    return len(leaves) == len(other) and all(
        x.dtype == y.dtype and torch.equal(x, y.to(x.device)) for x, y in pairs)


def dp_sharded(mx, device="cuda"):
    """In a rank of the process group: ``DP_SHARDED``'s train set cached
    replicated, row-sharded and "auto" with a budget only the sharded layout
    fits; an epoch's batches from each, bit-equal, the sharded exchange's
    ms and bytes a step; then the workload trained from the replicated and
    from the sharded cache, bit-equal. Returns the record."""
    from multivae_tpu_torch.data import DataLoader
    from multivae_tpu_torch.data.device_cache import (
        PlanBuffer,
        ShardedDeviceDataCache,
        build_device_cache,
        cache_per_device_nbytes,
        estimate_dataset_nbytes,
    )
    from multivae_tpu_torch.parallel import get_data_mesh
    from multivae_tpu_torch.tools import workloads

    name, rows = DP_SHARDED
    t0 = time.perf_counter()
    mesh = get_data_mesh(None, device)
    world = mesh.world_size
    w = workloads.build(name, n=rows, n_eval=0, device=device)
    est = estimate_dataset_nbytes(w.train)
    caches = {layout: build_device_cache(w.train, mesh.device, budget, layout=layout, mesh=mesh)
              for layout, budget in (("replicated", int(8e9)), ("sharded", int(8e9)),
                                     ("auto", int(DP_AUTO_BUDGET * est)))}
    kinds = {k: type(c).__name__ for k, c in caches.items()}
    check(kinds == {"replicated": "DeviceDataCache", "sharded": "ShardedDeviceDataCache",
                    "auto": "ShardedDeviceDataCache"}, f"dp_sharded: caches {kinds}")
    nbytes = {k: cache_per_device_nbytes(c) for k, c in caches.items()}
    block = -(-rows // world)
    check(nbytes["sharded"] == nbytes["auto"] == nbytes["replicated"] * block // rows,
          f"dp_sharded: bytes {nbytes} for blocks of {block} of {rows} rows")
    loader = DataLoader(w.train, DP_BATCH, shuffle=True, seed=0, num_processes=world,
                        process_index=mesh.rank)
    loader.set_epoch(1)
    plans = {k: PlanBuffer(loader, mesh.device, c) for k, c in caches.items()}
    uploaded = {k: p.upload() for k, p in plans.items()}
    sharded = caches["sharded"]
    assert isinstance(sharded, ShardedDeviceDataCache)
    events = []
    for i in range(len(loader)):
        ref = caches["replicated"].gather(uploaded["replicated"][0][i],
                                          uploaded["replicated"][1][i])
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        got = sharded.gather(uploaded["sharded"][0][i], uploaded["sharded"][1][i],
                             plans["sharded"].columns)
        b.record()
        events.append((a, b))
        auto = caches["auto"].gather(uploaded["auto"][0][i], uploaded["auto"][1][i],
                                     plans["auto"].columns)
        check(_batches_equal(ref, got) and _batches_equal(ref, auto),
              f"dp_sharded: batch {i} of the sharded cache differs from the replicated one's")
    torch.cuda.synchronize()
    exchange_ms = [a.elapsed_time(b) for a, b in events]
    exchange_bytes = sharded.exchange_nbytes(DP_BATCH)
    del caches, plans, uploaded, sharded, w
    torch.cuda.empty_cache()
    record = {"workload": name, "rows": rows, "world": world, "rank": mesh.rank,
              "backend": mesh.backend, "cache_bytes": nbytes, "estimate_bytes": est,
              "auto_budget_bytes": int(DP_AUTO_BUDGET * est),
              "exchange_ms_per_step": float(np.median(exchange_ms)),
              "exchange_bytes_per_step": exchange_bytes, "batches_checked": len(exchange_ms)}
    runs = {}
    for layout in ("replicated", "sharded"):
        runs[layout] = _dp_run(mx, name, rows, {"fwd": 2, "bwd_dz": 1}, DP_BATCH // world,
                               device, epochs=DP_SHARDED_EPOCHS,
                               overrides=dict(cache_on_device=True, device_cache_layout=layout))
        record[layout] = {k: runs[layout][0][k] for k in (
            "steps_per_s", "epoch_losses", "eval_losses", "train_cache", "launches")}
    rep, _, rep_final = runs["replicated"]
    sh, _, sh_final = runs["sharded"]
    check(sh["train_cache"]["kind"] == "ShardedDeviceDataCache",
          f"dp_sharded: the trainer cached {sh['train_cache']}")
    check(sh["epoch_losses"] == rep["epoch_losses"] and all(
        torch.equal(sh_final[k], v) for k, v in rep_final.items()),
          "dp_sharded: training on the sharded cache is not bit-equal to the replicated one")
    record["seconds"] = time.perf_counter() - t0
    return record


def dp_evaluators(mx, device="cuda", n_devices=1, labels=DP_EVAL_LABELS):
    """The evaluators ``labels`` of ``evaluator_calls`` on each of
    ``DP_EVAL_MODELS`` (seeded weights) on ``EVAL_ROWS`` labelled rows, at
    ``n_devices`` (alone, or this rank of the group): each one's metrics,
    seconds and mixture launches (MMVAE's paper NLL: NLL_K / NLL_CHUNK
    forwards on each rank, none elsewhere). The default generator is seeded
    before each evaluator, alike in every process. Returns the record and
    the launches."""
    from multivae_tpu_torch.tools import workloads
    from multivae_tpu_torch.tools.workloads import labelled_polymnist

    t0 = time.perf_counter()
    test, train = labelled_polymnist(EVAL_ROWS, 11), labelled_polymnist(EVAL_ROWS, 12)
    clfs = random_classifiers(device)
    record = {"rows": EVAL_ROWS, "n_devices": n_devices}
    total = {k: 0 for k in KERNELS}
    with tempfile.TemporaryDirectory() as tmp:
        for name in DP_EVAL_MODELS:
            model = workloads.build(name, n=DP_BATCH, n_eval=0, device=device).model
            calls = evaluator_calls(model, clfs, test, train, os.path.join(tmp, name),
                                    n_devices=n_devices, joint_samples=DP_EVAL_JOINT,
                                    cluster_runs=DP_EVAL_CLUSTER_RUNS)
            record[name] = {}
            for i, label in enumerate(labels):
                torch.manual_seed(100 + DP_EVAL_LABELS.index(label))
                value, stats, launches = _measured(mx, calls[label])
                paper_nll = label == "likelihoods" and model.model_name == "MMVAE"
                expected = counts(fwd=-(-NLL_K // NLL_CHUNK) if paper_nll else 0)
                check(launches == expected, f"{name} {label} over {n_devices}: expected "
                      f"{expected} launches, got {launches}")
                total = {k: total[k] + launches[k] for k in KERNELS}
                _check_metrics(name, label, value, test)
                record[name][label] = {"metrics": {k: float(v) for k, v in value.items()},
                                       "seconds": stats["seconds"], "launches": launches}
            del model
    record["seconds"] = time.perf_counter() - t0
    return record, total


@contextlib.contextmanager
def _draws_per_rank():
    """The evaluators' control: a planted fault in which each rank draws
    the noise of its own rows alone from the shared generator, instead of
    keeping its rows of the global batch's draws (``DataShard.draw``)."""
    from multivae_tpu_torch.parallel.shard import DataShard

    draw = DataShard.draw
    DataShard.draw = lambda self, hook, shape, generator=None, axis=-2, blocks=1: hook(
        shape, generator)
    try:
        yield
    finally:
        DataShard.draw = draw


# Evaluators over ranks against one process: the sums of the NLL, SSIM,
# MSE and the Fréchet steps reorder (each rank sums its columns, an
# all-reduce adds them); the counts (coherence, clustering) are exact but
# for a prediction whose classifier or k-means margin the rows' batch size
# moves. The tolerance is the geometric middle of the ranks' largest gap
# on an H100 (7.9e-8) and the smallest gap of the likelihoods with the
# draws planted per rank (``_draws_per_rank``: 7.0e-7, mvtcae_conv's NLL;
# mmvae_conv's 2.9e-6), which the phase measures again and checks above
# it.
DP_EVAL_RTOL = 2.4e-7
DP_EVAL_COUNT_ATOL = 2e-3
DP_EVAL_CONTROL = ("likelihoods",)


def _dp_eval_gaps(label, ref, run, exact, labels=DP_EVAL_LABELS):
    """The largest relative gap of ``run``'s metrics ``labels`` to
    ``ref``'s, and the largest absolute one of the count metrics; checked
    bit-equal where ``exact`` is True, within DP_EVAL_RTOL /
    DP_EVAL_COUNT_ATOL where it is False, and not at all where None."""
    gaps = {}
    for name in DP_EVAL_MODELS:
        for ev in labels:
            a, b = ref[name][ev]["metrics"], run[name][ev]["metrics"]
            check(set(a) == set(b), f"{label} {name} {ev}: keys {set(a) ^ set(b)}")
            counted = ev in ("coherence", "clustering")
            gap = max((abs(b[k] - v) if counted else abs(b[k] - v) / max(abs(v), 1e-30))
                      for k, v in a.items())
            gaps[f"{name} {ev}"] = gap
            if exact:
                check(a == b, f"{label} {name} {ev}: not bit-equal to one process")
            elif exact is False:
                check(gap <= (DP_EVAL_COUNT_ATOL if counted else DP_EVAL_RTOL),
                      f"{label} {name} {ev}: {gap} off one process")
    return gaps



def _dp_graphed_ranks(label, world, group_out, alone_run, counts):
    """The spawned ranks' graphed runs (``dp_graphed_rank``) against the
    graphed run alone: replicas bit-equal, the same losses on every rank,
    within DP_RTOL / DP_MOVE_RTOL of alone; with a profile, each replay
    holds the mixture kernels and at least one NCCL activity a step. Adds
    the ranks' launches to ``counts``; returns the summary."""
    alone, start, end = alone_run
    ranks, finals = [], []
    for r in range(world):
        with open(os.path.join(group_out, f"graphed_rank{r}.json")) as f:
            ranks.append(json.load(f))
        finals.append(torch.load(os.path.join(group_out, f"graphed_rank{r}.pt"),
                                 weights_only=True))
        check(all(torch.equal(finals[r][k], v) for k, v in finals[0].items())
              and ranks[r]["epoch_losses"] == ranks[0]["epoch_losses"],
              f"{label} graphed: rank {r} differs from rank 0")
        for k in KERNELS:
            counts[k] += ranks[r]["launches"][k]
    ends = {k: v.cpu() for k, v in end.items()}
    gaps = _loss_gaps(ranks[0], alone, {k: v.cpu() for k, v in start.items()}, finals[0], ends)
    loss_gap = max(gaps[k] for k in LOSS_GAP_KINDS)
    check(loss_gap <= DP_RTOL and gaps["move_rel_gap"] <= DP_MOVE_RTOL,
          f"{label} graphed: beyond {DP_RTOL} / {DP_MOVE_RTOL} of the run alone: {gaps}")
    chunk = DP_GRAPHED[3]
    for r in ranks:
        if "nccl_in_a_replay" in r:
            check(sum(r["nccl_in_a_replay"].values()) >= chunk,
                  f"{label} graphed rank {r['rank']}: a replay showed NCCL "
                  f"{r['nccl_in_a_replay']}, expected at least {chunk} all-reduces")
    return {"gaps": gaps, "ranks": [{k: r.get(k) for k in (
        "rank", "per_device_batch", "steps_per_s", "captures", "replays", "replayed_kernels",
        "nccl_in_a_replay", "device_activities_in_a_replay")} for r in ranks],
            "alone_steps_per_s": alone["steps_per_s"]}


def data_parallel(mx, device="cuda", one_process_backend="nccl", rank_command=None):
    """The ``data_parallel`` phase: each workload of ``DP_WORKLOADS`` trained
    (a) alone at batch ``DP_BATCH``, (b) in a group of one process over NCCL
    opened here, which must equal (a) exactly, (c) by two ranks sharing the
    card over gloo at half the batch each, spawned, which must equal (a)
    within DP_RTOL / DP_MOVE_RTOL, their replicas bit-equal and each rank's
    own counters at the workload's launches a step; with more than one card,
    also by min(cards, 4) ranks over NCCL, one card each. Then
    ``dp_graphed``, ``dp_evaluators`` alone and in the one-process group
    (bit-equal), and from the spawned ranks ``dp_sharded``'s and
    ``dp_evaluators``' records (each rank the same metrics, within
    ``DP_EVAL_RTOL`` / ``DP_EVAL_COUNT_ATOL`` of alone, and the likelihoods
    with the draws planted per rank beyond it). cuDNN runs its
    deterministic algorithms throughout. Returns (the record, the launches
    of (a) and (b), of the new runs and of every spawned rank). ``one_process_backend`` and
    ``rank_command`` (the spawned ranks' command line before the rank's
    arguments) let a CPU rehearsal run the phase over gloo."""
    import datetime

    import torch.distributed as dist

    t_phase = time.perf_counter()
    out = os.path.join(ROOT, "build", "chip_smoke", "data_parallel")
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    counts = {k: 0 for k in KERNELS}
    record = {"phase": "data_parallel", "epochs": DP_EPOCHS, "global_batch": DP_BATCH}
    try:
        groups = [("gloo", 2, os.path.join(out, "gloo2"))]
        n_cards = torch.cuda.device_count()
        if n_cards > 1:
            n = min(n_cards, 4)
            groups.append(("nccl", n if DP_BATCH % n == 0 else 2,
                           os.path.join(out, f"nccl{n_cards}")))
        record["cards"] = n_cards
        runs = {}
        for name, rows, per_step in DP_WORKLOADS:
            alone, start, final = _dp_run(mx, name, rows, per_step, DP_BATCH, device)
            dist.init_process_group(one_process_backend, init_method=f"tcp://127.0.0.1:{_free_port()}",
                                    world_size=1, rank=0,
                                    timeout=datetime.timedelta(seconds=DP_GROUP_TIMEOUT))
            try:
                nccl1, _, nccl1_final = _dp_run(mx, name, rows, per_step, DP_BATCH, device)
            finally:
                dist.destroy_process_group()
            for k in KERNELS:
                counts[k] += alone["launches"][k] + nccl1["launches"][k]
            runs[name] = dict(alone=(alone, start, final), nccl1=nccl1, gaps={
                "nccl1": _dp_compare(f"{name} {one_process_backend} world 1", alone, start,
                                     final, nccl1, nccl1_final, exact=True)})
        record["graphed"], graphed_counts, graphed_alone = dp_graphed(mx, device,
                                                                      one_process_backend)
        eval_alone, eval_counts = dp_evaluators(mx, device)
        dist.init_process_group(one_process_backend, init_method=f"tcp://127.0.0.1:{_free_port()}",
                                world_size=1, rank=0,
                                timeout=datetime.timedelta(seconds=DP_GROUP_TIMEOUT))
        try:
            eval_group, group_counts = dp_evaluators(mx, device)
        finally:
            dist.destroy_process_group()
        for c in (graphed_counts, eval_counts, group_counts):
            for k in KERNELS:
                counts[k] += c[k]
        record["evaluators"] = {"alone_s": eval_alone["seconds"],
                                f"{one_process_backend}1_s": eval_group["seconds"],
                                "alone": {n: {ev: eval_alone[n][ev]["seconds"]
                                              for ev in DP_EVAL_LABELS}
                                          for n in DP_EVAL_MODELS},
                                f"{one_process_backend}1_gaps": _dp_eval_gaps(
                                    f"evaluators {one_process_backend} world 1", eval_alone,
                                    eval_group, exact=True)}
        for backend, world, group_out in groups:
            t0 = time.perf_counter()
            _spawn_ranks(world, backend, group_out, rank_command or [
                sys.executable, os.path.abspath(__file__), "--dp-rank"])
            spawn_s = time.perf_counter() - t0
            label = f"{backend}{world}"
            for name, _, _ in DP_WORKLOADS:
                alone, start, final = runs[name]["alone"]
                ranks = []
                for r in range(world):
                    with open(os.path.join(group_out, f"{name}_rank{r}.json")) as f:
                        ranks.append(json.load(f))
                    weights = torch.load(os.path.join(group_out, f"{name}_rank{r}.pt"),
                                         weights_only=True)
                    if r == 0:
                        first = weights
                    else:
                        check(all(torch.equal(weights[k], v) for k, v in first.items()),
                              f"{name}: rank {r}'s replica differs from rank 0's")
                    check(ranks[-1]["epoch_losses"] == ranks[0]["epoch_losses"],
                          f"{name}: ranks logged different losses")
                    for k in KERNELS:
                        counts[k] += ranks[-1]["launches"][k]
                runs[name]["gaps"][label] = _dp_compare(f"{name} {label}", alone, start, final,
                                                        ranks[0], first, exact=False)
                runs[name][label] = ranks
            sharded, evaluators, controls = [], [], []
            for r in range(world):
                with open(os.path.join(group_out, f"sharded_rank{r}.json")) as f:
                    sharded.append(json.load(f))
                with open(os.path.join(group_out, f"evaluators_rank{r}.json")) as f:
                    evaluators.append(json.load(f))
                with open(os.path.join(group_out, f"control_rank{r}.json")) as f:
                    controls.append(json.load(f))
                for name in DP_EVAL_MODELS:
                    for ev in DP_EVAL_LABELS:
                        check(evaluators[r][name][ev]["metrics"]
                              == evaluators[0][name][ev]["metrics"],
                              f"{label} {name} {ev}: rank {r} returned other metrics")
                        for k in KERNELS:
                            counts[k] += evaluators[r][name][ev]["launches"][k]
                for layout in ("replicated", "sharded"):
                    for k in KERNELS:
                        counts[k] += sharded[r][layout]["launches"][k]
            record[f"{label}_sharded"] = [{k: r[k] for k in (
                "rank", "cache_bytes", "exchange_ms_per_step", "exchange_bytes_per_step",
                "seconds")} | {layout: {k: r[layout][k] for k in ("steps_per_s", "train_cache")}
                               for layout in ("replicated", "sharded")} for r in sharded]
            if backend in DP_GRAPHED_BACKENDS:
                record[f"{label}_graphed"] = _dp_graphed_ranks(label, world, group_out,
                                                               graphed_alone, counts)
            record[f"{label}_evaluators"] = {
                "seconds": [r["seconds"] for r in evaluators],
                "gaps": _dp_eval_gaps(f"evaluators {label}", eval_alone, evaluators[0],
                                      exact=False),
                "nll_launches_per_rank": [r["mmvae_conv"]["likelihoods"]["launches"]
                                          for r in evaluators],
                "control_gaps": _dp_eval_gaps(f"control {label}", eval_alone, controls[0],
                                              exact=None, labels=DP_EVAL_CONTROL)}
            control = record[f"{label}_evaluators"]["control_gaps"]
            check(min(control.values()) > DP_EVAL_RTOL,
                  f"evaluators {label}: with the draws planted per rank the likelihoods "
                  f"stay within DP_EVAL_RTOL {DP_EVAL_RTOL} of one process: {control}")
            record[f"{label}_spawn_and_train_s"] = spawn_s
            shutil.rmtree(group_out, ignore_errors=True)
        for name, run in runs.items():
            alone = run["alone"][0]
            summary = {"alone": {k: alone[k] for k in ("steps_per_s", "epoch_losses",
                                                       "eval_losses", "launches_per_step")},
                       "nccl1": {k: run["nccl1"][k] for k in (
                           "steps_per_s", "all_reduce", "launches_per_step")},
                       "gaps": run["gaps"]}
            for label in (f"{b}{w}" for b, w, _ in groups):
                summary[label] = [{k: r[k] for k in ("rank", "device", "per_device_batch",
                                                     "steps_per_s", "all_reduce",
                                                     "launches_per_step")}
                                  for r in run[label]]
            record[name] = summary
    finally:
        torch.backends.cudnn.deterministic = deterministic
    record["seconds"] = time.perf_counter() - t_phase
    return record, counts


# The mixed_precision phase: the trainer's bf16 mode. Each workload on
# MIXED_ROWS seeded rows for MIXED_EPOCHS epochs, in float32 and in bf16;
# the bf16 run's mixture launches a train step (its eval passes stay
# float32: the f32 forwards of an eval step). mmvae_conv's DReG step
# launches the bf16 kernels alone; cmvae_polymnist's IWAE step (on 256
# rows, as in its own phase) the full bf16 backward.
MIXED_ROWS = 1024
MIXED_EPOCHS = 2
# (workload, rows, eval rows (None: the workload's), launches an f32 train
# step, a bf16 one, f32 forwards an eval step). crmvae_resnet's 15% eval
# split of 1,024 rows is under one batch of 256, which drop_last leaves out:
# it gets 256 rows.
MIXED_WORKLOADS = (("mmvae_conv", MIXED_ROWS, None, {"fwd": 2, "bwd_dz": 1},
                    {"fwd_bf16": 2, "bwd_dz_bf16": 1}, 2),
                   ("crmvae_resnet", MIXED_ROWS, 256, {}, {}, 0),
                   ("mvae_conv", MIXED_ROWS, None, {}, {}, 0),
                   ("mvtcae_conv", MIXED_ROWS, None, {}, {}, 0),
                   ("cmvae_polymnist", 256, None, {"fwd": 1, "bwd": 1},
                    {"fwd_bf16": 1, "bwd_bf16": 1}, 0))
# bf16 against float32 training on the same weights, data and order: each
# epoch's train and eval loss within 5% (the JAX package's bound for one
# step, tests/test_perf_features.py; the CPU tests found 1e-4 to 4e-3 for
# one step of the 14 families, tests/test_torch_mixed_precision.py); the
# draws differ, bf16 noise being drawn in bf16.
MIXED_LOSS_RTOL = 0.05
# the graphed bf16 run: mmvae_conv (batch 256) on 2,048 cached rows, 8
# steps an epoch, 3 epochs (the first eager, the second captures, the third
# replays: its steps/s), in graphs of 8 steps, against the eager bf16 run
# with the capturable optimizer, within GRAPHED_RTOL; and the one-process
# NCCL group on MIXED_ROWS rows, bit-equal to no group
MIXED_GRAPHED = ("mmvae_conv", 2048, 3, 8)


def mixed_precision_phase(mx, device="cuda", one_process_backend="nccl",
                          workloads_=None, graphed_=None, rows=MIXED_ROWS):
    """The ``mixed_precision`` phase (its kernels are checked and timed in
    phase 3, ``bf16_kernels``): the workloads of ``MIXED_WORKLOADS`` in
    float32 and in bf16 (steps/s, peaks, the loss gaps, exact launches); a
    graphed bf16 run against the eager one and a bf16 run in a one-process
    NCCL group against none. Returns (the record, the launches of its
    training runs).
    ``one_process_backend``, ``workloads_`` (default ``MIXED_WORKLOADS``),
    ``graphed_`` (default ``MIXED_GRAPHED``) and ``rows`` (the NCCL run's)
    let a CPU rehearsal run it smaller over gloo."""
    import datetime

    import torch.distributed as dist

    from multivae_tpu_torch.tools import workloads

    t_phase = time.perf_counter()
    record = {"phase": "mixed_precision"}
    launches = {k: 0 for k in KERNELS}

    keys = ("steps_per_s", "peak_mem_bytes", "peak_above_held_bytes", "epoch_losses",
            "eval_losses", "launches")
    for name, n, n_eval, per_step32, per_step16, eval_fwd in workloads_ or MIXED_WORKLOADS:
        runs = {}
        for mixed, per_step in ((False, per_step32), (True, per_step16)):
            w = workloads.build(name, n=n, n_eval=n_eval, device=device)
            w.trainer_kwargs["mixed_precision"] = mixed
            run, _, counts_ = workload_run(mx, name, n=n, epochs=MIXED_EPOCHS,
                                           device=device, per_step=per_step,
                                           eval_fwd=eval_fwd, workload=w, small_check=False)
            runs[mixed] = {k: run[k] for k in keys if k in run}
            for k in KERNELS:
                launches[k] += counts_[k]
            del w
            torch.cuda.empty_cache()
        f32, bf16 = runs[False], runs[True]
        gaps = {which: [_rel(a, b) for a, b in zip(bf16[which], f32[which])]
                for which in ("epoch_losses", "eval_losses") if which in f32}
        check(all(g <= MIXED_LOSS_RTOL for v in gaps.values() for g in v),
              f"{name}: bf16 losses off the f32 run's by {gaps}")
        record[name] = {"f32": f32, "bf16": bf16, "loss_rel_gaps": gaps,
                        "steps_per_s_bf16_over_f32": bf16["steps_per_s"] / f32["steps_per_s"],
                        "peak_bf16_over_f32": bf16["peak_above_held_bytes"]
                        / f32["peak_above_held_bytes"]}
        print(f"  {name}: steps/s f32 {f32['steps_per_s']:.3f}, bf16 {bf16['steps_per_s']:.3f}; "
              f"peak above held f32 {f32['peak_above_held_bytes']}, bf16 "
              f"{bf16['peak_above_held_bytes']}; loss gaps {gaps}")

    name, graph_rows, epochs, chunk = graphed_ or MIXED_GRAPHED
    out = os.path.join(ROOT, "build", "chip_smoke", "mixed_precision")
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        graphed = {}
        for steps in (1, chunk):
            run, _, start, end = _graphed_run(mx, name, graph_rows, epochs, device, steps,
                                              pipeline=True, out=out, capturable=True,
                                              overrides={"mixed_precision": True})
            n = run["epochs_run"] * run["n_batches"]
            want = counts(fwd_bf16=2 * n, bwd_dz_bf16=n,
                          fwd=2 * run["epochs_run"] * run["eval_batches"])
            check(run["launches"] == want,
                  f"{name} bf16, steps_per_execution {steps}: expected {want}, "
                  f"got {run['launches']}")
            for k in KERNELS:
                launches[k] += run["launches"][k]
            graphed[steps] = (run, start, end)
        (eager, start, eager_end), (graph, _, graph_end) = graphed[1], graphed[chunk]
        gaps = {"train": max(abs(a - b) / abs(b) for a, b in zip(graph["epoch_losses"],
                                                                 eager["epoch_losses"])),
                "eval": max(abs(a - b) / abs(b) for a, b in zip(graph["eval_losses"],
                                                                eager["eval_losses"])),
                "moves": _move_gap(start, graph_end, eager_end)}
        check(all(v <= GRAPHED_RTOL for v in gaps.values()),
              f"{name} bf16: graphed off the eager run by {gaps}")
        check(graph["replays"]["train"] > 0 or torch.device(device).type != "cuda",
              f"{name} bf16: no graph replayed")
        record["graphed"] = {"workload": name, "rows": graph_rows, "chunk": chunk, "gaps": gaps,
                             "steps_per_s": {"eager": eager["steps_per_s"],
                                             "graphed": graph["steps_per_s"]},
                             "captures": graph["captures"], "replays": graph["replays"]}
        shutil.rmtree(out, ignore_errors=True)

        name, per_step = "mmvae_conv", {"fwd_bf16": 2, "bwd_dz_bf16": 1}
        bf16 = dict(per_step=per_step, eval_step={"fwd": 2},
                    overrides={"mixed_precision": True})
        alone, start, final = _dp_run(mx, name, rows, per_device=DP_BATCH,
                                      device=device, **bf16)
        dist.init_process_group(one_process_backend,
                                init_method=f"tcp://127.0.0.1:{_free_port()}",
                                world_size=1, rank=0,
                                timeout=datetime.timedelta(seconds=DP_GROUP_TIMEOUT))
        try:
            group, _, group_final = _dp_run(mx, name, rows, per_device=DP_BATCH,
                                            device=device, **bf16)
        finally:
            dist.destroy_process_group()
        for k in KERNELS:
            launches[k] += alone["launches"][k] + group["launches"][k]
        record["nccl_world_1"] = {
            "workload": name, "gaps": _dp_compare(f"{name} bf16 {one_process_backend} world 1",
                                                  alone, start,
                                                  final, group, group_final, exact=True),
            "steps_per_s": {"alone": alone["steps_per_s"], "group": group["steps_per_s"]},
            "all_reduce": group["all_reduce"]}
    finally:
        torch.backends.cudnn.deterministic = deterministic
    record["seconds"] = time.perf_counter() - t_phase
    print(f"  mixed_precision: {record['seconds']:.1f} s")
    return record, launches


# The state_sharding phase: the JAX package's fsdp and n_model_devices
# (combined_state_sharding's placements, parallel/state.py) on mmvae_conv
# (partial PolyMNIST at its full width, DReG: the mixture's forward and
# dz-only backward in every rank's step), under cuDNN's deterministic
# algorithms.
# (a) (workload, rows, epochs, steps a chunk): 4-step CUDA graphs on 1,024
# cached rows (2,048 and 8 steps until mvtcae_cub below needed the time)
# in a one-process NCCL group, fsdp off and on: epoch 1 runs
# the eager chunk, epoch 2 captures, epoch 3 replays. Over a data axis
# of one the gathers and scatters copy and the optimizer steps the same
# numbers in flat masters: bit-equal, else within GRAPHED_RTOL (the loss
# gaps and the weights' moves), the reason printed.
SS_GRAPHED = ("mmvae_conv", 1024, 3, 4)
# (b) two gloo ranks on the one card, eager, one epoch of SS_ROWS rows at the
# global batch DP_BATCH, each layout against one process on the global
# batch within DP_RTOL / DP_MOVE_RTOL (the data_parallel phase's gates):
# fsdp over data 2 (128 rows a rank), and data 1 x model 2 (each rank the
# whole batch, half of each wide layer's output channels)
SS_ROWS = 512
SS_EPOCHS = 1
SS_LAYOUTS = (("fsdp_data2", dict(n_devices=2, fsdp=True)),
              ("model2", dict(n_devices=1, n_model_devices=2)))
# (c) four cards over NCCL: data 2 x model 2 with fsdp, SS_GRAPHED's graphs
# at 128 rows a data index, against (a)'s graphed run without fsdp within
# DP_RTOL / DP_MOVE_RTOL
SS_FOUR = dict(n_devices=2, n_model_devices=2, fsdp=True)
# The checkpoints part: checkpoint_backend="orbax" (trainers/base/checkpoint.py),
# each rank writing its own pieces of the train state, in the background.
# (a) the fsdp run of SS_GRAPHED saves every epoch; each epoch's train_state
# restored into its trainer must give the masters and optimizer moments
# copied at the save, bit for bit, and a run resumed from epoch 1 the run's
# final weights. (b) the fsdp_data2 ranks save at their end; this process
# restores the checkpoint whole, replicated, and (c) four NCCL ranks into
# data 2 x model 2. (d) one crmvae_resnet trainer (103.1 M parameters) after
# one step of SS_LARGE rows saves with "msgpack", then with "orbax" twice
# (the first save pins its host buffers), each restored in turn.
SS_CHECKPOINT = dict(checkpoint_backend="orbax", async_checkpointing=True)
SS_LARGE = ("crmvae_resnet", 256)
# mvtcae_cub (tools/workloads.cub_workload: the CUB example's widths, its
# text encoder's attention projections placed by their per-head JAX leaves)
# on the synthetic CUB files (workloads.CUB_SYNTHETIC), written once into
# SS_CUB_ROOT: one epoch of the first SS_CUB_ROWS train captions at the
# global batch workloads.CUB_BATCH (4 steps), SS_CUB_EVAL eval captions.
# (b)'s ranks train it in each of SS_LAYOUTS against one process on the
# global batch, within DP_RTOL / DP_MOVE_RTOL, the fsdp ranks saving sharded
# at their end (restored in this process, bit-equal); (c)'s four ranks over
# SS_CUB_FOUR, where 2 heads do not divide over data 4, so that the out
# projections stay whole on every rank, as in JAX.
SS_CUB_ROOT = os.path.join(ROOT, "build", "chip_smoke", "state_sharding", "cub")
SS_CUB_ROWS, SS_CUB_EVAL = 256, 64
SS_CUB_FOUR = dict(n_devices=4, fsdp=True)
# seconds a spawned rank of this phase may take
SS_RANK_TIMEOUT = 480
SS_PER_STEP, SS_EVAL_FWD = {"fwd": 2, "bwd_dz": 1}, 2


@contextlib.contextmanager
def _capture_log():
    """The collectives each CUDA graph capture issues: a list with one entry
    a capture, ``{"name": train or eval, "calls": {kind: [count, bytes]}}``
    (the state's all-gathers and reduce-scatters, every all-reduce)."""
    import torch.distributed as dist

    from multivae_tpu_torch.parallel import state as st
    from multivae_tpu_torch.trainers.base import graphs

    log, current = [], []

    def counting(kind, fn):
        def inner(*args, **kwargs):
            if current and torch.cuda.is_current_stream_capturing():
                entry = current[-1]["calls"].setdefault(kind, [0, 0])
                entry[0] += 1
                entry[1] += args[0].numel() * args[0].element_size()
            return fn(*args, **kwargs)
        return inner

    plain = (st._all_gather, st._reduce_scatter, dist.all_reduce, graphs.ChunkGraphs._capture)

    def capture(self, fn):
        current.append({"name": self.name, "calls": {}})
        log.append(current[-1])
        try:
            return plain[3](self, fn)
        finally:
            current.pop()

    st._all_gather = counting("all_gather", plain[0])
    st._reduce_scatter = counting("reduce_scatter", plain[1])
    dist.all_reduce = counting("all_reduce", plain[2])
    graphs.ChunkGraphs._capture = capture
    try:
        yield log
    finally:
        st._all_gather, st._reduce_scatter, dist.all_reduce = plain[:3]
        graphs.ChunkGraphs._capture = plain[3]


def _expected_launches(run):
    expected = {k: SS_PER_STEP.get(k, 0) * run["epochs_run"] * run["n_batches"]
                for k in KERNELS}
    expected["fwd"] += SS_EVAL_FWD * run["epochs_run"] * run["eval_batches"]
    return expected


def ss_graphed(mx, device="cuda", backend="nccl", fsdps=(False, True)):
    """(a): ``SS_GRAPHED`` as 4-step graphs in a one-process ``backend``
    group, for each of ``fsdps``; returns (record, launches, the run
    without fsdp as (record, start, end)). With fsdp among them the record
    holds it to the run without; else the record is None."""
    import datetime

    import torch.distributed as dist

    name, rows, epochs, chunk = SS_GRAPHED
    out = os.path.join(ROOT, "build", "chip_smoke", "ss_graphed")
    shutil.rmtree(out, ignore_errors=True)
    cuda = torch.device(device).type == "cuda"
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{_free_port()}",
                            world_size=1, rank=0,
                            timeout=datetime.timedelta(seconds=DP_GROUP_TIMEOUT))
    runs, launches = {}, {k: 0 for k in KERNELS}
    try:
        for fsdp in fsdps:
            saved = {}
            with _capture_log() as log:
                run, trainer, start, end = _graphed_run(
                    mx, name, rows, epochs, device, chunk, False,
                    os.path.join(out, str(fsdp)), steps_saving=1 if fsdp else None,
                    overrides={"fsdp": fsdp, **(SS_CHECKPOINT if fsdp else {})},
                    on_trainer=(lambda t: saved.update(_checkpoint_log(t))) if fsdp else None)
            check(run["launches"] == _expected_launches(run),
                  f"ss_graphed fsdp={fsdp}: expected {_expected_launches(run)} launches, "
                  f"got {run['launches']}")
            check(not cuda or (run["replays"]["train"] > 0 and run["replays"]["eval"] > 0),
                  f"ss_graphed fsdp={fsdp}: a kind of graph never replayed {run['replays']}")
            for k in KERNELS:
                launches[k] += run["launches"][k]
            train_chunk = [e["calls"] for e in log if e["name"] == "train"]
            run["collectives_a_train_chunk"] = train_chunk[0] if train_chunk else {}
            run["collectives_an_eval_chunk"] = next(
                (e["calls"] for e in log if e["name"] == "eval"), {})
            run["state_bytes"] = _state_bytes(trainer)
            run["cut_leaves"] = sum(leaf.cut for leaf in trainer._state.leaves)
            if cuda:
                seen, counted, nccl, events, _ = _replay_profile(trainer, chunk)
                want = {k: SS_PER_STEP.get(k, 0) * chunk for k in KERNELS}
                check(seen == counted == want, f"ss_graphed fsdp={fsdp}: a replay launched "
                      f"{seen}, counted {counted}, expected {want}")
                run.update(mixture_a_replay=seen, nccl_in_a_replay=nccl,
                           device_activities_in_a_replay=events)
            if fsdp:
                run["checkpoints"], resumed = _ss_checkpoints(mx, trainer, saved, end, out,
                                                              device)
                for k in KERNELS:
                    launches[k] += resumed[k]
            runs[fsdp] = (run, start, end)
            del trainer
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
        shutil.rmtree(out, ignore_errors=True)
    if True not in runs:
        return None, launches, runs[False]
    (rep, rep_start, rep_end), (ours, start, end) = runs[False], runs[True]
    same = (all(torch.equal(start[k], v) for k, v in rep_start.items())
            and all(torch.equal(end[k], v) for k, v in rep_end.items())
            and ours["epoch_losses"] == rep["epoch_losses"]
            and ours["eval_losses"] == rep["eval_losses"])
    gaps = _loss_gaps(ours, rep, rep_start, end, rep_end)
    record = {"workload": name, "rows": rows, "epochs": epochs, "steps_per_execution": chunk,
              "backend": backend, "bit_equal": same, "gaps": gaps,
              "steps_per_s": {"replicated": rep["steps_per_s"], "fsdp": ours["steps_per_s"]},
              "fsdp_over_replicated": (ours["steps_per_s"] / rep["steps_per_s"]
                                       if rep["steps_per_s"] and ours["steps_per_s"] else None),
              "captures": ours["captures"], "replays": ours["replays"],
              "collectives_a_train_chunk": {"replicated": rep["collectives_a_train_chunk"],
                                            "fsdp": ours["collectives_a_train_chunk"]},
              "collectives_an_eval_chunk": {"replicated": rep["collectives_an_eval_chunk"],
                                            "fsdp": ours["collectives_an_eval_chunk"]},
              "state_bytes": {"replicated": rep["state_bytes"], "fsdp": ours["state_bytes"]},
              "cut_leaves": ours["cut_leaves"],
              "mixture_a_replay": ours.get("mixture_a_replay"),
              "nccl_in_a_replay": {"replicated": rep.get("nccl_in_a_replay"),
                                   "fsdp": ours.get("nccl_in_a_replay")},
              "peak_above_held_bytes": {"replicated": rep["peak_above_held_bytes"],
                                        "fsdp": ours["peak_above_held_bytes"]},
              "checkpoints": ours["checkpoints"],
              "epoch_losses": ours["epoch_losses"], "eval_losses": ours["eval_losses"]}
    if not same:
        record["reason"] = ("not bit-equal to the replicated graphed run: within GRAPHED_RTOL "
                            "is the gate (the flat masters' optimizer step and the copies of "
                            "the one-rank gathers may round differently)")
    check(same or (max(gaps.values()) <= GRAPHED_RTOL),
          f"ss_graphed: fsdp beyond GRAPHED_RTOL {GRAPHED_RTOL} of the replicated run: {gaps}")
    check(not cuda or ours["collectives_a_train_chunk"].get("reduce_scatter", [0])[0] >= chunk,
          f"ss_graphed: a train chunk captured {ours['collectives_a_train_chunk']}, expected "
          f"a reduce-scatter a step at least")
    return record, launches, runs[False]


def _progress(tag):
    """A callback printing ``tag``, the time and each epoch's start, flushed:
    where a spawned rank got to, in its log."""
    from multivae_tpu_torch.trainers.base.callbacks import TrainingCallback

    class Progress(TrainingCallback):
        def on_epoch_begin(self, training_config, **kwargs):
            print(f"[{time.strftime('%H:%M:%S')}] {tag}: epoch {kwargs.get('epoch')}", flush=True)

    return Progress()


def _cub_workload(device):
    """``mvtcae_cub`` on ``SS_CUB_ROOT``'s files: the first ``SS_CUB_ROWS``
    captions of the train split and the first ``SS_CUB_EVAL`` of the eval
    split."""
    import dataclasses

    from multivae_tpu_torch.data import ResampleDataset
    from multivae_tpu_torch.data.datasets import CUB
    from multivae_tpu_torch.tools import workloads

    train, eval_set = (CUB(SS_CUB_ROOT, split, output_type="tokens")
                       for split in ("train", "eval"))
    w = workloads.cub_workload(train, eval_set, device=device)
    return dataclasses.replace(w, train=ResampleDataset(train, np.arange(SS_CUB_ROWS)),
                               eval=ResampleDataset(eval_set, np.arange(SS_CUB_EVAL)))


def _save_rank(out, label, rank, record, final):
    torch.save(final, os.path.join(out, f"{label}_rank{rank}.pt"))
    with open(os.path.join(out, f"{label}_rank{rank}.json"), "w") as f:
        json.dump(record, f)


def _ss_cub_run(mx, device, layout=None, output_dir=None):
    """``mvtcae_cub`` one epoch in ``layout`` (None: one process on the
    global batch), saving sharded at its end under ``output_dir`` where
    given; ``_dp_run``'s (record, start, final), the record with the
    seconds of the run, construction included."""
    from multivae_tpu_torch.tools import workloads

    t0 = time.perf_counter()
    overrides = dict(layout or {}, **(dict(SS_CHECKPOINT, steps_saving=1) if output_dir else {}))
    record, start, final = _dp_run(
        mx, "mvtcae_cub", SS_CUB_ROWS, {}, workloads.CUB_BATCH // overrides.get("n_devices", 1),
        device, epochs=1, overrides=overrides, output_dir=output_dir,
        workload=_cub_workload(device))
    record["run_s"] = time.perf_counter() - t0
    return record, start, final


def ss_rank_main(argv, device="cuda"):
    """A spawned rank: ``--ss-rank R WORLD PORT BACKEND OUT MODE
    [CHECKPOINT]``. Joins the group at ``tcp://127.0.0.1:PORT``; MODE
    ``eager`` trains each layout of ``SS_LAYOUTS`` (b), the first saving its
    sharded train state under ``OUT``, then ``mvtcae_cub`` in each layout,
    the first saving too; ``graphed`` first restores CHECKPOINT in
    ``SS_FOUR``'s layout where it is given, then trains ``SS_FOUR``
    eagerly, ``mvtcae_cub`` over ``SS_CUB_FOUR`` and ``SS_FOUR`` as graphs
    (c); each record and final weights saved under ``OUT``."""
    import datetime

    import torch.distributed as dist

    import faulthandler

    rank, world, port, backend, out, mode = (int(argv[0]), int(argv[1]), argv[2], argv[3],
                                             argv[4], argv[5])
    from multivae_tpu_torch.ops import mixture as mx

    # a rank that hangs leaves every thread's stack in its log
    faulthandler.dump_traceback_later(SS_RANK_TIMEOUT - 30, exit=False)

    if device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.deterministic = True
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}", world_size=world,
                            rank=rank, timeout=datetime.timedelta(seconds=DP_GROUP_TIMEOUT))
    try:
        if mode == "eager":
            for label, layout in SS_LAYOUTS:
                # fsdp over data 2 saves its train state sharded, kept for the parent
                saving = dict(SS_CHECKPOINT, steps_saving=1) if label == "fsdp_data2" else {}
                record, _, final = _dp_run(mx, SS_GRAPHED[0], SS_ROWS, SS_PER_STEP,
                                           DP_BATCH // layout["n_devices"], device,
                                           epochs=SS_EPOCHS, overrides={**layout, **saving},
                                           output_dir=(os.path.join(out, "checkpoints")
                                                       if saving else None))
                _save_rank(out, label, rank, record, final)
            for label, layout in SS_LAYOUTS:
                record, _, final = _ss_cub_run(mx, device, layout, output_dir=(
                    os.path.join(out, "cub_checkpoints") if label == "fsdp_data2" else None))
                _save_rank(out, f"cub_{label}", rank, record, final)
                print(f"[{time.strftime('%H:%M:%S')}] mvtcae_cub {label} done", flush=True)
        else:
            name, rows, epochs, chunk = SS_GRAPHED
            per = DP_BATCH // SS_FOUR["n_devices"]
            if len(argv) > 6:   # the two gloo ranks' checkpoint, restored in this layout
                whole, restore_s = _restored(name, SS_ROWS, per, device, argv[6],
                                             overrides=SS_FOUR)
                if rank == 0:
                    torch.save(whole, os.path.join(out, "four_restored.pt"))
                with open(os.path.join(out, f"four_restore_rank{rank}.json"), "w") as f:
                    json.dump({"restore_s": restore_s}, f)
                print(f"[{time.strftime('%H:%M:%S')}] restore done", flush=True)
            # eager first: one epoch of SS_ROWS rows, as (b)
            record, _, final = _dp_run(mx, name, SS_ROWS, SS_PER_STEP, per, device,
                                       epochs=SS_EPOCHS, overrides=SS_FOUR)
            _save_rank(out, "four_eager", rank, record, final)
            print(f"[{time.strftime('%H:%M:%S')}] eager done", flush=True)
            record, _, final = _ss_cub_run(mx, device, SS_CUB_FOUR)
            _save_rank(out, "cub_four", rank, record, final)
            print(f"[{time.strftime('%H:%M:%S')}] mvtcae_cub done", flush=True)
            record, end = _ss_four_rank(mx, device, out, per)
            record["rank"] = rank
            torch.save({k: v.cpu() for k, v in end.items()},
                       os.path.join(out, f"four_rank{rank}.pt"))
            with open(os.path.join(out, f"four_rank{rank}.json"), "w") as f:
                json.dump(record, f)
    finally:
        dist.destroy_process_group()
    return 0


def _ss_four_rank(mx, device, out, per):
    """(c)'s graphed run in a rank, at ``per`` rows a data index: its record
    (with the bytes at rest and one profiled replay) and final weights. The
    trainer, whose graphs hold the NCCL communicators' work, is gone when
    this returns: the group's destruction waits for them otherwise."""
    name, rows, epochs, chunk = SS_GRAPHED
    record, trainer, _, end = _graphed_run(
        mx, name, rows, epochs, device, chunk, False, os.path.join(out, "run"),
        overrides={**SS_FOUR, "per_device_train_batch_size": per,
                   "per_device_eval_batch_size": per},
        callbacks=[_progress("graphed")])
    print(f"[{time.strftime('%H:%M:%S')}] graphed done", flush=True)
    record["state_bytes"] = _state_bytes(trainer)
    if device == "cuda":
        seen, counted, nccl, events, _ = _replay_profile(trainer, chunk)
        record.update(mixture_a_replay=seen, counted_a_replay=counted,
                      nccl_in_a_replay=nccl, device_activities_in_a_replay=events)
        torch.cuda.synchronize()
    return record, end


def _ss_ranks(label, world, out, alone, alone_start, alone_final, counts, extra=()):
    """The spawned ranks' results of ``label``: replicas bit-equal, each
    rank's launches added to ``counts``, rank 0 against ``alone`` within
    DP_RTOL / DP_MOVE_RTOL. Each rank's entry keeps the ``extra`` keys of
    its record too."""
    ranks, finals = [], []
    for r in range(world):
        with open(os.path.join(out, f"{label}_rank{r}.json")) as f:
            ranks.append(json.load(f))
        finals.append(torch.load(os.path.join(out, f"{label}_rank{r}.pt"), weights_only=True))
        check(all(torch.equal(finals[r][k], v) for k, v in finals[0].items())
              and ranks[r]["epoch_losses"] == ranks[0]["epoch_losses"],
              f"state_sharding {label}: rank {r} differs from rank 0")
        for k in KERNELS:
            counts[k] += ranks[r]["launches"][k]
    gaps = _dp_compare(f"state_sharding {label}", alone, alone_start, alone_final, ranks[0],
                       finals[0], exact=False)
    return {"gaps": gaps, "ranks": [{k: r.get(k) for k in (
        "rank", "mesh", "per_device_batch", "steps_per_s", "state_bytes", "all_reduce",
        "launches_per_step", *extra)} for r in ranks]}


def ss_four(mx, device, alone_run, eager_alone, counts, rank_command=None, backend="nccl",
            checkpoint=None, cub_alone=None):
    """(c): four ``backend`` ranks, one card each, as data 2 x model 2 with
    fsdp: ``checkpoint`` (``(folder, the saving ranks' final weights)``)
    restored and held to those weights bit for bit, one eager epoch against
    ``eager_alone`` (``_dp_run``'s (record, start, final) of one process) as
    (b), ``mvtcae_cub`` over ``SS_CUB_FOUR`` against ``cub_alone``
    (``_ss_cub_four``), then graphs of 4 steps against (a)'s replicated
    graphed run."""
    out = os.path.join(ROOT, "build", "chip_smoke", "state_sharding", "four")
    t0 = time.perf_counter()
    _spawn_ranks(4, backend, out, (rank_command or [
        sys.executable, os.path.abspath(__file__), "--ss-rank"]),
        extra=["graphed"] + ([checkpoint[0]] if checkpoint else []), timeout=SS_RANK_TIMEOUT)
    restore = None
    if checkpoint:
        whole = torch.load(os.path.join(out, "four_restored.pt"), weights_only=True)
        check(list(whole) == list(checkpoint[1])
              and all(torch.equal(whole[k], v) for k, v in checkpoint[1].items()),
              "state_sharding four: the two gloo ranks' checkpoint restored on data 2 x "
              "model 2 is not their final weights")
        restore = []
        for r in range(4):
            with open(os.path.join(out, f"four_restore_rank{r}.json")) as f:
                restore.append(json.load(f)["restore_s"])
        print(f"  checkpoint {SS_GRAPHED[0]} of the gloo ranks into data 2 x model 2: restore "
              f"{max(restore):.4f} s (slowest of 4 ranks), bit-equal | {_card()}", flush=True)
    eager = _ss_ranks("four_eager", 4, out, *eager_alone, counts)
    cub = _ss_cub_four(out, cub_alone, counts, _card(), backend)
    alone, start, end = alone_run
    ranks, finals = [], []
    for r in range(4):
        with open(os.path.join(out, f"four_rank{r}.json")) as f:
            ranks.append(json.load(f))
        finals.append(torch.load(os.path.join(out, f"four_rank{r}.pt"), weights_only=True))
        check(all(torch.equal(finals[r][k], v) for k, v in finals[0].items())
              and ranks[r]["epoch_losses"] == ranks[0]["epoch_losses"],
              f"state_sharding four: rank {r} differs from rank 0")
        check(ranks[r]["launches"] == _expected_launches(ranks[r]),
              f"state_sharding four rank {r}: launches {ranks[r]['launches']}")
        for k in KERNELS:
            counts[k] += ranks[r]["launches"][k]
    gaps = _loss_gaps(ranks[0], alone, {k: v.cpu() for k, v in start.items()}, finals[0],
                      {k: v.cpu() for k, v in end.items()})
    check(max(gaps[k] for k in LOSS_GAP_KINDS) <= DP_RTOL and gaps["move_rel_gap"] <= DP_MOVE_RTOL,
          f"state_sharding four: beyond {DP_RTOL} / {DP_MOVE_RTOL} of the run alone: {gaps}")
    shutil.rmtree(out, ignore_errors=True)
    return {"eager": eager, "mvtcae_cub": cub, "gaps": gaps,
            "spawn_and_train_s": time.perf_counter() - t0,
            "restore_s": restore,
            "alone_steps_per_s": alone["steps_per_s"],
            "ranks": [{k: r.get(k) for k in (
                "rank", "steps_per_s", "captures", "replays", "state_bytes", "mixture_a_replay",
                "nccl_in_a_replay", "device_activities_in_a_replay")} for r in ranks]}


def _ss_eager_alone(mx, device, counts):
    """One process on the global batch, eager, ``SS_EPOCHS`` epochs of
    ``SS_ROWS`` rows: ``_dp_run``'s (record, start, final) that the eager
    ranks of (b) and (c) are held to; its launches added to ``counts``."""
    run = _dp_run(mx, SS_GRAPHED[0], SS_ROWS, SS_PER_STEP, DP_BATCH, device, epochs=SS_EPOCHS)
    for k in KERNELS:
        counts[k] += run[0]["launches"][k]
    return run


def _card():
    """The card's name and power limit, for each checkpoint line."""
    return card_line() if torch.cuda.is_available() else "no card"


def _checkpoint_log(trainer) -> dict:
    """Hooks on ``trainer``: ``saves``, each save's ``checkpoint_times`` in
    order (the dict the commit at the next wait completes), and
    ``copies``, this rank's train state copied at each epoch's end, the
    state each save writes."""
    from multivae_tpu_torch.trainers.base.callbacks import TrainingCallback

    saves, copies, plain = [], [], trainer.save_checkpoint

    def save(dir_path, epoch):
        plain(dir_path, epoch)
        saves.append(trainer.checkpoint_times)

    class Copies(TrainingCallback):
        def on_epoch_end(self, training_config, **kwargs):
            copies.append(_train_state(trainer))

    trainer.save_checkpoint = save
    trainer.callback_handler.add_callback(Copies())
    return {"saves": saves, "copies": copies}


def _train_state(trainer):
    """Copies of this rank's masters and optimizer state tensors, where
    they are."""
    masters = [leaf.master.detach().clone() for leaf in trainer._layout().leaves]
    optimizer = {i: {k: v.detach().clone() for k, v in entry.items()
                     if isinstance(v, torch.Tensor)}
                 for i, entry in trainer.optimizer.state_dict()["state"].items()}
    return masters, optimizer


def _same_train_state(a, b) -> bool:
    (ma, oa), (mb, ob) = a, b

    def same(x, y):   # a step count may sit on the host on one side
        return x.shape == y.shape and torch.equal(x, y.to(x.device))

    return (len(ma) == len(mb) and all(same(x, y) for x, y in zip(ma, mb))
            and oa.keys() == ob.keys()
            and all(oa[i].keys() == ob[i].keys()
                    and all(same(oa[i][k], ob[i][k]) for k in oa[i]) for i in oa))


def _timed_restore(trainer, checkpoint_dir) -> float:
    """Seconds of ``trainer``'s resume from ``checkpoint_dir`` (what its
    construction with ``checkpoint=`` runs)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer._resume_from_checkpoint(checkpoint_dir)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def _dir_bytes(path) -> int:
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, files in os.walk(path)
               for f in files)


def _checkpoint_line(label, times, restore_s, card, extra=""):
    """One save's line: the seconds the loop was blocked, those to its files
    written and to its commit (a sharded save's, in the background: the
    commit waits for the trainer's next wait), its bytes a rank and the
    restore's seconds, beside the card's name and power limit."""
    line = (f"  checkpoint {label}: blocked {times['blocked_s']:.4f} s, "
            + (f"written {times['written_s']:.4f} s, commit {times['commit_s']:.4f} s, "
               if "commit_s" in times else "")
            + f"{times['bytes']} bytes a rank, restore {restore_s:.4f} s{extra} | {card}")
    print(line, flush=True)


def _ss_checkpoints(mx, trainer, saved, end, out, device):
    """(a)'s checkpoints: each epoch's restored into ``trainer`` against the
    copy taken at its save, then a run resumed from epoch 1 against the
    final weights ``end``. Returns (the record, the resumed run's
    launches)."""
    name, rows, epochs, chunk = SS_GRAPHED
    t0 = time.perf_counter()
    card, saves, copies = _card(), saved["saves"], saved["copies"]
    check(len(saves) == len(copies) == epochs and all("commit_s" in t for t in saves),
          f"ss_graphed checkpoints: {len(saves)} saves committed of {epochs} epochs")
    record = {"saves": [], "card": card}
    for epoch, (times, copy) in enumerate(zip(saves, copies), 1):
        path = os.path.join(trainer.training_dir, f"checkpoint_epoch_{epoch}")
        restore_s = _timed_restore(trainer, path)
        check(_same_train_state(_train_state(trainer), copy),
              f"ss_graphed checkpoints: epoch {epoch}'s train_state restored is not the "
              "state at its save")
        record["saves"].append(dict(times, restore_s=restore_s))
        _checkpoint_line(f"{name} graphed fsdp, 1 rank, epoch {epoch}", times, restore_s, card)
    resumed, rtrainer, _, rend = _graphed_run(
        mx, name, rows, epochs, device, chunk, False, os.path.join(out, "resumed"),
        checkpoint=os.path.join(trainer.training_dir, "checkpoint_epoch_1"), steps_saving=1,
        overrides={"fsdp": True, **SS_CHECKPOINT})
    check(resumed["epochs_run"] == epochs - 1
          and resumed["launches"] == _expected_launches(resumed),
          f"ss_graphed checkpoints: the resumed run launched {resumed['launches']} in "
          f"{resumed['epochs_run']} epochs, expected {_expected_launches(resumed)}")
    same = all(torch.equal(rend[k], v) for k, v in end.items())
    check(same, "ss_graphed checkpoints: the run resumed from epoch 1 does not repeat the "
          f"uninterrupted run's final weights (move gap {_move_gap(end, rend, end)})")
    record["resumed_bit_equal"] = same
    del rtrainer
    record["seconds"] = time.perf_counter() - t0
    print(f"  state_sharding checkpoints (a): {record['seconds']:.1f} s", flush=True)
    return record, resumed["launches"]


def _restored(name, rows, per_device, device, checkpoint, overrides=None, workload=None):
    """A trainer of ``name`` on ``rows`` seeded rows (or the built
    ``workload``) at ``per_device`` rows a device (``overrides``), as this
    rank of the group that exists, resumed from ``checkpoint``; returns
    (its whole weights on the host, the restore's seconds)."""
    from multivae_tpu_torch.tools import workloads
    from multivae_tpu_torch.trainers import BaseTrainer, BaseTrainerConfig

    w = workload if workload is not None else workloads.build(name, n=rows, device=device)
    kwargs = dict(w.trainer_kwargs, per_device_train_batch_size=per_device,
                  per_device_eval_batch_size=per_device, **(overrides or {}))
    trainer = BaseTrainer(w.model, w.train, w.eval, device=device,
                          training_config=BaseTrainerConfig(
                              output_dir=os.path.join(ROOT, "build", "chip_smoke", "restored"),
                              num_epochs=1, seed=0, **kwargs))
    restore_s = _timed_restore(trainer, checkpoint)
    whole = (trainer._state.whole_state_dict() if trainer._state is not None
             else trainer.model.state_dict())
    whole = {k: v.detach().cpu().clone() for k, v in whole.items()}
    if trainer.is_main_process:
        shutil.rmtree(trainer.training_dir, ignore_errors=True)
    del trainer, w
    torch.cuda.empty_cache()
    return whole, restore_s


def _ss_gloo_checkpoint(out, ranks, card, device, whole_state, label="fsdp_data2",
                        name=SS_GRAPHED[0], rows=SS_ROWS, per_device=DP_BATCH, build=None):
    """(b)'s checkpoint: the two ranks' ``label`` save of ``name``,
    restored whole in this process (``rows`` seeded rows at ``per_device``,
    or the workload ``build(device)`` gives) and held to their final
    weights bit for bit; each rank's file about its bytes at rest, not the
    whole state. Returns (the record, the checkpoint's folder, rank 0's
    final weights)."""
    final = torch.load(os.path.join(out, f"{label}_rank0.pt"), weights_only=True)
    saves = [r["checkpoint"] for r in ranks]
    path = os.path.join(saves[0]["training_dir"], f"checkpoint_epoch_{SS_EPOCHS}")
    whole, restore_s = _restored(name, rows, per_device, device, path,
                                 workload=build(device) if build else None)
    check(list(whole) == list(final) and all(torch.equal(whole[k], v) for k, v in final.items()),
          f"state_sharding checkpoints: the two ranks' sharded checkpoint of {name} restored in "
          "one process is not their final weights")
    files = [os.path.getsize(os.path.join(path, "train_state", f"rank_{r}.pt")) for r in (0, 1)]
    at_rest = [r["state_bytes"]["params_and_optimizer"] for r in ranks]
    check(all(f <= 1.05 * b for f, b in zip(files, at_rest)) and max(files) < 0.6 * whole_state,
          f"state_sharding checkpoints: rank files of {files} bytes against {at_rest} at rest "
          f"and {whole_state} in one process")
    for r, times in enumerate(saves):
        _checkpoint_line(f"{name} fsdp over data 2, gloo, rank {r}",
                         dict(times, bytes=files[r]), restore_s, card,
                         f" (into one process), {at_rest[r]} bytes at rest")
    return {"saves": saves, "rank_file_bytes": files, "bytes_at_rest": at_rest,
            "restore_alone_s": restore_s, "restored_bit_equal": True}, path, final


def _ss_large(device, card):
    """(d): ``SS_LARGE`` trained one step, then saved and restored each way;
    every restore held to the state at the saves bit for bit."""
    from multivae_tpu_torch.tools import workloads
    from multivae_tpu_torch.trainers import BaseTrainer, BaseTrainerConfig

    name, rows = SS_LARGE
    out = os.path.join(ROOT, "build", "chip_smoke", "ss_large")
    shutil.rmtree(out, ignore_errors=True)
    w = workloads.build(name, n=rows, device=device)
    kwargs = dict(w.trainer_kwargs, per_device_train_batch_size=rows)
    trainer = BaseTrainer(w.model, w.train, None, device=device, training_config=BaseTrainerConfig(
        output_dir=out, num_epochs=1, seed=0, **kwargs))
    trainer.train()
    state = _train_state(trainer)
    record = {"workload": name, "parameters": sum(p.numel() for p in w.model.parameters()),
              "card": card}
    try:
        saves = [("msgpack", None)] + [("orbax", i) for i in (1, 2)]
        for backend, i in saves:
            trainer.training_config.checkpoint_backend = backend
            where = os.path.join(out, backend if i is None else f"{backend}_{i}")
            trainer.save_checkpoint(where, epoch=1)
            trainer.wait_for_checkpoint()
            times = dict(trainer.checkpoint_times)
            path = os.path.join(where, "checkpoint_epoch_1")
            times["checkpoint_dir_bytes"] = _dir_bytes(path)
            if backend == "msgpack":   # rank 0 writes it all
                times["bytes"] = times["checkpoint_dir_bytes"]
            times["restore_s"] = _timed_restore(trainer, path)
            check(_same_train_state(_train_state(trainer), state),
                  f"state_sharding checkpoints: {name}'s {backend} restore is not the saved state")
            key = backend if i is None else f"{backend}_{i}"
            record[key] = times
            extra = f", {times['checkpoint_dir_bytes']} bytes in the folder" + (
                "" if backend == "msgpack" else
                f", msgpack blocked {record['msgpack']['blocked_s']:.4f} s")
            _checkpoint_line(f"{name}, 1 rank, {key}", times, times["restore_s"], card, extra)
    finally:
        shutil.rmtree(out, ignore_errors=True)
    del trainer, w
    torch.cuda.empty_cache()
    return record


def _ss_cub_alone(mx, device):
    """``SS_CUB_ROOT``'s CUB files written, then ``mvtcae_cub`` in one
    process on the global batch: ``_ss_cub_run``'s (record, start, final)."""
    from multivae_tpu_torch.tools import dataset_files, workloads

    shutil.rmtree(SS_CUB_ROOT, ignore_errors=True)
    dataset_files.write_cub(SS_CUB_ROOT, **workloads.CUB_SYNTHETIC)
    return _ss_cub_run(mx, device)


def _text_leaves(names) -> list:
    return [k for k in names if k.startswith("encoders.text.")]


def _ss_cub(out, alone, counts, card, device):
    """(b)'s ``mvtcae_cub``: the two ranks in each of ``SS_LAYOUTS`` against
    ``alone`` (``_ss_cub_run``'s one process), and the fsdp ranks' sharded
    checkpoint restored in this process, bit-equal. Prints a line for each
    rank: steps/s, bytes at rest and the text encoder's cut leaves, beside
    the one process's. Returns the record."""
    from multivae_tpu_torch.tools import workloads

    rec, start, final = alone
    n_text = len(_text_leaves(final))
    at_rest = rec["state_bytes"]["params_and_optimizer"]
    record = {"alone": {k: rec[k] for k in ("steps_per_s", "epoch_losses", "eval_losses",
                                            "state_bytes", "run_s")},
              "text_encoder_leaves": n_text}
    print(f"  mvtcae_cub alone: {rec['steps_per_s']:.3f} steps/s, {at_rest} bytes at rest, "
          f"run {rec['run_s']:.1f} s | {card}", flush=True)
    ranks = {}
    for label, _ in SS_LAYOUTS:
        res = _ss_ranks(f"cub_{label}", 2, out, rec, start, final, counts,
                        extra=("placements", "run_s", "checkpoint"))
        ranks[label] = res["ranks"]
        for r in res["ranks"]:
            r["text_encoder_cut_leaves"] = len(_text_leaves(r.pop("placements") or {}))
            check(r["text_encoder_cut_leaves"] > 0,
                  f"state_sharding mvtcae_cub {label}: no leaf of the text encoder cut")
            print(f"  mvtcae_cub {label}, rank {r['rank']} of 2 (gloo, one card): "
                  f"{r['steps_per_s']:.3f} steps/s, "
                  f"{r['state_bytes']['params_and_optimizer']} bytes at rest, "
                  f"{r['text_encoder_cut_leaves']} of {n_text} text encoder leaves cut, "
                  f"run {r['run_s']:.1f} s, gaps {res['gaps']} | {card}", flush=True)
        record[label] = res
    record["checkpoint"], _, _ = _ss_gloo_checkpoint(
        out, ranks["fsdp_data2"], card, device, at_rest, label="cub_fsdp_data2",
        name="mvtcae_cub", rows=SS_CUB_ROWS, per_device=workloads.CUB_BATCH,
        build=_cub_workload)
    for r in ranks["fsdp_data2"]:
        r.pop("checkpoint")
    return record


def _ss_cub_four(out, alone, counts, card, backend):
    """(c)'s ``mvtcae_cub`` over ``SS_CUB_FOUR``: the four ranks against
    ``alone``; each rank's out projections whole (2 heads over data 4), at
    4x the bytes at rest of its query projections, which are cut."""
    res = _ss_ranks("cub_four", 4, out, *alone, counts,
                    extra=("placements", "leaf_bytes", "run_s"))
    for r in res["ranks"]:
        placements, leaf_bytes = r.pop("placements"), r.pop("leaf_bytes")
        outs = [k for k in _text_leaves(leaf_bytes) if k.endswith(".out.weight")]
        ratios = [leaf_bytes[k] / leaf_bytes[k.replace(".out.", ".query.")] for k in outs]
        check(outs and not set(outs) & set(placements) and all(
            abs(x - 4) < 0.01 for x in ratios),
              f"state_sharding mvtcae_cub four: rank {r['rank']} cuts an out projection "
              f"({sorted(set(outs) & set(placements))}) or holds {ratios} of its query's bytes")
        r["text_encoder_cut_leaves"] = len(_text_leaves(placements))
        r["out_over_query_bytes"] = ratios
        print(f"  mvtcae_cub fsdp over data 4, rank {r['rank']} of 4 ({backend}): "
              f"{r['steps_per_s']:.3f} steps/s, "
              f"{r['state_bytes']['params_and_optimizer']} bytes at rest, out projections "
              f"whole ({ratios[0]:.4f}x a query's bytes), {r['text_encoder_cut_leaves']} text "
              f"encoder leaves cut, run {r['run_s']:.1f} s, gaps {res['gaps']} | {card}",
              flush=True)
    return res


def state_sharding(mx, device="cuda", one_process_backend="nccl", rank_command=None,
                   four_only=False):
    """The ``state_sharding`` phase: (a) ``ss_graphed``; (b) two gloo ranks
    on the one card, spawned (``--ss-rank``), fsdp over data 2 and data 1 x
    model 2, each against one process on the global batch, with each
    rank's bytes at rest of parameters and optimizer state beside the one
    process's, and the first's sharded checkpoint restored in this process,
    then ``mvtcae_cub`` in both layouts (``_ss_cub``); (c) where the
    machine shows four cards, ``ss_four``; (d) ``_ss_large``.
    ``four_only`` leaves out (a)'s fsdp run and (d): (c) and the runs it is
    held to. Returns (the record, the launches of every run and rank)."""
    t_phase = time.perf_counter()
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    counts = {k: 0 for k in KERNELS}
    record = {"phase": "state_sharding", "cards": torch.cuda.device_count()}
    try:
        graphed, launches, alone_run = ss_graphed(
            mx, device, one_process_backend, (False,) if four_only else (False, True))
        for k in KERNELS:
            counts[k] += launches[k]
        if graphed is not None:
            record["graphed"] = graphed
            print(json.dumps({"phase": "state_sharding", "graphed": graphed}), flush=True)
        eager_alone = alone, start, final = _ss_eager_alone(mx, device, counts)
        t0 = time.perf_counter()
        cub_alone = _ss_cub_alone(mx, device)
        cub_alone_s = time.perf_counter() - t0
        # (b) in both modes: (c) restores its checkpoint
        out = os.path.join(ROOT, "build", "chip_smoke", "state_sharding", "gloo2")
        t0 = time.perf_counter()
        _spawn_ranks(2, "gloo", out, rank_command or [
            sys.executable, os.path.abspath(__file__), "--ss-rank"], extra=["eager"],
            timeout=SS_RANK_TIMEOUT)
        record["gloo2_spawn_and_train_s"] = time.perf_counter() - t0
        record["alone"] = {k: alone[k] for k in ("steps_per_s", "epoch_losses",
                                                 "eval_losses", "state_bytes",
                                                 "launches_per_step")}
        for label, _ in SS_LAYOUTS:
            record[label] = _ss_ranks(label, 2, out, alone, start, final, counts)
            for r in record[label]["ranks"]:
                check(r["launches_per_step"]["train"] == {
                    k: float(SS_PER_STEP.get(k, 0)) for k in KERNELS},
                    f"state_sharding {label}: a rank's launches a step "
                    f"{r['launches_per_step']}")
        card = _card()
        t0 = time.perf_counter()
        record["mvtcae_cub"] = _ss_cub(out, cub_alone, counts, card, device)
        ranks_cub_s = sum(max(r["run_s"] for r in record["mvtcae_cub"][label]["ranks"])
                          for label, _ in SS_LAYOUTS)
        record["mvtcae_cub"]["seconds"] = {
            "files_and_alone": cub_alone_s, "ranks_slowest": ranks_cub_s,
            "checks_and_restore": time.perf_counter() - t0}
        print(f"  state_sharding mvtcae_cub: {cub_alone_s:.1f} s files and one process, "
              f"{ranks_cub_s:.1f} s in the slowest rank, "
              f"{record['mvtcae_cub']['seconds']['checks_and_restore']:.1f} s checks and "
              "restore", flush=True)
        ranks = []
        for r in range(2):
            with open(os.path.join(out, f"fsdp_data2_rank{r}.json")) as f:
                ranks.append(json.load(f))
        t0 = time.perf_counter()
        record["checkpoints"], saved, saved_final = _ss_gloo_checkpoint(
            out, ranks, card, device, alone["state_bytes"]["params_and_optimizer"])
        if not four_only:
            record["checkpoints"]["large"] = _ss_large(device, card)
        record["checkpoints"]["seconds"] = time.perf_counter() - t0
        print(f"  state_sharding checkpoints (b) and (d): "
              f"{record['checkpoints']['seconds']:.1f} s", flush=True)
        if torch.cuda.device_count() >= 4:
            record["four"] = ss_four(mx, device, alone_run, eager_alone, counts, rank_command,
                                     checkpoint=(saved, saved_final), cub_alone=cub_alone)
        shutil.rmtree(out, ignore_errors=True)
    finally:
        torch.backends.cudnn.deterministic = deterministic
        shutil.rmtree(SS_CUB_ROOT, ignore_errors=True)
    record["seconds"] = time.perf_counter() - t_phase
    print(f"  state_sharding: {record['seconds']:.1f} s")
    return record, counts



def main():
    start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU.", file=sys.stderr)
        return 1
    try:
        from multivae_tpu_torch.ops import cuda_build
        from multivae_tpu_torch.ops import mixture as mx
    except ImportError as e:
        print(f"chip_smoke: cannot import the port ({e}); run it from the "
              "root of a checkout.", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    try:
        print(card_line())
        kind = torch.cuda.get_device_name(0)
        print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
              f"{torch.cuda.device_count()} device(s), device 0: {kind}")

        t0 = time.perf_counter()
        reports = cuda_build.build()
        print(f"build: {time.perf_counter() - t0:.1f} s "
              f"({', '.join(cuda_build.SOURCES + cuda_build.HOST_SOURCES)})")
        for name, report in reports.items():
            if name in cuda_build.HOST_SOURCES:
                continue
            rows = ptxas_summary(report)
            spilling = [r for r in rows if r[2] or r[3]]
            print(f"  {name}: {len(rows)} kernel instances, {len(spilling)} "
                  "with spills (registers, spill store/load bytes):")
            for inst, regs, st, ld in rows:
                if "MQ=5 " in inst or "tensor-copy" in inst or st or ld:
                    print(f"    {inst}: {regs} registers, spill {st}/{ld} bytes")
        sh = SLICE_SHAPE
        for mode in ("fwd", "bwd_dz", "bwd"):
            for dtype in (torch.float32, torch.bfloat16):
                print(f"  launch at the slice, {mode} {dtype}: " + json.dumps(mx.launch_shape(
                    sh["mz"] * sh["k"], sh["b"], sh["d"], sh["mq"], mode, dtype=dtype)))

        print("kernels vs plain (rtol/atol out "
              f"{OUT_RTOL}/{OUT_ATOL}, grads {GRAD_RTOL}/{GRAD_ATOL}):")
        errs = {"fwd": 0.0, "bwd": 0.0, "bwd_dz": 0.0}
        failures = []
        for shape in CHECK_SHAPES:
            for dist in ("laplace", "normal"):
                try:
                    case = mixture_case(mx, shape, dist)
                except SmokeFailure as e:
                    failures.append(str(e))
                    continue
                errs = {k: max(errs[k], v) for k, v in case.items()}
        check(not failures, "; ".join(failures))
        names = forward_kernel_names(mx)
        print(f"  device kernels in one forward call (torch.profiler): {names}")
        check(len(names) == 1 and "mixture_kernel" in names[0],
              f"a CUDA forward must be exactly one mixture kernel, saw {names}")
        timing = mixture_timing(mx)
        for label, shape, times in (("slice", SLICE_SHAPE, timing),
                                    ("mmvaeplus_k10", K10_SHAPE, mixture_timing(mx, K10_SHAPE))):
            print(f"  at the {label} shape {shape}:")
            for kname, (ms, plain_ms, bound_ms, bound_by) in times.items():
                print(f"    mixture_{kname}: {ms:.4f} ms (plain {plain_ms:.4f} ms, "
                      f"bound {bound_ms:.4f} ms by {bound_by}, "
                      f"{100 * bound_ms / ms:.1f}% of bound)")
        fixed_cost(mx)
        print("bf16 kernels vs plain in float64 (rtol/atol out "
              f"{OUT_RTOL}/{OUT_ATOL}, grads {BF16_GRAD_RTOL}/{GRAD_ATOL}):")
        errs_bf16, timing_bf16 = bf16_kernels(mx)
        errs.update(errs_bf16)
        timing.update(timing_bf16)

        # launches of every training and inference phase that runs the kernels
        launches = {k: 0 for k in KERNELS}

        def add(counts):
            for k in KERNELS:
                launches[k] += counts[k]

        result, counts = slice_run(mx)
        print("slice: " + json.dumps(result))
        add(counts)
        iwae, counts = slice_run(mx, n=512, epochs=1, loss="iwae_looser")
        print("iwae path: " + json.dumps(iwae))
        add(counts)

        trained = {}
        random_records = {}   # runs on random arrays, beside the datasets phase's
        for name in ("mvtcae_mlp", "mvtcae_conv"):
            record, trained[name], _ = workload_run(mx, name)
            print(json.dumps(record))
            random_records[name] = record
        print(json.dumps(inference_phase(mx, "mvtcae_inference", trained, {
            "mvtcae_mlp": [("joint_nll", 512, 0)],
            "mvtcae_conv": [("joint_nll", 256, 0)]})[0]))

        moe = {}
        dreg, iwae_step = {"fwd": 2, "bwd_dz": 1}, {"fwd": 1, "bwd": 1}
        moe_records = {}
        for name, n, per_step in (("mmvae_conv", 1024, dreg),
                                  ("mmvaeplus_partial", 1024, dreg),
                                  ("mmvaeplus_k10", 512, iwae_step),
                                  ("cmvae_polymnist", 256, iwae_step)):
            record, moe[name], counts = workload_run(mx, name, n=n, per_step=per_step)
            print(json.dumps(record))
            moe_records[name] = random_records[name] = record
            add(counts)
        del moe["mmvaeplus_partial"]
        # MMVAE+ and CMVAE evaluate the mixture once a chunk of K // M samples
        # of every expert, MMVAE's paper estimator once a chunk of K
        per_expert_chunks = -(-(NLL_K // 5) // NLL_CHUNK)
        record, counts = inference_phase(mx, "moe_inference", moe, {
            "mmvae_conv": [("joint_nll", 256, 0),
                           ("joint_nll_paper", 64, -(-NLL_K // NLL_CHUNK))],
            "mmvaeplus_k10": [("joint_nll", 32, per_expert_chunks)],
            "cmvae_polymnist": [("joint_nll", 32, per_expert_chunks)]})
        print(json.dumps(record))
        add(counts)

        poe = {}
        for name in ("mvae_conv", "mopoe_conv", "crmvae_resnet"):
            record, poe[name], _ = workload_run(mx, name)
            print(json.dumps(record))
        print(json.dumps(inference_phase(mx, "poe_inference", poe, {
            "mvae_conv": [("joint_nll", 256, 0)],
            "mopoe_conv": [("joint_nll", 256, 0), ("joint_nll_paper", 256, 0)],
            "crmvae_resnet": [("joint_nll", 64, 0)]})[0]))

        joint = {}
        telbo_dir = None
        for name, n, epochs in (("dmvae_mnist_svhn", 2048, 2), ("jmvae_conv", 2048, 2),
                                ("telbo_conv", 1024, 3), ("cvae_tutorial", 256, 3)):
            record, joint[name], _ = workload_run(mx, name, n=n, epochs=epochs)
            print(json.dumps(record))
            random_records[name] = record
            if name == "telbo_conv":
                telbo_dir = record["training_dir"]
        mx.reset_launches()
        cvae = cvae_surface(joint.pop("cvae_tutorial"))
        check(not any(mx.launches.values()), f"cvae inference launched {mx.launches}")
        record, _ = inference_phase(mx, "joint_inference", joint, {
            "dmvae_mnist_svhn": [("joint_nll", 512, 0)],
            "jmvae_conv": [("joint_nll", 256, 0)],
            "telbo_conv": [("joint_nll", 256, 0)]})
        record["cvae_tutorial"] = cvae
        print(json.dumps(record))

        record, jnf, _ = workload_run(mx, "jnf_conv", n=2048, epochs=3)
        print(json.dumps(record))
        print(json.dumps(jnf_inference(mx, jnf)))
        print(json.dumps(samplers_phase(mx, jnf, joint["dmvae_mnist_svhn"])))

        record, mhvae, _ = workload_run(mx, "mhvae_polymnist", n=2048, epochs=2)
        print(json.dumps(record))
        record, nexus, _ = workload_run(mx, "nexus_e2e", n=600, epochs=2)
        print(json.dumps(record))
        print(json.dumps(hierarchical_inference(mx, mhvae, nexus)))
        print(json.dumps(samplers_incomplete(mx, trained["mvtcae_conv"], moe["mmvae_conv"])))
        record, counts = evaluation_phase(mx, {"mvtcae_conv": trained["mvtcae_conv"].model,
                                               "mmvae_conv": moe["mmvae_conv"].model})
        print(json.dumps(record))
        add(counts)
        record, counts = trainer_lifecycle(mx, trained["mvtcae_conv"].model,
                                           moe_records["mmvaeplus_k10"], telbo_dir)
        print(json.dumps(record))
        add(counts)
        del trained, moe, poe, joint, jnf, mhvae, nexus
        record, counts = datasets_phase(mx, random_records)
        print(json.dumps(record))
        add(counts)
        record, counts = resident_data(mx)
        print(json.dumps(record))
        add(counts)
        record, counts = graphed_steps(mx)
        print(json.dumps({k: v for k, v in record.items() if k in (
            "phase", "seconds", "launches", "chunk")}))
        add(counts)
        record, counts = data_parallel(mx)
        print(json.dumps(record))
        add(counts)
        record, counts = mixed_precision_phase(mx)
        print(json.dumps(record))
        add(counts)
        record, counts = state_sharding(mx)
        print(json.dumps(record))
        add(counts)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1

    missing = [k for k in KERNELS if not launches[k]]
    if missing:
        print(f"chip_smoke: FAILED: no main-path run launched {missing}", file=sys.stderr)
        return 1
    kernels = []
    for kname, line in (("fwd", 81), ("bwd", 97), ("bwd_dz", 97),
                        ("fwd_bf16", 81), ("bwd_bf16", 97), ("bwd_dz_bf16", 97)):
        ms, plain_ms, bound_ms, bound_by = timing[kname]
        src = "multivae_tpu_torch/csrc/" + (
            "mixture_bf16.cu" if kname.endswith("_bf16") else "mixture.cu")
        base = kname.replace("_bf16", "")
        kernels.append({
            "name": f"mixture_{kname}", "route": "cuda", "source": src,
            "design": mx.route(torch.bfloat16 if kname.endswith("_bf16") else torch.float32,
                               base, SLICE_SHAPE["d"], SLICE_SHAPE["mq"], True),
            "replaces": f"multivae_tpu/ops/pallas_mixture.py:{line}",
            "launches": launches[kname], "max_abs_err": errs[kname], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None,
        })
    print(f"chip_smoke: every phase passed in {time.perf_counter() - start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


def four_cards_main():
    """``--state-sharding-four``: the kernels built, then only the
    state_sharding phase's four-card run (c) and the graphed run it is held
    to; prints the card's line, the phase's record and the launches."""
    if torch.cuda.device_count() < 4:
        print("chip_smoke: --state-sharding-four needs four cards", file=sys.stderr)
        return 1
    from multivae_tpu_torch.ops import cuda_build
    from multivae_tpu_torch.ops import mixture as mx

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(card_line())
    cuda_build.build()
    try:
        record, counts = state_sharding(mx, four_only=True)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(json.dumps(record))
    print(json.dumps({"launches": counts}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-rank"]:
        sys.exit(dp_rank_main(sys.argv[2:]))
    if sys.argv[1:2] == ["--ss-rank"]:
        sys.exit(ss_rank_main(sys.argv[2:]))
    if sys.argv[1:2] == ["--state-sharding-four"]:
        sys.exit(four_cards_main())
    sys.exit(main())
