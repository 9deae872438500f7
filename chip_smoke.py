"""Smoke test of the PyTorch/CUDA port (``multivae_tpu_torch``) on one GPU.

Run from the root of a checkout, on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. the card's name and power limit (nvidia-smi), torch and CUDA versions;
2. build every CUDA kernel of the port from ``multivae_tpu_torch/csrc``
   with nvcc (into ``build/kernels/``), printing the build time and the
   compiler's register/shared-memory report;
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
20. the seconds the whole run took, a ``kernels`` JSON line (launches
    summed over every training and inference phase that runs the kernels),
    then the last line
    ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

It imports nothing of JAX and nothing of the JAX package.
"""

import contextlib
import copy
import json
import os
import re
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
KERNELS = ("fwd", "bwd", "bwd_dz")
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
    check(mx.launches == {"fwd": before["fwd"] + 2, "bwd": before["bwd"] + 1,
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


def mixture_timing(mx, s=SLICE_SHAPE):
    """Kernel, plain and bound times at the shapes ``s`` (Laplace)."""
    from multivae_tpu_torch.tools.mixture_sweep import flush_buffer, op_times

    z, mus, sig, mask, g = mixture_inputs(**s)
    r, b, d, mq = s["mz"] * s["k"], s["b"], s["d"], s["mq"]
    flush = flush_buffer()
    # Each op is one launch of its kernel: the forward reads sigma itself.
    kernel = op_times(mx.mixture_log_density, z, mus, sig, mask, g, flush)
    plain = op_times(mx.mixture_log_density_plain, z, mus, sig, mask, g, flush)
    big, small = r * b * d, mq * b * d        # z (and dz); mu, sigma (dmu, dsig)
    fwd_bytes = 4 * (big + 2 * small + 2 * mq * b + r * b)   # + mask, logc, out
    dz_bytes = 4 * (2 * big + 2 * small + 2 * mq * b + 2 * r * b)  # + out, g
    bwd_bytes = dz_bytes + 4 * 2 * small      # + dmu, dsig
    terms = r * b * mq * d

    def bound(nbytes, ops):
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        t_ops = ops / PEAK_F32_OPS_PER_S * 1e3
        return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")

    work = {"fwd": (fwd_bytes, FWD_OPS_PER_TERM * terms),
            "bwd": (bwd_bytes, BWD_OPS_PER_TERM * terms),
            "bwd_dz": (dz_bytes, DZ_OPS_PER_TERM * terms)}
    return {k: (kernel[k], plain[k], *bound(*work[k])) for k in work}


def ptxas_summary(report):
    """(kernel instance, registers, spill store bytes, spill load bytes) from
    the compiler's -Xptxas -v report."""
    pat = re.compile(r"mixture_kernelILb(\d)ELi(\d+)ELi(\d+)ELi(\d)ELb(\d)ELb(\d)E")
    modes = ("fwd", "bwd_dz", "bwd")
    rows, name, spill = [], None, (0, 0)
    for line in report.splitlines():
        m = pat.search(line)
        if "Function properties for" in line and m:
            lap, q, w, mode, chunked, stream = m.groups()
            name = (f"{'laplace' if lap == '1' else 'normal'} {modes[int(mode)]} "
                    f"MQ={'chunks of ' if chunked == '1' else ''}{q} "
                    f"{'float4' if w == '4' else 'scalar'}"
                    f"{' streaming' if stream == '1' else ''}")
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
    expected = ({"fwd": 2 * steps, "bwd": 0, "bwd_dz": steps}
                if loss == "dreg_looser" else
                {"fwd": steps, "bwd": steps, "bwd_dz": 0})
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

    raw = dataset.get_batch(idx)
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    return batch_from_arrays({m: v.astype(np_dtype) for m, v in raw["data"].items()},
                             masks=raw.get("masks"))


def workload_run(mx, name, n=2048, epochs=2, device="cuda", per_step=None):
    """Train a workload of ``tools/workloads.py`` with its trainer
    (BaseTrainer unless it names another); returns (the phase's JSON record,
    the workload, the mixture launches). The kernels must launch
    ``per_step`` times (forward, full and dz-only backward) on each train
    step and the forwards on each eval step: none on the MVTCAE workloads.
    The steps are counted by a hook on the optimizer, set again on the new
    optimizer of a ``MultistageTrainer`` reset; a two-stage model's steps/s
    are also given for each stage, and its 8-row loss is checked card vs CPU
    in stage 1 too."""
    from multivae_tpu_torch.tools import workloads
    from multivae_tpu_torch.trainers import BaseTrainer, BaseTrainerConfig

    per_step = per_step or {}
    w = workloads.build(name, n=n, device=device)
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
    expected["fwd"] += per_step.get("fwd", 0) * eval_steps
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
              "wall_s": wall_s, "launches": launches}
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
    expected = {"fwd": (repeats + 1) * per_call, "bwd": 0, "bwd_dz": 0}
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


def evaluator_calls(model, clfs, test, train, out_dir, inception_path=None, small=False):
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
    128-feature covariance of 64 rows would be singular)."""
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

    def likelihoods():
        ev = LikelihoodsEvaluator(model, nll_set, eval_config=LikelihoodsEvaluatorConfig(
            num_samples=K, batch_size_k=chunk, unified_implementation=not paper))
        return finished(ev, dict(ev.eval(), rows=len(nll_set)))

    def coherence():
        ev = CoherenceEvaluator(model, clfs, test, eval_config=CoherenceEvaluatorConfig(
            batch_size=512, num_classes=10, **({"nb_samples_for_joint": 64} if small else {})))
        return finished(ev, dict(ev.eval()))

    def reconstruction():
        out = {}
        for metric in ("SSIM", "MSE"):
            ev = Reconstruction(model, test, eval_config=ReconstructionConfig(metric=metric))
            out.update(finished(ev, ev.eval()))
        return out

    def clustering():
        ev = Clustering(model, test, train, eval_config=ClusteringConfig(
            number_of_runs=1 if small else 4), generator=torch.Generator().manual_seed(0))
        return finished(ev, dict(ev.eval()))

    def visualization():
        ev = Visualization(model, test, output=out_dir)
        return finished(ev, {"unconditional": ev.eval().unconditional_generation,
                             "from_m1": ev.conditional_samples_subset(["m1"])})

    def fid_subsets():
        embed = {m: clfs[m] if small else clfs[m].features for m in mods}
        ev = FIDEvaluator(model, test, custom_encoders=embed,
                          eval_config=FIDEvaluatorConfig(batch_size=256))
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
                expected = {"fwd": -(-NLL_K // NLL_CHUNK) if paper_nll else 0,
                            "bwd": 0, "bwd_dz": 0}
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
              f"({', '.join(cuda_build.SOURCES)})")
        for name, report in reports.items():
            rows = ptxas_summary(report)
            spilling = [r for r in rows if r[2] or r[3]]
            print(f"  {name}: {len(rows)} kernel instances, {len(spilling)} "
                  "with spills (registers, spill store/load bytes):")
            for inst, regs, st, ld in rows:
                if "MQ=5 " in inst or st or ld:
                    print(f"    {inst}: {regs} registers, spill {st}/{ld} bytes")
        sh = SLICE_SHAPE
        for mode in ("fwd", "bwd_dz", "bwd"):
            print(f"  launch at the slice, {mode}: " + json.dumps(mx.launch_shape(
                sh["mz"] * sh["k"], sh["b"], sh["d"], sh["mq"], mode)))

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
        for name in ("mvtcae_mlp", "mvtcae_conv"):
            record, trained[name], _ = workload_run(mx, name)
            print(json.dumps(record))
        print(json.dumps(inference_phase(mx, "mvtcae_inference", trained, {
            "mvtcae_mlp": [("joint_nll", 512, 0)],
            "mvtcae_conv": [("joint_nll", 256, 0)]})[0]))

        moe = {}
        dreg, iwae_step = {"fwd": 2, "bwd_dz": 1}, {"fwd": 1, "bwd": 1}
        for name, n, per_step in (("mmvae_conv", 1024, dreg),
                                  ("mmvaeplus_partial", 1024, dreg),
                                  ("mmvaeplus_k10", 512, iwae_step),
                                  ("cmvae_polymnist", 256, iwae_step)):
            record, moe[name], counts = workload_run(mx, name, n=n, per_step=per_step)
            print(json.dumps(record))
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
        for name, n, epochs in (("dmvae_mnist_svhn", 2048, 2), ("jmvae_conv", 2048, 2),
                                ("telbo_conv", 1024, 3), ("cvae_tutorial", 256, 3)):
            record, joint[name], _ = workload_run(mx, name, n=n, epochs=epochs)
            print(json.dumps(record))
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
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1

    src = "multivae_tpu_torch/csrc/mixture.cu"
    kernels = []
    for kname, line in (("fwd", 81), ("bwd", 97), ("bwd_dz", 97)):
        ms, plain_ms, bound_ms, bound_by = timing[kname]
        kernels.append({
            "name": f"mixture_{kname}", "route": "cuda", "source": src,
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


if __name__ == "__main__":
    sys.exit(main())
