"""Smoke test of the PyTorch/CUDA port (``multivae_tpu_torch``) on one GPU.

Run from the root of a checkout, on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. the card's name and power limit (nvidia-smi), torch and CUDA versions;
2. build every CUDA kernel of the port from ``multivae_tpu_torch/csrc``
   with nvcc (into ``build/kernels/``), printing the build time and the
   compiler's register/shared-memory report;
3. kernels: the mixture log-density forward and its three gradients
   against the plain PyTorch version on the card, at the MMVAE slice
   shapes and at a ragged shape, for Laplace and Normal, with a masked
   expert on some columns and one fully masked column; then each kernel's
   time (CUDA events, median of 20 runs, L2 flushed before each), the plain
   version's time and the memory bound;
4. slice: the full-width MMVAE (5 modalities of 3x28x28, latent 512,
   K=10, default MLP nets, Laplace decoders, DReG) trained by
   ``BaseTrainer.train()`` for 2 epochs of 2048 random samples (16 steps of
   batch 256, Adam 1e-3, float32); every epoch loss must be finite, the
   mixture kernels must launch exactly twice (forward) and once (backward)
   per step, and the trained model's loss on 8 rows must agree between the
   card (kernel path) and the CPU (plain path) on the same noise;
5. a ``kernels`` JSON line, then the last line
   ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

It imports nothing of JAX and nothing of the JAX package.
"""

import copy
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth and f32 without
# tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
# Operations per (row, expert, batch column, coordinate) term: forward
# sub, mul, abs (or square), add; backward recomputes that and adds ~12
# for the three gradient accumulations.
FWD_OPS_PER_TERM = 4
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
LOSS_RTOL = 1e-4

SLICE_SHAPE = dict(mz=5, k=10, b=256, d=512, mq=5)
RAGGED_SHAPE = dict(mz=3, k=4, b=37, d=100, mq=3)


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


def time_ms(fn, flush, reps=20, warmup=3):
    """Median device time of ``fn`` (CUDA events), L2 flushed before each."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def mixture_inputs(mz, k, b, d, mq, seed=0):
    rng = np.random.default_rng(seed)
    mask = np.ones((mq, b), np.float32)
    mask[1, : max(b // 3, 2)] = 0.0   # a masked expert on some columns
    mask[:, 0] = 0.0                  # a fully masked column
    arrays = (rng.normal(size=(mz, k, b, d)), rng.normal(size=(mq, b, d)),
              rng.uniform(0.5, 1.5, size=(mq, b, d)), mask,
              rng.normal(size=(mz, k, b)))
    return [torch.tensor(np.asarray(a, np.float32), device="cuda") for a in arrays]


def mixture_case(mx, shape, dist):
    """Kernel vs plain on one shape; returns (fwd max err, grad max err)."""
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
    torch.cuda.synchronize()
    check(mx.launches["fwd"] == before["fwd"] + 1
          and mx.launches["bwd"] == before["bwd"] + 1,
          f"launch counters did not move for {shape} {dist}")
    out_k, grads_k = results["kernel"]
    out_p, grads_p = results["plain"]
    _, grads_64 = results["plain64"]
    check(out_k.shape == out_p.shape, "forward shape differs")
    fwd_err = (out_k - out_p)[..., 1:].abs().max().item()
    names = ("dz", "dmu", "dsig")
    errs = {n: (gk - gp).abs().max().item()
            for n, gk, gp in zip(names, grads_k, grads_p)}
    scale = {n: gp.abs().max().item() for n, gp in zip(names, grads_p)}
    err64 = {n: ((gk.double() - g64).abs().max().item(),
                 (gp.double() - g64).abs().max().item())
             for n, gk, gp, g64 in zip(names, grads_k, grads_p, grads_64)}
    print(f"  mixture {dist:7s} {shape}: fwd max abs err {fwd_err:.3e} "
          "(fully masked column excluded); grads max abs err / max|plain|: "
          + ", ".join(f"{n} {errs[n]:.3e}/{scale[n]:.3e}" for n in names)
          + "; vs float64, kernel (plain f32): "
          + ", ".join(f"{n} {a:.2e} ({b:.2e})" for n, (a, b) in err64.items()))
    check(torch.allclose(out_k, out_p, rtol=OUT_RTOL, atol=OUT_ATOL),
          f"forward differs for {shape} {dist}")
    for n, gk in zip(names, grads_k):
        check(bool(torch.isfinite(gk).all()), f"{n} not finite ({shape} {dist})")
        check(errs[n] <= GRAD_ATOL + GRAD_RTOL * scale[n],
              f"{n} differs for {shape} {dist}")
    check(bool((grads_k[0][..., 0, :] == 0).all()),
          "a fully masked column must get zero dz")
    return fwd_err, max(errs.values())


def mixture_timing(mx, flush):
    """Kernel, plain and bound times at the slice shapes (Laplace)."""
    s = SLICE_SHAPE
    z, mus, sig, mask, g = mixture_inputs(**s)
    r, b, d, mq = s["mz"] * s["k"], s["b"], s["d"], s["mq"]
    dist = "laplace"
    with torch.no_grad():
        # The kernels alone; the wrapper's torch prep (1/sigma and the
        # per-expert constant, four more launches) is timed apart, since its
        # host launch gaps vary from run to run.
        z3 = z.view(r, b, d)
        inv_sig, logc = mx._prep(sig, d, dist)
        fwd_ms = time_ms(lambda: mx._launch_fwd(z3, mus, inv_sig, logc, mask, True),
                         flush)
        wrapper_ms = time_ms(
            lambda: mx.mixture_log_density(z, mus, sig, mask, dist), flush)
        plain_fwd_ms = time_ms(
            lambda: mx.mixture_log_density_plain(z, mus, sig, mask, dist), flush)
        print(f"  mixture_log_density forward with its torch prep: {wrapper_ms:.4f} ms")
        out = mx._launch_fwd(z3, mus, inv_sig, logc, mask, True)
        g2 = g.reshape(r, b).contiguous()
        bwd_ms = time_ms(lambda: mx._launch_bwd(z3, mus, inv_sig, logc, mask,
                                                out, g2, True), flush)
    leaves = [t.clone().requires_grad_() for t in (z, mus, sig)]
    out_p = mx.mixture_log_density_plain(*leaves, mask, dist)
    plain_bwd_ms = time_ms(lambda: torch.autograd.grad(out_p, leaves, g,
                                                       retain_graph=True), flush)
    big = r * b * d + 2 * mq * b * d           # z, mu, sigma
    fwd_bytes = 4 * (big + mq * b + r * b)     # + mask, out
    bwd_bytes = 4 * (2 * big + mq * b + 2 * r * b)  # + dz, dmu, dsig, g, out
    terms = r * b * mq * d

    def bound(nbytes, ops):
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        t_ops = ops / PEAK_F32_OPS_PER_S * 1e3
        return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")

    return {
        "fwd": (fwd_ms, plain_fwd_ms, *bound(fwd_bytes, FWD_OPS_PER_TERM * terms)),
        "bwd": (bwd_ms, plain_bwd_ms, *bound(bwd_bytes, BWD_OPS_PER_TERM * terms)),
    }


def slice_run(mx, n_mods=5, shape=(3, 28, 28), n=2048, latent_dim=512, K=10,
              batch_size=256, epochs=2, device="cuda"):
    """Train the MMVAE slice with BaseTrainer (defaults: full width)."""
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
        prior_and_posterior_dist="laplace_with_softmax", loss="dreg_looser")
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
    check(launches == {"fwd": 2 * steps, "bwd": steps},
          f"expected fwd={2 * steps}, bwd={steps} launches, got {launches}")
    steps_per_s = (steps - 1) / (step_ends[0].elapsed_time(step_ends[-1]) / 1e3)
    peak_bytes = torch.cuda.max_memory_allocated()

    # The trained model's loss on 8 rows: card (kernel) vs CPU (plain).
    rows = {m: v[:8] for m, v in data.items()}
    noise_gen = torch.Generator().manual_seed(1)
    u = {m: sample_noise(model.dist_name, (K, 8, latent_dim), generator=noise_gen)
         for m in data}

    def small_loss(net, device):
        batch = batch_from_arrays(rows).to(device)
        with torch.no_grad():
            post = net._posterior_params(batch)
            zs = {m: dist_rsample_k(net.dist_name, mu, sig, K,
                                    u=u[m].to(device))
                  for m, (mu, sig) in post.items()}
            return net._dreg_looser(batch, post, zs)["loss"].item()

    loss_card = small_loss(model, device)
    loss_cpu = small_loss(copy.deepcopy(model).to("cpu"), "cpu")
    check(np.isfinite(loss_card), "small-input loss is not finite")
    check(abs(loss_card - loss_cpu) <= LOSS_RTOL * abs(loss_cpu),
          f"small-input loss card {loss_card} vs cpu {loss_cpu}")
    return {"steps": steps, "epoch_losses": losses, "steps_per_s": steps_per_s,
            "peak_mem_bytes": peak_bytes, "wall_s": wall_s,
            "small_loss_card": loss_card, "small_loss_cpu": loss_cpu}, launches


def main():
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
            for line in report.splitlines():
                if "registers" in line or "spill" in line or "error" in line:
                    print(f"  {name}: {line.strip()}")

        print("kernels vs plain (rtol/atol out "
              f"{OUT_RTOL}/{OUT_ATOL}, grads {GRAD_RTOL}/{GRAD_ATOL}):")
        fwd_err = grad_err = 0.0
        failures = []
        for shape in (SLICE_SHAPE, RAGGED_SHAPE):
            for dist in ("laplace", "normal"):
                try:
                    f, gerr = mixture_case(mx, shape, dist)
                except SmokeFailure as e:
                    failures.append(str(e))
                    continue
                fwd_err, grad_err = max(fwd_err, f), max(grad_err, gerr)
        check(not failures, "; ".join(failures))
        flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
        timing = mixture_timing(mx, flush)
        del flush
        for kname, (ms, plain_ms, bound_ms, bound_by) in timing.items():
            print(f"  mixture_{kname}: {ms:.4f} ms (plain {plain_ms:.4f} ms, "
                  f"bound {bound_ms:.4f} ms by {bound_by})")

        result, launches = slice_run(mx)
        print("slice: " + json.dumps(result))
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1

    src = "multivae_tpu_torch/csrc/mixture.cu"
    kernels = []
    for kname, line, err in (("fwd", 81, fwd_err), ("bwd", 97, grad_err)):
        ms, plain_ms, bound_ms, bound_by = timing[kname]
        kernels.append({
            "name": f"mixture_{kname}", "route": "cuda", "source": src,
            "replaces": f"multivae_tpu/ops/pallas_mixture.py:{line}",
            "launches": launches[kname], "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None,
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
