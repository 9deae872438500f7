"""Device time of the mixture op against the number of sample rows.

Times the op through its public entry, ``mixture_log_density``, at B=256,
D=512, MQ=5 (or at each ``--shape B D MQ``), Laplace, float32, for each R in
``--rows`` (the MMVAE slice has R = MZ*K = 50): the whole forward, the
backward with gradients to z, mus and sigmas, and the backward to z alone
(mus and sigmas detached, the DReG case). Each time is ``time_ms``'s, which ``chip_smoke.py`` uses too. The
slope over R is the cost of a row in steady state; the intercept is the
fixed cost of a call.

``--root DIR`` imports the port from another checkout, for example an
unpacked parent commit, so that two versions are timed the same way in one
run. Run it by path (not with ``-m``), on a machine with a CUDA GPU:

    python3 multivae_tpu_torch/tools/mixture_sweep.py [--rows 4 16 32 50 100]
        [--shape 256 512 5 ...] [--root DIR]

Prints the card's name and power limit, then one JSON line per shape and R
(with the error instead of times where the op refuses the shape).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

import numpy as np
import torch

# The L2 flush before each timed call writes this many bytes (256 MB, five
# times the H100's 50 MB L2).
FLUSH_BYTES = 256 * 2 ** 20
# About 1 ms at the H100's clock: long enough for the host to queue the
# flush and the timed call behind it.
SLEEP_CYCLES = 2_000_000


def flush_buffer():
    return torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")


def time_ms(fn, flush, reps=20, warmup=3):
    """Median device time of ``fn`` in ms over ``reps`` calls: CUDA events
    around one call, the L2 flushed (``flush.zero_()``) before each. The
    stream sleeps first while the host queues the flush and the call, so
    host time between the launches of ``fn`` is not counted."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        torch.cuda._sleep(SLEEP_CYCLES)
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def op_times(fn, z, mus, sigmas, mask, g, flush, dist="laplace"):
    """ms of the forward ('fwd'), the backward to z, mus and sigmas ('bwd')
    and the backward to z alone ('bwd_dz') of ``fn(z, mus, sigmas, mask,
    dist)``, each timed alone with ``time_ms``."""
    with torch.no_grad():
        fwd = time_ms(lambda: fn(z, mus, sigmas, mask, dist), flush)
    leaves = [t.clone().requires_grad_() for t in (z, mus, sigmas)]
    out = fn(*leaves, mask, dist)
    bwd = time_ms(lambda: torch.autograd.grad(out, leaves, g, retain_graph=True),
                  flush)
    z_leaf = z.clone().requires_grad_()
    out_z = fn(z_leaf, mus, sigmas, mask, dist)
    bwd_dz = time_ms(lambda: torch.autograd.grad(out_z, [z_leaf], g,
                                                 retain_graph=True), flush)
    return {"fwd": fwd, "bwd": bwd, "bwd_dz": bwd_dz}


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--rows", type=int, nargs="+", default=[4, 16, 32, 50, 100])
    parser.add_argument("--shape", type=int, nargs=3, action="append",
                        metavar=("B", "D", "MQ"),
                        help="batch columns, coordinates, experts (repeatable; "
                             "default 256 512 5)")
    parser.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))),
        help="checkout whose multivae_tpu_torch is timed (default: this one)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("mixture_sweep needs a CUDA device.")
    sys.path.insert(0, os.path.abspath(args.root))
    from multivae_tpu_torch.ops import mixture as mx

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    flush = flush_buffer()
    for b, d, mq in args.shape or [(256, 512, 5)]:
        rng = np.random.default_rng(0)
        mus = torch.tensor(rng.normal(size=(mq, b, d)), dtype=torch.float32,
                           device="cuda")
        sig = torch.tensor(rng.uniform(0.5, 1.5, size=(mq, b, d)),
                           dtype=torch.float32, device="cuda")
        mask = torch.ones((mq, b), dtype=torch.float32, device="cuda")
        for r in args.rows:
            z = torch.tensor(rng.normal(size=(1, r, b, d)), dtype=torch.float32,
                             device="cuda")
            g = torch.tensor(rng.normal(size=(1, r, b)), dtype=torch.float32,
                             device="cuda")
            line = {"root": args.root, "b": b, "d": d, "mq": mq, "rows": r}
            try:
                line["ms"] = op_times(mx.mixture_log_density, z, mus, sig, mask, g,
                                      flush)
            except ValueError as e:   # a shape this checkout's op refuses
                line["error"] = str(e)
            print(json.dumps(line))


if __name__ == "__main__":
    main()
