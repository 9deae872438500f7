"""Device time of the mixture op against the number of sample rows.

Times the op through its public entry, ``mixture_log_density``, at B=256,
D=512, MQ=5 (or at each ``--shape B D MQ``), Laplace, with z, mu, sigma and
the mask in each ``--dtype`` (float32 by default; bfloat16 runs the bf16
kernels), for each R in ``--rows`` (the MMVAE slice has R = MZ*K = 50): the
whole forward, the backward with gradients to z, mus and sigmas, and the
backward to z alone (mus and sigmas detached, the DReG case). Each time is
``time_ms``'s, which ``chip_smoke.py`` uses too. The slope over R is the
cost of a row in steady state; the intercept is the fixed cost of a call.

``--root DIR`` imports the port from another checkout, for example an
unpacked parent commit. ``--against DIR --pairs N`` times the two
checkouts in N alternating pairs (DIR first, then ``--root``; then the
other way round, and so on), each run a process of its own, after building
both checkouts' kernels in parallel; it prints every run's lines, then one
summary line per checkout, shape, dtype, R and op with the median, least
and largest ms over the pairs. Run it by path (not with ``-m``), on a
machine with a CUDA GPU:

    python3 multivae_tpu_torch/tools/mixture_sweep.py [--rows 4 16 32 50 100]
        [--shape 256 512 5 ...] [--dtype float32 bfloat16] [--root DIR]
        [--against DIR --pairs 10]

Prints the card's name and power limit, then one JSON line per checkout,
shape, dtype and R (with the error instead of times where the op refuses
the shape).
"""

from __future__ import annotations

import argparse
import collections
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
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
HERE = os.path.abspath(__file__)


def flush_buffer():
    return torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")


def time_ms(fn, flush, reps=20, warmup=3, read_only=False):
    """Median device time of ``fn`` in ms over ``reps`` calls: CUDA events
    around one call, the L2 flushed (``flush.zero_()``) before each. The
    stream sleeps first while the host queues the flush and the call, so
    host time between the launches of ``fn`` is not counted.
    ``read_only`` flushes by summing the buffer instead, which leaves the
    L2 holding clean lines (``zero_()`` leaves it dirty)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        torch.cuda._sleep(SLEEP_CYCLES)
        if read_only:
            flush.sum()
        else:
            flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def op_calls(fn, z, mus, sigmas, mask, g, dist="laplace"):
    """Calls of the forward ('fwd'), the backward to z, mus and sigmas
    ('bwd') and the backward to z alone ('bwd_dz') of ``fn(z, mus, sigmas,
    mask, dist)``; each backward reuses one forward's graph."""
    def fwd():
        with torch.no_grad():
            return fn(z, mus, sigmas, mask, dist)

    leaves = [t.clone().requires_grad_() for t in (z, mus, sigmas)]
    out = fn(*leaves, mask, dist)
    z_leaf = z.clone().requires_grad_()
    out_z = fn(z_leaf, mus, sigmas, mask, dist)
    return {"fwd": fwd,
            "bwd": lambda: torch.autograd.grad(out, leaves, g, retain_graph=True),
            "bwd_dz": lambda: torch.autograd.grad(out_z, [z_leaf], g, retain_graph=True)}


def op_times(fn, z, mus, sigmas, mask, g, flush, dist="laplace"):
    """ms of each of ``op_calls``, each timed alone with ``time_ms``."""
    return {k: time_ms(c, flush) for k, c in op_calls(fn, z, mus, sigmas, mask, g,
                                                      dist).items()}


def sweep(mx, root, shapes, rows, dtypes):
    flush = flush_buffer()
    for b, d, mq in shapes:
        for dname in dtypes:
            dtype = DTYPES[dname]
            rng = np.random.default_rng(0)
            mus = torch.tensor(rng.normal(size=(mq, b, d)), dtype=dtype, device="cuda")
            sig = torch.tensor(rng.uniform(0.5, 1.5, size=(mq, b, d)), dtype=dtype,
                               device="cuda")
            mask = torch.ones((mq, b), dtype=dtype, device="cuda")
            for r in rows:
                z = torch.tensor(rng.normal(size=(1, r, b, d)), dtype=dtype,
                                 device="cuda")
                g = torch.tensor(rng.normal(size=(1, r, b)), dtype=torch.float32,
                                 device="cuda")
                line = {"root": root, "b": b, "d": d, "mq": mq, "dtype": dname,
                        "rows": r}
                try:
                    line["ms"] = op_times(mx.mixture_log_density, z, mus, sig, mask, g,
                                          flush)
                except ValueError as e:   # a shape this checkout's op refuses
                    line["error"] = str(e)
                print(json.dumps(line), flush=True)


def _build(root):
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from multivae_tpu_torch.ops import cuda_build; cuda_build.build()")
    return subprocess.Popen([sys.executable, "-c", code, root])


def pairs(args, shapes):
    """``--against``: alternating runs of the two checkouts, then the
    summary lines."""
    roots = [os.path.abspath(args.against), os.path.abspath(args.root)]
    builds = [_build(r) for r in roots]
    if any(p.wait() != 0 for p in builds):
        raise SystemExit("mixture_sweep: a checkout's kernels did not build.")
    common = ["--rows", *map(str, args.rows), "--dtype", *args.dtype]
    for b, d, mq in shapes:
        common += ["--shape", str(b), str(d), str(mq)]
    ms = collections.defaultdict(list)
    for i in range(args.pairs):
        for root in (roots if i % 2 == 0 else roots[::-1]):
            out = subprocess.run([sys.executable, HERE, "--root", root, *common],
                                 capture_output=True, text=True, check=True).stdout
            for text in out.splitlines()[1:]:  # after the card's line
                print(text, flush=True)
                line = json.loads(text)
                for op, t in line.get("ms", {}).items():
                    ms[(root, line["b"], line["d"], line["mq"], line["dtype"],
                        line["rows"], op)].append(t)
    for (root, b, d, mq, dname, r, op), ts in ms.items():
        print(json.dumps({"summary": True, "root": root, "b": b, "d": d, "mq": mq,
                          "dtype": dname, "rows": r, "op": op, "pairs": len(ts),
                          "median_ms": statistics.median(ts), "min_ms": min(ts),
                          "max_ms": max(ts)}))


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--rows", type=int, nargs="+", default=[4, 16, 32, 50, 100])
    parser.add_argument("--shape", type=int, nargs=3, action="append",
                        metavar=("B", "D", "MQ"),
                        help="batch columns, coordinates, experts (repeatable; "
                             "default 256 512 5)")
    parser.add_argument("--dtype", nargs="+", choices=sorted(DTYPES), default=["float32"],
                        help="element types of z, mu, sigma and the mask")
    parser.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.dirname(HERE))),
        help="checkout whose multivae_tpu_torch is timed (default: this one)")
    parser.add_argument("--against", help="a second checkout, timed in alternating "
                                          "pairs with --root")
    parser.add_argument("--pairs", type=int, default=10)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("mixture_sweep needs a CUDA device.")
    shapes = args.shape or [(256, 512, 5)]
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    if args.against:
        pairs(args, shapes)
        return
    sys.path.insert(0, os.path.abspath(args.root))
    from multivae_tpu_torch.ops import mixture as mx

    sweep(mx, os.path.abspath(args.root), shapes, args.rows, args.dtype)


if __name__ == "__main__":
    main()
