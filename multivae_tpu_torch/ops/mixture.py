"""Masked mixture-of-experts log-density: CUDA kernel and plain version.

Counterpart of ``multivae_tpu/ops/pallas_mixture.py``. The hot op of the
MMVAE-family objectives is

    out[z, k, b] = logsumexp_q [ mask[q, b] ? sum_d log f(Z[z,k,b,d];
                                 mu[q,b,d], sig[q,b,d]) : -1e30 ]

with f Laplace or Normal, NOT divided by the expert count.

- ``mixture_log_density_plain`` is a straight PyTorch copy of
  ``mixture_log_density_xla``: it forms the (MQ, MZ, K, B, D) broadcast and
  takes ``torch.logsumexp``. The CPU path and the numerics anchor. Its
  terms are in the inputs' dtype and the sum over D in at least float32,
  so bfloat16 inputs (the trainer's ``mixed_precision``) give a float32
  result and bfloat16 gradients, as the XLA composition does.
- On CUDA tensors ``mixture_log_density`` runs ``csrc/mixture.cu``
  through an autograd Function (see the note at the top of the source for
  the design and its bound). The forward is one kernel launch: the kernel
  reads sigma itself and returns the per-expert constant ``logc`` for the
  backward. The backward is one launch too, of the dz-only kernel when
  neither ``mus`` nor ``sigmas`` needs a gradient (the DReG path), else of
  the full one. Float32 inputs run the kernels of ``csrc/mixture.cu``,
  bfloat16 inputs the kernels of ``csrc/mixture_bf16.cu``, which read
  bf16 and compute in float32: ``out`` is float32 for both, and ``dz``
  (``dmu``, ``dsig``) come back in the inputs' dtype. ``route`` names the
  design a bf16 launch takes: the tensor-copy kernels written for bf16
  (``"tma"``: the forward, the dz-only backward and the full backward on
  16-byte rows of at most ``TMA_MAX_D`` coordinates and at most
  ``TMA_MAX_Q`` experts; the full backward adds dmu and dsig across a
  column's row splits in a thread block cluster, bound by its 31.5 MB at
  the slice, 9.4 us) or ``mixture.cu``'s kernels built for bf16
  (``"template"``: every other shape); float32 always takes
  ``"template"``. There is no fallback and no cast: a CUDA input the
  kernels do not take (another dtype, mixed dtypes, not contiguous, too
  large for shared memory) raises, and so does a failed launch of the
  design the route names.
- ``_fwd_reference`` and ``_bwd_reference`` compute in plain PyTorch what
  the C entries compute (``mixture_fwd`` and ``mixture_fwd_tma``,
  ``mixture_bwd``, ``mixture_bwd_dz_tma`` and ``mixture_bwd_tma``), with the
  same arguments and
  outputs, so the CPU tests can drive the autograd glue.

``launches`` counts kernel launches, one per launch of each kernel (the
bf16 instances under ``fwd_bf16``, ``bwd_bf16`` and ``bwd_dz_bf16``). A
launch captured in a CUDA graph (the trainer's ``steps_per_execution``)
counts at each replay of the graph, not at its capture
(``trainers/base/graphs.py``). The launches go to the current stream,
which is the capturing one under a capture.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import cuda_build
from .gaussian import sum_f32

_LOG2 = math.log(2.0)
_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)
_NEG = -1e30
DISTS = ("laplace", "normal")
_FWD, _BWD_DZ, _BWD = 0, 1, 2

DTYPES = (torch.float32, torch.bfloat16)
# The tensor-copy design's limits (csrc/mixture_bf16.cu): a thread holds 8
# coordinates of a row (kElems), a slice at most kMaxThreads threads, and
# the registers at most kMaxQ experts.
TMA_MAX_D = 2048
TMA_MAX_Q = 8
KERNELS = ("fwd", "bwd", "bwd_dz", "fwd_bf16", "bwd_bf16", "bwd_dz_bf16")
launches = {k: 0 for k in KERNELS}


def reset_launches():
    for k in launches:
        launches[k] = 0


def _logf_terms(dist: str, z, mu, sig):
    """Elementwise log-density terms (broadcast)."""
    if dist == "laplace":
        return -torch.abs(z - mu) / sig - torch.log(sig) - _LOG2
    return -0.5 * ((z - mu) / sig) ** 2 - torch.log(sig) - _HALF_LOG_2PI


def mixture_log_density_plain(z, mus, sigmas, mask, dist: str = "laplace"):
    """(MZ,K,B,D), (MQ,B,D), (MQ,B,D), (MQ,B) -> (MZ,K,B)."""
    lq = sum_f32(_logf_terms(dist, z[None], mus[:, None, None],
                             sigmas[:, None, None]))
    lq = torch.where(mask[:, None, None, :] > 0, lq, _NEG)
    return torch.logsumexp(lq, dim=0)


def _widen(*tensors):
    """bf16 tensors as float32 (the kernels' arithmetic), others as they
    are."""
    return [t.float() if t.dtype == torch.bfloat16 else t for t in tensors]


def _lq_reference(z3, mus, sigmas, logc, mask, laplace: bool):
    """lq[q, r, b] = logc[q, b] - sum_d t(z, mu, sig), -1e30 where masked."""
    u = (z3[None] - mus[:, None]) * (1.0 / sigmas)[:, None]
    t = u.abs() if laplace else 0.5 * u * u
    lq = logc[:, None] - t.sum(-1)
    return torch.where(mask[:, None] > 0, lq, _NEG)


def _fwd_reference(z3, mus, sigmas, mask, laplace: bool):
    """What ``mixture_fwd`` computes: (R,B,D), (MQ,B,D) x2, (MQ,B) ->
    out (R,B) and logc (MQ,B)."""
    z3, mus, sigmas, mask = _widen(z3, mus, sigmas, mask)
    c = _LOG2 if laplace else _HALF_LOG_2PI
    logc = -torch.log(sigmas).sum(-1) - z3.shape[-1] * c
    lq = _lq_reference(z3, mus, sigmas, logc, mask, laplace)
    return torch.logsumexp(lq, dim=0), logc


def _bwd_reference(z3, mus, sigmas, logc, mask, out, g, laplace: bool,
                   need_params: bool):
    """What ``mixture_bwd`` computes: dz (R,B,D), and dmu, dsig (MQ,B,D)
    when ``need_params``, else None for both; in the inputs' dtype."""
    dtype = z3.dtype
    z3, mus, sigmas, mask = _widen(z3, mus, sigmas, mask)
    lq = _lq_reference(z3, mus, sigmas, logc, mask, laplace)
    w = torch.where(mask[:, None] > 0, torch.exp(lq - out[None]) * g[None],
                    0.0)[..., None]
    inv = (1.0 / sigmas)[:, None]
    diff = z3[None] - mus[:, None]
    if laplace:
        df_dz = -torch.sign(diff) * inv
        df_dsig = (diff.abs() * inv - 1.0) * inv
    else:
        df_dz = -diff * inv * inv
        df_dsig = (diff * diff * inv * inv - 1.0) * inv
    wz = w * df_dz
    if not need_params:
        return wz.sum(0).to(dtype), None, None
    return (wz.sum(0).to(dtype), (-wz.sum(1)).to(dtype),
            (w * df_dsig).sum(1).to(dtype))


def route(dtype: torch.dtype, mode: str, d: int, mq: int, vec: bool) -> str:
    """The design a launch of ``mode`` ('fwd', 'bwd_dz' or 'bwd') takes for
    inputs of ``dtype`` with rows of ``d`` coordinates, ``mq`` experts and
    16-byte rows (``vec``, see ``_vectorized``): ``"tma"`` (the bf16
    kernels that TMA tensor copies feed) or ``"template"``."""
    if (dtype == torch.bfloat16 and mode in ("fwd", "bwd_dz", "bwd") and vec
            and d <= TMA_MAX_D and mq <= TMA_MAX_Q):
        return "tma"
    return "template"


@functools.lru_cache(maxsize=None)
def _lib(dtype: torch.dtype = torch.float32) -> ctypes.CDLL:
    """The library of the kernels for ``dtype`` (float32 or bfloat16)."""
    lib = cuda_build.load("mixture" if dtype == torch.float32 else "mixture_bf16")
    P, I = ctypes.c_void_p, ctypes.c_int
    if dtype == torch.bfloat16:
        lib.mixture_fwd_tma.argtypes = [P] * 6 + [I] * 4 + [ctypes.c_float, I, P]
        lib.mixture_fwd_tma.restype = I
        lib.mixture_bwd_dz_tma.argtypes = [P] * 8 + [I] * 5 + [P]
        lib.mixture_bwd_dz_tma.restype = I
        lib.mixture_bwd_tma.argtypes = [P] * 10 + [I] * 5 + [P]
        lib.mixture_bwd_tma.restype = I
        lib.mixture_tma_launch_shape.argtypes = [I] * 6 + [P]
        lib.mixture_tma_launch_shape.restype = I
        lib.mixture_empty.argtypes = [P]
        lib.mixture_empty.restype = I
    lib.mixture_fwd.argtypes = [P] * 6 + [I] * 4 + [ctypes.c_float] + [I] * 2 + [P]
    lib.mixture_fwd.restype = I
    lib.mixture_bwd.argtypes = [P] * 10 + [I] * 6 + [P] * 2
    lib.mixture_bwd.restype = I
    lib.mixture_smem.argtypes = [I] * 7
    lib.mixture_smem.restype = ctypes.c_size_t
    lib.mixture_workspace.argtypes = [I] * 7
    lib.mixture_workspace.restype = ctypes.c_size_t
    lib.mixture_launch_shape.argtypes = [I] * 7 + [P]
    lib.mixture_launch_shape.restype = I
    lib.mixture_error_string.argtypes = [I]
    lib.mixture_error_string.restype = ctypes.c_char_p
    return lib


def launch_shape(r: int, b: int, d: int, mq: int, mode: str, laplace=True,
                 vec=True, dtype: torch.dtype = torch.float32) -> dict:
    """How the kernel of ``mode`` ('fwd', 'bwd_dz' or 'bwd') for ``dtype``
    launches at these shapes on the current card: its ``route``, blocks
    per SM (occupancy), threads per block, row splits and shared memory
    per block; on the "tma" route also the rows a block takes, the rows it
    holds in shared memory at once, the blocks of a cluster (the full
    backward's splits) and whether all blocks are resident at once."""
    m = {"fwd": _FWD, "bwd_dz": _BWD_DZ, "bwd": _BWD}[mode]
    design = route(dtype, mode, d, mq, vec)
    keys = ("blocks_per_sm", "threads", "splits", "smem_bytes")
    if design == "tma":
        keys += ("rows_per_block", "rows_per_round", "cluster", "one_wave")
        vals = (ctypes.c_int * len(keys))()
        err = _lib(dtype).mixture_tma_launch_shape(r, b, d, mq, m, int(laplace),
                                                   ctypes.cast(vals, ctypes.c_void_p))
    else:
        vals = (ctypes.c_int * 4)()
        err = _lib(dtype).mixture_launch_shape(r, b, d, mq, m, int(laplace), int(vec),
                                               ctypes.cast(vals, ctypes.c_void_p))
    _raise_on(err, "mixture_launch_shape")
    return {"route": design, **dict(zip(keys, vals))}


def _check_inputs(z, mus, sigmas, mask, dist):
    if dist not in DISTS:
        raise ValueError(f"dist must be one of {DISTS}, got {dist!r}")
    named = {"z": z, "mus": mus, "sigmas": sigmas, "mask": mask}
    if z.dtype not in DTYPES:
        raise TypeError(f"mixture_log_density: z is {z.dtype}; the kernels "
                        "take float32 or bfloat16.")
    for name, t in named.items():
        if t.dtype != z.dtype:
            raise TypeError(
                f"mixture_log_density: {name} is {t.dtype} and z {z.dtype}; "
                "the kernels take z, mus, sigmas and mask in one dtype.")
    for name, t in named.items():
        if not t.is_contiguous():
            raise ValueError(f"mixture_log_density: {name} is not contiguous.")
        if t.device != z.device or t.device.type != "cuda":
            raise ValueError(
                f"mixture_log_density: {name} is on {t.device}; the kernel "
                f"needs every input on z's CUDA device ({z.device}).")
    if z.dim() != 4 or mus.dim() != 3:
        raise ValueError("mixture_log_density: z must be (MZ,K,B,D) and mus "
                         "(MQ,B,D).")
    mq, b, d = mus.shape
    if (sigmas.shape != mus.shape or tuple(mask.shape) != (mq, b)
            or tuple(z.shape[2:]) != (b, d)):
        raise ValueError(
            "mixture_log_density: shapes do not agree: z "
            f"{tuple(z.shape)}, mus {tuple(mus.shape)}, sigmas "
            f"{tuple(sigmas.shape)}, mask {tuple(mask.shape)}.")
    if z.numel() == 0 or mus.numel() == 0:
        raise ValueError("mixture_log_density: empty inputs.")


def _vectorized(d: int, *tensors) -> bool:
    """16-byte path: rows of whole 16-byte words (4 float32 or 8 bf16
    values) and 16-byte aligned pointers."""
    per_word = 16 // tensors[0].element_size()
    return d % per_word == 0 and all(t.data_ptr() % 16 == 0 for t in tensors)


def _smem_limit(device) -> int:
    props = torch.cuda.get_device_properties(device)
    return getattr(props, "shared_memory_per_block_optin", 232448)


def _check_smem(lib, shape, mode: int, vec: bool, device):
    limit = _smem_limit(device)
    nbytes = lib.mixture_smem(*shape, mode, int(vec), limit)
    if nbytes == 0 or nbytes > limit:
        raise ValueError(
            f"mixture kernel cannot take (R, B, D, MQ) = {shape}: it needs "
            f"{nbytes} bytes of shared memory per block; "
            f"the card allows {limit}.")


def _raise_on(err: int, name: str):
    if err:
        msg = _lib(torch.float32).mixture_error_string(err).decode()
        raise RuntimeError(f"{name} failed to launch: CUDA error {err} ({msg})")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _counter(kernel: str, z3) -> str:
    """The ``launches`` key of ``kernel`` for z3's dtype."""
    return kernel if z3.dtype == torch.float32 else f"{kernel}_bf16"


def _stream():
    return torch.cuda.current_stream().cuda_stream


def _run_fwd(design, z3, mus, sigmas, mask, out, logc, laplace: bool, vec: bool):
    """One launch of the C forward entry of ``design``, writing ``out``
    and ``logc``."""
    r, b, d = z3.shape
    mq = mus.shape[0]
    lib = _lib(z3.dtype)
    dc = d * (_LOG2 if laplace else _HALF_LOG_2PI)
    args = (z3.data_ptr(), mus.data_ptr(), sigmas.data_ptr(), mask.data_ptr(),
            out.data_ptr(), logc.data_ptr(), r, b, d, mq, dc, int(laplace))
    with torch.cuda.device(z3.device):
        if design == "tma":
            err = lib.mixture_fwd_tma(*args, _stream())
        else:
            _check_smem(lib, (r, b, d, mq), _FWD, vec, z3.device)
            err = lib.mixture_fwd(*args, int(vec), _stream())
    _raise_on(err, "mixture_fwd_tma" if design == "tma" else "mixture_fwd")


def _run_bwd(design, z3, mus, sigmas, logc, mask, out, g, dz, dmu, dsig,
             laplace: bool, vec: bool):
    """One launch of the C backward entry of ``design``, writing ``dz``,
    and ``dmu`` and ``dsig`` unless both are None (the dz-only kernel)."""
    r, b, d = z3.shape
    mq = mus.shape[0]
    lib = _lib(z3.dtype)
    ins = (z3.data_ptr(), mus.data_ptr(), sigmas.data_ptr(), logc.data_ptr(),
           mask.data_ptr(), out.data_ptr(), g.data_ptr(), dz.data_ptr())
    with torch.cuda.device(z3.device):
        if design == "tma" and dmu is None:
            entry = "mixture_bwd_dz_tma"
            err = lib.mixture_bwd_dz_tma(*ins, r, b, d, mq, int(laplace), _stream())
        elif design == "tma":
            entry = "mixture_bwd_tma"
            err = lib.mixture_bwd_tma(*ins, dmu.data_ptr(), dsig.data_ptr(), r, b, d, mq,
                                      int(laplace), _stream())
        else:
            entry = "mixture_bwd"
            mode = _BWD if dmu is not None else _BWD_DZ
            _check_smem(lib, (r, b, d, mq), mode, vec, z3.device)
            # the bf16 chunked path's float partial sums (none elsewhere)
            n_ws = lib.mixture_workspace(r, b, d, mq, mode, int(vec),
                                         _smem_limit(z3.device))
            ws = (torch.empty(n_ws, dtype=torch.float32, device=z3.device)
                  if n_ws else None)
            err = lib.mixture_bwd(*ins, _ptr(dmu), _ptr(dsig), r, b, d, mq,
                                  int(laplace), int(vec), _ptr(ws), _stream())
    _raise_on(err, entry)


def _launch_fwd(z3, mus, sigmas, mask, laplace: bool):
    """One launch of the forward kernel that ``route`` names: out (R,B)
    and logc (MQ,B)."""
    r, b, d = z3.shape
    mq = mus.shape[0]
    vec = _vectorized(d, z3, mus, sigmas)
    out = torch.empty((r, b), dtype=torch.float32, device=z3.device)
    logc = torch.empty((mq, b), dtype=torch.float32, device=z3.device)
    _run_fwd(route(z3.dtype, "fwd", d, mq, vec), z3, mus, sigmas, mask, out, logc,
             laplace, vec)
    launches[_counter("fwd", z3)] += 1
    return out, logc


def _launch_bwd(z3, mus, sigmas, logc, mask, out, g, laplace: bool,
                need_params: bool):
    """One launch of the backward kernel that ``route`` names: dz, and dmu
    and dsig when ``need_params`` (else the dz-only kernel, and None for
    both)."""
    r, b, d = z3.shape
    mq = mus.shape[0]
    kernel = "bwd" if need_params else "bwd_dz"
    dz = torch.empty_like(z3)
    dmu = torch.empty_like(mus) if need_params else None
    dsig = torch.empty_like(mus) if need_params else None
    vec = _vectorized(d, z3, mus, sigmas)
    _run_bwd(route(z3.dtype, kernel, d, mq, vec), z3, mus, sigmas, logc, mask, out,
             g, dz, dmu, dsig, laplace, vec)
    launches[_counter(kernel, z3)] += 1
    return dz, dmu, dsig


class _MixtureLogDensity(torch.autograd.Function):
    @staticmethod
    def forward(ctx, z, mus, sigmas, mask, dist):
        mz, k, b, d = z.shape
        z3 = z.view(mz * k, b, d)
        out, logc = _launch_fwd(z3, mus, sigmas, mask, dist == "laplace")
        ctx.save_for_backward(z3, mus, sigmas, logc, mask, out)
        ctx.laplace = dist == "laplace"
        ctx.z_shape = z.shape
        return out.view(mz, k, b)

    @staticmethod
    def backward(ctx, g):
        z3, mus, sigmas, logc, mask, out = ctx.saved_tensors
        g = g.reshape(out.shape).to(torch.float32).contiguous()
        need_params = ctx.needs_input_grad[1] or ctx.needs_input_grad[2]
        dz, dmu, dsig = _launch_bwd(z3, mus, sigmas, logc, mask, out, g,
                                    ctx.laplace, need_params)
        return dz.view(ctx.z_shape), dmu, dsig, None, None


def mixture_log_density(z, mus, sigmas, mask, dist: str = "laplace"):
    """Mixture log-density: the CUDA kernel on CUDA tensors, the plain
    version on CPU tensors.

    Args:
        z: (MZ, K, B, D) samples.
        mus / sigmas: (MQ, B, D) expert params.
        mask: (MQ, B) availability (0 experts are excluded).
        dist: 'laplace' or 'normal'.

    Returns:
        (MZ, K, B) logsumexp over experts (NOT divided by the expert count).
    """
    if all(t.device.type == "cpu" for t in (z, mus, sigmas, mask)):
        return mixture_log_density_plain(z, mus, sigmas, mask, dist)
    _check_inputs(z, mus, sigmas, mask, dist)
    return _MixtureLogDensity.apply(z, mus, sigmas, mask, dist)
