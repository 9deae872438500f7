"""Masked mixture-of-experts log-density: CUDA kernel and plain version.

Counterpart of ``multivae_tpu/ops/pallas_mixture.py``. The hot op of the
MMVAE-family objectives is

    out[z, k, b] = logsumexp_q [ mask[q, b] ? sum_d log f(Z[z,k,b,d];
                                 mu[q,b,d], sig[q,b,d]) : -1e30 ]

with f Laplace or Normal, NOT divided by the expert count.

- ``mixture_log_density_plain`` is a straight PyTorch copy of
  ``mixture_log_density_xla``: it forms the (MQ, MZ, K, B, D) broadcast and
  takes ``torch.logsumexp``. The CPU path and the numerics anchor.
- On CUDA tensors ``mixture_log_density`` runs ``csrc/mixture.cu``
  through an autograd Function whose forward and backward both launch
  kernels (see the note at the top of the source for the design and its
  bound). There is no fallback: a CUDA input the kernel does not take
  (not float32, not contiguous, too large for shared memory) raises.

``launches`` counts kernel launches, one per launch of each kernel.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import cuda_build

_LOG2 = math.log(2.0)
_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)
_NEG = -1e30
DISTS = ("laplace", "normal")

launches = {"fwd": 0, "bwd": 0}


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
    lq = _logf_terms(dist, z[None], mus[:, None, None],
                     sigmas[:, None, None]).sum(-1)
    lq = torch.where(mask[:, None, None, :] > 0, lq, _NEG)
    return torch.logsumexp(lq, dim=0)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("mixture")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.mixture_fwd.argtypes = [P] * 6 + [I] * 5 + [P]
    lib.mixture_fwd.restype = I
    lib.mixture_bwd.argtypes = [P] * 10 + [I] * 5 + [P]
    lib.mixture_bwd.restype = I
    for fn in (lib.mixture_fwd_smem, lib.mixture_bwd_smem):
        fn.argtypes = [I] * 3
        fn.restype = ctypes.c_size_t
    lib.mixture_error_string.argtypes = [I]
    lib.mixture_error_string.restype = ctypes.c_char_p
    return lib


def _check_inputs(z, mus, sigmas, mask, dist):
    if dist not in DISTS:
        raise ValueError(f"dist must be one of {DISTS}, got {dist!r}")
    named = {"z": z, "mus": mus, "sigmas": sigmas, "mask": mask}
    for name, t in named.items():
        if t.dtype != torch.float32:
            raise TypeError(f"mixture_log_density: {name} is {t.dtype}; the "
                            "kernel takes float32 only.")
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


def _check_smem(nbytes: int, device):
    props = torch.cuda.get_device_properties(device)
    limit = getattr(props, "shared_memory_per_block_optin", 232448)
    if nbytes > limit:
        raise ValueError(
            f"mixture kernel needs {nbytes} bytes of shared memory per block "
            f"(experts x latent too large); the card allows {limit}.")


def _raise_on(err: int, name: str):
    if err:
        msg = _lib().mixture_error_string(err).decode()
        raise RuntimeError(f"{name} failed to launch: CUDA error {err} ({msg})")


def _prep(sigmas, d: int, dist: str):
    """1/sig and the per-(expert, column) constant -sum_d log sig - D*c."""
    c = _LOG2 if dist == "laplace" else _HALF_LOG_2PI
    return 1.0 / sigmas, -torch.log(sigmas).sum(-1) - d * c


def _launch_fwd(z3, mus, inv_sig, logc, mask, laplace: bool):
    r, b, d = z3.shape
    mq = mus.shape[0]
    lib = _lib()
    _check_smem(lib.mixture_fwd_smem(r, d, mq), z3.device)
    out = torch.empty((r, b), dtype=torch.float32, device=z3.device)
    with torch.cuda.device(z3.device):
        err = lib.mixture_fwd(
            z3.data_ptr(), mus.data_ptr(), inv_sig.data_ptr(),
            logc.data_ptr(), mask.data_ptr(), out.data_ptr(),
            r, b, d, mq, int(laplace), torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "mixture_fwd")
    launches["fwd"] += 1
    return out


def _launch_bwd(z3, mus, inv_sig, logc, mask, out, g, laplace: bool):
    r, b, d = z3.shape
    mq = mus.shape[0]
    lib = _lib()
    _check_smem(lib.mixture_bwd_smem(r, d, mq), z3.device)
    dz = torch.empty_like(z3)
    dmu = torch.empty_like(mus)
    dsig = torch.empty_like(mus)
    with torch.cuda.device(z3.device):
        err = lib.mixture_bwd(
            z3.data_ptr(), mus.data_ptr(), inv_sig.data_ptr(),
            logc.data_ptr(), mask.data_ptr(), out.data_ptr(), g.data_ptr(),
            dz.data_ptr(), dmu.data_ptr(), dsig.data_ptr(),
            r, b, d, mq, int(laplace), torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "mixture_bwd")
    launches["bwd"] += 1
    return dz, dmu, dsig


class _MixtureLogDensity(torch.autograd.Function):
    @staticmethod
    def forward(ctx, z, mus, sigmas, mask, dist):
        mz, k, b, d = z.shape
        inv_sig, logc = _prep(sigmas, d, dist)
        z3 = z.view(mz * k, b, d)
        out = _launch_fwd(z3, mus, inv_sig, logc, mask, dist == "laplace")
        ctx.save_for_backward(z3, mus, inv_sig, logc, mask, out)
        ctx.laplace = dist == "laplace"
        ctx.z_shape = z.shape
        return out.view(mz, k, b)

    @staticmethod
    def backward(ctx, g):
        z3, mus, inv_sig, logc, mask, out = ctx.saved_tensors
        g = g.reshape(out.shape).to(torch.float32).contiguous()
        dz, dmu, dsig = _launch_bwd(z3, mus, inv_sig, logc, mask, out, g,
                                    ctx.laplace)
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
