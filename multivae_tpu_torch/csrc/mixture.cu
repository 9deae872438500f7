// Masked mixture-of-experts log-density, forward and backward, for Hopper
// (sm_90a). Plain C interface, loaded with ctypes by
// multivae_tpu_torch/ops/mixture.py, which also holds the plain PyTorch
// version these kernels are checked against.
//
// What it replaces: the TPU kernels `_fwd_kernel` and `_bwd_kernel` of
// multivae_tpu/ops/pallas_mixture.py (launched by `_call_fwd` and
// `_call_bwd`). With R = MZ*K sample rows, MQ experts, B batch columns and
// D latent coordinates:
//
//   out[r,b] = logsumexp_q( ok[q,b] ? logc[q,b] - sum_d t(z[r,b,d]; mu, sig)
//                                   : -1e30 )
//   t = |z-mu|/sig (Laplace) or ((z-mu)/sig)^2/2 (Normal),
//   logc[q,b] = -sum_d log sig[q,b,d] - D*c  (computed by the wrapper).
//
// The backward recomputes the per-expert densities, forms
// w[r,q] = exp(lq[r,q] - out[r]) * g[r] (0 for a masked expert, so masked
// experts and fully masked columns get exactly zero gradient, as the plain
// version's torch.where gives), and accumulates
//   dz[r]  = sum_q w df/dz,   dmu[q] = -sum_r w df/dz,   dsig[q] = sum_r w df/dsig.
// The Laplace sign is 0 at z == mu, as the derivative of torch.abs (and
// jnp.abs) is; the TPU kernel used +1 there.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32 without tensor cores) at
// the MMVAE slice shapes (R=50, B=256, D=512, MQ=5, float32): the forward
// reads z (26.2 MB) and the expert parameters (5.2 MB) and writes 51 KB,
// about 31.5 MB or 9.4 us, against ~131 M flops (~2 us); the backward also
// writes dz (26.2 MB) and dmu, dsig (5.2 MB), about 63 MB or 18.8 us,
// against ~0.4 G flops (~6 us). Both are bound by device memory.
//
// What the design does about it: one block per batch column b. The MQ
// experts' mu and 1/sig for that column (MQ*D floats each, 20 KB at the
// slice) are staged once in shared memory, so the only large stream from
// device memory is z, read with consecutive lanes on consecutive addresses.
// The forward gives one warp to each row r: lanes stride over d, a shuffle
// reduction finishes each expert's sum, and the streaming (max, sum)
// logsumexp over experts stays in registers; the (MQ, R, B, D) broadcast
// that the plain version builds (131 MB at the slice) never exists. The
// backward first computes w[r,q] the same way into shared memory, then
// gives each thread a coordinate d and loops over the rows: dz[r,b,d] is
// written once, and dmu/dsig for (q,b,d) accumulate in shared memory owned
// by that thread, so there are no atomics and each output is written once.
// The sequential grid axis and the (8,128) tiles of the TPU version are not
// carried over; any B and D are accepted.

#include <cuda_runtime.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr size_t kDefaultSmemBytes = 48 * 1024;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The data-dependent part of -log f for one coordinate.
template <bool kLaplace>
__device__ __forceinline__ float neg_quad(float z, float mu, float inv_sig) {
  const float u = (z - mu) * inv_sig;
  return kLaplace ? fabsf(u) : 0.5f * u * u;
}

// Stage column b's expert parameters in shared memory: mu and 1/sig as
// (MQ, D), the constant and the availability flag as (MQ,).
__device__ __forceinline__ void stage_column(
    const float* __restrict__ mu, const float* __restrict__ inv_sig,
    const float* __restrict__ logc, const float* __restrict__ mask,
    float* s_mu, float* s_is, float* s_c, float* s_ok, int b, int B, int D,
    int MQ) {
  for (int i = threadIdx.x; i < MQ * D; i += blockDim.x) {
    const int q = i / D;
    const size_t src = ((size_t)q * B + b) * D + (i - q * D);
    s_mu[i] = mu[src];
    s_is[i] = inv_sig[src];
  }
  for (int q = threadIdx.x; q < MQ; q += blockDim.x) {
    s_c[q] = logc[(size_t)q * B + b];
    s_ok[q] = mask[(size_t)q * B + b] > 0.f ? 1.f : 0.f;
  }
}

// sum_d t(z[r,b,d]) for expert q, reduced over the warp (all lanes get it).
template <bool kLaplace>
__device__ __forceinline__ float expert_sum(const float* __restrict__ zr,
                                            const float* s_mu, const float* s_is,
                                            int q, int D, int lane) {
  const float* mq = s_mu + (size_t)q * D;
  const float* iq = s_is + (size_t)q * D;
  float acc = 0.f;
  for (int d = lane; d < D; d += 32) acc += neg_quad<kLaplace>(zr[d], mq[d], iq[d]);
  return warp_sum(acc);
}

template <bool kLaplace>
__global__ void __launch_bounds__(kThreads) mixture_fwd_kernel(
    const float* __restrict__ z, const float* __restrict__ mu,
    const float* __restrict__ inv_sig, const float* __restrict__ logc,
    const float* __restrict__ mask, float* __restrict__ out, int R, int B,
    int D, int MQ) {
  extern __shared__ float smem[];
  float* s_mu = smem;
  float* s_is = s_mu + (size_t)MQ * D;
  float* s_c = s_is + (size_t)MQ * D;
  float* s_ok = s_c + MQ;
  const int b = blockIdx.x;
  stage_column(mu, inv_sig, logc, mask, s_mu, s_is, s_c, s_ok, b, B, D, MQ);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < R; r += kWarps) {
    const float* zr = z + ((size_t)r * B + b) * D;
    float m = kNeg, s = 0.f;
    for (int q = 0; q < MQ; ++q) {
      const float acc = expert_sum<kLaplace>(zr, s_mu, s_is, q, D, lane);
      const float lq = s_ok[q] > 0.f ? s_c[q] - acc : kNeg;
      const float m_new = fmaxf(m, lq);
      s = s * expf(m - m_new) + expf(lq - m_new);
      m = m_new;
    }
    if (lane == 0) out[(size_t)r * B + b] = logf(s) + m;
  }
}

template <bool kLaplace>
__global__ void __launch_bounds__(kThreads) mixture_bwd_kernel(
    const float* __restrict__ z, const float* __restrict__ mu,
    const float* __restrict__ inv_sig, const float* __restrict__ logc,
    const float* __restrict__ mask, const float* __restrict__ out,
    const float* __restrict__ g, float* __restrict__ dz,
    float* __restrict__ dmu, float* __restrict__ dsig, int R, int B, int D,
    int MQ) {
  extern __shared__ float smem[];
  float* s_mu = smem;
  float* s_is = s_mu + (size_t)MQ * D;
  float* s_dmu = s_is + (size_t)MQ * D;
  float* s_dsig = s_dmu + (size_t)MQ * D;
  float* s_w = s_dsig + (size_t)MQ * D;
  float* s_c = s_w + (size_t)R * MQ;
  float* s_ok = s_c + MQ;
  const int b = blockIdx.x;
  stage_column(mu, inv_sig, logc, mask, s_mu, s_is, s_c, s_ok, b, B, D, MQ);
  for (int i = threadIdx.x; i < MQ * D; i += blockDim.x) {
    s_dmu[i] = 0.f;
    s_dsig[i] = 0.f;
  }
  __syncthreads();

  // Phase 1: w[r,q] = softmax weight of expert q for row r, times g[r].
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < R; r += kWarps) {
    const float* zr = z + ((size_t)r * B + b) * D;
    const float o = out[(size_t)r * B + b];
    const float gr = g[(size_t)r * B + b];
    for (int q = 0; q < MQ; ++q) {
      const float acc = expert_sum<kLaplace>(zr, s_mu, s_is, q, D, lane);
      if (lane == 0)
        s_w[r * MQ + q] = s_ok[q] > 0.f ? expf(s_c[q] - acc - o) * gr : 0.f;
    }
  }
  __syncthreads();

  // Phase 2: each thread owns coordinates d; rows are a loop.
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    for (int r = 0; r < R; ++r) {
      const size_t zi = ((size_t)r * B + b) * D + d;
      const float zv = z[zi];
      float dzv = 0.f;
      for (int q = 0; q < MQ; ++q) {
        const float w = s_w[r * MQ + q];
        const float diff = zv - s_mu[q * D + d];
        const float is = s_is[q * D + d];
        float df_dz, df_dsig;
        if (kLaplace) {
          // d|x|/dx = sign(x) with sign(0) = 0, as torch.abs and jnp.abs
          // define it (the TPU kernel took +1 at 0)
          const float sgn = diff > 0.f ? 1.f : (diff < 0.f ? -1.f : 0.f);
          df_dz = -sgn * is;
          df_dsig = (fabsf(diff) * is - 1.f) * is;
        } else {
          df_dz = -diff * is * is;
          df_dsig = (diff * diff * is * is - 1.f) * is;
        }
        const float wz = w * df_dz;
        dzv += wz;
        s_dmu[q * D + d] -= wz;
        s_dsig[q * D + d] += w * df_dsig;
      }
      dz[zi] = dzv;
    }
    for (int q = 0; q < MQ; ++q) {
      const size_t o = ((size_t)q * B + b) * D + d;
      dmu[o] = s_dmu[q * D + d];
      dsig[o] = s_dsig[q * D + d];
    }
  }
}

cudaError_t allow_smem(const void* kernel, size_t bytes) {
  if (bytes <= kDefaultSmemBytes) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace

extern "C" {

const char* mixture_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Shared memory per block, in bytes; the wrapper checks it against the
// card's limit before launching.
size_t mixture_fwd_smem(int R, int D, int MQ) {
  (void)R;
  return (2 * (size_t)MQ * D + 2 * (size_t)MQ) * sizeof(float);
}

size_t mixture_bwd_smem(int R, int D, int MQ) {
  return (4 * (size_t)MQ * D + (size_t)R * MQ + 2 * (size_t)MQ) * sizeof(float);
}

// z (R,B,D), mu and inv_sig (MQ,B,D), logc and mask (MQ,B) -> out (R,B).
int mixture_fwd(const float* z, const float* mu, const float* inv_sig,
                const float* logc, const float* mask, float* out, int R, int B,
                int D, int MQ, int laplace, void* stream) {
  const size_t smem = mixture_fwd_smem(R, D, MQ);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const void* kernel = laplace
      ? reinterpret_cast<const void*>(&mixture_fwd_kernel<true>)
      : reinterpret_cast<const void*>(&mixture_fwd_kernel<false>);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (laplace)
    mixture_fwd_kernel<true><<<B, kThreads, smem, st>>>(z, mu, inv_sig, logc, mask, out, R, B, D, MQ);
  else
    mixture_fwd_kernel<false><<<B, kThreads, smem, st>>>(z, mu, inv_sig, logc, mask, out, R, B, D, MQ);
  return static_cast<int>(cudaGetLastError());
}

// The forward's inputs plus out and g (R,B) -> dz (R,B,D), dmu and dsig
// (MQ,B,D), each written in full.
int mixture_bwd(const float* z, const float* mu, const float* inv_sig,
                const float* logc, const float* mask, const float* out,
                const float* g, float* dz, float* dmu, float* dsig, int R,
                int B, int D, int MQ, int laplace, void* stream) {
  const size_t smem = mixture_bwd_smem(R, D, MQ);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const void* kernel = laplace
      ? reinterpret_cast<const void*>(&mixture_bwd_kernel<true>)
      : reinterpret_cast<const void*>(&mixture_bwd_kernel<false>);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (laplace)
    mixture_bwd_kernel<true><<<B, kThreads, smem, st>>>(z, mu, inv_sig, logc, mask, out, g, dz, dmu, dsig, R, B, D, MQ);
  else
    mixture_bwd_kernel<false><<<B, kThreads, smem, st>>>(z, mu, inv_sig, logc, mask, out, g, dz, dmu, dsig, R, B, D, MQ);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
