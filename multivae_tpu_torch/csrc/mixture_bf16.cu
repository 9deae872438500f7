// The bfloat16 mixture kernels (z, mu, sig, mask, dz, dmu and dsig in bf16;
// out, logc, g and all arithmetic float), loaded by
// multivae_tpu_torch/ops/mixture.py for bf16 inputs (the trainer's
// mixed_precision). A source of its own so that nvcc builds the two element
// types in parallel.
//
// Two designs live here:
//  - the template: mixture.cu built with MIXTURE_BF16 (its entries
//    mixture_fwd and mixture_bwd, and their plan, for bf16). It takes the
//    shapes outside the design below: the scalar path (D % 8 != 0 or
//    unaligned pointers), MQ > 8 and rows of more than 2048 coordinates.
//  - the tensor-copy design (mixture_fwd_tma, mixture_bwd_dz_tma,
//    mixture_bwd_tma): the forward, the dz-only backward and the full
//    backward, written for bf16 on Hopper. Which shape takes which is
//    decided by `route` in ops/mixture.py; an entry here refuses a shape
//    outside its design (no fallback).
//
// What it replaces: the TPU kernels `_fwd_kernel` and `_bwd_kernel` of
// multivae_tpu/ops/pallas_mixture.py (see mixture.cu for the function).
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32 without tensor cores) at
// the MMVAE slice (R=50, B=256, D=512, MQ=5) in bf16: the forward reads z
// (12.8 MB), mu and sigma (2.6 MB) and writes out and logc, 15.8 MB or
// 4.7 us, against ~131 M operations (~2 us); the dz-only backward also
// reads out and g and writes dz (12.8 MB), 28.9 MB or 8.6 us, against
// ~0.33 G operations (~4.9 us); the full backward also writes dmu and dsig
// (2.6 MB), 31.5 MB or 9.4 us, against ~0.52 G operations (~7.8 us). All
// three are bound by bytes. Counted in instructions a thread issues, the
// backward kernels are near their issue rate too: 2 a term for lq, 4 for
// dz and 2 more for dmu and dsig (below), ~6 us (dz-only) and ~8 us (full)
// over the card's 528 schedulers.
//
// Why a design of its own. The template streams z through a 2-stage ring of
// 4-row groups with cp.async: in bf16 a block has ~16 KB of z in flight, a
// slice pays one device-memory round trip a group, one after another, and
// mu and sigma are loaded synchronously. That chain did not shrink with
// the bytes: bf16 took 0.87-0.91x the float32 time at half the bytes.
//
// Design. One block handles one batch column b (grid.x) and RPB rows of it
// (grid.y = S splits; RPB a multiple of kBox = 4, the last split fewer),
// holding RB of them in shared memory at once (RB = RPB, but for the full
// backward's plan: rounds of RB rows). A block has P slices of
// T = 32*ceil(D/8/32) threads (P*T about 128); thread t of a slice owns the
// 8 coordinates d = 8t..8t+7 of every row.
//  - Copies are TMA tensor copies (cp.async.bulk.tensor on mbarriers), one
//    thread a copy, no registers spent: a 4-D map over (bd, D/bd, B, n) for
//    each of z, mu and sigma (innermost first) brings whole rows of one
//    column, [rows][D], a copy: mu's MQ rows, sigma's, and box k of z (kBox
//    rows, on mbarrier k). The block requests mu, sigma and each slice's
//    first box at its start, and its other boxes once mu and sigma have
//    landed: requested with them, mu and sigma queued behind the whole
//    grid's z and landed about halfway through it (measured, PERF.md). So
//    all of a block's z is in flight from ~2 us on, in at most ~50 KB of
//    shared memory. A later round's boxes are requested once every slice is
//    done with the round before (a block barrier; the mbarriers' next
//    phase).
//  - The small inputs (the mask; in the backward logc, out and g of the
//    block's rows) are loaded into registers before anything else and
//    stored to shared memory only after mu and sigma land, so no thread
//    stalls on them early.
//  - Once mu and sigma land, slice p forms 1/sig (__fdividef) for the
//    experts q with q % P == p into shared memory, and in the forward their
//    sum of log sigma (log2 of 8 mantissas' product plus the exponents, one
//    log2f a thread and expert); after one block barrier each thread keeps
//    mu and 1/sig of its coordinates in registers (2*kQ*8 floats; kQ = MQ
//    rounded up to 2, 5 or 8, padded experts zero and masked). Split 0
//    writes logc.
//  - Box k belongs to slice k % P. A group's kG*kQ partial sums
//    (sum_d |z-mu|/sig, or ((z-mu)/sig)^2) are reduced as in mixture.cu
//    (warp reduce-scatter, one pass over the slice's warps through shared
//    memory) behind a barrier of the slice alone (bar.sync on a named
//    barrier; none where a slice is one warp). Lane g*kQ + q then holds lq
//    of the group's row g and expert q.
//  - Forward: the slice's first warp finishes each row's logsumexp with
//    shuffles and writes out.
//  - Backward: every warp forms w = exp(lq - out) * g (0 for a masked
//    expert or a row past R) in its own lanes, shuffles each row's w to all
//    lanes and computes dz from the z still in shared memory (z is read
//    from device memory once), writing it in bf16, 16 bytes a thread, as
//    soon as the group is done. For Laplace a term of the dz-only kernel is
//    4 instructions: the difference, the running product of the
//    differences, w with the difference's sign bit xored in, and an fma
//    with 1/sig; only where the product is not a nonzero number (an exact
//    z == mu, or an under- or overflow) is the coordinate taken again with
//    the sign 0 at 0, as torch.abs's derivative has it. The full backward
//    selects 0 at z == mu instead, without a branch (below). A masked
//    expert and a fully masked column give exactly zero dz, dmu and dsig.
//  - Full backward, dmu and dsig: as in mixture.cu, each thread adds for
//    its 8 coordinates and each expert sums that leave 1/sig out, in
//    registers over all the slice's rows (sum_r w sgn(z-mu) and
//    sum_r w |z-mu| for Laplace, sum_r w (z-mu) and sum_r w (z-mu)^2 for
//    Normal: 2 instructions a term, and for Laplace 2 more for the select of
//    the sign, 0 at z == mu: with the sums' registers an SM holds 8 warps,
//    too few to hide a branch a coordinate, as the dz-only kernel takes),
//    and its warp's lanes sum_r w of each expert: 2*kQ*8 more registers a
//    thread, so the full backward's launch bounds allow 255 (a 128-thread
//    block uses half of an SM's registers). After its rows each slice
//    leaves its sums in the block's shared memory, over z, mu and sigma.
//    The S blocks of a column are one thread block cluster (launched with
//    cudaLaunchKernelEx, cluster (1, S, 1), S <= 8): after a cluster
//    barrier (arrive.release, wait.acquire) rank k reads the sums of its
//    share of the (q, d) entries from every rank's shared memory (mapa,
//    ld.shared::cluster), ranks and slices in order, applies 1/sig once
//    and writes those entries of dmu and dsig in bf16; a second cluster
//    barrier keeps every block's shared memory until all have read. No
//    workspace, one launch.
//  - No atomics; every sum in a fixed order, so results are deterministic.
//  - Plan, forward and dz-only: the smallest RB (largest S) at which all
//    B*S blocks are resident at once, counting blocks an SM by threads, by
//    the launch bounds' register cap (128 a thread for kQ <= 5, 255 for
//    kQ = 8) and by shared memory; where no RB gives one wave (more z than
//    the card's shared memory holds), RB = 32. At the slice: T = 64, P = 2,
//    RB = 28, S = 2 (28 and 22 rows), 512 blocks of 128 threads, 4 an SM,
//    one wave.
//  - Plan, full backward: the most splits S <= 8 (each at its fewest rows a
//    block, RPB) at which all B clusters can be resident at once, by the
//    card's own count (cudaOccupancyMaxActiveClusters: registers, shared
//    memory, the GPCs), and for that S the fewest rounds of even size (the
//    most rows RB in shared memory) that keep them so; the sums'
//    4*(2*MQ*D + MQ) bytes a slice count in the block's shared memory where
//    they exceed z, mu and sigma. Rounds keep the grid in one wave where
//    blocks holding all their rows would take several, each of which pays
//    the wait for mu, sigma and the first box again. Where even kBox rows a
//    round do not fit one wave (B above the card's blocks), one block a
//    column in rounds of 32 rows, over several waves. At the slice: T = 64,
//    P = 2, S = 1 (one block a column: two splits are 512 blocks, and
//    128-thread blocks at 255 registers fit 2 an SM), RB = 52, 256 blocks,
//    one wave; at mmvaeplus_k10 (R=50, B=32, D=32) clusters of 7 blocks of
//    8 rows; at R=5, B=32, D=32 clusters of 2. Plans are kept per shape
//    and card.
//  - What holds them (chip_smoke.py's fixed_cost and PERF.md): the event
//    window of an empty launch, the wait for mu and sigma, the compute of
//    the boxes a slice (~3.5 in the forward and dz-only, ~6.5 in the full
//    backward at the slice), and for dz the stores' device-memory
//    traffic.

#define MIXTURE_BF16
#include "mixture.cu"

#include <cuda.h>

#include <algorithm>
#include <array>
#include <cstdint>
#include <map>

namespace {

using Bf16 = __nv_bfloat16;

constexpr int kTmaThreads = 128;    // threads a block aims at (P slices of T)
constexpr int kMaxCluster = 8;      // the portable cluster size: S of the full backward
constexpr int kBox = 4;             // rows a tensor copy brings, on a barrier of its own
constexpr int kBoxD = 256;          // a tensor map's box limit a dimension
constexpr int kEarly = 1;           // boxes a slice requests with mu and sigma
constexpr float kLn2 = 0.693147180559945309f;
constexpr int kTmaWaveRows = 32;    // rows a block where no plan fits one wave
constexpr int kRegsPerSm = 65536;
constexpr int kThreadsPerSm = 2048;
constexpr int kBlocksPerSm = 32;

struct TmaArgs {
  const Bf16* mask;     // (MQ, B)
  const float* out_in;  // (R, B), backward
  const float* g;       // (R, B), backward
  float* out;           // (R, B), forward
  float* logc;          // (MQ, B): written by the forward, read by the backward
  Bf16* dz;             // (R, B, D), backward
  Bf16* dmu;            // (MQ, B, D), full backward
  Bf16* dsig;           // (MQ, B, D), full backward
  int R, B, D, MQ;
  int T, P;             // threads a slice, slices a block
  int S;                // row splits (the full backward: blocks of a cluster)
  int RPB;              // rows a block (a multiple of kBox; the last split fewer)
  int RB;               // rows in shared memory at once (RPB but in rounds)
  float dc;             // D * c
};

// The 16-byte route: whole 16-byte words a row, at most kMaxThreads
// threads of 8 coordinates, at most kMaxQ experts in registers.
bool tma_takes(int D, int MQ, const void* const* ptrs, int n) {
  if (D < 8 || D % 8 != 0 || D / 8 > kMaxThreads || MQ < 1 || MQ > kMaxQ) return false;
  for (int i = 0; i < n; ++i)
    if (reinterpret_cast<std::uintptr_t>(ptrs[i]) % 16 != 0) return false;
  return true;
}

// Rows land whole, [rows][D], each copy on a 128-byte boundary.
struct TmaLayout {
  int zbox, pbox;  // elements of a box of z, of mu or sigma
  int accs;        // floats of a slice's sums, full backward: smu, sa (MQ*D each), sum w
  int z, mu, sig, acc, is, bars, red, ls, ok, c, out, g, total;  // byte offsets
};

__host__ __device__ inline TmaLayout tma_layout(int P, int T, int RB, int RPB, int D, int MQ,
                                                int kq, bool grads) {
  const int nwarp = T / 32;
  TmaLayout l;
  l.zbox = (kBox * D + 63) / 64 * 64;
  l.pbox = (MQ * D + 63) / 64 * 64;
  l.accs = grads ? 2 * MQ * D + (MQ + 3) / 4 * 4 : 0;
  int o = 0;
  l.z = o;     o += (RB / kBox) * l.zbox * 2;
  l.mu = o;    o += l.pbox * 2;
  l.sig = o;   o += l.pbox * 2;
  l.acc = 0;                                      // over z, mu and sigma, once the rows are done
  if (o < P * l.accs * 4) o = P * l.accs * 4;
  l.is = o;    o += MQ * D * 4;                   // 1/sig (float)
  l.bars = o;  o += (1 + RB / kBox) * 8;          // mu and sigma, then a box of rows each
  l.red = o;   o += 2 * P * nwarp * kG * kq * 4;  // per-warp partial sums, x2
  l.ls = o;    o += MQ * nwarp * 4;               // per-warp sum log2 sig, forward
  l.ok = o;    o += kq * 4;                       // availability (0 for padding)
  l.c = o;     o += kq * 4;                       // logc, backward
  l.out = o;   o += RPB * 4;                      // out of the block's rows, backward
  l.g = o;     o += RPB * 4;                      // g of the block's rows, backward
  l.total = o;
  return l;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

// Arrives once and expects `bytes` of tensor copies on the barrier.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// Waits for the barrier's phase of this parity (round j of the rows waits
// for parity j & 1; mu and sigma's barrier is used once).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity = 0) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  while (!done)
    asm volatile("{\n .reg .pred p;\n"
                 " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 " selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(a), "r"(parity) : "memory");
}

// The box of `map` (see tensor_map) of column b and rows from w on into
// shared dst, completing on bar.
__device__ __forceinline__ void tensor_load(void* dst, const CUtensorMap* map, int b, int w,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {0, 0, %2, %3}], [%4];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(b), "r"(w),
         "r"(smem_u32(bar))
      : "memory");
}

// The barrier of the T threads of slice `id - 1` (0 is __syncthreads').
__device__ __forceinline__ void slice_sync(int id, int nthreads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(nthreads) : "memory");
}

// Every thread of every block of the cluster: this block's shared memory
// writes before it are seen by the cluster's reads after it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The address of shared p (this block's) in the shared memory of cluster
// rank `rank`.
__device__ __forceinline__ uint32_t cluster_addr(const void* p, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(smem_u32(p)), "r"(rank));
  return r;
}

// Adds the 8 floats at cluster address `addr` (16-byte aligned) to v.
__device__ __forceinline__ void add_cluster8(uint32_t addr, float (&v)[kElems]) {
#pragma unroll
  for (int h = 0; h < kElems / 4; ++h) {
    float x0, x1, x2, x3;
    asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                 : "=f"(x0), "=f"(x1), "=f"(x2), "=f"(x3) : "r"(addr + 16 * h) : "memory");
    v[4 * h] += x0; v[4 * h + 1] += x1; v[4 * h + 2] += x2; v[4 * h + 3] += x3;
  }
}

__device__ __forceinline__ float ld_cluster(uint32_t addr) {
  float x;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(x) : "r"(addr) : "memory");
  return x;
}

template <bool kLaplace, int kQ, int kMode>
__global__ void __launch_bounds__(kMaxThreads, (kMode != kBwdFull && kQ <= 6) ? 2 : 1)
mixture_tma_kernel(const TmaArgs a, const __grid_constant__ CUtensorMap zmap,
                   const __grid_constant__ CUtensorMap mumap,
                   const __grid_constant__ CUtensorMap sigmap) {
  constexpr int kN = kG * kQ;
  constexpr bool kForward = kMode == kFwd;
  constexpr bool kGrads = kMode == kBwdFull;
  extern __shared__ __align__(128) unsigned char tma_smem[];

  const int T = a.T, P = a.P, PT = P * T;
  const int tid = threadIdx.x, slice = tid / T, t = tid - slice * T;
  const int lane = tid & 31, warp = t >> 5, nwarp = T >> 5;
  const int b = blockIdx.x, B = a.B, D = a.D, R = a.R, MQ = a.MQ, RB = a.RB;
  const bool active = t < D / kElems;  // owns coordinates 8t..8t+7
  // Rows a block, in rounds of at most RB: only the full backward's plan
  // takes more than one round, so for the other modes the count is a
  // constant 1 and their code and registers stay those of one round.
  const int RPB = kGrads ? a.RPB : RB;
  const int r0 = blockIdx.y * RPB, nrows = min(RPB, R - r0);
  const int nround = kGrads ? (nrows + RB - 1) / RB : 1;
  // boxes holding round j's rows
  auto boxes = [&](int j) { return (min(RB, nrows - j * RB) + kBox - 1) / kBox; };
  const int nbox = boxes(0);
  const int br = min(kBox, R);  // a box's rows (the map's, see launch_tma)
  const TmaLayout L = tma_layout(P, T, RB, RPB, D, MQ, kQ, kGrads);
  Bf16* s_z = reinterpret_cast<Bf16*>(tma_smem + L.z);
  Bf16* s_mu = reinterpret_cast<Bf16*>(tma_smem + L.mu);
  Bf16* s_sig = reinterpret_cast<Bf16*>(tma_smem + L.sig);
  float* s_is = reinterpret_cast<float*>(tma_smem + L.is);
  uint64_t* bars = reinterpret_cast<uint64_t*>(tma_smem + L.bars);
  float* s_red = reinterpret_cast<float*>(tma_smem + L.red);
  float* s_ls = reinterpret_cast<float*>(tma_smem + L.ls);
  float* s_ok = reinterpret_cast<float*>(tma_smem + L.ok);
  float* s_c = reinterpret_cast<float*>(tma_smem + L.c);
  float* s_out = reinterpret_cast<float*>(tma_smem + L.out);
  float* s_g = reinterpret_cast<float*>(tma_smem + L.g);

  // The small inputs first, into registers: thread q < kQ the mask (and,
  // backward, logc) of expert q, thread i < nrows out and g of row i. A
  // load stalls its thread only where the value is used, after mu and
  // sigma have landed; the indices are clamped, so every load is valid.
  const size_t qb = (size_t)min(tid, MQ - 1) * B + b;
  const size_t rb = (size_t)(r0 + min(tid, nrows - 1)) * B + b;
  const Bf16 mask_q = a.mask[qb];
  const float logc_q = kForward ? 0.f : a.logc[qb];
  const float out_r = kForward ? 0.f : a.out_in[rb];
  const float g_r = kForward ? 0.f : a.g[rb];

  if (tid == 0) {
    for (int i = 0; i < 1 + nbox; ++i) mbar_init(bars + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // Copies: mu, sigma, then box k of z (rows k*kBox on). The first kEarly
  // boxes of each slice go out with mu and sigma; the rest once mu and
  // sigma have landed (below), so that they do not queue behind the whole
  // grid's z in device memory.
  const int early = min(nbox, kEarly * P);
  auto issue = [&](int first, int last) {  // copies [first, last) by the warp's lanes
    for (int k = first + lane; k < last; k += 32) {
      if (k == 0) tensor_load(s_mu, &mumap, b, 0, bars);
      else if (k == 1) tensor_load(s_sig, &sigmap, b, 0, bars);
      else tensor_load(s_z + (k - 2) * L.zbox, &zmap, b, r0 + (k - 2) * kBox, bars + k - 1);
    }
  };
  if (tid < 32) {
    if (lane == 0) {
      mbar_expect(bars, 2 * MQ * D * 2);
      for (int k = 0; k < nbox; ++k) mbar_expect(bars + 1 + k, br * D * 2);
    }
    __syncwarp();
    issue(0, 2 + early);
  }

  mbar_wait(bars);
  if (tid >= PT - 32) issue(2 + early, 2 + nbox);  // the last warp
  // The small inputs into shared memory (loaded at the start: see there).
  if (tid < kQ) {
    s_ok[tid] = tid < MQ && to_f(mask_q) > 0.f ? 1.f : 0.f;
    if (!kForward) s_c[tid] = tid < MQ ? logc_q : 0.f;
  }
  if (!kForward) {
    if (tid < nrows) {
      s_out[tid] = out_r;
      s_g[tid] = g_r;
    }
    for (int i = tid + PT; i < nrows; i += PT) {
      s_out[i] = a.out_in[(size_t)(r0 + i) * B + b];
      s_g[i] = a.g[(size_t)(r0 + i) * B + b];
    }
  }
  // 1/sig, and in the forward the sum of log sig, once a block: slice p
  // forms them for the experts q with q % P == p at its coordinates. log sig
  // of 8 coordinates is taken as one log2 of their mantissas' product (in
  // [1, 256)) plus their exponents; a zero, subnormal or non-finite sigma
  // takes log2f of its own.
  for (int q = slice; q < MQ; q += P) {  // uniform over the warp
    float ls = 0.f;
    if (active) {
      float sg[kElems], inv[kElems], prod = 1.f;
      int ex = 0;
      ld_vec<kElems>(s_sig + q * D + t * kElems, sg);
#pragma unroll
      for (int e = 0; e < kElems; ++e) {
        inv[e] = __fdividef(1.f, sg[e]);
        if (kForward) {
          const unsigned u = __float_as_uint(sg[e]), f = u >> 23;
          if (f - 1u < 254u) {
            ex += static_cast<int>(f) - 127;
            prod *= __uint_as_float((u & 0x7fffffu) | 0x3f800000u);
          } else {
            ls += log2f(sg[e]);
          }
        }
      }
      st_vec<kElems>(s_is + q * D + t * kElems, inv);
      if (kForward) ls += log2f(prod) + static_cast<float>(ex);
    }
    if (kForward) {
      ls = warp_sum(ls);
      if (lane == 0) s_ls[q * nwarp + warp] = ls;
    }
  }
  __syncthreads();
  // mu and 1/sig of this thread's coordinates in registers (0 past D or MQ)
  float pm[kQ][kElems], pis[kQ][kElems];
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    float m[kElems], is[kElems];
#pragma unroll
    for (int e = 0; e < kElems; ++e) m[e] = is[e] = 0.f;
    if (q < MQ && active) {
      ld_vec<kElems>(s_mu + q * D + t * kElems, m);
      ld_vec<kElems>(s_is + q * D + t * kElems, is);
    }
#pragma unroll
    for (int e = 0; e < kElems; ++e) {
      pm[q][e] = m[e];
      pis[q][e] = is[e];
    }
  }

  // Lane g*kQ + q (< kN) finishes row g of a group for expert q.
  const int lg = lane / kQ, lqx = lane - lg * kQ;
  bool my_ok = false;
  float my_c = 0.f;
  if (lane < kN && lqx < MQ) {
    my_ok = s_ok[lqx] > 0.f;
    if (kForward) {
      float tot = 0.f;
      for (int w = 0; w < nwarp; ++w) tot += s_ls[lqx * nwarp + w];
      my_c = -tot * kLn2 - a.dc;
    } else {
      my_c = s_c[lqx];
    }
  }
  if (kForward && blockIdx.y == 0 && tid < MQ) a.logc[(size_t)tid * B + b] = my_c;

  // The full backward's raw sums over the slice's rows, scaled at the end
  // (as in mixture.cu): smu = sum_r w sgn(z-mu) (Laplace) or sum_r w (z-mu)
  // (Normal), so dmu = smu/sig^p; sa = sum_r w |z-mu|^p, so dsig =
  // (sa/sig^p - sum_r w)/sig, with p = 1 (Laplace) or 2 (Normal). Lane
  // g*kQ + q adds w of row g of each group for expert q into wsum.
  float smu[kGrads ? kQ : 1][kElems], sa[kGrads ? kQ : 1][kElems];
  float wsum = 0.f;
  if constexpr (kGrads) {
#pragma unroll
    for (int q = 0; q < kQ; ++q)
#pragma unroll
      for (int e = 0; e < kElems; ++e) smu[q][e] = sa[q][e] = 0.f;
  }

  // Box k of a round's rows belongs to slice k % P; a box is kBox / kG
  // groups of kG rows.
  int phase = 0;
  for (int j = 0; j < nround; ++j) {
    const int nb = boxes(j);
    if (j > 0) {
      // round j's rows into the boxes of round j - 1, once every slice is
      // done with them
      __syncthreads();
      if (tid < 32) {
        if (lane == 0)
          for (int k = 0; k < nb; ++k) mbar_expect(bars + 1 + k, br * D * 2);
        __syncwarp();
        for (int k = lane; k < nb; k += 32)
          tensor_load(s_z + k * L.zbox, &zmap, b, r0 + j * RB + k * kBox, bars + 1 + k);
      }
    }
    for (int k = slice; k < nb; k += P) {
      mbar_wait(bars + 1 + k, j & 1);
      const Bf16* box = s_z + k * L.zbox + t * kElems;
      for (int gb = 0; gb < kBox / kG; ++gb) {
        const int i0 = j * RB + k * kBox + gb * kG;  // the group's first block row
        const int live = min(kG, nrows - i0);        // its rows
        if (live <= 0) break;                        // uniform over the slice
        float part[kN];
#pragma unroll
        for (int i = 0; i < kN; ++i) part[i] = 0.f;
        if (active) {
#pragma unroll
          for (int g = 0; g < kG; ++g) {
            if (g >= live) continue;
            float zv[kElems];
            ld_vec<kElems>(box + (gb * kG + g) * D, zv);
#pragma unroll
            for (int e = 0; e < kElems; ++e)
#pragma unroll
              for (int q = 0; q < kQ; ++q) {
                const float diff = zv[e] - pm[q][e];
                float& acc = part[g * kQ + q];
                if (kLaplace) {
                  acc = fmaf(fabsf(diff), pis[q][e], acc);
                } else {
                  const float u = diff * pis[q][e];
                  acc = fmaf(u, u, acc);
                }
              }
          }
        }
        // The slice's totals: warp reduce-scatter, then one pass over the
        // slice's warps. Two alternating buffers, so one barrier a group.
        float* red = s_red + (((phase++ & 1) * P + slice) * nwarp) * kN;
        int base = 0, lim = kN;
        reduce_scatter<kN, kN, 16>(part, lane, base, lim);
        if (base < lim) red[warp * kN + base] = part[0];
        if (nwarp == 1) __syncwarp(); else slice_sync(1 + slice, T);
        float tot = 0.f;
        if (lane < kN)
          for (int w = 0; w < nwarp; ++w) tot += red[w * kN + lane];
        const bool mine = lane < kN && lg < live;
        const float lq = (mine && my_ok) ? my_c - (kLaplace ? tot : 0.5f * tot) : kNeg;

        if constexpr (kForward) {
          if (warp == 0) {
            float v[kQ], m = kNeg;
#pragma unroll
            for (int q = 0; q < kQ; ++q) {
              v[q] = __shfl_sync(0xffffffffu, lq, lg * kQ + q);
              m = fmaxf(m, v[q]);
            }
            float sum = 0.f;
#pragma unroll
            for (int q = 0; q < kQ; ++q) sum += expf(v[q] - m);
            if (mine && lqx == 0) a.out[(size_t)(r0 + i0 + lg) * B + b] = logf(sum) + m;
          }
        } else {
          // w[r, q] = exp(lq - out) * g, 0 for a masked expert or a row past R
          float wl = 0.f;
          if (mine && my_ok) wl = expf(lq - s_out[i0 + lg]) * s_g[i0 + lg];
          if (kGrads) wsum += wl;
#pragma unroll
          for (int g = 0; g < kG; ++g) {
            if (g >= live) continue;  // uniform over the slice
            float w[kQ];
#pragma unroll
            for (int q = 0; q < kQ; ++q) w[q] = __shfl_sync(0xffffffffu, wl, g * kQ + q);
            if (!active) continue;
            float zv[kElems], s[kElems];  // s = -dz
            ld_vec<kElems>(box + (gb * kG + g) * D, zv);
#pragma unroll
            for (int e = 0; e < kElems; ++e) {
              s[e] = 0.f;
              if constexpr (kLaplace && kGrads) {
                // d|x|/dx = sign(x) with sign(0) = 0, as torch.abs defines
                // it: w times the sign is w with the sign bit of z - mu
                // xored in, and 0 where z == mu (a select, no branch: the
                // coordinates' chains interleave at the 8 warps an SM that
                // the sums' registers leave).
#pragma unroll
                for (int q = 0; q < kQ; ++q) {
                  const float diff = zv[e] - pm[q][e];
                  const float ws =
                      diff == 0.f ? 0.f
                                  : __int_as_float(__float_as_int(w[q]) ^
                                                   (__float_as_int(diff) & 0x80000000));
                  s[e] = fmaf(ws, pis[q][e], s[e]);
                  smu[q][e] += ws;
                  sa[q][e] = fmaf(w[q], fabsf(diff), sa[q][e]);
                }
              } else if constexpr (kLaplace) {
                // The same sign, in 4 instructions a term: the product of
                // the differences flags an exact z == mu (or a product that
                // under- or overflowed), and only then are the terms taken
                // again with the sign 0 at 0: the same sums.
                float prod = 1.f;
#pragma unroll
                for (int q = 0; q < kQ; ++q) {
                  const float diff = zv[e] - pm[q][e];
                  prod *= diff;
                  const float ws = __int_as_float(__float_as_int(w[q]) ^
                                                  (__float_as_int(diff) & 0x80000000));
                  s[e] = fmaf(ws, pis[q][e], s[e]);
                }
                if (!(fabsf(prod) > 0.f)) {
                  s[e] = 0.f;
#pragma unroll
                  for (int q = 0; q < kQ; ++q) {
                    const float diff = zv[e] - pm[q][e];
                    const float ws = diff == 0.f ? 0.f : copysignf(1.f, diff) * w[q];
                    s[e] = fmaf(ws, pis[q][e], s[e]);
                  }
                }
              } else {
#pragma unroll
                for (int q = 0; q < kQ; ++q) {
                  const float diff = zv[e] - pm[q][e];
                  const float wd = w[q] * diff;
                  s[e] = fmaf(wd * pis[q][e], pis[q][e], s[e]);
                  if constexpr (kGrads) {
                    smu[q][e] += wd;
                    sa[q][e] = fmaf(wd, diff, sa[q][e]);
                  }
                }
              }
              s[e] = -s[e];
            }
            st_vec<kElems>(a.dz + ((size_t)(r0 + i0 + g) * B + b) * D + t * kElems, s);
          }
        }
      }
    }
  }

  if constexpr (kGrads) {
    // The slice's sum of w for expert lane (< kQ), its rows in order.
    float wq = 0.f;
#pragma unroll
    for (int g = 0; g < kG; ++g)
      wq += __shfl_sync(0xffffffffu, wsum, g * kQ + min(lane, kQ - 1));
    __syncthreads();  // every slice is done with z, mu and sigma: the sums go there
    float* acc = reinterpret_cast<float*>(tma_smem + L.acc);
    float* own = acc + slice * L.accs;
    if (active) {
#pragma unroll
      for (int q = 0; q < kQ; ++q)
        if (q < MQ) {
          st_vec<kElems>(own + q * D + t * kElems, smu[q]);
          st_vec<kElems>(own + (MQ + q) * D + t * kElems, sa[q]);
        }
    }
    if (warp == 0 && lane < MQ) own[2 * MQ * D + lane] = wq;
    const int S = a.S;
    cluster_sync();
    // Rank k of the cluster (its split, blockIdx.y: the cluster spans
    // grid.y) finishes units [n8*k/S, n8*(k+1)/S) of the column's n8 units
    // of 8 (q, d) entries: every rank's and slice's sums added in order,
    // then dmu = smu/sig^p and dsig = (sa/sig^p - sum_r w)/sig.
    const int rank = blockIdx.y, n8 = MQ * D / kElems;
    const int u1 = (rank + 1) * n8 / S;
    for (int u = rank * n8 / S + tid; u < u1; u += PT) {
      const int q = u * kElems / D, d = u * kElems - q * D;
      float sm[kElems], sg[kElems], is[kElems], ws = 0.f;
#pragma unroll
      for (int e = 0; e < kElems; ++e) sm[e] = sg[e] = 0.f;
      for (int r = 0; r < S; ++r)
        for (int p = 0; p < P; ++p) {
          const uint32_t src = cluster_addr(acc + p * L.accs, r);
          add_cluster8(src + (q * D + d) * 4, sm);
          add_cluster8(src + ((MQ + q) * D + d) * 4, sg);
          ws += ld_cluster(src + (2 * MQ * D + q) * 4);
        }
      ld_vec<kElems>(s_is + q * D + d, is);
#pragma unroll
      for (int e = 0; e < kElems; ++e) {
        const float isp = kLaplace ? is[e] : is[e] * is[e];
        sm[e] *= isp;
        sg[e] = (sg[e] * isp - ws) * is[e];
      }
      const size_t o = ((size_t)q * B + b) * D + d;
      st_vec<kElems>(a.dmu + o, sm);
      st_vec<kElems>(a.dsig + o, sg);
    }
    cluster_sync();  // the other ranks read this block's sums until here
  }
}

__global__ void mixture_empty_kernel() {}

struct TmaPlan {
  int T, P, S, RPB, RB, kq;
  bool one_wave;  // all blocks resident at once
  size_t smem;
};

// T, P and kq of a launch of `mode` (RPB, RB, S and smem are the plan's).
void tma_threads(int D, int MQ, int mode, TmaPlan* p) {
  p->T = (D / kElems + 31) / 32 * 32;
  p->P = kTmaThreads / p->T > 1 ? kTmaThreads / p->T : 1;
  p->kq = padded_q(MQ);
}

size_t tma_bytes(const TmaPlan& p, int rb, int rpb, int D, int MQ, int mode) {
  return static_cast<size_t>(
      tma_layout(p.P, p.T, rb, rpb, D, MQ, p.kq, mode == kBwdFull).total);
}

// The forward's and the dz-only backward's launch shape on a card with nsm
// SMs, smem_limit bytes of shared memory a block, smem_sm an SM and
// `reserved` bytes kept per block.
void make_tma_plan(int R, int B, int D, int MQ, int mode, int nsm, int smem_limit,
                   int smem_sm, int reserved, TmaPlan* p) {
  tma_threads(D, MQ, mode, p);
  const int threads = p->P * p->T;
  const int regs = p->kq <= 6 ? 128 : 256;  // the launch bounds' cap, allocated
  const int cap = std::min({kRegsPerSm / (threads * regs), kThreadsPerSm / threads,
                            kBlocksPerSm});
  auto bytes = [&](int rb) { return tma_bytes(*p, rb, rb, D, MQ, mode); };
  const int most = (R + kBox - 1) / kBox * kBox;
  int RB = 0;
  for (int rb = kBox; rb <= most && bytes(rb) <= (size_t)smem_limit; rb += kBox) {
    const int s = (R + rb - 1) / rb;
    const int slots = std::min(cap, static_cast<int>(smem_sm / (bytes(rb) + reserved)));
    if ((long long)B * s <= (long long)nsm * slots) {
      RB = rb;
      break;
    }
  }
  p->one_wave = RB > 0;
  if (RB == 0) {  // more z than fits the card at once: several waves
    RB = std::min(most, kTmaWaveRows);
    while (RB > kBox && bytes(RB) > (size_t)smem_limit) RB -= kBox;
  }
  p->RB = p->RPB = RB;
  p->S = (R + RB - 1) / RB;
  p->smem = bytes(RB);
}

// A launch of B x S blocks of `threads`, the S splits of a column one
// cluster.
void cluster_launch(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr, int B, int S,
                    int threads, size_t smem, cudaStream_t stream) {
  *cfg = {};
  cfg->gridDim = dim3(B, S);
  cfg->blockDim = dim3(threads);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = 1;
  attr->val.clusterDim.y = S;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
}

// Clusters of S blocks (`threads` each, `smem` bytes of shared memory) that
// the card holds at once, by its own count (registers, shared memory, how
// clusters fit its GPCs); blocks for S = 1.
cudaError_t resident(const void* kernel, int nsm, int B, int S, int threads, size_t smem,
                     int* n) {
  if (S == 1) {
    const cudaError_t err =
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(n, kernel, threads, smem);
    *n *= nsm;
    return err;
  }
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cluster_launch(&cfg, &attr, B, S, threads, smem, nullptr);
  return cudaOccupancyMaxActiveClusters(n, kernel, &cfg);
}

// The full backward's launch shape: the most splits S <= kMaxCluster (each
// at its fewest rows a block, RPB) at which all B clusters can be resident
// at once, and for that S the fewest rounds (the most rows RB in shared
// memory, in rounds of even size) that still keep them so. Where even one
// split of kBox rows a round does not fit (B above the card's blocks), one
// block a column in rounds of kTmaWaveRows, over several waves.
cudaError_t make_bwd_plan(int R, int B, int D, int MQ, const void* kernel, int nsm,
                          int smem_limit, TmaPlan* p) {
  tma_threads(D, MQ, kBwdFull, p);
  const int threads = p->P * p->T;
  auto up = [](int x) { return (x + kBox - 1) / kBox * kBox; };
  auto bytes = [&](int rb, int rpb) { return tma_bytes(*p, rb, rpb, D, MQ, kBwdFull); };
  auto set = [&](int s, int rpb, int rb, bool one_wave) {
    p->S = s;
    p->RPB = rpb;
    p->RB = rb;
    p->one_wave = one_wave;
    p->smem = bytes(rb, rpb);
  };
  for (int s = std::min(kMaxCluster, (R + kBox - 1) / kBox); s >= 1; --s) {
    const int rpb = up((R + s - 1) / s);
    if ((R + rpb - 1) / rpb != s) continue;  // the split of a larger s
    int n = 0;
    if (bytes(kBox, rpb) > (size_t)smem_limit) continue;
    cudaError_t err = resident(kernel, nsm, B, s, threads, bytes(kBox, rpb), &n);
    if (err != cudaSuccess) return err;
    if (n < B) continue;  // not even at kBox rows a round
    for (int rounds = 1;; ++rounds) {
      const int rb = up((rpb + rounds - 1) / rounds);
      if ((rpb + rb - 1) / rb < rounds) continue;  // the rb of fewer rounds
      if (bytes(rb, rpb) <= (size_t)smem_limit) {
        err = resident(kernel, nsm, B, s, threads, bytes(rb, rpb), &n);
        if (err != cudaSuccess) return err;
        if (n >= B || rb == kBox) {
          set(s, rpb, rb, true);
          return cudaSuccess;
        }
      }
    }
  }
  const int rpb = up(R);
  int rb = std::min(rpb, kTmaWaveRows);
  while (rb > kBox && bytes(rb, rpb) > (size_t)smem_limit) rb -= kBox;
  set(1, rpb, rb, false);
  return cudaSuccess;
}

template <int kMode, bool kLap>
const void* pick_tma(int kq) {
  switch (kq) {
    case 2: return (const void*)&mixture_tma_kernel<kLap, 2, kMode>;
    case 5: return (const void*)&mixture_tma_kernel<kLap, 5, kMode>;
    case kMaxQ: return (const void*)&mixture_tma_kernel<kLap, kMaxQ, kMode>;
  }
  return nullptr;
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of libcuda, looked up once through the runtime's
// entry-point query (this library does not link libcuda).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) !=
            cudaSuccess || q != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// An (n, B, D) bf16 tensor as a 4-D map (bd, D / bd, B, n) whose box is
// whole rows: (bd, D / bd, 1, rows), landing as [rows][D]. bd is the
// largest multiple of 8 that divides D within the box's limit of 256.
cudaError_t tensor_map(CUtensorMap* map, const Bf16* base, int n, int B, int D, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  int bd = 8;
  for (int c = kBoxD; c > 8; c -= 8)
    if (D % c == 0) {
      bd = c;
      break;
    }
  const cuuint64_t dims[4] = {(cuuint64_t)bd, (cuuint64_t)(D / bd), (cuuint64_t)B,
                              (cuuint64_t)n};
  const cuuint64_t strides[3] = {(cuuint64_t)bd * 2, (cuuint64_t)D * 2,
                                 (cuuint64_t)B * D * 2};
  const cuuint32_t box[4] = {(cuuint32_t)bd, (cuuint32_t)(D / bd), 1, (cuuint32_t)rows};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                              const_cast<Bf16*>(base), dims, strides, box, unit,
                              CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Plans made, by (R, B, D, MQ, mode, laplace, device); under g_ready_mutex.
std::map<std::array<int, 7>, TmaPlan> g_plans;

// The kernel for these shapes, with its shared memory attributes set, and
// its plan.
template <int kMode>
cudaError_t prepare_tma(const TmaArgs& a, int laplace, TmaPlan* p, const void** kernel) {
  int dev = 0, nsm = 0, optin = 0, smem_sm = 0, reserved = 0;
  cudaError_t err = cudaGetDevice(&dev);
  // The device's context current on this thread: the tensor maps are
  // encoded by a driver call (cuTensorMapEncodeTiled), which fails on a
  // thread that has made no runtime call needing a context yet (an autograd
  // worker's first call, once the plan is kept).
  if (err == cudaSuccess) err = cudaSetDevice(dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&smem_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev);
  if (err != cudaSuccess) return err;
  if (a.R < 1 || a.B < 1) return cudaErrorInvalidValue;
  *kernel = laplace ? pick_tma<kMode, true>(padded_q(a.MQ))
                    : pick_tma<kMode, false>(padded_q(a.MQ));
  if (*kernel == nullptr) return cudaErrorInvalidValue;
  std::lock_guard<std::mutex> lock(g_ready_mutex);
  if (!g_ready.count({*kernel, dev})) {
    err = cudaFuncSetAttribute(*kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(*kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (err != cudaSuccess) return err;
    g_ready.insert({*kernel, dev});
  }
  const std::array<int, 7> key = {a.R, a.B, a.D, a.MQ, kMode, laplace ? 1 : 0, dev};
  auto it = g_plans.find(key);
  if (it == g_plans.end()) {
    TmaPlan plan = {};
    if (kMode == kBwdFull) {
      err = make_bwd_plan(a.R, a.B, a.D, a.MQ, *kernel, nsm, optin, &plan);
      if (err != cudaSuccess) return err;
    } else {
      make_tma_plan(a.R, a.B, a.D, a.MQ, kMode, nsm, optin, smem_sm, reserved, &plan);
    }
    if (plan.smem > (size_t)optin) return cudaErrorInvalidValue;
    it = g_plans.emplace(key, plan).first;
  }
  *p = it->second;
  return cudaSuccess;
}

template <int kMode>
int launch_tma(TmaArgs a, const Bf16* z, const Bf16* mu, const Bf16* sig, int laplace,
               void* stream) {
  TmaPlan p;
  const void* kernel = nullptr;
  cudaError_t err = prepare_tma<kMode>(a, laplace, &p, &kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  a.T = p.T;
  a.P = p.P;
  a.S = p.S;
  a.RPB = p.RPB;
  a.RB = p.RB;
  CUtensorMap zmap, mumap, sigmap;
  err = tensor_map(&zmap, z, a.R, a.B, a.D, std::min(kBox, a.R));
  if (err == cudaSuccess) err = tensor_map(&mumap, mu, a.MQ, a.B, a.D, a.MQ);
  if (err == cudaSuccess) err = tensor_map(&sigmap, sig, a.MQ, a.B, a.D, a.MQ);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* params[] = {&a, &zmap, &mumap, &sigmap};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kMode == kBwdFull) {
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    cluster_launch(&cfg, &attr, a.B, p.S, p.P * p.T, p.smem, s);
    err = cudaLaunchKernelExC(&cfg, kernel, params);
  } else {
    err = cudaLaunchKernel(kernel, dim3(a.B, p.S), dim3(p.P * p.T), params, p.smem, s);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The tensor-copy forward: the arguments of mixture_fwd without vec (the
// route needs D % 8 == 0 and 16-byte aligned pointers; anything else is
// refused with cudaErrorInvalidValue).
int mixture_fwd_tma(const Elem* z, const Elem* mu, const Elem* sig, const Elem* mask,
                    float* out, float* logc, int R, int B, int D, int MQ, float dc,
                    int laplace, void* stream) {
  const void* ptrs[] = {z, mu, sig};
  if (!tma_takes(D, MQ, ptrs, 3)) return static_cast<int>(cudaErrorInvalidValue);
  TmaArgs a = {};
  a.mask = mask; a.out = out; a.logc = logc;
  a.R = R; a.B = B; a.D = D; a.MQ = MQ; a.dc = dc;
  return launch_tma<kFwd>(a, z, mu, sig, laplace, stream);
}

// The tensor-copy dz-only backward: mixture_bwd's arguments without dmu,
// dsig, vec and the workspace.
int mixture_bwd_dz_tma(const Elem* z, const Elem* mu, const Elem* sig, const float* logc,
                       const Elem* mask, const float* out, const float* g, Elem* dz,
                       int R, int B, int D, int MQ, int laplace, void* stream) {
  const void* ptrs[] = {z, mu, sig, dz};
  if (!tma_takes(D, MQ, ptrs, 4)) return static_cast<int>(cudaErrorInvalidValue);
  TmaArgs a = {};
  a.mask = mask; a.out_in = out; a.g = g; a.logc = const_cast<float*>(logc); a.dz = dz;
  a.R = R; a.B = B; a.D = D; a.MQ = MQ;
  return launch_tma<kBwdDz>(a, z, mu, sig, laplace, stream);
}

// The tensor-copy full backward: mixture_bwd's arguments without vec and
// the workspace (dmu and dsig are written; neither may be NULL).
int mixture_bwd_tma(const Elem* z, const Elem* mu, const Elem* sig, const float* logc,
                    const Elem* mask, const float* out, const float* g, Elem* dz, Elem* dmu,
                    Elem* dsig, int R, int B, int D, int MQ, int laplace, void* stream) {
  const void* ptrs[] = {z, mu, sig, dz, dmu, dsig};
  if (dmu == nullptr || dsig == nullptr || !tma_takes(D, MQ, ptrs, 6))
    return static_cast<int>(cudaErrorInvalidValue);
  TmaArgs a = {};
  a.mask = mask; a.out_in = out; a.g = g; a.logc = const_cast<float*>(logc); a.dz = dz;
  a.dmu = dmu; a.dsig = dsig;
  a.R = R; a.B = B; a.D = D; a.MQ = MQ;
  return launch_tma<kBwdFull>(a, z, mu, sig, laplace, stream);
}

// The tensor-copy launch of mode 0 (forward), 1 (dz-only) or 2 (full
// backward) at these shapes: out = {blocks per SM, threads per block, row
// splits, shared memory bytes per block, rows per block, rows in shared
// memory at once, blocks of a cluster, 1 where all blocks are resident at
// once}.
int mixture_tma_launch_shape(int R, int B, int D, int MQ, int mode, int laplace,
                             int* out) {
  if (!tma_takes(D, MQ, nullptr, 0) || mode < kFwd || mode > kBwdFull)
    return static_cast<int>(cudaErrorInvalidValue);
  TmaArgs a = {};
  a.R = R; a.B = B; a.D = D; a.MQ = MQ;
  TmaPlan p = {};
  const void* kernel = nullptr;
  cudaError_t err = mode == kFwd     ? prepare_tma<kFwd>(a, laplace, &p, &kernel)
                    : mode == kBwdDz ? prepare_tma<kBwdDz>(a, laplace, &p, &kernel)
                                     : prepare_tma<kBwdFull>(a, laplace, &p, &kernel);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], kernel, p.P * p.T,
                                                        p.smem);
  out[1] = p.P * p.T;
  out[2] = p.S;
  out[3] = static_cast<int>(p.smem);
  out[4] = p.RPB;
  out[5] = p.RB;
  out[6] = mode == kBwdFull ? p.S : 1;
  out[7] = p.one_wave ? 1 : 0;
  return static_cast<int>(err);
}

// One launch of an empty kernel through the same path (ctypes, then
// cudaLaunchKernel on the caller's stream): the fixed cost of a launch
// between two events, for chip_smoke.py's decomposition.
int mixture_empty(void* stream) {
  void* params[] = {nullptr};
  cudaError_t err = cudaLaunchKernel((const void*)&mixture_empty_kernel, dim3(1), dim3(32),
                                     params, 0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
