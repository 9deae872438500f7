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
//   logc[q,b] = -sum_d log sig[q,b,d] - D*c.
//
// The forward reads sigma itself: it forms 1/sig and logc in the kernel
// and writes logc (MQ, B) as a side output, so a forward is one launch.
// The backward reuses logc, recomputes the per-expert densities, forms
// w[r,q] = exp(lq[r,q] - out[r]) * g[r] (0 for a masked expert, so masked
// experts and fully masked columns get exactly zero gradient, as the plain
// version's torch.where gives), and computes
//   dz[r]  = sum_q w df/dz,   dmu[q] = -sum_r w df/dz,   dsig[q] = sum_r w df/dsig.
// A dz-only instantiation skips dmu and dsig (the DReG path detaches mu and
// sigma). The Laplace sign is 0 at z == mu, as the derivative of torch.abs
// (and jnp.abs) is; the TPU kernel used +1 there.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32 without tensor cores) at
// the MMVAE slice shapes (R=50, B=256, D=512, MQ=5, float32): the forward
// reads z (26.2 MB), mu and sigma (5.2 MB) and writes out and logc, about
// 31.5 MB or 9.4 us, against ~131 M operations (~2 us); the dz-only
// backward also reads out and g and writes dz (26.2 MB), about 57.8 MB or
// 17.3 us; the full backward writes dmu and dsig too, about 63.0 MB or
// 18.8 us, against ~0.4 G operations (~6 us). All three are bound by device
// memory, and z is the stream that matters.
//
// Design. One block handles one batch column b (grid.x) and a share of its
// rows (grid.y = S splits, used only when B is too small to fill the card).
// Inside a block, P row slices of T threads each walk rows
// r = slot, slot + S*P, ...; thread t of a slice owns kElems = 8 coordinates
// of every row, d = 4*(t + v*T) + e (v < 2, e < 4) when D % 4 == 0 and the
// pointers are 16-byte aligned (float4 accesses), else d = t + v*T (v < 8,
// scalar accesses; this covers D % 4 != 0).
//  - Expert parameters are read once per block. The block copies the
//    column's mu and sigma (MQ*D floats each) into shared memory with
//    cp.async, ahead of z's first rows; the forward sums log sigma per expert
//    there (one warp sum per expert, then one pass over the warps) and writes
//    logc; then 1/sigma replaces sigma in place. Each thread then keeps mu and
//    1/sig of its coordinates in registers (2*kQ*8 of them) for every row, so
//    each z element is read from device memory once and meets all MQ experts
//    there. The register count kQ is a template parameter with instances 2,
//    5 and 8: MQ is rounded up to the next one, and the padded experts have
//    mu = 1/sig = 0 and a zero mask, so their lq is -1e30, their w is 0 and
//    nothing is written for them. 5 is the MMVAE slice's count; padded to 8
//    it would run one block per SM instead of two, and its full backward
//    would spill (PERF.md).
//  - The chunked path takes what the register instances cannot: MQ > 8
//    (experts in chunks of 8), rows of more than 256*8 coordinates (NT tiles
//    of 8 coordinates a thread) and the scalar accesses. It reloads the
//    parameter registers for each (chunk, tile) and is slower; no model
//    path takes it. Where the whole rows and the staged mu and 1/sig fit in
//    shared memory it keeps them there as the register path does (z read
//    once). Beyond that (D > 3072 at MQ=5) it streams: see the ring below.
//  - z streams through a ring of kStages = 2 shared-memory stages, filled
//    with cp.async (16-byte cg, or 4-byte ca on the scalar path;
//    zero-filled past the row's end or R). A stage holds kG = 4 rows,
//    whole, except on the streaming chunked path, where it holds one tile of
//    them and mu and sigma are not staged: each (chunk, tile) reloads the
//    parameter registers from device memory (L2 after the first group) and
//    forms 1/sig there, a group's tiles stream once per expert chunk and
//    again for dz, and shared memory no longer grows with D. Each thread
//    copies and later reads only its own slots, so the ring needs no
//    barrier: the copy of step i+1 is in flight while step i is computed,
//    and no register holds it. Rows past R are neither read nor computed.
//  - The kG*kQ partial sums of a group are reduced together: a
//    reduce-scatter over the warp (lanes exchange halves: 21 shuffles for 20
//    sums instead of 100), then one shared-memory pass over the slice's
//    warps behind one barrier (two alternating buffers, so that barrier is
//    the forward's only one per group). The slice's first warp then holds
//    lq[r, q] in lane g*kQ + q and finishes the logsumexp with shuffles.
//  - Per term the forward does 2 operations for Laplace (fma(|z-mu|, 1/sig,
//    acc)) and 3 for Normal; 1/2 is applied to the sum.
//  - The backward forms w for the group in that warp, then computes dz from
//    the z still staged in shared memory (z is not read twice) and writes it
//    once, coalesced. For dmu and dsig it accumulates sums that leave 1/sig
//    out (sum_r w sgn(z-mu) and sum_r w |z-mu| for Laplace, sum_r w (z-mu)
//    and sum_r w (z-mu)^2 for Normal, plus sum_r w per expert) in registers
//    over all rows of the slice, and applies 1/sig once at the end: 3 to 4
//    operations per term instead of ~12. The P slices add their sums in a
//    fixed order through shared memory and each (q, b, d) is written once.
//    No atomics: results are deterministic. In the chunked path the block
//    has one slice and each thread adds into dmu/dsig in device memory,
//    where it owns its coordinates.
//  - Parameters: T = 32*ceil(D/8/32) threads a slice, at most 256; a longer
//    row takes NT = ceil(D/8/256) tiles. Forward and dz-only: P = 256/T
//    slices (at least 1), S = clamp(2*SMs/B, 1, ceil(R/(P*kG))), launch
//    bounds of 2 blocks per SM for kQ <= 6 (128 registers); full backward:
//    P = 128/T, S = 1, launch bounds of one 256-thread block (255
//    registers). Shared memory holds the ring (2*4*8 floats per thread and
//    tile held) and, unless streaming, mu and 1/sig (2*MQ*D floats); the
//    chunked path streams when that exceeds the card's limit (D > 3072 at
//    MQ=5), and then needs about 66 KB whatever D is. At the slice
//    (D=512, MQ=5): T=64, S=1; forward and dz-only: P=4, 256 blocks of 256
//    threads, 87,896 bytes of shared memory per block (64 KB ring, 20 KB mu
//    and 1/sig), 2 blocks per SM, so all 256 blocks run in one wave with
//    64 KB of z in flight per SM; full backward: P=2, 256 blocks of 128
//    threads, 62,400 bytes, 2 blocks per SM. Registers and spills per
//    instance are in the -Xptxas -v report that chip_smoke.py prints.
//  - Measured (tools/mixture_sweep.py and chip_smoke.py on the H100; see
//    PERF.md): in steady state a row costs about 70% of peak bandwidth, but
//    each call has a fixed cost of several microseconds (the parameters and
//    the first groups of z arrive before the ring runs, and the single wave
//    of blocks waits for them together), which keeps the kernels under half
//    of their bound at R=50.
//
// bfloat16 (mixture_bf16.cu builds this file with MIXTURE_BF16: the C
// entries then take z, mu, sig, mask, dz, dmu and dsig as bf16; the
// trainer's mixed_precision hands them bf16). There the forward and the
// dz-only backward on 16-byte rows take mixture_bf16.cu's own design; the
// instances here take the full backward and the other shapes. The element type In is a
// template parameter of the kernel: a 16-byte cp.async now holds 8
// coordinates, so a thread's 8 coordinates of a row are one copy (kW = 8),
// and the ring takes half the shared memory. Values are widened to float
// in registers; 1/sig and logc are formed in float in shared memory (mu
// and sigma are widened there as they are staged, after z's first copies
// are issued), and every sum and product stays float. out and logc are
// written float, dz, dmu and dsig bf16. A single bf16 coordinate (the
// scalar path, D % 8 != 0) is below cp.async's 4 bytes: the thread copies
// it itself. The chunked path keeps its partial sums in float: in a
// workspace (Args::acc_*) where float outputs would have held them. Bound
// at the slice in bf16: forward 15.8 MB (4.7 us), dz-only 28.9 MB
// (8.6 us), full 31.5 MB (9.4 us), all bytes.
//
// Tensor cores do not apply. The Laplace term |z - mu| has no product form.
// For Normal, sum_d (z-mu)^2/sig^2 = sum z^2/sig^2 - 2 sum z mu/sig^2 + ...
// would make the sum a GEMM with N = MQ = 5, but at |out| ~ 10^3 its terms
// cancel catastrophically in float32, and TF32 inputs are not float32
// parity. The kernels are bound by device memory either way.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <mutex>
#include <set>
#include <type_traits>
#include <utility>

namespace {

constexpr float kNeg = -1e30f;
constexpr int kMaxThreads = 256;  // per block
constexpr int kElems = 8;         // coordinates of a row per thread and tile
constexpr int kG = 4;             // rows per group
constexpr int kStages = 2;        // depth of the cp.async ring
constexpr int kMaxQ = 8;          // largest expert count held in registers

// The expert counts with a register instantiation; MQ is rounded up to the
// next one, and the padded experts add nothing (mu = 1/sig = 0, masked).
// 5 is the MMVAE slice's count: at 8 its forward would lose half its
// occupancy (one block per SM, see the launch bounds).
int padded_q(int MQ) {
  return MQ <= 2 ? 2 : MQ <= 5 ? 5 : kMaxQ;
}

enum Mode { kFwd = 0, kBwdDz = 1, kBwdFull = 2 };

// In: the element type of z, mu, sig, mask, dz, dmu and dsig (float or
// __nv_bfloat16); out, logc, g and all arithmetic are float.
template <typename In>
struct Args {
  const In* z;          // (R, B, D)
  const In* mu;         // (MQ, B, D)
  const In* sig;        // (MQ, B, D)
  const In* mask;       // (MQ, B)
  const float* out_in;  // (R, B), backward
  const float* g;       // (R, B), backward
  float* out;           // (R, B), forward
  float* logc;          // (MQ, B): written by the forward, read by the backward
  In* dz;               // (R, B, D)
  In* dmu;              // (MQ, B, D), full backward
  In* dsig;             // (MQ, B, D), full backward
  // float partial sums of the chunked path, kept across expert chunks (dz,
  // MQ > kMaxQ) and rows (dmu, dsig): dz, dmu and dsig themselves for float,
  // a workspace for bf16 (mixture_workspace)
  float* acc_dz;
  float* acc_mu;
  float* acc_sig;
  int R, B, D, MQ;
  int T, P, S, NT;      // threads per slice, slices per block, row splits,
                        // tiles of a row (chunked path)
  float dc;             // D * c
};

template <typename In>
constexpr bool kIsF32 = std::is_same<In, float>::value;

// Elements of In in one 16-byte access: 4 floats or 8 bf16 values.
template <typename In>
constexpr int kVecW = 16 / static_cast<int>(sizeof(In));

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename In>
__device__ __forceinline__ In from_f(float x) {
  if constexpr (kIsF32<In>) return x;
  else return __float2bfloat16_rn(x);
}

// kW elements at p (one 16-byte access for kW = kVecW, else one element)
// into floats; a float row of kW = 8 (bf16's width, staged mu and 1/sig) is
// two 16-byte accesses.
template <int kW, typename T>
__device__ __forceinline__ void ld_vec(const T* p, float (&v)[kW]) {
  if constexpr (kW == 1) {
    v[0] = to_f(*p);
  } else if constexpr (kIsF32<T>) {
#pragma unroll
    for (int h = 0; h < kW / 4; ++h) {
      const float4 t = reinterpret_cast<const float4*>(p)[h];
      v[4 * h] = t.x; v[4 * h + 1] = t.y; v[4 * h + 2] = t.z; v[4 * h + 3] = t.w;
    }
  } else {
    static_assert(kW == 8, "bf16 rows are read 8 at a time");
    const uint4 t = *reinterpret_cast<const uint4*>(p);
    const unsigned w[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[h]));
      v[2 * h] = f.x; v[2 * h + 1] = f.y;
    }
  }
}

template <int kW, typename T>
__device__ __forceinline__ void st_vec(T* p, const float (&v)[kW]) {
  if constexpr (kW == 1) {
    *p = from_f<T>(v[0]);
  } else if constexpr (kIsF32<T>) {
#pragma unroll
    for (int h = 0; h < kW / 4; ++h)
      reinterpret_cast<float4*>(p)[h] =
          make_float4(v[4 * h], v[4 * h + 1], v[4 * h + 2], v[4 * h + 3]);
  } else {
    static_assert(kW == 8, "bf16 rows are written 8 at a time");
    unsigned w[4];
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const __nv_bfloat162 b2 = __floats2bfloat162_rn(v[2 * h], v[2 * h + 1]);
      w[h] = *reinterpret_cast<const unsigned*>(&b2);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// Asynchronous copy of kW elements to shared memory; zero-filled when !ok.
// cp.async copies 4, 8 or 16 bytes: a single bf16 element (the scalar path)
// is copied by the thread itself, which alone reads that slot later.
template <int kW, typename In>
__device__ __forceinline__ void cp_async(In* dst, const In* src, bool ok) {
  constexpr int kBytes = kW * static_cast<int>(sizeof(In));
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = ok ? kBytes : 0;
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(s), "l"(src), "r"(n) : "memory");
  } else if constexpr (kBytes == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(s), "l"(src), "r"(n) : "memory");
  } else {
    static_assert(kBytes == 2, "a copy of 2, 4 or 16 bytes");
    *dst = ok ? *src : from_f<In>(0.f);
  }
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Warp reduce-scatter of the N values v[0..N) (N <= 32): at each level lane
// pairs swap halves and add, so after five levels v[0] holds the warp's
// total of value `base`, valid when base < lim.
template <int M, int N, int kOff>
__device__ __forceinline__ void reduce_scatter(float (&v)[M], int lane,
                                               int& base, int& lim) {
  if constexpr (kOff > 0) {
    constexpr int H = (N + 1) / 2;
    const bool up = (lane & kOff) != 0;
#pragma unroll
    for (int i = 0; i < H; ++i) {
      const float lo = v[i];
      const float hi = (i + H < N) ? v[i + H] : 0.f;
      v[i] = (up ? hi : lo) + __shfl_xor_sync(0xffffffffu, up ? lo : hi, kOff);
    }
    if (up) base += H; else lim = min(lim, base + H);
    reduce_scatter<M, H, kOff / 2>(v, lane, base, lim);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Shared memory, in floats: the ring (or, at the end of the full backward,
// the exchange of dmu/dsig between slices, if larger), then mu and 1/sig of
// the column (unless streaming), then small per-block arrays. Streaming,
// nothing in it grows with D.
struct Layout {
  int mu, is, red, lq, wsum, ls, c, ok, total;
};

// nq = max(MQ, kq): the experts with the padding of a register instance.
// A ring stage holds the NT tiles of whole rows, or one tile when streaming,
// in elements of eb bytes (z's type); everything else is float.
__host__ __device__ inline Layout layout(int P, int T, int NT, int kq, int MQ,
                                         int D, int mode, bool chunked,
                                         bool stream, int eb) {
  const int nq = MQ > kq ? MQ : kq;
  const int ring = kStages * P * T * kG * kElems * (stream ? 1 : NT) * eb / 4;
  const int exch = (mode == kBwdFull && !chunked) ? 2 * P * T * kq * kElems : 0;
  const int params = stream ? 0 : MQ * D;
  Layout l;
  int o = ring > exch ? ring : exch;
  l.mu = o;   o += params;
  l.is = o;   o += params;
  l.red = o;  o += 2 * P * (T / 32) * kG * kq;  // per-warp partial sums, x2
  l.lq = o;   o += P * kG * nq;             // lq, then w, per slice and row
  l.wsum = o; o += P * MQ;                  // sum_r w per slice, full backward
  l.ls = o;   o += MQ * (P * T / 32);       // per-warp sum log sig, forward
  l.c = o;    o += nq;                      // logc (0 for padding)
  l.ok = o;   o += nq;                      // availability (0 for padding)
  l.total = o;
  return l;
}

// kStream (chunked path only): stream row tiles, mu and sigma unstaged. A
// template parameter, not a flag: the instances that hold whole rows keep
// the registers they had without the streaming code.
// In: the element type (float or bf16); kW: elements per access (kVecW<In>
// or 1).
template <typename In, bool kLaplace, int kQ, int kW, int kMode, bool kChunked,
          bool kStream>
__global__ void __launch_bounds__(kMaxThreads,
                                  (kMode != kBwdFull && kQ <= 6) ? 2 : 1)
mixture_kernel(const Args<In> a) {
  constexpr int kV = kElems / kW;
  constexpr int kN = kG * kQ;
  constexpr bool kGrads = kMode == kBwdFull;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);

  const int T = a.T, P = a.P, PT = P * T;
  const int tid = threadIdx.x, slice = tid / T, t = tid - slice * T;
  const int lane = tid & 31, warp = t >> 5, nwarp = T >> 5;
  const int b = blockIdx.x, B = a.B, D = a.D, R = a.R, MQ = a.MQ;
  const int Dv = D / kW;
  const int nq = MQ > kQ ? MQ : kQ;
  // The chunked path walks experts in chunks of kQ and a row in NT tiles of
  // kElems coordinates a thread, reloading the parameter registers for each
  // (chunk, tile); the register path has one of each.
  const int nchunk = kChunked ? (MQ + kQ - 1) / kQ : 1;
  const int NT = kChunked ? a.NT : 1;
  const int nv = NT * kV;  // slots of a row per thread, over all tiles
  const bool reload = nchunk * NT > 1;
  constexpr bool stream = kChunked && kStream;
  const int slot = blockIdx.y * P + slice, SP = a.S * P;
  const int ngroups = ((R + SP - 1) / SP + kG - 1) / kG;
  // z passes through the ring one step at a time. A step is the group's kG
  // rows, whole, except when streaming: then it is one tile of them, and a
  // group takes one step per (chunk, tile) for its lq and, in the backward,
  // as many again for dz (all but the first read from L2).
  const int nsteps = stream ? nchunk * NT * (kMode == kFwd ? 1 : 2) : 1;
  const int total = ngroups * nsteps;
  const int TS = stream ? 1 : NT;  // tiles a ring stage holds

  const Layout L = layout(P, T, NT, kQ, MQ, D, kMode, kChunked, stream,
                          static_cast<int>(sizeof(In)));
  In* ring = reinterpret_cast<In*>(smem);
  float* s_mu = smem + L.mu;
  float* s_is = smem + L.is;
  float* s_red = smem + L.red;
  float* s_lq = smem + L.lq;
  float* s_wsum = smem + L.wsum;
  float* s_ls = smem + L.ls;
  float* s_c = smem + L.c;
  float* s_ok = smem + L.ok;

  auto row_of = [&](int gi, int g) { return slot + (gi * kG + g) * SP; };
  // In the stage of step st, row g holds this thread's coordinates
  // d = kW*(t + (j*kV + v)*T) + e of tile j, v < kV, in slot j*kV + v (slot
  // v when streaming: the stage holds tile j alone).
  auto ring_at = [&](int st, int g, int j, int v) {
    const int s = (stream ? 0 : j * kV) + v;
    return ring + ((((st % kStages) * kG + g) * TS * kV + s) * PT + tid) * kW;
  };
  auto issue = [&](int st) {
    const int gi = st / nsteps;
    const int j0 = stream ? (st - gi * nsteps) % NT : 0;
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      const int r = row_of(gi, g);
      const bool rok = r < R;
      const In* zr = a.z + ((size_t)(rok ? r : 0) * B + b) * D;
      for (int j = j0; j < j0 + TS; ++j)
#pragma unroll
        for (int v = 0; v < kV; ++v) {
          const int dv = t + (j * kV + v) * T;
          const bool ok = rok && dv < Dv;
          cp_async<kW>(ring_at(st, g, j, v), ok ? zr + (size_t)dv * kW : a.z, ok);
        }
    }
    cp_commit();
  };
  // The next step: starts the copy of step st + kStages - 1 into the stage
  // that step st - 1 used (each thread reads only the slots it copied, so no
  // barrier is needed), waits for step st's tile and returns st.
  int st_next = 0;
  auto advance = [&]() {
    const int st = st_next++;
    if (st + kStages - 1 < total) issue(st + kStages - 1); else cp_commit();
    cp_wait<kStages - 1>();
    return st;
  };

  // Stage the column's mu and sigma once per block (asynchronously, ahead
  // of z's first rows), then form logc (forward) and 1/sig in place; when
  // streaming, they are read from device memory instead. bf16 values are
  // widened to float on the way, after z's first copies are issued.
  auto stage_params = [&]() {
    for (int i = tid; i < MQ * Dv; i += PT) {
      const int q = i / Dv, dv = i - q * Dv;
      const size_t off = ((size_t)q * B + b) * D + (size_t)dv * kW;
      if constexpr (kIsF32<In>) {
        cp_async<kW>(s_mu + q * D + dv * kW, a.mu + off, true);
        cp_async<kW>(s_is + q * D + dv * kW, a.sig + off, true);
      } else {
        float m[kW], s[kW];
        ld_vec<kW>(a.mu + off, m);
        ld_vec<kW>(a.sig + off, s);
        st_vec<kW>(s_mu + q * D + dv * kW, m);
        st_vec<kW>(s_is + q * D + dv * kW, s);
      }
    }
  };
  if (kIsF32<In> && !stream) stage_params();
  cp_commit();
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < total) issue(i); else cp_commit();
  }
  if (!kIsF32<In> && !stream) stage_params();
  for (int q = tid; q < nq; q += PT) {
    const bool real = q < MQ;
    s_ok[q] = real && to_f(a.mask[(size_t)q * B + b]) > 0.f ? 1.f : 0.f;
    s_c[q] = real && kMode != kFwd ? a.logc[(size_t)q * B + b] : 0.f;
  }
  if (kGrads)
    for (int i = tid; i < P * MQ; i += PT) s_wsum[i] = 0.f;
  cp_wait<kStages - 1>();  // the parameters; z's first rows may still be in flight
  __syncthreads();
  // 1/sig in place (unless streaming); the forward also sums log sig per
  // expert into logc.
  const int nwb = PT >> 5;
  for (int q = 0; q < MQ; ++q) {
    float ls = 0.f;
    for (int d = tid; d < D; d += PT) {
      if (stream) {
        if (kMode == kFwd) ls += logf(to_f(a.sig[((size_t)q * B + b) * D + d]));
      } else {
        const float sg = s_is[q * D + d];
        if (kMode == kFwd) ls += logf(sg);
        s_is[q * D + d] = __frcp_rn(sg);
      }
    }
    if (kMode == kFwd) {
      ls = warp_sum(ls);
      if (lane == 0) s_ls[q * nwb + (tid >> 5)] = ls;
    }
  }
  __syncthreads();
  if (kMode == kFwd && tid < MQ) {
    float tot = 0.f;
    for (int w = 0; w < nwb; ++w) tot += s_ls[tid * nwb + w];
    s_c[tid] = -tot - a.dc;  // read after the next barrier
    if (blockIdx.y == 0) a.logc[(size_t)tid * B + b] = s_c[tid];
  }

  // mu and 1/sig of this thread's coordinates of tile j for experts
  // [c*kQ, c*kQ+kQ), in registers (from shared memory, or from device
  // memory when streaming); zero past D or MQ, so those terms add exactly
  // 0.
  float pm[kQ][kElems], pis[kQ][kElems];
  auto load_params = [&](int c, int j) {
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      const int qq = c * kQ + q;
#pragma unroll
      for (int v = 0; v < kV; ++v) {
        const int dv = t + (j * kV + v) * T;
        float m[kW], s[kW];
#pragma unroll
        for (int e = 0; e < kW; ++e) m[e] = s[e] = 0.f;
        if (qq < MQ && dv < Dv) {
          if (stream) {
            const size_t off = ((size_t)qq * B + b) * D + (size_t)dv * kW;
            ld_vec<kW>(a.mu + off, m);
            ld_vec<kW>(a.sig + off, s);
#pragma unroll
            for (int e = 0; e < kW; ++e) s[e] = __frcp_rn(s[e]);
          } else {
            ld_vec<kW>(s_mu + qq * D + dv * kW, m);
            ld_vec<kW>(s_is + qq * D + dv * kW, s);
          }
        }
#pragma unroll
        for (int e = 0; e < kW; ++e) {
          pm[q][v * kW + e] = m[e];
          pis[q][v * kW + e] = s[e];
        }
      }
    }
  };
  load_params(0, 0);

  // Sum the per-thread values v[0..kN) (index g*kQ + q) over the slice;
  // thread t < kN of the slice (all in the slice's first warp) gets total t
  // back. s_red alternates between two buffers, so one barrier per call
  // suffices: a warp can only write a buffer again after the next barrier,
  // which the readers of this call reach after reading.
  int phase = 0;
  auto slice_sum = [&](float (&v)[kN], float& tot) {
    float* red = s_red + (phase++ & 1) * P * nwarp * kN;
    int base = 0, lim = kN;
    reduce_scatter<kN, kN, 16>(v, lane, base, lim);
    if (base < lim) red[(slice * nwarp + warp) * kN + base] = v[0];
    __syncthreads();
    tot = 0.f;
    if (t < kN)
      for (int w = 0; w < nwarp; ++w) tot += red[(slice * nwarp + w) * kN + t];
  };
  // Adds to part the partial sums of this thread's coordinates of tile j
  // (in step st's stage) for the group's rows and the experts in the
  // registers: sum_d |z-mu|/sig (Laplace) or ((z-mu)/sig)^2.
  auto partials = [&](int st, int j, const bool (&rok)[kG], float (&part)[kN]) {
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      if (!rok[g]) continue;
#pragma unroll
      for (int v = 0; v < kV; ++v) {
        float zv[kW];
        ld_vec<kW>(ring_at(st, g, j, v), zv);
#pragma unroll
        for (int e = 0; e < kW; ++e)
#pragma unroll
          for (int q = 0; q < kQ; ++q) {
            const int i = v * kW + e;
            const float diff = zv[e] - pm[q][i];
            float& acc = part[g * kQ + q];
            if (kLaplace) {
              acc = fmaf(fabsf(diff), pis[q][i], acc);
            } else {
              const float u = diff * pis[q][i];
              acc = fmaf(u, u, acc);
            }
          }
      }
    }
  };

  // Raw backward sums, scaled at the end: smu = sum_r w sgn(diff) (Laplace)
  // or sum_r w diff (Normal), so dmu = smu/sig^p; sa = sum_r w |diff|^p, so
  // dsig = (sa/sig^p - sum_r w)/sig, with p = 1 (Laplace) or 2 (Normal).
  float smu[kGrads ? kQ : 1][kElems], sa[kGrads ? kQ : 1][kElems];
  if constexpr (kGrads) {
#pragma unroll
    for (int q = 0; q < kQ; ++q)
#pragma unroll
      for (int i = 0; i < kElems; ++i) smu[q][i] = sa[q][i] = 0.f;
    if constexpr (kChunked) {
      // one slice and one split per column: this thread owns its
      // coordinates of dmu and dsig for every expert
      for (int q = 0; q < MQ; ++q)
        for (int jv = 0; jv < nv; ++jv) {
          const int dv = t + jv * T;
          if (dv < Dv) {
            const float zero[kW] = {};
            const size_t off = ((size_t)q * B + b) * D + (size_t)dv * kW;
            st_vec<kW>(a.acc_mu + off, zero);
            st_vec<kW>(a.acc_sig + off, zero);
          }
        }
    }
  }

  for (int gi = 0; gi < ngroups; ++gi) {
    // The group's one step when its rows are held whole.
    const int st0 = stream ? 0 : advance();
    bool rok[kG];
#pragma unroll
    for (int g = 0; g < kG; ++g) rok[g] = row_of(gi, g) < R;  // same in a slice

    if constexpr (!kChunked) {
      // One chunk: the slice's first warp holds lq[g, q] in lane g*kQ + q
      // and finishes the group with shuffles.
      float part[kN], tot;
#pragma unroll
      for (int i = 0; i < kN; ++i) part[i] = 0.f;
      partials(st0, 0, rok, part);
      slice_sum(part, tot);
      if (warp == 0) {
        const bool mine = t < kN;
        const int g = mine ? t / kQ : 0, q = mine ? t % kQ : 0;
        const int r = row_of(gi, g);
        const bool live = mine && r < R;
        const float lq = (live && s_ok[q] > 0.f)
                             ? s_c[q] - (kLaplace ? tot : 0.5f * tot) : kNeg;
        if constexpr (kMode == kFwd) {
          float v[kQ], m = kNeg;
#pragma unroll
          for (int j = 0; j < kQ; ++j) {
            v[j] = __shfl_sync(0xffffffffu, lq, g * kQ + j);
            m = fmaxf(m, v[j]);
          }
          float sum = 0.f;
#pragma unroll
          for (int j = 0; j < kQ; ++j) sum += expf(v[j] - m);
          if (live && q == 0) a.out[(size_t)r * B + b] = logf(sum) + m;
        } else if (mine) {
          // w[r, q] = exp(lq - out) * g, 0 for a masked expert or a row past R
          float w = 0.f;
          if (live && s_ok[q] > 0.f)
            w = expf(lq - a.out_in[(size_t)r * B + b]) * a.g[(size_t)r * B + b];
          s_lq[(slice * kG + g) * nq + q] = w;
        }
      }
      // The forward needs no barrier here: the next write to this s_red
      // buffer is two barriers away.
      if constexpr (kMode != kFwd) __syncthreads();
    } else {
      // lq[r, q] for the group's rows, chunk by chunk (each summed over the
      // row's tiles), into s_lq.
      for (int c = 0; c < nchunk; ++c) {
        float part[kN], tot;
#pragma unroll
        for (int i = 0; i < kN; ++i) part[i] = 0.f;
        for (int j = 0; j < NT; ++j) {
          const int st = stream ? advance() : st0;
          if (reload) load_params(c, j);
          partials(st, j, rok, part);
        }
        slice_sum(part, tot);
        if (t < kN) {
          const int g = t / kQ, qq = c * kQ + t % kQ;
          if (qq < MQ)
            s_lq[(slice * kG + g) * nq + qq] =
                s_ok[qq] > 0.f ? s_c[qq] - (kLaplace ? tot : 0.5f * tot) : kNeg;
        }
      }
      __syncthreads();
      if constexpr (kMode == kFwd) {
        // The next write to s_lq comes after the next group's first barrier.
        const int r = row_of(gi, t);
        if (t < kG && r < R) {
          const float* l = s_lq + (slice * kG + t) * nq;
          float m = kNeg;
          for (int q = 0; q < MQ; ++q) m = fmaxf(m, l[q]);
          float sum = 0.f;
          for (int q = 0; q < MQ; ++q) sum += expf(l[q] - m);
          a.out[(size_t)r * B + b] = logf(sum) + m;
        }
      } else {
        // w[r, q] = exp(lq - out) * g, 0 for a masked expert or a row past R.
        if (t < kG) {
          const int r = row_of(gi, t);
          float* l = s_lq + (slice * kG + t) * nq;
          const bool ok = r < R;
          const float o = ok ? a.out_in[(size_t)r * B + b] : 0.f;
          const float gr = ok ? a.g[(size_t)r * B + b] : 0.f;
          for (int q = 0; q < MQ; ++q)
            l[q] = (ok && s_ok[q] > 0.f) ? expf(l[q] - o) * gr : 0.f;
        }
        __syncthreads();
      }
    }

    if constexpr (kMode != kFwd) {
      if (kGrads && t == 0)
        for (int q = 0; q < MQ; ++q) {
          float s = 0.f;
          for (int g = 0; g < kG; ++g) s += s_lq[(slice * kG + g) * nq + q];
          s_wsum[slice * MQ + q] += s;
        }

      for (int cj = 0; cj < nchunk * NT; ++cj) {
        const int c = cj / NT, j = cj - c * NT;  // expert chunk, tile
        const int st = stream ? advance() : st0;  // z of the tile, again
        if (kChunked && reload) load_params(c, j);
#pragma unroll
        for (int g = 0; g < kG; ++g) {
          if (!rok[g]) continue;
          const int r = row_of(gi, g);
          const float* wl = s_lq + (slice * kG + g) * nq;
          float w[kQ];
#pragma unroll
          for (int q = 0; q < kQ; ++q) w[q] = c * kQ + q < MQ ? wl[c * kQ + q] : 0.f;
#pragma unroll
          for (int v = 0; v < kV; ++v) {
            const int jv = j * kV + v, dv = t + jv * T;
            const bool ok = dv < Dv;
            const size_t zo = ((size_t)r * B + b) * D + (size_t)dv * kW;
            float zv[kW], s[kW];  // s = -dz
            ld_vec<kW>(ring_at(st, g, j, v), zv);
#pragma unroll
            for (int e = 0; e < kW; ++e) s[e] = 0.f;
            if (kChunked && c > 0 && ok) {
              ld_vec<kW>(a.acc_dz + zo, s);
#pragma unroll
              for (int e = 0; e < kW; ++e) s[e] = -s[e];
            }
#pragma unroll
            for (int e = 0; e < kW; ++e) {
#pragma unroll
              for (int q = 0; q < kQ; ++q) {
                const int i = v * kW + e;
                const float diff = zv[e] - pm[q][i];
                const float is = pis[q][i];
                if (kLaplace) {
                  // d|x|/dx = sign(x) with sign(0) = 0, as torch.abs and
                  // jnp.abs define it (the TPU kernel took +1 at 0)
                  const float ws = diff == 0.f ? 0.f : copysignf(1.f, diff) * w[q];
                  s[e] = fmaf(ws, is, s[e]);
                  if constexpr (kGrads) {
                    smu[q][i] += ws;
                    sa[q][i] = fmaf(w[q], fabsf(diff), sa[q][i]);
                  }
                } else {
                  const float wd = w[q] * diff;
                  s[e] = fmaf(wd * is, is, s[e]);
                  if constexpr (kGrads) {
                    smu[q][i] += wd;
                    sa[q][i] = fmaf(wd, diff, sa[q][i]);
                  }
                }
              }
            }
            if (ok) {
#pragma unroll
              for (int e = 0; e < kW; ++e) s[e] = -s[e];
              // a partial dz stays float until the last expert chunk
              if (kChunked && c < nchunk - 1) st_vec<kW>(a.acc_dz + zo, s);
              else st_vec<kW>(a.dz + zo, s);
            }
          }
        }
        if constexpr (kGrads && kChunked) {
          // add this chunk's and tile's raw sums into dmu/dsig (owned by
          // this thread)
#pragma unroll
          for (int q = 0; q < kQ; ++q) {
            const int qq = c * kQ + q;
#pragma unroll
            for (int v = 0; v < kV; ++v) {
              const int dv = t + (j * kV + v) * T;
              if (qq < MQ && dv < Dv) {
                const size_t off = ((size_t)qq * B + b) * D + (size_t)dv * kW;
                float m[kW], s[kW];
                ld_vec<kW>(a.acc_mu + off, m);
                ld_vec<kW>(a.acc_sig + off, s);
#pragma unroll
                for (int e = 0; e < kW; ++e) {
                  m[e] += smu[q][v * kW + e];
                  s[e] += sa[q][v * kW + e];
                  smu[q][v * kW + e] = sa[q][v * kW + e] = 0.f;
                }
                st_vec<kW>(a.acc_mu + off, m);
                st_vec<kW>(a.acc_sig + off, s);
              }
            }
          }
        }
      }
    }
  }

  if constexpr (kGrads) {
    cp_wait<0>();
    __syncthreads();
    // dmu = smu/sig^p and dsig = (sa/sig^p - sum_r w)/sig from the sums of
    // all slices (added in slice order), each (q, b, d) written once.
    auto finish = [&](int q, int d, float sm, float sg) {
      const size_t o = ((size_t)q * B + b) * D + d;
      const float is = stream ? __frcp_rn(to_f(a.sig[o])) : s_is[q * D + d];
      const float isp = kLaplace ? is : is * is;
      float ws = 0.f;
      for (int p = 0; p < P; ++p) ws += s_wsum[p * MQ + q];
      a.dmu[o] = from_f<In>(sm * isp);
      a.dsig[o] = from_f<In>((sg * isp - ws) * is);
    };
    if constexpr (kChunked) {
      for (int q = 0; q < MQ; ++q)
        for (int jv = 0; jv < nv; ++jv) {
          const int dv = t + jv * T;
          if (dv < Dv)
            for (int e = 0; e < kW; ++e) {
              const size_t o = ((size_t)q * B + b) * D + (size_t)dv * kW + e;
              finish(q, dv * kW + e, a.acc_mu[o], a.acc_sig[o]);
            }
        }
    } else {
      // The ring is free now: the slices' sums meet there.
      const int n = kQ * kV * T * kW;  // floats per slice and sum
      auto put = [&](const float (&acc)[kQ][kElems], float* dst) {
#pragma unroll
        for (int q = 0; q < kQ; ++q)
#pragma unroll
          for (int v = 0; v < kV; ++v) {
            float x[kW];
#pragma unroll
            for (int e = 0; e < kW; ++e) x[e] = acc[q][v * kW + e];
            st_vec<kW>(dst + slice * n + ((q * kV + v) * T + t) * kW, x);
          }
      };
      put(smu, smem);
      put(sa, smem + P * n);
      __syncthreads();
      for (int i = tid; i < n; i += PT) {
        const int qv = i / (T * kW), rem = i - qv * (T * kW);
        const int q = qv / kV, v = qv - q * kV;
        const int dv = rem / kW + v * T;
        if (dv < Dv && q < MQ) {  // not the padded experts
          float sm = 0.f, sg = 0.f;
          for (int p = 0; p < P; ++p) {
            sm += smem[p * n + i];
            sg += smem[(P + p) * n + i];
          }
          finish(q, dv * kW + rem % kW, sm, sg);
        }
      }
    }
  }
}

struct Plan {
  int T, P, S, NT, kq;
  bool chunked, stream;
  size_t smem;
};

// The launch shape on a card with nsm SMs and smem_limit bytes of shared
// memory per block, for elements of eb bytes; false for an empty input.
bool make_plan(int R, int B, int D, int MQ, int mode, int vec, int nsm,
               int smem_limit, int eb, Plan* p) {
  if (R < 1 || B < 1 || D < 1 || MQ < 1) return false;
  const int kw = vec ? 16 / eb : 1;
  const int kv = kElems / kw;
  // threads a row needs at kElems coordinates each; beyond kMaxThreads the
  // row is cut into NT tiles, each thread holding kElems coordinates of each
  const int need = (D / kw + kv - 1) / kv;
  const int NT = (need + kMaxThreads - 1) / kMaxThreads;
  const int T = ((need + NT - 1) / NT + 31) / 32 * 32;
  p->T = T;
  p->NT = NT;
  p->chunked = !vec || MQ > kMaxQ || NT > 1;
  p->kq = p->chunked ? kMaxQ : padded_q(MQ);
  int P = (mode == kBwdFull ? kMaxThreads / 2 : kMaxThreads) / T;
  if (P < 1) P = 1;
  if (mode == kBwdFull && p->chunked) P = 1;
  p->P = P;
  int S = 1;
  if (mode != kBwdFull) {
    const int most = (R + P * kG - 1) / (P * kG);
    S = 2 * nsm / B;
    if (S > most) S = most;
    if (S < 1) S = 1;
  }
  p->S = S;
  // the chunked path streams only where whole rows and staged parameters
  // do not fit
  auto bytes = [&](bool stream) {
    return layout(P, T, NT, p->kq, MQ, D, mode, p->chunked, stream, eb).total *
           sizeof(float);
  };
  p->stream = p->chunked && bytes(false) > (size_t)smem_limit;
  p->smem = bytes(p->stream);
  return true;
}

// Floats of workspace a bf16 launch needs for the chunked path's partial
// sums (Args::acc_*): dz across expert chunks (MQ > kMaxQ), then dmu and
// dsig across rows (full backward). A float launch needs none: it keeps
// them in its outputs.
size_t workspace_floats(const Plan& p, int R, int B, int D, int MQ, int mode,
                        int eb) {
  if (eb == 4 || !p.chunked || mode == kFwd) return 0;
  const size_t dz = MQ > kMaxQ ? (size_t)R * B * D : 0;
  return dz + (mode == kBwdFull ? 2 * (size_t)MQ * B * D : 0);
}

template <typename In, int kMode, bool kLap>
const void* pick(int vec, int kq, bool chunked, bool stream) {
  constexpr int kV = kVecW<In>;
  if (chunked && stream)
    return vec ? (const void*)&mixture_kernel<In, kLap, kMaxQ, kV, kMode, true, true>
               : (const void*)&mixture_kernel<In, kLap, kMaxQ, 1, kMode, true, true>;
  if (chunked)
    return vec ? (const void*)&mixture_kernel<In, kLap, kMaxQ, kV, kMode, true, false>
               : (const void*)&mixture_kernel<In, kLap, kMaxQ, 1, kMode, true, false>;
  switch (kq) {
    case 2: return (const void*)&mixture_kernel<In, kLap, 2, kV, kMode, false, false>;
    case 5: return (const void*)&mixture_kernel<In, kLap, 5, kV, kMode, false, false>;
    case kMaxQ: return (const void*)&mixture_kernel<In, kLap, kMaxQ, kV, kMode, false, false>;
  }
  return nullptr;
}

// The plan and the kernel for these shapes, with the kernel's shared
// memory attributes set.
std::mutex g_ready_mutex;
std::set<std::pair<const void*, int>> g_ready;  // (kernel, device) set up

template <typename In, int kMode>
cudaError_t prepare(const Args<In>& a, int laplace, int vec, Plan* p,
                    const void** kernel) {
  int dev = 0, nsm = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (!make_plan(a.R, a.B, a.D, a.MQ, kMode, vec, nsm, optin, sizeof(In), p))
    return cudaErrorInvalidValue;
  *kernel = laplace ? pick<In, kMode, true>(vec, p->kq, p->chunked, p->stream)
                    : pick<In, kMode, false>(vec, p->kq, p->chunked, p->stream);
  // Once per kernel and device: allow the largest dynamic shared memory a
  // block may have, and prefer shared memory over L1, so that two blocks'
  // rings fit on an SM.
  std::lock_guard<std::mutex> lock(g_ready_mutex);
  if (g_ready.count({*kernel, dev})) return cudaSuccess;
  err = cudaFuncSetAttribute(*kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(*kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (err == cudaSuccess) g_ready.insert({*kernel, dev});
  return err;
}

// ws: the caller's workspace of mixture_workspace floats (bf16 only).
template <typename In, int kMode>
int launch(Args<In> a, int laplace, int vec, float* ws, void* stream) {
  Plan p;
  const void* kernel = nullptr;
  cudaError_t err = prepare<In, kMode>(a, laplace, vec, &p, &kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  a.T = p.T;
  a.P = p.P;
  a.S = p.S;
  a.NT = p.NT;
  if constexpr (kIsF32<In>) {
    a.acc_dz = a.dz;
    a.acc_mu = a.dmu;
    a.acc_sig = a.dsig;
  } else {
    const size_t n = workspace_floats(p, a.R, a.B, a.D, a.MQ, kMode, sizeof(In));
    if (n > 0 && ws == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    const size_t ndz = a.MQ > kMaxQ && p.chunked ? (size_t)a.R * a.B * a.D : 0;
    a.acc_dz = ws;
    a.acc_mu = n > 0 ? ws + ndz : nullptr;
    a.acc_sig = n > 0 ? ws + ndz + (size_t)a.MQ * a.B * a.D : nullptr;
  }
  void* params[] = {&a};
  err = cudaLaunchKernel(kernel, dim3(a.B, p.S), dim3(p.P * p.T), params, p.smem,
                         static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename In, int kMode>
int occupancy(Args<In> a, int laplace, int vec, int* out) {
  Plan p;
  const void* kernel = nullptr;
  cudaError_t err = prepare<In, kMode>(a, laplace, vec, &p, &kernel);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], kernel, p.P * p.T,
                                                        p.smem);
  out[1] = p.P * p.T;
  out[2] = p.S;
  out[3] = static_cast<int>(p.smem);
  return static_cast<int>(err);
}

}  // namespace

// The element type of this library's entries: float here; bf16 where
// mixture_bf16.cu defines MIXTURE_BF16 and includes this file.
#ifdef MIXTURE_BF16
using Elem = __nv_bfloat16;
#else
using Elem = float;
#endif

extern "C" {

const char* mixture_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Shared memory per block in bytes for mode 0 (forward), 1 (dz-only
// backward) or 2 (full backward) on a card that allows smem_limit bytes a
// block; 0 for an empty input. The wrapper checks it against that limit
// before launching.
size_t mixture_smem(int R, int B, int D, int MQ, int mode, int vec, int smem_limit) {
  Plan p;
  return make_plan(R, B, D, MQ, mode, vec, 132, smem_limit, sizeof(Elem), &p) ? p.smem
                                                                             : 0;
}

// Floats of workspace mixture_bwd needs at these shapes (0: pass NULL).
size_t mixture_workspace(int R, int B, int D, int MQ, int mode, int vec,
                         int smem_limit) {
  Plan p;
  if (!make_plan(R, B, D, MQ, mode, vec, 132, smem_limit, sizeof(Elem), &p)) return 0;
  return workspace_floats(p, R, B, D, MQ, mode, sizeof(Elem));
}

// z (R,B,D), mu and sig (MQ,B,D), mask (MQ,B), all of Elem -> out (R,B),
// logc (MQ,B), float. vec: 16-byte rows (D a multiple of 4 floats or 8 bf16
// values) and every pointer 16-byte aligned.
int mixture_fwd(const Elem* z, const Elem* mu, const Elem* sig,
                const Elem* mask, float* out, float* logc, int R, int B,
                int D, int MQ, float dc, int laplace, int vec, void* stream) {
  Args<Elem> a = {};
  a.z = z; a.mu = mu; a.sig = sig; a.mask = mask; a.out = out; a.logc = logc;
  a.R = R; a.B = B; a.D = D; a.MQ = MQ; a.dc = dc;
  return launch<Elem, kFwd>(a, laplace, vec, nullptr, stream);
}

// The forward's inputs, its logc and out, and g (R,B) -> dz (R,B,D), and
// dmu and dsig (MQ,B,D) unless both are NULL (the dz-only kernel), of Elem;
// ws: mixture_workspace floats, or NULL where that is 0.
int mixture_bwd(const Elem* z, const Elem* mu, const Elem* sig,
                const float* logc, const Elem* mask, const float* out,
                const float* g, Elem* dz, Elem* dmu, Elem* dsig, int R,
                int B, int D, int MQ, int laplace, int vec, float* ws,
                void* stream) {
  Args<Elem> a = {};
  a.z = z; a.mu = mu; a.sig = sig; a.mask = mask; a.out_in = out; a.g = g;
  a.logc = const_cast<float*>(logc); a.dz = dz; a.dmu = dmu; a.dsig = dsig;
  a.R = R; a.B = B; a.D = D; a.MQ = MQ;
  if (dmu == nullptr && dsig == nullptr)
    return launch<Elem, kBwdDz>(a, laplace, vec, ws, stream);
  if (dmu == nullptr || dsig == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch<Elem, kBwdFull>(a, laplace, vec, ws, stream);
}

// The launch of mode 0, 1 or 2 at these shapes: out = {blocks per SM,
// threads per block, row splits, shared memory bytes per block}.
int mixture_launch_shape(int R, int B, int D, int MQ, int mode, int laplace,
                         int vec, int* out) {
  Args<Elem> a = {};
  a.R = R; a.B = B; a.D = D; a.MQ = MQ;
  if (mode == kFwd) return occupancy<Elem, kFwd>(a, laplace, vec, out);
  if (mode == kBwdDz) return occupancy<Elem, kBwdDz>(a, laplace, vec, out);
  return occupancy<Elem, kBwdFull>(a, laplace, vec, out);
}

}  // extern "C"
