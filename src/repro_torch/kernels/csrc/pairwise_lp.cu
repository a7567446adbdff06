// All-pairs root-free Lp power sums: out[b, j] = sum_k |q[b, k] - x[j, k]|^p[b], with
// rows whose p is 2 given the product identity max(|q|^2 + |x|^2 - 2 q.x, 0).
//
// Replaces: src/repro/kernels/lp_distance.py:pairwise_lp_kernel_call (:136), the Pallas
// kernels _pairwise_l2_kernel (:77, one matmul per output tile), _pairwise_vpu_kernel
// (:88, a diff tile per query row) and _pairwise_vec_kernel (:102, per-row p, p = 2 rows
// on the identity). It scores the bulk builder's exact passes (the exact seed pools and
// every upper level's kNN, repro_torch.core.bulk_build) and the shared-ids form of
// kernels.ops.lp_gather_distance.
//
// Bound on the H100: operations. Each output costs d elementwise steps (one FMA at p = 2,
// two instructions at p = 1, more for the sqrt and general families), and every input row
// is reused across a whole tile of the other operand, so at the build's shapes (a few
// thousand rows of d = 512) the float32 units, not the 3.35 TB/s of memory, are the limit.
// p = 2 is a product, which the reference left to the TPU's matrix unit; here it stays on
// plain float32 FMAs: no tensor cores and no TF32, since the build's L2 pools depend on
// the order of near-tied distances.
//
// Design. The limit is the FP32 issue rate, so the kernel keeps the FMA pipe fed:
//  - one block of 256 threads computes a 128 x 128 output tile; each thread keeps an
//    8 x 8 register tile, rows ty + 16 r and columns tx + 16 c (interleaved, so that the
//    eight threads of a shared-memory phase read eight different padded rows, which fall
//    in eight different bank groups). A call too small to give every SM a 128 x 128 tile
//    (the delta tier's scans, the upper levels of the build) takes 64 x 64 or 32 x 32
//    tiles instead (4 x 4 or 2 x 2 a thread), the largest that still does;
//  - both operands are staged in their row-major [row][k] layout (rows padded to 36
//    floats) by 16-byte cp.async copies into a ring of 2 stages of depth 32; the copies
//    of the next stage are in flight while the current one is computed (a third stage
//    measured slower on the H100, a depth of 16 too);
//  - at each group of 4 dimensions a thread reads its 8 columns and its 8 rows as float4
//    (16 LDS.128) for 4 x 64 element updates (at 128 x 128);
//  - a block whose rows share one p runs a loop specialised for that p family; a block
//    with mixed p picks each row's family once per group of 4 dimensions;
//  - rows on the identity accumulate q.x; when the tile holds such a row, each thread also
//    sums the squares of one staged row (q rows for threads 0-127, x rows for 128-255),
//    read once per stage, and the epilogue reads the norms from shared memory.
// Every output is summed over k in ascending order, one term at a time (no split-K), as
// the first version of this kernel did, so outputs keep their bits and pairwise_lp(a, a)
// stays exactly symmetric. Out-of-range rows and dimensions are zero-filled, which adds 0
// to every family's sum. Inputs that are not 16-byte aligned rows (d % 4 != 0) are
// staged by 4-byte copies instead.
#include <stdint.h>

#include "lp_common.cuh"

namespace {

constexpr int kSide = 16;                  // threads along each side of a block
constexpr int kThreads = kSide * kSide;    // 256
constexpr int kDepth = 32;                 // dimensions per stage
constexpr int kStages = 2;                 // stages in the cp.async ring (3 was slower)
constexpr int kLd = kDepth + 4;            // padded row stride in floats (144 bytes)
constexpr int kIdentity = -1;              // family tag of a p = 2 row (product identity)
constexpr int kMixed = -2;                 // a block whose rows differ in p

// The block shape for P rows and P columns a thread: a (16 P) x (16 P) output tile.
template <int P>
struct Shape {
  static constexpr int kTile = kSide * P;
  static constexpr int kStageFloats = 2 * kTile * kLd;   // q tile, then x tile
  static constexpr int kSmemBytes = (kStages * kStageFloats + 2 * kTile) * 4;   // + norms
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Starts the copy of dimensions [k0, k0 + kDepth) of rows [r0, r0 + T) of a (rows, d)
// matrix into dst[T][kLd]; rows past `rows` and dimensions past d are zero-filled.
template <int T>
__device__ __forceinline__ void stage_tile(float* dst, const float* __restrict__ src, int r0,
                                           int rows, int d, int k0, bool vec4) {
  if (vec4) {
#pragma unroll
    for (int i = threadIdx.x; i < T * (kDepth / 4); i += kThreads) {
      const int r = i / (kDepth / 4);
      const int c = (i % (kDepth / 4)) * 4;
      const bool ok = r0 + r < rows && k0 + c < d;
      cp_async16(dst + r * kLd + c, ok ? src + static_cast<size_t>(r0 + r) * d + k0 + c : src,
                 ok);
    }
  } else {
    for (int i = threadIdx.x; i < T * kDepth; i += kThreads) {
      const int r = i / kDepth;
      const int c = i % kDepth;
      const bool ok = r0 + r < rows && k0 + c < d;
      cp_async4(dst + r * kLd + c, ok ? src + static_cast<size_t>(r0 + r) * d + k0 + c : src,
                ok);
    }
  }
}

// One row's update over 4 dimensions (x, y, z, w in ascending order) and P columns. The
// identity's FMAs go column by column; the other families dimension by dimension, which
// puts P independent additions between two that depend on each other (faster at p = 1 on
// the H100, slower at p = 2). Either way each accumulator adds its terms in ascending k.
template <int F, int P>
__device__ __forceinline__ void row_update(float (&acc)[P], const float4 q,
                                           const float4 (&xv)[P], float p) {
  if constexpr (F == kIdentity) {
#pragma unroll
    for (int c = 0; c < P; ++c) {
      acc[c] = fmaf(q.x, xv[c].x, acc[c]);
      acc[c] = fmaf(q.y, xv[c].y, acc[c]);
      acc[c] = fmaf(q.z, xv[c].z, acc[c]);
      acc[c] = fmaf(q.w, xv[c].w, acc[c]);
    }
  } else {
#pragma unroll
    for (int c = 0; c < P; ++c) acc[c] += lp::pow_from_abs<F>(fabsf(q.x - xv[c].x), p);
#pragma unroll
    for (int c = 0; c < P; ++c) acc[c] += lp::pow_from_abs<F>(fabsf(q.y - xv[c].y), p);
#pragma unroll
    for (int c = 0; c < P; ++c) acc[c] += lp::pow_from_abs<F>(fabsf(q.z - xv[c].z), p);
#pragma unroll
    for (int c = 0; c < P; ++c) acc[c] += lp::pow_from_abs<F>(fabsf(q.w - xv[c].w), p);
  }
}

template <int F, int P>
__device__ __forceinline__ void tile_loop(const float* __restrict__ q, const float* __restrict__ x,
                                          const int (&fam)[P], const float (&pr)[P],
                                          float* __restrict__ out, int B, int N, int d,
                                          bool vec4, bool norms, float* smem) {
  constexpr int T = Shape<P>::kTile;
  constexpr int kStageFloats = Shape<P>::kStageFloats;
  const int tx = threadIdx.x % kSide;
  const int ty = threadIdx.x / kSide;
  const int row0 = blockIdx.y * T;
  const int col0 = blockIdx.x * T;
  float* norm_s = smem + kStages * kStageFloats;   // [0, T) q rows, [T, 2T) x rows
  const int n_stages = (d + kDepth - 1) / kDepth;

  float acc[P][P];
#pragma unroll
  for (int r = 0; r < P; ++r)
#pragma unroll
    for (int c = 0; c < P; ++c) acc[r][c] = 0.0f;
  float nrm = 0.0f;   // squared norm of staged row threadIdx.x (q rows, then x rows)

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_stages) {
      float* st = smem + s * kStageFloats;
      stage_tile<T>(st, q, row0, B, d, s * kDepth, vec4);
      stage_tile<T>(st + T * kLd, x, col0, N, d, s * kDepth, vec4);
    }
    cp_async_commit();
  }

  for (int t = 0; t < n_stages; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();   // stage t has landed; every thread is done with stage t - 1
    {
      const int nxt = t + kStages - 1;
      if (nxt < n_stages) {
        float* st = smem + (nxt % kStages) * kStageFloats;
        stage_tile<T>(st, q, row0, B, d, nxt * kDepth, vec4);
        stage_tile<T>(st + T * kLd, x, col0, N, d, nxt * kDepth, vec4);
      }
      cp_async_commit();
    }
    const float* qs = smem + (t % kStages) * kStageFloats;
    const float* xs = qs + T * kLd;

    if (norms && threadIdx.x < 2 * T) {
      const float* own = (threadIdx.x < T ? qs : xs) + (threadIdx.x % T) * kLd;
#pragma unroll
      for (int k = 0; k < kDepth; k += 4) {
        const float4 v = *reinterpret_cast<const float4*>(own + k);
        nrm = fmaf(v.x, v.x, nrm);
        nrm = fmaf(v.y, v.y, nrm);
        nrm = fmaf(v.z, v.z, nrm);
        nrm = fmaf(v.w, v.w, nrm);
      }
    }

    // only the build's families (p = 1, p = 2) are unrolled across the stage: the others'
    // bodies (a sqrt, or a log and an exp, per term; every family's in a mixed block) stay
    // rolled, since unrolled they take nvcc minutes
    constexpr int kUnroll = (F == kIdentity || F == lp::kL1) ? kDepth / 4 : 1;
#pragma unroll(kUnroll)
    for (int k = 0; k < kDepth; k += 4) {
      float4 xv[P];
#pragma unroll
      for (int c = 0; c < P; ++c)
        xv[c] = *reinterpret_cast<const float4*>(xs + (tx + kSide * c) * kLd + k);
#pragma unroll
      for (int r = 0; r < P; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(qs + (ty + kSide * r) * kLd + k);
        if constexpr (F == kMixed) {
          switch (fam[r]) {
            case kIdentity: row_update<kIdentity, P>(acc[r], qv, xv, pr[r]); break;
            case lp::kL1: row_update<lp::kL1, P>(acc[r], qv, xv, pr[r]); break;
            case lp::kSqrt: row_update<lp::kSqrt, P>(acc[r], qv, xv, pr[r]); break;
            case lp::kL15: row_update<lp::kL15, P>(acc[r], qv, xv, pr[r]); break;
            default: row_update<lp::kGeneral, P>(acc[r], qv, xv, pr[r]); break;
          }
        } else {
          row_update<F, P>(acc[r], qv, xv, pr[0]);
        }
      }
    }
  }
  cp_async_wait<0>();

  if (norms) {
    if (threadIdx.x < 2 * T) norm_s[threadIdx.x] = nrm;   // outside the ring
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < P; ++r) {
    const int row = row0 + ty + kSide * r;
    if (row >= B) continue;
    const bool ident = F == kIdentity || (F == kMixed && fam[r] == kIdentity);
    const float qq = ident ? norm_s[ty + kSide * r] : 0.0f;
#pragma unroll
    for (int c = 0; c < P; ++c) {
      const int col = col0 + tx + kSide * c;
      if (col >= N) continue;
      float v = acc[r][c];
      if (ident) {   // the clamp at 0 is a select: fmaxf would score a NaN row 0
        const float e = (qq + norm_s[T + tx + kSide * c]) - 2.0f * acc[r][c];
        v = e < 0.0f ? 0.0f : e;
      }
      out[static_cast<size_t>(row) * N + col] = v;
    }
  }
}

template <int P>
__global__ void __launch_bounds__(kThreads, 1)
pairwise_lp_kernel(const float* __restrict__ q, const float* __restrict__ x,
                   const float* __restrict__ p, float p_scalar, float* __restrict__ out, int B,
                   int N, int d, bool vec4) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  __shared__ int tile_has_identity;
  __shared__ int tile_mixed;

  const int ty = threadIdx.x / kSide;
  const int row0 = blockIdx.y * Shape<P>::kTile;
  const float p0 = p != nullptr ? p[row0] : p_scalar;   // row0 < B for every block
  if (threadIdx.x == 0) {
    tile_has_identity = 0;
    tile_mixed = 0;
  }
  __syncthreads();
  int fam[P];
  float pr[P];
#pragma unroll
  for (int r = 0; r < P; ++r) {
    const int row = row0 + ty + kSide * r;
    pr[r] = (p != nullptr && row < B) ? p[row] : p0;
    fam[r] = pr[r] == 2.0f ? kIdentity : lp::family_of(pr[r]);
    if (fam[r] == kIdentity) tile_has_identity = 1;   // benign races: all write 1
    if (pr[r] != p0) tile_mixed = 1;
  }
  __syncthreads();
  const bool norms = tile_has_identity != 0;
  if (tile_mixed) {
    tile_loop<kMixed, P>(q, x, fam, pr, out, B, N, d, vec4, norms, smem);
    return;
  }
  switch (fam[0]) {
    case kIdentity: tile_loop<kIdentity, P>(q, x, fam, pr, out, B, N, d, vec4, norms, smem); break;
    case lp::kL1: tile_loop<lp::kL1, P>(q, x, fam, pr, out, B, N, d, vec4, norms, smem); break;
    case lp::kSqrt: tile_loop<lp::kSqrt, P>(q, x, fam, pr, out, B, N, d, vec4, norms, smem); break;
    case lp::kL15: tile_loop<lp::kL15, P>(q, x, fam, pr, out, B, N, d, vec4, norms, smem); break;
    default: tile_loop<lp::kGeneral, P>(q, x, fam, pr, out, B, N, d, vec4, norms, smem); break;
  }
}

int blocks_of(int tile, int B, int N) { return ((N + tile - 1) / tile) * ((B + tile - 1) / tile); }

template <int P>
cudaError_t launch(const float* q, const float* x, const float* p, float p_scalar, float* out,
                   int B, int N, int d, bool vec4, cudaStream_t stream) {
  constexpr int T = Shape<P>::kTile;
  constexpr int smem = Shape<P>::kSmemBytes;
  static bool opted_in = smem <= 48 * 1024;   // once per process, where it is needed
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        pairwise_lp_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  const dim3 grid((N + T - 1) / T, (B + T - 1) / T);
  pairwise_lp_kernel<P><<<grid, kThreads, smem, stream>>>(q, x, p, p_scalar, out, B, N, d, vec4);
  return cudaGetLastError();
}

}  // namespace

// q (B, d) f32, x (N, d) f32, p (B,) f32 or null for the scalar p_scalar -> out (B, N) f32,
// all contiguous on the device. The tile is the largest of 128, 64 and 32 whose grid still
// gives every SM a block. Launches on `stream`; returns cudaGetLastError() (or the error
// of the shared-memory opt-in).
extern "C" int pairwise_lp_launch(const void* q, const void* x, const void* p, float p_scalar,
                                  void* out, int B, int N, int d, void* stream) {
  if (B == 0 || N == 0) return 0;
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      sms = 132;
  }
  const bool vec4 = d % 4 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const auto* q_ = static_cast<const float*>(q);
  const auto* x_ = static_cast<const float*>(x);
  const auto* p_ = static_cast<const float*>(p);
  auto* out_ = static_cast<float*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (blocks_of(Shape<8>::kTile, B, N) >= sms)
    err = launch<8>(q_, x_, p_, p_scalar, out_, B, N, d, vec4, s);
  else if (blocks_of(Shape<4>::kTile, B, N) >= sms)
    err = launch<4>(q_, x_, p_, p_scalar, out_, B, N, d, vec4, s);
  else
    err = launch<2>(q_, x_, p_, p_scalar, out_, B, N, d, vec4, s);
  return static_cast<int>(err);
}
