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
// Bound on the H100: operations. Each output costs d elementwise steps (3 to 6 float32
// operations, two transcendentals for general p), and every input row is reused across a
// whole tile of the other operand, so at the build's shapes (a few thousand rows of
// d = 512) the float32 units, not the 3.35 TB/s of memory, are the limit. p = 2 is a
// product, which the reference left to the TPU's matrix unit; here it stays on plain
// float32 FMAs: no tensor cores and no TF32, since the build's L2 pools depend on the
// order of near-tied distances.
//
// Design, simple first: one block of 16 x 16 threads computes a 64 x 64 output tile;
// the block stages a 64 x 16 slice of Q and of X in shared memory, transposed so that a
// thread reads its 4 rows and its 4 columns as float4, and each thread keeps a 4 x 4
// register tile. Each of a thread's rows picks its p family once per slice, so a per-row
// p costs a switch per row and slice, not per element. Rows on the identity accumulate
// q.x, and the squared norms ride along in the same pass when the tile holds such a row.
// wgmma and TMA are later work.
#include <stdint.h>

#include "lp_common.cuh"

namespace {

constexpr int kTile = 64;            // output rows and columns per block
constexpr int kDepth = 16;           // dimensions per shared-memory slice
constexpr int kPer = 4;              // rows and columns per thread
constexpr int kThreads = (kTile / kPer) * (kTile / kPer);
constexpr int kIdentity = -1;        // family tag of a p = 2 row (product identity)

template <int F>
__device__ __forceinline__ void slice_rows(float (&acc)[kPer], const float (&xv)[kDepth][kPer],
                                           const float* qcol, float p) {
  // qcol[k * (kTile + kPer)] is this row's q at dimension k of the slice
#pragma unroll
  for (int k = 0; k < kDepth; ++k) {
    const float q = qcol[k * (kTile + kPer)];
#pragma unroll
    for (int c = 0; c < kPer; ++c) acc[c] += lp::pow_from_abs<F>(fabsf(q - xv[k][c]), p);
  }
}

__global__ void __launch_bounds__(kThreads)
pairwise_lp_kernel(const float* __restrict__ q, const float* __restrict__ x,
                   const float* __restrict__ p, float* __restrict__ out, int B, int N, int d) {
  __shared__ __align__(16) float qs[kDepth][kTile + kPer];
  __shared__ __align__(16) float xs[kDepth][kTile + kPer];
  __shared__ int tile_has_identity;

  const int tx = threadIdx.x % (kTile / kPer);   // column group
  const int ty = threadIdx.x / (kTile / kPer);   // row group
  const int row0 = blockIdx.y * kTile;
  const int col0 = blockIdx.x * kTile;

  if (threadIdx.x == 0) tile_has_identity = 0;
  __syncthreads();
  int fam[kPer];
  float pr[kPer];
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    const int row = row0 + ty * kPer + r;
    pr[r] = row < B ? p[row] : 1.0f;
    fam[r] = pr[r] == 2.0f ? kIdentity : lp::family_of(pr[r]);
    if (fam[r] == kIdentity) tile_has_identity = 1;   // benign race: all write 1
  }
  __syncthreads();
  const bool norms = tile_has_identity != 0;

  float acc[kPer][kPer] = {};
  float qq[kPer] = {};
  float xx[kPer] = {};

  for (int k0 = 0; k0 < d; k0 += kDepth) {
    // stage the slice: element i of the 64 x 16 tile is (row i / 16, dim i % 16);
    // out-of-range rows and dimensions load 0, which adds 0 to every family's sum
    for (int i = threadIdx.x; i < kTile * kDepth; i += kThreads) {
      const int r = i / kDepth;
      const int k = i % kDepth;
      const int kk = k0 + k;
      const int qr = row0 + r;
      const int xr = col0 + r;
      qs[k][r] = (qr < B && kk < d) ? q[static_cast<size_t>(qr) * d + kk] : 0.0f;
      xs[k][r] = (xr < N && kk < d) ? x[static_cast<size_t>(xr) * d + kk] : 0.0f;
    }
    __syncthreads();

    float xv[kDepth][kPer];
#pragma unroll
    for (int k = 0; k < kDepth; ++k) {
      const float4 v = *reinterpret_cast<const float4*>(&xs[k][tx * kPer]);
      xv[k][0] = v.x;
      xv[k][1] = v.y;
      xv[k][2] = v.z;
      xv[k][3] = v.w;
    }
    if (norms) {
#pragma unroll
      for (int k = 0; k < kDepth; ++k)
#pragma unroll
        for (int c = 0; c < kPer; ++c) xx[c] = fmaf(xv[k][c], xv[k][c], xx[c]);
    }
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      const float* qcol = &qs[0][ty * kPer + r];
      switch (fam[r]) {
        case kIdentity:
#pragma unroll
          for (int k = 0; k < kDepth; ++k) {
            const float qv = qcol[k * (kTile + kPer)];
            qq[r] = fmaf(qv, qv, qq[r]);
#pragma unroll
            for (int c = 0; c < kPer; ++c) acc[r][c] = fmaf(qv, xv[k][c], acc[r][c]);
          }
          break;
        case lp::kL1: slice_rows<lp::kL1>(acc[r], xv, qcol, pr[r]); break;
        case lp::kSqrt: slice_rows<lp::kSqrt>(acc[r], xv, qcol, pr[r]); break;
        case lp::kL15: slice_rows<lp::kL15>(acc[r], xv, qcol, pr[r]); break;
        default: slice_rows<lp::kGeneral>(acc[r], xv, qcol, pr[r]); break;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    const int row = row0 + ty * kPer + r;
    if (row >= B) continue;
#pragma unroll
    for (int c = 0; c < kPer; ++c) {
      const int col = col0 + tx * kPer + c;
      if (col >= N) continue;
      const float v = fam[r] == kIdentity
                          ? fmaxf((qq[r] + xx[c]) - 2.0f * acc[r][c], 0.0f)
                          : acc[r][c];
      out[static_cast<size_t>(row) * N + col] = v;
    }
  }
}

}  // namespace

// q (B, d) f32, x (N, d) f32, p (B,) f32 -> out (B, N) f32, all contiguous on the device.
// Launches on `stream`; returns cudaGetLastError().
extern "C" int pairwise_lp_launch(const void* q, const void* x, const void* p, void* out,
                                  int B, int N, int d, void* stream) {
  if (B == 0 || N == 0) return 0;
  const dim3 grid((N + kTile - 1) / kTile, (B + kTile - 1) / kTile);
  pairwise_lp_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(x), static_cast<const float*>(p),
      static_cast<float*>(out), B, N, d);
  return static_cast<int>(cudaGetLastError());
}
