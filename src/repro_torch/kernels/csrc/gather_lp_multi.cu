// Fused gather + root-free Lp power sums under up to two metrics from one read of each row:
// out[i, b, c] = sum_j |q[b, j] - x[ids[b, c], j]|^p_i, +inf where ids[b, c] lies outside
// [0, n), for p_0 and (when given) p_1.
//
// Replaces: src/repro/kernels/lp_distance.py:gather_lp_kernel_call (:384), at the shape the
// shared-pass bulk build calls it: repro.core.bulk_build scores each NN-Descent candidate
// block once per metric (L1 and L2) through that kernel. This is the same function for two
// static p at once; `gather_lp.cu` keeps the single-p form for the query path and the
// delta tier, and this kernel's per-row arithmetic is that kernel's, so each output keeps
// its bits.
//
// Bound on the H100: bytes. At the build's shape (78,306 nodes x 448 candidates x 512
// dims, the rows 160 MB in all) a kernel that reads every named row from device memory
// moves 72 GB per metric. The work needed is far less: the two metrics read the same rows,
// a node's block names the same id 1.5 times on average (forward pools, reverse edges and
// two-hop samples overlap), and the whole corpus is named by every 32 nodes or so.
//
// Design:
//  - one read for both metrics: a warp reads a gathered row once, in gather_lp.cu's lane
//    layout (lane j takes float4 j, j + 32, ...), and keeps one sum per p in registers;
//    each sum ends in the same butterfly, so it has the single-p kernel's bits;
//  - no second read of a duplicate: the wrapper hands each row's ids sorted (`sids`), with
//    the slot each sorted position came from (`perm`). A warp walks a row's sorted ids 32
//    at a time, marks the heads of runs of equal ids with a ballot, scores each head's row
//    once and writes its sums to every slot of the run through `perm`, so the output is in
//    the caller's slot order. A run that crosses a 32-position boundary is scored once
//    more (about one row in a hundred);
//  - rows kept in L2: the corpus is cut into slabs of `slab_rows` rows (sized to the 50 MB
//    L2), the slab is the slowest grid dimension, and the wrapper gives each row's span of
//    sorted positions inside each slab (`off`). The blocks in flight at one moment then
//    read one slab's rows, which stay in L2 while every node scores its candidates in that
//    slab; each node's own row is re-read once per slab, with streaming loads that do not
//    displace the slab. One slab (off == nullptr) is the sort and the duplicate skip alone;
//  - one warp per (node, slab), eight nodes of one slab per block; the warp stages its
//    node's row in shared memory and needs no block-wide barrier.
#include <stdint.h>

#include "lp_common.cuh"

namespace {

constexpr int kNone = -1;   // no second metric

// One row's power sums under the families F0 and F1 (kNone: F0 alone), read once.
template <int F0, int F1>
__device__ __forceinline__ void row_power_sums(const float* __restrict__ xr,
                                               const float* __restrict__ qs, int d, float p0,
                                               float p1, int lane, bool vec4, float& s0,
                                               float& s1) {
  float acc0 = 0.0f;
  float acc1 = 0.0f;
  if (vec4) {
    const float4* x4 = reinterpret_cast<const float4*>(xr);
    const float4* q4 = reinterpret_cast<const float4*>(qs);
    for (int i = lane; i < d / 4; i += 32) {
      const float4 xv = __ldg(x4 + i);
      const float4 qv = q4[i];
      const float a[4] = {fabsf(xv.x - qv.x), fabsf(xv.y - qv.y), fabsf(xv.z - qv.z),
                          fabsf(xv.w - qv.w)};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc0 += lp::pow_from_abs<F0>(a[e], p0);
        if constexpr (F1 != kNone) acc1 += lp::pow_from_abs<F1 == kNone ? 0 : F1>(a[e], p1);
      }
    }
  } else {
    for (int i = lane; i < d; i += 32) {
      const float a = fabsf(__ldg(xr + i) - qs[i]);
      acc0 += lp::pow_from_abs<F0>(a, p0);
      if constexpr (F1 != kNone) acc1 += lp::pow_from_abs<F1 == kNone ? 0 : F1>(a, p1);
    }
  }
  s0 = lp::warp_sum(acc0);
  s1 = F1 != kNone ? lp::warp_sum(acc1) : 0.0f;
}

template <int F0, int F1>
__global__ void __launch_bounds__(lp::kWarps * 32)
gather_lp_multi_kernel(const int* __restrict__ sids, const long long* __restrict__ perm,
                       const int* __restrict__ off, const float* __restrict__ q,
                       const float* __restrict__ x, float* __restrict__ out, int B, int C,
                       int n, int d, int S, float p0, float p1, bool vec4, bool q_vec4) {
  extern __shared__ float4 q_smem4[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * lp::kWarps + warp;
  if (b >= B) return;
  int lo = 0;
  int hi = C;
  if (off != nullptr) {
    const int* ob = off + static_cast<size_t>(b) * (S + 1) + blockIdx.y;
    lo = ob[0];
    hi = ob[1];
  }
  if (lo >= hi) return;
  const int dpad = (d + 3) & ~3;
  float* qs = reinterpret_cast<float*>(q_smem4) + warp * dpad;
  const float* qrow = q + static_cast<size_t>(b) * d;
  if (q_vec4) {
    for (int i = lane; i < d / 4; i += 32)
      reinterpret_cast<float4*>(qs)[i] = __ldcs(reinterpret_cast<const float4*>(qrow) + i);
  } else {
    for (int i = lane; i < d; i += 32) qs[i] = __ldcs(qrow + i);
  }
  __syncwarp();

  const size_t row0 = static_cast<size_t>(b) * C;
  const size_t plane = static_cast<size_t>(B) * C;
  for (int base = lo; base < hi; base += 32) {
    const int pos = base + lane;
    const bool in = pos < hi;
    const int id = in ? sids[row0 + pos] : 0;
    const long long slot = in ? perm[row0 + pos] : 0;
    const int prev = __shfl_up_sync(0xffffffffu, id, 1);
    unsigned heads = __ballot_sync(0xffffffffu, in && (lane == 0 || id != prev));
    while (heads != 0u) {
      const int h = __ffs(heads) - 1;
      heads &= heads - 1u;
      const int next = heads != 0u ? __ffs(heads) - 1 : 32;
      const int hid = __shfl_sync(0xffffffffu, id, h);
      float s0 = INFINITY;
      float s1 = INFINITY;
      if (hid >= 0 && hid < n)
        row_power_sums<F0, F1>(x + static_cast<size_t>(hid) * d, qs, d, p0, p1, lane, vec4,
                               s0, s1);
      if (in && lane >= h && lane < next) {
        out[row0 + slot] = s0;
        if constexpr (F1 != kNone) out[plane + row0 + slot] = s1;
      }
    }
  }
}

using Kernel = void (*)(const int*, const long long*, const int*, const float*, const float*,
                        float*, int, int, int, int, int, float, float, bool, bool);

template <int F0>
Kernel pick_second(int f1) {
  switch (f1) {
    case lp::kL1: return gather_lp_multi_kernel<F0, lp::kL1>;
    case lp::kL2: return gather_lp_multi_kernel<F0, lp::kL2>;
    case lp::kSqrt: return gather_lp_multi_kernel<F0, lp::kSqrt>;
    case lp::kL15: return gather_lp_multi_kernel<F0, lp::kL15>;
    case lp::kGeneral: return gather_lp_multi_kernel<F0, lp::kGeneral>;
    default: return gather_lp_multi_kernel<F0, kNone>;
  }
}

int host_family(float p) {
  if (p == 1.0f) return lp::kL1;
  if (p == 2.0f) return lp::kL2;
  if (p == 0.5f) return lp::kSqrt;
  if (p == 1.5f) return lp::kL15;
  return lp::kGeneral;
}

Kernel pick(int f0, int f1) {
  switch (f0) {
    case lp::kL1: return pick_second<lp::kL1>(f1);
    case lp::kL2: return pick_second<lp::kL2>(f1);
    case lp::kSqrt: return pick_second<lp::kSqrt>(f1);
    case lp::kL15: return pick_second<lp::kL15>(f1);
    default: return pick_second<lp::kGeneral>(f1);
  }
}

}  // namespace

// The arguments come packed in one int64 array:
//   a[0] sids (B, C) int32, each row's ids sorted ascending; a[1] perm (B, C) int64, the
//   slot each sorted position came from; a[2] off (B, S + 1) int32, each row's span of
//   sorted positions in each slab (off[b, s] .. off[b, s + 1]; the first span starts at
//   0 and the last ends at C, so the padding ids go with them), or 0 for one slab;
//   a[3] q (B, d) f32; a[4] x (n, d) f32; a[5] out (P, B, C) f32, all contiguous on the
//   device; a[6..9] B, C, n, d; a[10] S, the number of slabs; a[11] P, 1 or 2; a[12] the
//   stream. p0 and p1 are the metrics (p1 unused when P = 1).
// Launches on the stream; returns cudaGetLastError(), or cudaErrorInvalidValue for P
// outside {1, 2}.
extern "C" int gather_lp_multi_launch(const long long* a, float p0, float p1) {
  const auto* sids = reinterpret_cast<const int*>(a[0]);
  const auto* perm = reinterpret_cast<const long long*>(a[1]);
  const auto* off = reinterpret_cast<const int*>(a[2]);
  const auto* q = reinterpret_cast<const float*>(a[3]);
  const auto* x = reinterpret_cast<const float*>(a[4]);
  auto* out = reinterpret_cast<float*>(a[5]);
  const int B = static_cast<int>(a[6]);
  const int C = static_cast<int>(a[7]);
  const int n = static_cast<int>(a[8]);
  const int d = static_cast<int>(a[9]);
  const int S = static_cast<int>(a[10]);
  const int P = static_cast<int>(a[11]);
  const auto stream = reinterpret_cast<cudaStream_t>(a[12]);
  if (P < 1 || P > 2 || S < 1 || (S > 1 && off == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || C == 0) return 0;
  const Kernel kernel = pick(host_family(p0), P == 2 ? host_family(p1) : kNone);
  const size_t smem = static_cast<size_t>(lp::kWarps) * ((d + 3) & ~3) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // vec4 as gather_lp.cu decides it (it sets the order of the sums); the node row is
  // staged with 16-byte loads only where its own alignment allows
  const bool vec4 = (d % 4 == 0) && (reinterpret_cast<uintptr_t>(x) % 16 == 0);
  const bool q_vec4 = (d % 4 == 0) && (reinterpret_cast<uintptr_t>(q) % 16 == 0);
  const dim3 grid((B + lp::kWarps - 1) / lp::kWarps, S);
  kernel<<<grid, lp::kWarps * 32, smem, stream>>>(sids, perm, S > 1 ? off : nullptr, q, x,
                                                  out, B, C, n, d, S, p0, p1, vec4, q_vec4);
  return static_cast<int>(cudaGetLastError());
}
