// Root-free Lp power sums of pre-gathered candidate rows:
// out[b, j] = sum_i |q[b, i] - c[b, j, i]|^p[b].
//
// Replaces: src/repro/kernels/lp_distance.py:rowwise_lp_kernel_call (:240), the Pallas
// kernels _rowwise_l2_kernel (:195, p = 2 on the product |q|^2 + |c|^2 - 2 q.c),
// _rowwise_vpu_kernel (:212, a diff block per query row) and _rowwise_vec_kernel (:225,
// per-row p). It is reached through kernels.ops.lp_rowwise_distance, the counterpart of
// repro.kernels.ops.pallas_rowwise_lp.
//
// Bound on the H100: bytes. Every candidate row is its own (B, C, d) slab of C, read once
// and used once: at B = 256, C = 300, d = 512 that is 157 MB, about 0.047 ms at 3.35 TB/s.
// Under general p the first design's accurate power, expf(p * logf(a)) (lp_common.cuh), is
// some 35-45 float32 instructions an element, about 0.05 ms for those 39.3 M elements on
// 132 SMs: above the byte bound, so the first design stopped at 0.083 ms on the device.
//
// Design:
//  - one block per (query row, 8 warps' candidates); each warp takes one candidate row,
//    reads it once with 16-byte loads (lane j: float4 j, j + 32, ...; the loop unrolled so
//    that a lane's loads are in flight together) and reduces over d with a butterfly. The
//    query row's float4s come through the L1 cache (the block's warps read the same row),
//    so no block barrier stands before the loads;
//  - p = 1, 2, 0.5 and 1.5 take lp_common.cuh's sequences, so their sums keep the first
//    design's bits (the same order of additions). p = 2 sums the squared differences
//    directly, with no product identity (which cancels when q and c are close) and no TF32;
//  - general p computes a^p as 2^(p log2 a) on the special function unit (lg2.approx.f32,
//    ex2.approx.f32: two of its 16 operations a clock an SM, about 0.02 ms for the 39.3 M
//    elements, below the byte bound), with lp_common.cuh's guards as selects (a < 1e-30
//    takes the log of 1e-30, a == 0 gives 0, a NaN stays NaN). Each term is within about
//    2^-21 of the accurate power, well inside the 1e-5 relative tolerance on the sums;
//    the other kernels keep the accurate power and their bits;
//  - p is a kernel argument when the caller passes one p, a (B,) pointer otherwise; the
//    family is chosen once per row, so a row has the same bits under either.
// Timed on the card and dropped: two candidate rows a warp (both rows' loads in flight),
// no faster than one at any p.
#include <stdint.h>

#include "lp_common.cuh"

namespace {

constexpr int kWarps = 8;

// a^p for a >= 0 on the special function unit: 2^(p * log2 a).
__device__ __forceinline__ float pow_sfu(float a, float p) {
  float l2;
  float r;
  const float x = a < lp::kEps ? lp::kEps : a;
  asm("lg2.approx.f32 %0, %1;" : "=f"(l2) : "f"(x));
  asm("ex2.approx.f32 %0, %1;" : "=f"(r) : "f"(p * l2));
  return a == 0.0f ? 0.0f : r;
}

template <int F>
__device__ __forceinline__ float term(float a, float p) {
  if constexpr (F == lp::kGeneral) {
    return pow_sfu(a, p);
  } else {
    return lp::pow_from_abs<F>(a, p);
  }
}

// Power sum of one candidate row xr (d floats) against the query row q, taken by one warp;
// every lane ends with the sum.
template <int F>
__device__ __forceinline__ float row_power_sum(const float* __restrict__ xr,
                                               const float* __restrict__ q, int d, float p,
                                               int lane, bool vec4) {
  float acc = 0.0f;
  if (vec4) {
    const float4* q4 = reinterpret_cast<const float4*>(q);
    const float4* x4 = reinterpret_cast<const float4*>(xr);
    // unrolled: a lane's float4 loads of a row are in flight together (d = 512: all four)
#pragma unroll 4
    for (int i = lane; i < d / 4; i += 32) {
      const float4 qv = __ldg(q4 + i);
      const float4 xv = __ldg(x4 + i);
      acc += term<F>(fabsf(xv.x - qv.x), p);
      acc += term<F>(fabsf(xv.y - qv.y), p);
      acc += term<F>(fabsf(xv.z - qv.z), p);
      acc += term<F>(fabsf(xv.w - qv.w), p);
    }
  } else {
    for (int i = lane; i < d; i += 32) acc += term<F>(fabsf(__ldg(xr + i) - __ldg(q + i)), p);
  }
  return lp::warp_sum(acc);
}

__global__ void __launch_bounds__(kWarps * 32)
rowwise_lp_kernel(const float* __restrict__ q, const float* __restrict__ c,
                  const float* __restrict__ p, float p_scalar, float* __restrict__ out, int C,
                  int d, bool vec4) {
  const int b = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int j = blockIdx.y * kWarps + warp;
  if (j >= C) return;
  const float pr = p != nullptr ? p[b] : p_scalar;
  const float* qrow = q + static_cast<size_t>(b) * d;
  const size_t slot = static_cast<size_t>(b) * C + j;
  const float* xr = c + slot * d;
  float res;
  switch (lp::family_of(pr)) {
    case lp::kL1: res = row_power_sum<lp::kL1>(xr, qrow, d, pr, lane, vec4); break;
    case lp::kL2: res = row_power_sum<lp::kL2>(xr, qrow, d, pr, lane, vec4); break;
    case lp::kSqrt: res = row_power_sum<lp::kSqrt>(xr, qrow, d, pr, lane, vec4); break;
    case lp::kL15: res = row_power_sum<lp::kL15>(xr, qrow, d, pr, lane, vec4); break;
    default: res = row_power_sum<lp::kGeneral>(xr, qrow, d, pr, lane, vec4); break;
  }
  if (lane == 0) out[slot] = res;
}

}  // namespace

// The arguments come packed in one int64 array: a[0] q (B, d) f32; a[1] c (B, C, d) f32;
// a[2] p (B,) f32 or 0 for the scalar p_scalar; a[3] out (B, C) f32, all contiguous on the
// device; a[4..6] B, C, d; a[7] the stream.
// Launches on the stream; returns cudaGetLastError().
extern "C" int rowwise_lp_launch(const long long* a, float p_scalar) {
  const auto* q = reinterpret_cast<const float*>(a[0]);
  const auto* c = reinterpret_cast<const float*>(a[1]);
  const auto* p = reinterpret_cast<const float*>(a[2]);
  auto* out = reinterpret_cast<float*>(a[3]);
  const int B = static_cast<int>(a[4]);
  const int C = static_cast<int>(a[5]);
  const int d = static_cast<int>(a[6]);
  const auto stream = reinterpret_cast<cudaStream_t>(a[7]);
  if (B == 0 || C == 0) return 0;
  const bool vec4 = (d % 4 == 0) && (reinterpret_cast<uintptr_t>(c) % 16 == 0) &&
                    (reinterpret_cast<uintptr_t>(q) % 16 == 0);
  const dim3 grid(B, (C + kWarps - 1) / kWarps);
  rowwise_lp_kernel<<<grid, kWarps * 32, 0, stream>>>(q, c, p, p_scalar, out, C, d, vec4);
  return static_cast<int>(cudaGetLastError());
}
