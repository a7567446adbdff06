// Per-p op sequences shared by the Lp kernels: the CUDA form of the table in
// src/repro_torch/core/lp_ops.py (and src/repro/core/lp_ops.py). Each row
// picks its family from its own p, so a row gives the same bits whether the
// caller passed p as one float or as a per-row vector.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace lp {

constexpr float kEps = 1e-30f;       // guard for log(0), lp_ops.EPS
constexpr float kDeflate = 0.999f;   // 1 - lp_ops.BOUND_SLACK
constexpr int kWarps = 8;            // warps (candidates in flight) per block

enum Family { kL1 = 0, kL2 = 1, kSqrt = 2, kL15 = 3, kGeneral = 4 };

__device__ __forceinline__ int family_of(float p) {
  if (p == 1.0f) return kL1;
  if (p == 2.0f) return kL2;
  if (p == 0.5f) return kSqrt;
  if (p == 1.5f) return kL15;
  return kGeneral;
}

// a^p for a >= 0, cheapest sequence for the family (lp_ops.pow_from_abs). The guard
// for log(0) is a select, not fmaxf, so that a NaN stays NaN as under clamp_min.
template <int F>
__device__ __forceinline__ float pow_from_abs(float a, float p) {
  if (F == kL1) return a;
  if (F == kL2) return a * a;
  if (F == kSqrt) return sqrtf(a);
  if (F == kL15) return a * sqrtf(a);
  return a == 0.0f ? 0.0f : expf(p * logf(a < kEps ? kEps : a));
}

// x^e for x >= 0 via exp(e * log x), x <= 0 -> 0 (lp_ops._safe_pow). The guard is a
// select, as in pow_from_abs: fmaxf(NaN, kEps) would turn a NaN into kEps.
__device__ __forceinline__ float safe_pow(float x, float e) {
  return x <= 0.0f ? 0.0f : expf(e * logf(x < kEps ? kEps : x));
}

// lp_ops.lp_entry_bound for one candidate from its base power sum sb over d dims
// (base_l1: sb holds an L1 sum, else a squared L2 sum); also the suffix bound. A NaN sb
// gives a NaN bound, as under clamp_min, so the candidate dies at entry (NaN <= thr is
// false); hence the select in place of fmaxf, which would make the bound 0.
__device__ __forceinline__ float entry_bound(float sb, bool base_l1, float p, float d) {
  sb = sb < 0.0f ? 0.0f : sb;
  float lb;
  if (base_l1) {
    lb = safe_pow(sb, p);
    if (p > 1.0f) lb = lb * safe_pow(fmaxf(d, 1.0f), 1.0f - p);
  } else {
    lb = safe_pow(sb, p * 0.5f);
  }
  return lb * kDeflate;
}

// Butterfly sum: every lane ends with the same bits (IEEE add commutes).
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Root-free power sum of one row against the query row qs (shared memory), taken by one
// warp: lane j reads elements j, j + 32, ... (as float4 when vec4, i.e. d % 4 == 0 and
// the row 16-byte aligned), then a butterfly sum leaves the total on every lane.
template <int F>
__device__ float row_power_sum(const float* __restrict__ xr, const float* __restrict__ qs,
                               int d, float p, int lane, bool vec4) {
  float acc = 0.0f;
  if (vec4) {
    const float4* x4 = reinterpret_cast<const float4*>(xr);
    const float4* q4 = reinterpret_cast<const float4*>(qs);
    for (int i = lane; i < d / 4; i += 32) {
      const float4 xv = __ldg(x4 + i);
      const float4 qv = q4[i];
      acc += pow_from_abs<F>(fabsf(xv.x - qv.x), p);
      acc += pow_from_abs<F>(fabsf(xv.y - qv.y), p);
      acc += pow_from_abs<F>(fabsf(xv.z - qv.z), p);
      acc += pow_from_abs<F>(fabsf(xv.w - qv.w), p);
    }
  } else {
    for (int i = lane; i < d; i += 32) acc += pow_from_abs<F>(fabsf(__ldg(xr + i) - qs[i]), p);
  }
  return warp_sum(acc);
}

// row_power_sum with the family picked from p: one switch per row, none per element.
__device__ __forceinline__ float row_power_sum_any(const float* __restrict__ xr,
                                                   const float* __restrict__ qs, int d, float p,
                                                   int lane, bool vec4) {
  switch (family_of(p)) {
    case kL1: return row_power_sum<kL1>(xr, qs, d, p, lane, vec4);
    case kL2: return row_power_sum<kL2>(xr, qs, d, p, lane, vec4);
    case kSqrt: return row_power_sum<kSqrt>(xr, qs, d, p, lane, vec4);
    case kL15: return row_power_sum<kL15>(xr, qs, d, p, lane, vec4);
    default: return row_power_sum<kGeneral>(xr, qs, d, p, lane, vec4);
  }
}

}  // namespace lp
