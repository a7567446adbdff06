// Fused gather + root-free Lp power sums: out[b, c] = sum_j |q[b, j] - x[ids[b, c], j]|^p[b],
// +inf where ids[b, c] lies outside [0, n).
//
// Replaces: src/repro/kernels/lp_distance.py:gather_lp_kernel_call (:384), the Pallas
// kernels _gather_lp_kernel / _gather_lp_vec_kernel. It scores the first k candidates
// of every query in the early-abandoning verification (repro_torch.core.uhnsw).
//
// Bound on the H100: bytes. Each valid candidate costs one gathered row of X
// (4*d bytes, 2 KB at d = 512). The cheap families (p in {1, 2, 0.5, 1.5}) do a few
// operations per 4-byte element, far below the ~20 operations per byte (67 TFLOP/s over
// 3.35 TB/s) at which the float32 units would be the limit; general p adds an accurate
// expf and logf per element, which brings it closer to that line.
//
// Design, simple first: one block per (query row, 8 candidates); the block stages the
// query row in shared memory, and each warp takes one candidate, reads its row with
// coalesced 16-byte loads and reduces over d with warp shuffles. The p family is chosen
// once per row, outside the inner loop. There is no product and no TF32: p = 2 is a plain
// sum of squares. Making it fast (several candidates per warp, rows kept in flight with
// cp.async) is later work; at the query path's shapes (B = 256, C = 10) the launch
// itself is a large share of the time.
#include <stdint.h>

#include "lp_common.cuh"

namespace {

__global__ void __launch_bounds__(lp::kWarps * 32)
gather_lp_kernel(const int* __restrict__ ids, const float* __restrict__ q,
                 const float* __restrict__ x, const float* __restrict__ p,
                 float* __restrict__ out, int C, int n, int d, bool vec4) {
  extern __shared__ float4 q_smem4[];
  float* qs = reinterpret_cast<float*>(q_smem4);
  const int b = blockIdx.x;
  const float* qrow = q + static_cast<size_t>(b) * d;
  for (int i = threadIdx.x; i < d; i += blockDim.x) qs[i] = qrow[i];
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.y * lp::kWarps + warp;
  if (c >= C) return;
  const size_t slot = static_cast<size_t>(b) * C + c;
  const int id = ids[slot];
  float result = INFINITY;
  if (id >= 0 && id < n) {
    const float* xr = x + static_cast<size_t>(id) * d;
    result = lp::row_power_sum_any(xr, qs, d, p[b], lane, vec4);
  }
  if (lane == 0) out[slot] = result;
}

}  // namespace

// ids (B, C) int32, q (B, d) f32, x (n, d) f32, p (B,) f32 -> out (B, C) f32, all
// contiguous on the device. Launches on `stream`; returns cudaGetLastError().
extern "C" int gather_lp_launch(const void* ids, const void* q, const void* x, const void* p,
                                void* out, int B, int C, int n, int d, void* stream) {
  if (B == 0 || C == 0) return 0;
  const size_t smem = static_cast<size_t>(d) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        gather_lp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const bool vec4 = (d % 4 == 0) && (reinterpret_cast<uintptr_t>(x) % 16 == 0);
  const dim3 grid(B, (C + lp::kWarps - 1) / lp::kWarps);
  gather_lp_kernel<<<grid, lp::kWarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ids), static_cast<const float*>(q), static_cast<const float*>(x),
      static_cast<const float*>(p), static_cast<float*>(out), C, n, d, vec4);
  return static_cast<int>(cudaGetLastError());
}
