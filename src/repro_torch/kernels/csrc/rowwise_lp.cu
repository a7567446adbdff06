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
// and used once: at B = 256, C = 300, d = 512 that is 157 MB, about 0.047 ms at 3.35 TB/s,
// against 3 to 6 float32 operations per 4-byte element (two transcendentals for general
// p), below the ~20 operations per byte at which the float32 units would be the limit.
//
// Design, simple first: gather_lp's, without the gather. One block per (query row, 8
// candidates); the block stages the query row in shared memory and each warp takes one
// candidate row, reads it once with coalesced 16-byte loads and reduces over d with warp
// shuffles. The p family is chosen once per row. p = 2 sums the squared differences
// directly, with no product identity (which cancels when q and c are close) and no TF32.
#include <stdint.h>

#include "lp_common.cuh"

namespace {

__global__ void __launch_bounds__(lp::kWarps * 32)
rowwise_lp_kernel(const float* __restrict__ q, const float* __restrict__ c,
                  const float* __restrict__ p, float* __restrict__ out, int C, int d,
                  bool vec4) {
  extern __shared__ float4 q_smem4[];
  float* qs = reinterpret_cast<float*>(q_smem4);
  const int b = blockIdx.x;
  const float* qrow = q + static_cast<size_t>(b) * d;
  for (int i = threadIdx.x; i < d; i += blockDim.x) qs[i] = qrow[i];
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int j = blockIdx.y * lp::kWarps + warp;
  if (j >= C) return;
  const size_t slot = static_cast<size_t>(b) * C + j;
  const float result = lp::row_power_sum_any(c + slot * d, qs, d, p[b], lane, vec4);
  if (lane == 0) out[slot] = result;
}

}  // namespace

// q (B, d) f32, c (B, C, d) f32, p (B,) f32 -> out (B, C) f32, all contiguous on the
// device. Launches on `stream`; returns cudaGetLastError().
extern "C" int rowwise_lp_launch(const void* q, const void* c, const void* p, void* out,
                                 int B, int C, int d, void* stream) {
  if (B == 0 || C == 0) return 0;
  const size_t smem = static_cast<size_t>(d) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        rowwise_lp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const bool vec4 = (d % 4 == 0) && (reinterpret_cast<uintptr_t>(c) % 16 == 0);
  const dim3 grid(B, (C + lp::kWarps - 1) / lp::kWarps);
  rowwise_lp_kernel<<<grid, lp::kWarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(c), static_cast<const float*>(p),
      static_cast<float*>(out), C, d, vec4);
  return static_cast<int>(cudaGetLastError());
}
