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
// itself is a large share of the time, so the launch is kept light: the arguments come
// packed in one array, and a scalar p goes in as an argument instead of a (B,) tensor.
// The build's scoring pass, which scores one id block under two metrics, has its own
// kernel (gather_lp_multi.cu) with this kernel's per-row arithmetic.
#include <stdint.h>

#include "lp_common.cuh"

namespace {

__global__ void __launch_bounds__(lp::kWarps * 32)
gather_lp_kernel(const int* __restrict__ ids, const float* __restrict__ q,
                 const float* __restrict__ x, const float* __restrict__ p, float p_scalar,
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
    result = lp::row_power_sum_any(xr, qs, d, p ? p[b] : p_scalar, lane, vec4);
  }
  if (lane == 0) out[slot] = result;
}

}  // namespace

// The arguments come packed in one int64 array (one ctypes argument instead of ten):
//   a[0] ids (B, C) int32; a[1] q (B, d) f32; a[2] x (n, d) f32; a[3] p (B,) f32, or 0
//   for the scalar p_scalar; a[4] out (B, C) f32, all contiguous on the device;
//   a[5..8] B, C, n, d; a[9] the stream.
// Launches on the stream; returns cudaGetLastError().
extern "C" int gather_lp_launch(const long long* a, float p_scalar) {
  const auto* ids = reinterpret_cast<const int*>(a[0]);
  const auto* q = reinterpret_cast<const float*>(a[1]);
  const auto* x = reinterpret_cast<const float*>(a[2]);
  const auto* p = reinterpret_cast<const float*>(a[3]);
  auto* out = reinterpret_cast<float*>(a[4]);
  const int B = static_cast<int>(a[5]);
  const int C = static_cast<int>(a[6]);
  const int n = static_cast<int>(a[7]);
  const int d = static_cast<int>(a[8]);
  const auto stream = reinterpret_cast<cudaStream_t>(a[9]);
  if (B == 0 || C == 0) return 0;
  const size_t smem = static_cast<size_t>(d) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        gather_lp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const bool vec4 = (d % 4 == 0) && (reinterpret_cast<uintptr_t>(x) % 16 == 0);
  const dim3 grid(B, (C + lp::kWarps - 1) / lp::kWarps);
  gather_lp_kernel<<<grid, lp::kWarps * 32, smem, stream>>>(ids, q, x, p, p_scalar, out, C, n,
                                                            d, vec4);
  return static_cast<int>(cudaGetLastError());
}
