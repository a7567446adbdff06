// Compressed-band screen (DESIGN.md §10): fused gather of int8 band rows + a blocked
// certified lower bound on the Lp power sum. For each candidate of query b, with band row
// codes[ids[b, c]], dequantised x^_j = codes_j * scale_j and per-coordinate radius r_j:
//   lower terms  max(|q_j - x^_j| - r_j, 0)^p       (s, accumulated per dimension block)
//   upper terms  |q_j - x^_j| + r_j                  (sbase, in the base metric)
//   dies at entry if   entry_bound(sb) > thr
//   after each block   s * (1 - slack) > thr   or   (s + suffix_bound(sb - sbase)) * (1 - slack) > thr
// keep = 1 for candidates alive after the last block (their f32 rows are then rescored
// exactly), 0 for dead and padding ones; nd = the band dimensions scanned while alive.
//
// Replaces: src/repro/kernels/lp_distance.py:gather_lp_screen_kernel_call (:761), the Pallas
// kernels _gather_screen_kernel (:717) and _gather_screen_vec_kernel (:738), row logic
// _screen_row (:662). It screens every kappa batch of the two-band verification
// (repro_torch.core.uhnsw, UHNSWParams.compressed_band).
//
// Bound on the H100: bytes, and only the bytes of the blocks scanned: one byte per scanned
// dimension of a candidate's band row (a quarter of the f32 row that gather_lp_abandon
// reads), and nothing at all for a frozen query row (threshold -inf).
//
// Design, gather_lp_abandon's: one block per (query row, 8 candidates), with the query row,
// the scales and the radii in shared memory; each warp walks one candidate's dimension
// blocks, lane j reading byte j of the block (a coalesced 32-byte read for block_d = 32),
// and reduces the block's two sums with butterfly shuffles, which leave the same bits on
// every lane, so the kill test is uniform across the warp. The dequantisation is rounded
// before the subtraction (__fmul_rn), as the band's radii were measured on that value.
#include <stdint.h>

#include "lp_common.cuh"

namespace {

// Screens one candidate that passed the entry test; returns 1 if it survives.
template <int F>
__device__ int screen_candidate(const int8_t* __restrict__ xr, const float* __restrict__ qs,
                                const float* __restrict__ scs, const float* __restrict__ rad,
                                int d, int block_d, float p, bool base_l1, float thr, float sb,
                                int lane, int* nd) {
  float s = 0.0f;
  float sbase = 0.0f;
  for (int start = 0; start < d; start += block_d) {
    float v = 0.0f;
    float bb = 0.0f;
    for (int i = start + lane; i < start + block_d; i += 32) {
      const float xh = __fmul_rn(static_cast<float>(__ldg(xr + i)), scs[i]);
      const float a0 = fabsf(xh - qs[i]);
      const float al = fmaxf(a0 - rad[i], 0.0f);
      const float au = a0 + rad[i];
      v += lp::pow_from_abs<F>(al, p);
      bb += base_l1 ? au : au * au;
    }
    s += lp::warp_sum(v);
    sbase += lp::warp_sum(bb);
    *nd += block_d;
    const int d_rem = d - (start + block_d);
    bool dead = s * lp::kDeflate > thr;
    if (!dead && d_rem > 0)
      dead = (s + lp::entry_bound(sb - sbase, base_l1, p, static_cast<float>(d_rem))) *
                 lp::kDeflate > thr;
    if (dead) return 0;
  }
  return 1;
}

__global__ void __launch_bounds__(lp::kWarps * 32)
gather_lp_screen_kernel(const int* __restrict__ ids, const float* __restrict__ q,
                        const float* __restrict__ thresh, const float* __restrict__ sb,
                        const int8_t* __restrict__ codes, const float* __restrict__ scale,
                        const float* __restrict__ radius, const float* __restrict__ p,
                        int* __restrict__ keep_out, int* __restrict__ nd_out, int C, int n,
                        int d, int block_d, bool base_l1) {
  extern __shared__ float smem[];
  float* qs = smem;
  float* scs = smem + d;
  float* rad = smem + 2 * d;
  const int b = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.y * lp::kWarps + warp;
  const size_t slot = static_cast<size_t>(b) * C + c;
  const float thr = thresh[b];
  if (thr == -INFINITY) {  // frozen row: every candidate dies at entry, nothing is loaded
    if (c < C && lane == 0) {
      keep_out[slot] = 0;
      nd_out[slot] = 0;
    }
    return;
  }
  const float* qrow = q + static_cast<size_t>(b) * d;
  for (int i = threadIdx.x; i < d; i += blockDim.x) {
    qs[i] = qrow[i];
    scs[i] = scale[i];
    rad[i] = radius[i];
  }
  __syncthreads();
  if (c >= C) return;

  const int id = ids[slot];
  const float pr = p[b];
  const float sbv = sb[slot];
  int keep = 0;
  int nd = 0;
  if (id >= 0 && id < n && lp::entry_bound(sbv, base_l1, pr, static_cast<float>(d)) <= thr) {
    const int8_t* xr = codes + static_cast<size_t>(id) * d;
    switch (lp::family_of(pr)) {
      case lp::kL1:
        keep = screen_candidate<lp::kL1>(xr, qs, scs, rad, d, block_d, pr, base_l1, thr, sbv,
                                         lane, &nd);
        break;
      case lp::kL2:
        keep = screen_candidate<lp::kL2>(xr, qs, scs, rad, d, block_d, pr, base_l1, thr, sbv,
                                         lane, &nd);
        break;
      case lp::kSqrt:
        keep = screen_candidate<lp::kSqrt>(xr, qs, scs, rad, d, block_d, pr, base_l1, thr, sbv,
                                           lane, &nd);
        break;
      case lp::kL15:
        keep = screen_candidate<lp::kL15>(xr, qs, scs, rad, d, block_d, pr, base_l1, thr, sbv,
                                          lane, &nd);
        break;
      default:
        keep = screen_candidate<lp::kGeneral>(xr, qs, scs, rad, d, block_d, pr, base_l1, thr,
                                              sbv, lane, &nd);
        break;
    }
  }
  if (lane == 0) {
    keep_out[slot] = keep;
    nd_out[slot] = nd;
  }
}

}  // namespace

// ids (B, C) int32, q (B, d) f32 in band coordinate order, thresh (B,) f32, sb (B, C) f32,
// codes (n, d) int8, scale (d,) f32, radius (d,) f32, p (B,) f32 -> keep (B, C) int32,
// nd (B, C) int32, all contiguous on the device; d % block_d == 0; base_l1 = 1 when sb
// holds L1 sums, 0 for squared L2. Launches on `stream`; returns cudaGetLastError().
extern "C" int gather_lp_screen_launch(const void* ids, const void* q, const void* thresh,
                                       const void* sb, const void* codes, const void* scale,
                                       const void* radius, const void* p, void* keep, void* nd,
                                       int B, int C, int n, int d, int block_d, int base_l1,
                                       void* stream) {
  if (B == 0 || C == 0) return 0;
  const size_t smem = 3 * static_cast<size_t>(d) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(gather_lp_screen_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(B, (C + lp::kWarps - 1) / lp::kWarps);
  gather_lp_screen_kernel<<<grid, lp::kWarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ids), static_cast<const float*>(q),
      static_cast<const float*>(thresh), static_cast<const float*>(sb),
      static_cast<const int8_t*>(codes), static_cast<const float*>(scale),
      static_cast<const float*>(radius), static_cast<const float*>(p),
      static_cast<int*>(keep), static_cast<int*>(nd), C, n, d, block_d, base_l1 != 0);
  return static_cast<int>(cudaGetLastError());
}
