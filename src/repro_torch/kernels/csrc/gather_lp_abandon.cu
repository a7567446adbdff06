// Early-abandoning fused gather + blocked-dimension Lp scan (DESIGN.md §8).
// For each candidate x = X[ids[b, c]] of query b, with threshold thr = thresh[b] and base
// power sum sb[b, c]:
//   dies at entry if   entry_bound(sb) > thr
//   after each block   s > thr   or   s + suffix_bound(sb - sbase, d_rem) > thr
// where s / sbase are the running Lp / base-metric power sums over the dimension blocks
// scanned so far. out = s for survivors, +inf for dead or padding candidates; nd = the
// dimensions scanned while alive.
//
// Replaces: src/repro/kernels/lp_distance.py:gather_lp_abandon_kernel_call (:560), the
// Pallas kernels _gather_abandon_kernel / _gather_abandon_vec_kernel (row logic
// _abandon_row, :472). It scores every kappa batch of the verification after the first k.
//
// Bound on the H100: bytes, and only the bytes of the blocks actually scanned: a row of X
// is read one dimension block at a time and never past the block in which its candidate
// dies, and a frozen query row (threshold -inf) reads nothing at all.
//
// Design, simple first: one block per (query row, 8 candidates), the query row in shared
// memory; each warp walks one candidate's dimension blocks with lane j reading dimension j
// of the block (a coalesced 128-byte read for block_d = 32), then reduces the block's Lp
// and base sums with butterfly shuffles, which leave the same bits on every lane, so the
// abandon test is uniform across the warp. The block widths are the reference's
// (pick_abandon_block_d), since nd depends on them. Wider loads and more candidates per
// warp are later work.
#include <stdint.h>

#include "lp_common.cuh"

namespace {

// Scans one live candidate; returns its power sum, or +inf once it dies.
template <int F>
__device__ float scan_candidate(const float* __restrict__ xr, const float* __restrict__ qs,
                                int d, int block_d, float p, bool base_l1, float thr,
                                float sb, int lane, int* nd) {
  float s = 0.0f;
  float sbase = 0.0f;
  for (int start = 0; start < d; start += block_d) {
    float v = 0.0f;
    float bb = 0.0f;
    for (int i = start + lane; i < start + block_d; i += 32) {
      const float a = fabsf(__ldg(xr + i) - qs[i]);
      v += lp::pow_from_abs<F>(a, p);
      bb += base_l1 ? a : a * a;
    }
    s += lp::warp_sum(v);
    sbase += lp::warp_sum(bb);
    *nd += block_d;
    const int d_rem = d - (start + block_d);
    bool dead = s > thr;
    if (!dead && d_rem > 0)
      dead = s + lp::entry_bound(sb - sbase, base_l1, p, static_cast<float>(d_rem)) > thr;
    if (dead) return INFINITY;
  }
  return s;
}

__global__ void __launch_bounds__(lp::kWarps * 32)
gather_lp_abandon_kernel(const int* __restrict__ ids, const float* __restrict__ q,
                         const float* __restrict__ thresh, const float* __restrict__ sb,
                         const float* __restrict__ x, const float* __restrict__ p,
                         float* __restrict__ out, int* __restrict__ nd_out, int C, int n,
                         int d, int block_d, bool base_l1) {
  extern __shared__ float q_smem[];
  const int b = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.y * lp::kWarps + warp;
  const size_t slot = static_cast<size_t>(b) * C + c;
  const float thr = thresh[b];
  if (thr == -INFINITY) {  // frozen row: every candidate dies at entry, nothing is loaded
    if (c < C && lane == 0) {
      out[slot] = INFINITY;
      nd_out[slot] = 0;
    }
    return;
  }
  const float* qrow = q + static_cast<size_t>(b) * d;
  for (int i = threadIdx.x; i < d; i += blockDim.x) q_smem[i] = qrow[i];
  __syncthreads();
  if (c >= C) return;

  const int id = ids[slot];
  const float pr = p[b];
  const float sbv = sb[slot];
  float result = INFINITY;
  int nd = 0;
  if (id >= 0 && id < n &&
      lp::entry_bound(sbv, base_l1, pr, static_cast<float>(d)) <= thr) {
    const float* xr = x + static_cast<size_t>(id) * d;
    switch (lp::family_of(pr)) {
      case lp::kL1:
        result = scan_candidate<lp::kL1>(xr, q_smem, d, block_d, pr, base_l1, thr, sbv, lane, &nd);
        break;
      case lp::kL2:
        result = scan_candidate<lp::kL2>(xr, q_smem, d, block_d, pr, base_l1, thr, sbv, lane, &nd);
        break;
      case lp::kSqrt:
        result = scan_candidate<lp::kSqrt>(xr, q_smem, d, block_d, pr, base_l1, thr, sbv, lane, &nd);
        break;
      case lp::kL15:
        result = scan_candidate<lp::kL15>(xr, q_smem, d, block_d, pr, base_l1, thr, sbv, lane, &nd);
        break;
      default:
        result = scan_candidate<lp::kGeneral>(xr, q_smem, d, block_d, pr, base_l1, thr, sbv, lane, &nd);
        break;
    }
  }
  if (lane == 0) {
    out[slot] = result;
    nd_out[slot] = nd;
  }
}

}  // namespace

// ids (B, C) int32, q (B, d) f32, thresh (B,) f32, sb (B, C) f32, x (n, d) f32, p (B,) f32
// -> out (B, C) f32, nd (B, C) int32, all contiguous on the device; d % block_d == 0;
// base_l1 = 1 when sb holds L1 sums, 0 for squared L2. Launches on `stream`; returns
// cudaGetLastError().
extern "C" int gather_lp_abandon_launch(const void* ids, const void* q, const void* thresh,
                                        const void* sb, const void* x, const void* p, void* out,
                                        void* nd, int B, int C, int n, int d, int block_d,
                                        int base_l1, void* stream) {
  if (B == 0 || C == 0) return 0;
  const size_t smem = static_cast<size_t>(d) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(gather_lp_abandon_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(B, (C + lp::kWarps - 1) / lp::kWarps);
  gather_lp_abandon_kernel<<<grid, lp::kWarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ids), static_cast<const float*>(q),
      static_cast<const float*>(thresh), static_cast<const float*>(sb),
      static_cast<const float*>(x), static_cast<const float*>(p), static_cast<float*>(out),
      static_cast<int*>(nd), C, n, d, block_d, base_l1 != 0);
  return static_cast<int>(cudaGetLastError());
}
