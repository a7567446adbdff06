// Fused root-free Lp distances + running top-k over each query's own candidate block:
// for query b, the k smallest sum_i |q[b, i] - c[b, j, i]|^p[b] over j in [0, C), with
// their j, in ascending order; ties go to the lower j.
//
// Replaces: src/repro/kernels/lp_topk.py:pallas_lp_topk (:60), the Pallas kernel
// _fused_kernel (:31). The TPU kernel walks the candidate tiles in grid order and carries
// the running top-k in VMEM scratch from one grid step to the next, merging each tile by a
// stable sort of [running list, tile]. Hopper blocks run in no order, so here one block
// owns one query and walks its tiles in a loop. The wrapper applies the root, once, to the
// (B, k) result.
//
// Bound on the H100: bytes. Each candidate row is read once (C x d floats per query); the
// merge touches shared memory only, and only (B, k) leaves the kernel: no (B, C) distance
// matrix goes to device memory.
//
// Design, simple first: one block of 8 warps per query. The query row sits in shared
// memory. For each tile of kTile candidates, each warp scores one candidate at a time
// (coalesced 16-byte loads, warp-shuffle sum) into a shared array placed after the k
// running entries. Then every thread takes entries of [running list, tile] and counts how
// many entries order before its own under the key (empty, NaN, distance, position): that
// is the entry's place in a stable sort, so the entries of place < k form the new running
// list. Positions are distinct, so the places are a permutation and the merge needs no
// sort network. The running list starts as k empty slots (+inf, id -1), which order after
// every candidate, so the result is a stable sort of the candidates alone (NaN last), as
// the plain version gives; the reference starts from (+inf, -1) entries that order before
// candidates of distance +inf, which makes a difference only where a block has fewer than
// k finite candidates.
#include <stdint.h>

#include "lp_common.cuh"

namespace {

constexpr int kTile = 128;    // candidates scored per merge (kernels/lp_topk.py TILE)

// True when entry (da, id ia, position pa) orders before entry (db, ib, pb): empty slots
// (id -1) after every candidate, NaN after every number, then by distance, then by
// position (the stable sort's tie rule).
__device__ __forceinline__ bool before(float da, int ia, int pa, float db, int ib, int pb) {
  const bool ea = ia < 0;
  const bool eb = ib < 0;
  if (ea != eb) return eb;
  const bool na = isnan(da);
  const bool nb = isnan(db);
  if (na != nb) return nb;
  if (!na && da != db) return da < db;
  return pa < pb;
}

__global__ void __launch_bounds__(lp::kWarps * 32)
lp_topk_kernel(const float* __restrict__ q, const float* __restrict__ c,
               const float* __restrict__ p, float* __restrict__ out_d,
               int* __restrict__ out_i, int C, int d, int k, bool vec4) {
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);       // (d,) the query row
  float* md = qs + ((d + 3) & ~3);                   // (k + kTile,) running list, then tile
  int* mi = reinterpret_cast<int*>(md + k + kTile);   // their candidate ids
  float* nd = reinterpret_cast<float*>(mi + k + kTile);  // (k,) the merged list
  int* ni = reinterpret_cast<int*>(nd + k);

  const int b = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const float* qrow = q + static_cast<size_t>(b) * d;
  for (int i = threadIdx.x; i < d; i += blockDim.x) qs[i] = qrow[i];
  for (int i = threadIdx.x; i < k; i += blockDim.x) {
    md[i] = INFINITY;
    mi[i] = -1;
  }
  __syncthreads();

  const float pr = p[b];
  const float* cb = c + static_cast<size_t>(b) * C * d;
  for (int start = 0; start < C; start += kTile) {
    const int n_tile = min(kTile, C - start);
    for (int j = warp; j < n_tile; j += lp::kWarps) {
      const float dist = lp::row_power_sum_any(cb + static_cast<size_t>(start + j) * d, qs, d,
                                               pr, lane, vec4);
      if (lane == 0) {
        md[k + j] = dist;
        mi[k + j] = start + j;
      }
    }
    __syncthreads();
    const int m = k + n_tile;
    for (int e = threadIdx.x; e < m; e += blockDim.x) {
      const float de = md[e];
      const int ie = mi[e];
      int place = 0;
      for (int f = 0; f < m; ++f) place += before(md[f], mi[f], f, de, ie, e);
      if (place < k) {
        nd[place] = de;
        ni[place] = ie;
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < k; i += blockDim.x) {
      md[i] = nd[i];
      mi[i] = ni[i];
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < k; i += blockDim.x) {
    out_d[static_cast<size_t>(b) * k + i] = md[i];
    out_i[static_cast<size_t>(b) * k + i] = mi[i];
  }
}

}  // namespace

// q (B, d) f32, c (B, C, d) f32, p (B,) f32 -> out_d (B, k) f32 root-free sums, out_i
// (B, k) int32 candidate indices, all contiguous on the device; 1 <= k <= C. The running
// list is sized by k in dynamic shared memory (8 (2k + kTile) bytes beside the query row),
// opted in above 48 KB. Launches on `stream`; returns cudaGetLastError(), the opt-in's
// error for a k whose list does not fit, or cudaErrorInvalidValue for k outside [1, C].
extern "C" int lp_topk_launch(const void* q, const void* c, const void* p, void* out_d,
                              void* out_i, int B, int C, int d, int k, void* stream) {
  if (k < 1 || k > C) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  const size_t smem = static_cast<size_t>((d + 3) & ~3) * sizeof(float) +
                      static_cast<size_t>(k + kTile) * (sizeof(float) + sizeof(int)) +
                      static_cast<size_t>(k) * (sizeof(float) + sizeof(int));
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        lp_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const bool vec4 = (d % 4 == 0) && (reinterpret_cast<uintptr_t>(c) % 16 == 0);
  lp_topk_kernel<<<B, lp::kWarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(c), static_cast<const float*>(p),
      static_cast<float*>(out_d), static_cast<int*>(out_i), C, d, k, vec4);
  return static_cast<int>(cudaGetLastError());
}
