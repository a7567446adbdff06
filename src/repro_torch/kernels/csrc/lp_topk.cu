// Fused root-free Lp distances + running top-k over each query's own candidate block:
// for query b, the k smallest sum_i |q[b, i] - c[b, j, i]|^p over j in [0, C), with their
// j, in ascending order; ties go to the lower j, NaN last.
//
// Replaces: src/repro/kernels/lp_topk.py:pallas_lp_topk (:60), the Pallas kernel
// _fused_kernel (:31). The TPU kernel walks the candidate tiles in grid order and carries
// the running top-k in VMEM scratch from one grid step to the next, merging each tile by a
// stable sort of [running list, tile]. Hopper blocks run in no order, so here one block
// owns one query, each of its warps walks its share of the candidates in a loop with a
// running list of its own, and the block merges the lists at the end. The wrapper applies
// the root, once, to the (B, k) result.
//
// Bound on the H100: bytes. Each candidate row is read once (C x d floats per query); the
// lists live in shared memory, and only (B, k) leaves the kernel. Under general p the
// accurate log and exp of every element bring the float32 pipes close to that line.
//
// Design. A query's block is contiguous (C x d floats), so it streams, and no barrier of
// the block stands between a warp's rows:
//  - one block of 8 warps a query; warp w takes rows w, w + 8, ... of the query's C;
//  - each warp streams its rows through a 3-stage ring of its own in shared memory
//    (cp.async, 16-byte copies when the rows are 16-byte aligned; every lane waits for its
//    own copies, then the warp synchronises), so the loads of its next two rows are in
//    flight while it scores and merges this one. Rows wider than kRingMaxD floats are read
//    straight from device memory instead;
//  - a warp scores a row from shared memory in gather_lp's lane layout and butterfly (lane
//    j takes float4 j, j + 32, ...; the loop unrolled twice, the additions in order), so
//    each distance has the bits of the other kernels' sums;
//  - filter before the merge: a scored candidate joins the warp's pending buffer only if
//    it orders before the warp's k-th entry under the key (empty, NaN, distance, position);
//    once the warp's list is full, few do. The warp merges its pending buffer when it is
//    full, and after its last row: each running entry's new place is its old place plus
//    the pending entries before it, each pending entry's the running entries before it (a
//    binary search: the list is sorted) plus the pending entries before it. The key is a
//    strict order (positions are distinct; empty slots carry positions >= C), so the
//    places are a permutation and no sort network is needed;
//  - after a block barrier the warps' lists merge by the same rule: each entry is placed
//    by binary searches in the seven other lists, and the entries of place < k are written.
// The running lists start as k empty slots, which order after every candidate, so the
// result is a stable sort of the candidates alone (NaN last), as the plain version gives;
// the reference starts from (+inf, -1) entries that order before candidates of distance
// +inf, which makes a difference only where a block has fewer than k finite candidates.
#include <stdint.h>

#include "lp_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 3;               // rows in each warp's ring
constexpr int kRingMaxD = 1024;          // widest row streamed through the rings
constexpr int kPend = 32;                // a warp's pending candidates between merges
constexpr int kUnroll = 2;               // the scoring loop's unrolling

// Strict order of list entries: empty slots (position >= C) after every candidate, NaN
// after every number, then by distance, then by position.
__device__ __forceinline__ bool before(float da, int pa, float db, int pb, int C) {
  const bool ea = pa >= C;
  const bool eb = pb >= C;
  if (ea != eb) return eb;
  const bool na = isnan(da);
  const bool nb = isnan(db);
  if (na != nb) return nb;
  if (!na && da != db) return da < db;
  return pa < pb;
}

// Entries of the sorted list (ld, lp) of length k that order before (d, p).
__device__ __forceinline__ int count_before(const float* ld, const int* lpos, int k, float d,
                                            int p, int C) {
  int lo = 0;
  int hi = k;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (before(ld[mid], lpos[mid], d, p, C)) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// Root-free power sum of one row (shared or device memory), by one warp, in
// row_power_sum's (lp_common.cuh) lane layout and butterfly. The loop over a lane's
// float4s is unrolled U times, so U x 4 independent power sequences are in flight; the
// additions into acc keep their order, and with it their bits.
template <int F, int U>
__device__ __forceinline__ float unrolled_row_power_sum(const float* xr, const float* qs, int d,
                                                        float p, int lane, bool vec4) {
  float acc = 0.0f;
  if (vec4) {
    const float4* x4 = reinterpret_cast<const float4*>(xr);
    const float4* q4 = reinterpret_cast<const float4*>(qs);
    const int n4 = d / 4;
    int i = lane;
    for (; i + 32 * (U - 1) < n4; i += 32 * U) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float4 xv = x4[i + 32 * u];
        const float4 qv = q4[i + 32 * u];
        acc += lp::pow_from_abs<F>(fabsf(xv.x - qv.x), p);
        acc += lp::pow_from_abs<F>(fabsf(xv.y - qv.y), p);
        acc += lp::pow_from_abs<F>(fabsf(xv.z - qv.z), p);
        acc += lp::pow_from_abs<F>(fabsf(xv.w - qv.w), p);
      }
    }
    for (; i < n4; i += 32) {
      const float4 xv = x4[i];
      const float4 qv = q4[i];
      acc += lp::pow_from_abs<F>(fabsf(xv.x - qv.x), p);
      acc += lp::pow_from_abs<F>(fabsf(xv.y - qv.y), p);
      acc += lp::pow_from_abs<F>(fabsf(xv.z - qv.z), p);
      acc += lp::pow_from_abs<F>(fabsf(xv.w - qv.w), p);
    }
  } else {
    for (int i = lane; i < d; i += 32) acc += lp::pow_from_abs<F>(fabsf(xr[i] - qs[i]), p);
  }
  return lp::warp_sum(acc);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// A warp's merge of its pending entries (pd, pp; np of them) into its sorted list cur of
// k entries, written to nxt.
__device__ __forceinline__ void warp_merge(const float* cur_d, const int* cur_p, float* nxt_d,
                                           int* nxt_p, const float* pd, const int* pp, int np,
                                           int k, int C, int lane) {
  for (int i = lane; i < k; i += 32) {
    const float di = cur_d[i];
    const int pi = cur_p[i];
    int place = i;
    for (int f = 0; f < np; ++f) place += before(pd[f], pp[f], di, pi, C);
    if (place < k) {
      nxt_d[place] = di;
      nxt_p[place] = pi;
    }
  }
  for (int e = lane; e < np; e += 32) {
    const float de = pd[e];
    const int pe = pp[e];
    int place = count_before(cur_d, cur_p, k, de, pe, C);
    for (int f = 0; f < np; ++f) place += before(pd[f], pp[f], de, pe, C);
    if (place < k) {
      nxt_d[place] = de;
      nxt_p[place] = pe;
    }
  }
}

template <int F, bool Ring>
__global__ void __launch_bounds__(kThreads)
lp_topk_kernel(const float* __restrict__ q, const float* __restrict__ c, float p,
               float* __restrict__ out_d, int* __restrict__ out_i, int C, int d, int k,
               bool vec4) {
  extern __shared__ float4 smem4[];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int dpad = (d + 3) & ~3;
  // the query row; each warp's ring (Ring only); each warp's two lists of k entries and its
  // pending buffer, the distances of all warps first, then their positions
  float* qs = reinterpret_cast<float*>(smem4);
  float* ring = qs + dpad + warp * (Ring ? kStages * dpad : 0);
  float* lists = qs + dpad + (Ring ? kWarps * kStages * dpad : 0);
  const int per_warp = 2 * k + kPend;
  float* wd = lists + warp * per_warp;                      // this warp's distances
  int* wp = reinterpret_cast<int*>(lists + kWarps * per_warp) + warp * per_warp;

  const int n_mine = warp < C ? (C - warp + kWarps - 1) / kWarps : 0;
  const float* cb = c + (static_cast<size_t>(b) * C + warp) * d;          // the warp's row 0
  const size_t stride = static_cast<size_t>(kWarps) * d;                   // to its next row

  auto issue = [&](int t) {
    if (!Ring || t >= n_mine) return;
    float* dst = ring + (t % kStages) * dpad;
    const float* src = cb + t * stride;
    if (vec4) {
      for (int u = lane; u < d / 4; u += 32) cp_async16(dst + 4 * u, src + 4 * u);
    } else {
      for (int u = lane; u < d; u += 32) cp_async4(dst + u, src + u);
    }
  };
  for (int t = 0; t < kStages - 1; ++t) {
    issue(t);
    cp_async_commit();
  }
  const float* qrow = q + static_cast<size_t>(b) * d;
  for (int i = tid; i < d; i += kThreads) qs[i] = qrow[i];
  for (int i = lane; i < k; i += 32) {
    wd[i] = INFINITY;
    wp[i] = C + warp * k + i;                     // empty, with a position no other slot has
  }
  __syncthreads();                                // the query row and the lists set

  float* cur_d = wd;
  int* cur_p = wp;
  float* nxt_d = wd + k;
  int* nxt_p = wp + k;
  float* pd = wd + 2 * k;
  int* pp = wp + 2 * k;
  int np = 0;
  for (int t = 0; t < n_mine; ++t) {
    issue(t + kStages - 1);                       // into the slot row t - 1 used
    cp_async_commit();
    cp_async_wait<kStages - 1>();                 // this lane's copies of row t landed
    __syncwarp();                                 // and every lane's
    const float* xr = Ring ? ring + (t % kStages) * dpad : cb + t * stride;
    const float dist = unrolled_row_power_sum<F, kUnroll>(xr, qs, d, p, lane, vec4);
    const int pos = warp + t * kWarps;
    if (before(dist, pos, cur_d[k - 1], cur_p[k - 1], C)) {   // uniform: dist is the warp's
      if (lane == 0) {
        pd[np] = dist;
        pp[np] = pos;
      }
      ++np;
    }
    __syncwarp();                                 // the slot read; the pending entry written
    if (np == kPend || (np > 0 && t == n_mine - 1)) {
      warp_merge(cur_d, cur_p, nxt_d, nxt_p, pd, pp, np, k, C, lane);
      __syncwarp();
      float* td = cur_d;
      cur_d = nxt_d;
      nxt_d = td;
      int* tp = cur_p;
      cur_p = nxt_p;
      nxt_p = tp;
      np = 0;
    }
  }
  if (cur_d != wd) {                              // the final list goes to a fixed place
    for (int i = lane; i < k; i += 32) {
      wd[i] = cur_d[i];
      wp[i] = cur_p[i];
    }
  }
  __syncthreads();                                // every warp's list final

  // place each entry of the warp lists among the other warps' lists
  const int* lpos = reinterpret_cast<const int*>(lists + kWarps * per_warp);
  for (int e = tid; e < kWarps * k; e += kThreads) {
    const int w = e / k;
    const int i = e - w * k;
    const float de = lists[w * per_warp + i];
    const int pe = lpos[w * per_warp + i];
    int place = i;
    for (int ow = 0; ow < kWarps && place < k; ++ow) {
      if (ow == w) continue;
      place += count_before(lists + ow * per_warp, lpos + ow * per_warp, k, de, pe, C);
    }
    if (place < k) {                              // every entry placed below k is a candidate
      out_d[static_cast<size_t>(b) * k + place] = de;
      out_i[static_cast<size_t>(b) * k + place] = pe;
    }
  }
}

using Kernel = void (*)(const float*, const float*, float, float*, int*, int, int, int, bool);

template <bool Ring>
Kernel pick_family(float p) {
  if (p == 1.0f) return lp_topk_kernel<lp::kL1, Ring>;
  if (p == 2.0f) return lp_topk_kernel<lp::kL2, Ring>;
  if (p == 0.5f) return lp_topk_kernel<lp::kSqrt, Ring>;
  if (p == 1.5f) return lp_topk_kernel<lp::kL15, Ring>;
  return lp_topk_kernel<lp::kGeneral, Ring>;
}

}  // namespace

// The arguments come packed in one int64 array:
//   a[0] q (B, d) f32; a[1] c (B, C, d) f32; a[2] out_d (B, k) f32 root-free sums; a[3]
//   out_i (B, k) int32 candidate indices, all contiguous on the device; a[4..7] B, C, d,
//   k with 1 <= k <= C; a[8] the stream. p is the metric.
// Shared memory (dynamic, opted in above 48 KB): the query row; for d <= kRingMaxD, each
// warp's ring of kStages rows; each warp's two lists of k entries and kPend pending entries
// (8 bytes each). kernels/lp_topk.py `smem_bytes` computes the same. Launches on the
// stream; returns cudaGetLastError(), the opt-in's error for a k whose lists do not fit,
// or cudaErrorInvalidValue for k outside [1, C].
extern "C" int lp_topk_launch(const long long* a, float p) {
  const auto* q = reinterpret_cast<const float*>(a[0]);
  const auto* c = reinterpret_cast<const float*>(a[1]);
  auto* out_d = reinterpret_cast<float*>(a[2]);
  auto* out_i = reinterpret_cast<int*>(a[3]);
  const int B = static_cast<int>(a[4]);
  const int C = static_cast<int>(a[5]);
  const int d = static_cast<int>(a[6]);
  const int k = static_cast<int>(a[7]);
  const auto stream = reinterpret_cast<cudaStream_t>(a[8]);
  if (k < 1 || k > C) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  const bool ring = d <= kRingMaxD;
  const size_t dpad = static_cast<size_t>((d + 3) & ~3);
  const size_t smem = sizeof(float) * (dpad + (ring ? kWarps * kStages * dpad : 0)) +
                      static_cast<size_t>(kWarps) * (2 * k + kPend) * (sizeof(float) +
                                                                       sizeof(int));
  const Kernel kernel = ring ? pick_family<true>(p) : pick_family<false>(p);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const bool vec4 = (d % 4 == 0) && (reinterpret_cast<uintptr_t>(c) % 16 == 0);
  kernel<<<B, kThreads, smem, stream>>>(q, c, p, out_d, out_i, C, d, k, vec4);
  return static_cast<int>(cudaGetLastError());
}
