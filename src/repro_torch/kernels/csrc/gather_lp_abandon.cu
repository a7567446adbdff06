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
// _abandon_row, :472). It scores every kappa batch of the verification after the first k,
// and the delta tier's threshold scan.
//
// Bound on the H100: bytes, and only the bytes of the blocks actually scanned, plus one: a
// frozen query row (threshold -inf) reads nothing, and a candidate reads its row one
// dimension block at a time, never more than one block past the block in which it dies.
// At the query path's shapes (a few candidates per query, most dying in their first
// blocks) the time is latency: the chain of dependent loads of a surviving candidate.
//
// Design. At the path's shapes the time is the chain of a surviving candidate: per block a
// load, the family's power, two group sums, the suffix bound (a log and an exp) and the
// test, 16 times over at d = 512. So each candidate gets as many lanes as its block has
// dimensions, and the chain does as little as it can:
//  - lane groups: a candidate is scanned by G = min(block_d, 32) lanes, lane j taking
//    dimension j of each block (j, j + 32, ... for the wider blocks of the fallback
//    width); a warp scans 32 / G candidates of one query (one at block_d = 32, the
//    reference's width at d = 512). The group reduces its block's Lp and base sums with
//    log2(G) shuffles, which leave the same bits on every lane of the group, so the
//    abandon test is uniform within it;
//  - overlap: a lane's load of block i + 1 (and its query element) is issued before block
//    i is reduced and tested, so memory latency overlaps the chain;
//  - a grid sized to the work: one query per block and as many warps as its candidates
//    need (5 at C = kappa = 5, none idle; chunks of up to 8 warps above that); the block
//    loads its query row into shared memory once, or nothing for a frozen row;
//  - a light launch: ids and sb are read through their row strides (the verification
//    loop's column slices go in without a copy), and p is a scalar argument unless the
//    caller passes a (B,) vector.
// The abandon rule, the block widths and nd are the reference's; only the order of the
// additions inside a block differs from the plain version.
#include "lp_common.cuh"

namespace {

constexpr int kMaxThreads = 256;   // 8 warps: the candidates of one block

// Sum over the G aligned lanes of a group; every lane of the group ends with the same bits.
template <int G>
__device__ __forceinline__ float group_sum(float v, unsigned mask) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) v += __shfl_xor_sync(mask, v, o);
  return v;
}

// Scans one live candidate with its group of G lanes; returns its power sum, or +inf once
// it dies. With block_d == G each lane holds one dimension of a block (x_first is its
// element of the first block, loaded by the caller), and the next block's element is
// loaded before this block is reduced; wider blocks (the fallback width, G = 32) loop over
// their dimensions with a stride of 32.
template <int F, int G>
__device__ float scan_candidate(const float* __restrict__ xr, const float* __restrict__ qs,
                                int d, int block_d, float p, bool base_l1, float thr, float sb,
                                int g, unsigned mask, float x_first, int* nd) {
  float s = 0.0f;
  float sbase = 0.0f;
  const bool one = block_d == G;
  float x_next = x_first;
  float q_next = one ? qs[g] : 0.0f;
  for (int start = 0; start < d; start += block_d) {
    float v = 0.0f;
    float bb = 0.0f;
    if (one) {
      const float a = fabsf(x_next - q_next);
      if (start + block_d < d) {                 // one block ahead
        x_next = __ldg(xr + start + block_d + g);
        q_next = qs[start + block_d + g];
      }
      v = lp::pow_from_abs<F>(a, p);
      bb = base_l1 ? a : a * a;
    } else {
      for (int i = start + g; i < start + block_d; i += G) {
        const float a = fabsf(__ldg(xr + i) - qs[i]);
        v += lp::pow_from_abs<F>(a, p);
        bb += base_l1 ? a : a * a;
      }
    }
    s += group_sum<G>(v, mask);
    sbase += group_sum<G>(bb, mask);
    *nd += block_d;
    const int d_rem = d - (start + block_d);
    bool dead = s > thr;
    if (!dead && d_rem > 0)
      dead = s + lp::entry_bound(sb - sbase, base_l1, p, static_cast<float>(d_rem)) > thr;
    if (dead) return INFINITY;
  }
  return s;
}

template <int G>
__global__ void __launch_bounds__(kMaxThreads)
gather_lp_abandon_kernel(const int* __restrict__ ids, int ids_stride,
                         const float* __restrict__ q, const float* __restrict__ thresh,
                         const float* __restrict__ sb, int sb_stride,
                         const float* __restrict__ x, const float* __restrict__ p,
                         float p_scalar, float* __restrict__ out, int* __restrict__ nd_out,
                         int C, int n, int d, int block_d, int cpb, bool base_l1) {
  extern __shared__ float q_smem[];
  const int b = blockIdx.x;
  const int group = threadIdx.x / G;
  const int g = threadIdx.x % G;
  const int c = blockIdx.y * cpb + group;
  const bool active = group < cpb && c < C;   // whole groups are active or not
  // the row's and the candidate's scalars first: their loads are independent
  const float thr = thresh[b];
  int id = -1;
  float sbv = 0.0f;
  if (active) {
    id = ids[static_cast<size_t>(b) * ids_stride + c];
    sbv = sb[static_cast<size_t>(b) * sb_stride + c];
  }
  const float pr = p != nullptr ? p[b] : p_scalar;
  if (thr == -INFINITY) {  // frozen row: every candidate dies at entry, nothing is loaded
    if (active && g == 0) {
      out[static_cast<size_t>(b) * C + c] = INFINITY;
      nd_out[static_cast<size_t>(b) * C + c] = 0;
    }
    return;
  }
  const bool live = active && id >= 0 && id < n &&
                    lp::entry_bound(sbv, base_l1, pr, static_cast<float>(d)) <= thr;
  const float* xr = x + static_cast<size_t>(live ? id : 0) * d;
  // the first block's element is in flight while the block stages its query row
  const float x_first = (live && block_d == G) ? __ldg(xr + g) : 0.0f;
  const float* qrow = q + static_cast<size_t>(b) * d;
  for (int i = threadIdx.x; i < d; i += blockDim.x) q_smem[i] = qrow[i];
  __syncthreads();
  if (!active) return;

  const unsigned mask =
      (G == 32 ? 0xffffffffu : ((1u << G) - 1u) << ((threadIdx.x & 31) & ~(G - 1)));
  float result = INFINITY;
  int nd = 0;
  if (live) {
    switch (lp::family_of(pr)) {
      case lp::kL1:
        result = scan_candidate<lp::kL1, G>(xr, q_smem, d, block_d, pr, base_l1, thr, sbv, g,
                                            mask, x_first, &nd);
        break;
      case lp::kL2:
        result = scan_candidate<lp::kL2, G>(xr, q_smem, d, block_d, pr, base_l1, thr, sbv, g,
                                            mask, x_first, &nd);
        break;
      case lp::kSqrt:
        result = scan_candidate<lp::kSqrt, G>(xr, q_smem, d, block_d, pr, base_l1, thr, sbv, g,
                                              mask, x_first, &nd);
        break;
      case lp::kL15:
        result = scan_candidate<lp::kL15, G>(xr, q_smem, d, block_d, pr, base_l1, thr, sbv, g,
                                             mask, x_first, &nd);
        break;
      default:
        result = scan_candidate<lp::kGeneral, G>(xr, q_smem, d, block_d, pr, base_l1, thr, sbv,
                                                 g, mask, x_first, &nd);
        break;
    }
  }
  if (g == 0) {
    out[static_cast<size_t>(b) * C + c] = result;
    nd_out[static_cast<size_t>(b) * C + c] = nd;
  }
}

template <int G>
cudaError_t launch(const int* ids, int ids_stride, const float* q, const float* thresh,
                   const float* sb, int sb_stride, const float* x, const float* p,
                   float p_scalar, float* out, int* nd, int B, int C, int n, int d, int block_d,
                   bool base_l1, cudaStream_t stream) {
  // candidates per block: all of C if they fit in 8 warps, else C in equal chunks
  const int cap = kMaxThreads / G;
  const int chunks = (C + cap - 1) / cap;
  const int cpb = (C + chunks - 1) / chunks;
  const int threads = (cpb * G + 31) / 32 * 32;
  const size_t smem = static_cast<size_t>(d) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        gather_lp_abandon_kernel<G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  gather_lp_abandon_kernel<G><<<dim3(B, chunks), threads, smem, stream>>>(
      ids, ids_stride, q, thresh, sb, sb_stride, x, p, p_scalar, out, nd, C, n, d, block_d,
      cpb, base_l1);
  return cudaGetLastError();
}

}  // namespace

// The arguments come packed in one int64 array (one ctypes argument instead of seventeen:
// the verification loop launches this kernel once per kappa batch, and ctypes converts
// each argument on every call):
//   a[0] ids (B, C) int32 with row stride a[1]; a[2] q (B, d) f32; a[3] thresh (B,) f32;
//   a[4] sb (B, C) f32 with row stride a[5]; a[6] x (n, d) f32; a[7] p (B,) f32 or 0 for
//   the scalar p_scalar; a[8] out (B, C) f32 and a[9] nd (B, C) int32 (contiguous);
//   a[10..14] B, C, n, d, block_d (d % block_d == 0); a[15] base_l1 (1 when sb holds L1
//   sums, 0 for squared L2); a[16] the stream.
// Launches on the stream; returns cudaGetLastError().
extern "C" int gather_lp_abandon_launch(const long long* a, float p_scalar) {
  const auto* ids = reinterpret_cast<const int*>(a[0]);
  const int ids_stride = static_cast<int>(a[1]);
  const auto* q = reinterpret_cast<const float*>(a[2]);
  const auto* thresh = reinterpret_cast<const float*>(a[3]);
  const auto* sb = reinterpret_cast<const float*>(a[4]);
  const int sb_stride = static_cast<int>(a[5]);
  const auto* x = reinterpret_cast<const float*>(a[6]);
  const auto* p = reinterpret_cast<const float*>(a[7]);
  auto* out = reinterpret_cast<float*>(a[8]);
  auto* nd = reinterpret_cast<int*>(a[9]);
  const int B = static_cast<int>(a[10]);
  const int C = static_cast<int>(a[11]);
  const int n = static_cast<int>(a[12]);
  const int d = static_cast<int>(a[13]);
  const int block_d = static_cast<int>(a[14]);
  const bool base_l1 = a[15] != 0;
  const auto stream = reinterpret_cast<cudaStream_t>(a[16]);
  if (B == 0 || C == 0) return 0;
  cudaError_t err;
  switch (block_d) {
    case 8:
      err = launch<8>(ids, ids_stride, q, thresh, sb, sb_stride, x, p, p_scalar, out, nd, B, C,
                      n, d, block_d, base_l1, stream);
      break;
    case 16:
      err = launch<16>(ids, ids_stride, q, thresh, sb, sb_stride, x, p, p_scalar, out, nd, B, C,
                       n, d, block_d, base_l1, stream);
      break;
    default:   // 32, and the fallback width d, which a warp walks 32 dimensions at a time
      err = launch<32>(ids, ids_stride, q, thresh, sb, sb_stride, x, p, p_scalar, out, nd, B, C,
                       n, d, block_d, base_l1, stream);
      break;
  }
  return static_cast<int>(err);
}
