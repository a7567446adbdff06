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
// Bound on the H100: bytes, one byte per scanned dimension of a candidate's band row (a
// quarter of the f32 row that gather_lp_abandon reads), and nothing for a frozen query row
// (threshold -inf). At the path's shapes (B = 256 queries x C = kappa = 5 candidates, d =
// 512) that is 0.00036 ms: the time is latency, not bytes. The first design walked a
// candidate's 16 dimension blocks in order, each a dependent load, two butterflies, the
// suffix bound and a test, so a warp waited for memory 16 times (0.0143 ms on the device).
//
// Design: one wait for memory, then arithmetic that does not wait on itself.
//  - grid: one block a query row and one warp a candidate, as many warps as the row's
//    candidates (5 at C = kappa = 5, none idle; C in equal chunks of at most 8 above that).
//    Rows share nothing but the scales and radii, which each block stages from L2 (4 KB at
//    d = 512); several rows a block would make every row wait for the slowest one's loads;
//  - the row's scalars (threshold, id, base sum, p) are read first, and the entry test
//    runs on them; a frozen row stops there and loads nothing more. Then the block issues
//    one round of asynchronous copies: the query row, the scales and the radii (16-byte
//    cp.async.cg), and each live candidate's whole band row into its warp's slot in shared
//    memory (16-byte cp.async.cg where d % 16 == 0, 4-byte cp.async.ca where rows are only
//    4-byte aligned, byte loads otherwise: d = 37). A candidate that dies after its first
//    block has then read its whole row: at the smoke's tight thresholds that is more bytes
//    than the first design read; on Sun's path nothing dies, so nothing is added there;
//  - the terms: lane j forms the terms of dimensions start + j, start + j + 32, ... of each
//    block, in the first design's lane layout and order, so each lane's partial sum of a
//    block has that design's bits. For blocks of at most 32 dimensions (Sun's 32, and 16
//    and 8) that is one dimension a block, with no inner loop and no branch, so several
//    blocks' loads and arithmetic overlap. The partials go to the warp's term tile in
//    shared memory, a row of 32 a block;
//  - the block sums: lane t adds block t's row of the tile in the first design's butterfly
//    order (pairs 16 apart, then 8, 4, 2, 1: the bits every lane of that butterfly held);
//  - the kill tests in parallel: lane t forms the running sums s_t and sbase_t through block
//    t by the first design's sequential additions (the block sums broadcast by shuffles),
//    tests block t with its one suffix bound, and a ballot gives the first dead block.
//    Rows of more than 16 blocks go 32 blocks at a time (block_d = 8 at d = 512: two
//    chunks), carrying the sums, and stop at the first chunk with a dead block. A NaN sum
//    kills nothing, as NaN > thr is false; the lower terms keep a NaN (a select, where
//    fmaxf would drop it), as the plain version's clamp does.
// keep is written as one byte (torch.bool), so the caller launches nothing after it.
// Timed on the card and dropped, in throwaway builds of this file: the scan fully unrolled
// for each p family with the terms in registers (slower than the first design under mixed
// p: the five families' unrolled copies do not stay in the instruction cache together),
// the terms' inner loop kept for blocks of 32 dimensions (no overlap between blocks: each
// block's loads wait for the last block's arithmetic), a transposed butterfly in place of
// the per-lane tile sums (as fast, more code), the band row copied before the entry test
// (no faster), and the term loop unrolled by 4 or in full (no faster than by 8).
#include <stdint.h>

#include "lp_common.cuh"

namespace {

constexpr int kMaxThreads = 256;   // 8 warps: the candidates of one block
constexpr unsigned kFull = 0xffffffffu;
// floats per term-tile row: 32 partials and 4 of padding, so that the lanes of a quarter
// warp reading their own rows as float4 hit different banks
constexpr int kPitch = 36;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// The band terms of one dimension i: the lower term max(|q - x^| - r, 0)^p and the
// base-metric upper term (|q - x^| + r, squared for L2).
template <int F>
__device__ __forceinline__ void band_terms(const int8_t* __restrict__ row,
                                           const float* __restrict__ qs,
                                           const float* __restrict__ scs,
                                           const float* __restrict__ rad, int i, float p,
                                           bool base_l1, float* lo, float* up) {
  const float xh = __fmul_rn(static_cast<float>(row[i]), scs[i]);
  const float a0 = fabsf(xh - qs[i]);
  const float t = a0 - rad[i];
  const float al = t < 0.0f ? 0.0f : t;   // keeps a NaN, as clamp_min does
  const float au = a0 + rad[i];
  *lo = lp::pow_from_abs<F>(al, p);
  *up = base_l1 ? au : au * au;
}

// This lane's partials of the M blocks m0 .. m0 + M - 1 (0 past the last block), in the
// first design's order (lane j adds dimensions start + j, start + j + 32, ... of a block),
// written to its warp's term tile: tv[j * kPitch + lane] (lower), tu[...] (upper).
// Blocks of at most 32 dimensions (Sun's 32, and 16 and 8) give a lane at most one
// dimension a block: that path has no inner loop and no branch, so the loads and the
// arithmetic of several blocks overlap. The loop over blocks is not unrolled in full:
// each p family has its own copy, and fully unrolled copies would not stay in the
// instruction cache together under mixed p.
template <int F, int M>
__device__ __forceinline__ void block_terms(const int8_t* __restrict__ row,
                                            const float* __restrict__ qs,
                                            const float* __restrict__ scs,
                                            const float* __restrict__ rad, int m0, int nb,
                                            int block_d, float p, bool base_l1, int lane,
                                            float* __restrict__ tv, float* __restrict__ tu) {
  if (block_d <= 32) {
#pragma unroll 8
    for (int j = 0; j < M; ++j) {
      const bool here = m0 + j < nb && lane < block_d;
      float lo;
      float up;
      band_terms<F>(row, qs, scs, rad, here ? (m0 + j) * block_d + lane : 0, p, base_l1, &lo,
                    &up);
      float vj = 0.0f;
      float uj = 0.0f;
      vj += lo;
      uj += up;
      tv[j * kPitch + lane] = here ? vj : 0.0f;
      tu[j * kPitch + lane] = here ? uj : 0.0f;
    }
  } else {
    for (int j = 0; j < M; ++j) {
      float vj = 0.0f;
      float uj = 0.0f;
      if (m0 + j < nb) {
        const int start = (m0 + j) * block_d;
        for (int i = start + lane; i < start + block_d; i += 32) {
          float lo;
          float up;
          band_terms<F>(row, qs, scs, rad, i, p, base_l1, &lo, &up);
          vj += lo;
          uj += up;
        }
      }
      tv[j * kPitch + lane] = vj;
      tu[j * kPitch + lane] = uj;
    }
  }
}

// The butterfly's sum of one tile row x[0..31] (the 32 lanes' partials of one block),
// added in the butterfly's order: pairs 16 apart, then 8, 4, 2 and 1 apart. Every lane of
// a butterfly holds these bits (IEEE addition commutes).
__device__ __forceinline__ float tree_sum(const float* __restrict__ x) {
  float a[32];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float4 v4 = reinterpret_cast<const float4*>(x)[k];
    a[4 * k] = v4.x;
    a[4 * k + 1] = v4.y;
    a[4 * k + 2] = v4.z;
    a[4 * k + 3] = v4.w;
  }
#pragma unroll
  for (int j = 0; j < 16; ++j) a[j] = a[j] + a[j + 16];
#pragma unroll
  for (int j = 0; j < 8; ++j) a[j] = a[j] + a[j + 8];
#pragma unroll
  for (int j = 0; j < 4; ++j) a[j] = a[j] + a[j + 4];
  a[0] = a[0] + a[2];
  a[1] = a[1] + a[3];
  return a[0] + a[1];
}

// Screens one candidate that passed the entry test, its band row in shared memory and its
// warp's term tiles tv, tu (M rows of kPitch floats each); sets keep and nd (uniform
// across the warp).
template <int M>
__device__ void screen_candidate(const int8_t* __restrict__ row, const float* __restrict__ qs,
                                 const float* __restrict__ scs, const float* __restrict__ rad,
                                 int d, int block_d, float p, bool base_l1, float thr, float sb,
                                 int lane, float* __restrict__ tv, float* __restrict__ tu,
                                 bool* keep, int* nd) {
  const int nb = d / block_d;
  const int family = lp::family_of(p);
  float s_in = 0.0f;
  float sbase_in = 0.0f;
  for (int m0 = 0; m0 < nb; m0 += M) {
    switch (family) {
      case lp::kL1:
        block_terms<lp::kL1, M>(row, qs, scs, rad, m0, nb, block_d, p, base_l1, lane, tv, tu);
        break;
      case lp::kL2:
        block_terms<lp::kL2, M>(row, qs, scs, rad, m0, nb, block_d, p, base_l1, lane, tv, tu);
        break;
      case lp::kSqrt:
        block_terms<lp::kSqrt, M>(row, qs, scs, rad, m0, nb, block_d, p, base_l1, lane, tv, tu);
        break;
      case lp::kL15:
        block_terms<lp::kL15, M>(row, qs, scs, rad, m0, nb, block_d, p, base_l1, lane, tv, tu);
        break;
      default:
        block_terms<lp::kGeneral, M>(row, qs, scs, rad, m0, nb, block_d, p, base_l1, lane, tv,
                                     tu);
        break;
    }
    __syncwarp();
    // lane t sums block t's row of each tile (lanes t >= M repeat a block)
    const int own = lane & (M - 1);
    const float w = tree_sum(tv + own * kPitch);
    const float wb = tree_sum(tu + own * kPitch);
    __syncwarp();   // the next chunk's terms overwrite the tiles
    // lane t: the running sums through block m0 + t, added in block order from the sums
    // carried in; lanes t >= M end with the chunk's last sums, which carry on
    float s = s_in;
    float sbase = sbase_in;
#pragma unroll
    for (int j = 0; j < M; ++j) {
      const float wv = __shfl_sync(kFull, w, j);
      const float wu = __shfl_sync(kFull, wb, j);
      if (j <= lane) {
        s += wv;
        sbase += wu;
      }
    }
    bool dead = false;
    const int m = m0 + lane;
    if (lane < M && m < nb) {
      const int d_rem = d - (m + 1) * block_d;
      dead = s * lp::kDeflate > thr;
      if (!dead && d_rem > 0)
        dead = (s + lp::entry_bound(sb - sbase, base_l1, p, static_cast<float>(d_rem))) *
                   lp::kDeflate > thr;
    }
    const unsigned killed = __ballot_sync(kFull, dead);
    if (killed != 0u) {
      *keep = false;
      *nd = (m0 + __ffs(killed)) * block_d;
      return;
    }
    s_in = __shfl_sync(kFull, s, 31);
    sbase_in = __shfl_sync(kFull, sbase, 31);
  }
  *keep = true;
  *nd = d;
}

template <int M>
__global__ void __launch_bounds__(kMaxThreads)
gather_lp_screen_kernel(const int* __restrict__ ids, int ids_stride,
                        const float* __restrict__ q, const float* __restrict__ thresh,
                        const float* __restrict__ sb, int sb_stride,
                        const int8_t* __restrict__ codes, const float* __restrict__ scale,
                        const float* __restrict__ radius, const float* __restrict__ p,
                        float p_scalar, bool* __restrict__ keep_out, int* __restrict__ nd_out,
                        int C, int n, int d, int block_d, int cpb, bool base_l1, bool vec_f32,
                        int row_vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int dpad = (d + 3) & ~3;                  // floats, so each array is 16-byte aligned
  float* qs = reinterpret_cast<float*>(smem);
  float* scs = qs + dpad;
  float* rad = scs + dpad;
  const int row_pitch = (d + 15) & ~15;           // bytes of a warp's band row slot
  float* tiles = rad + dpad;                      // each warp's term tiles, 2 x M x kPitch
  const int b = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.y * cpb + warp;
  const bool active = warp < cpb && c < C;       // whole warps are active or not
  // the row's and the candidate's scalars first: their loads are independent
  const float thr = thresh[b];
  int id = -1;
  float sbv = 0.0f;
  if (active) {
    id = ids[static_cast<size_t>(b) * ids_stride + c];
    sbv = sb[static_cast<size_t>(b) * sb_stride + c];
  }
  const float pr = p != nullptr ? p[b] : p_scalar;
  const size_t slot = static_cast<size_t>(b) * C + c;
  if (thr == -INFINITY) {  // frozen row: every candidate dies at entry, nothing is loaded
    if (active && lane == 0) {
      keep_out[slot] = false;
      nd_out[slot] = 0;
    }
    return;
  }
  const bool live = active && id >= 0 && id < n &&
                    lp::entry_bound(sbv, base_l1, pr, static_cast<float>(d)) <= thr;
  // one round of copies: the query row, scales and radii, and each live band row
  const float* qrow = q + static_cast<size_t>(b) * d;
  if (vec_f32) {
    for (int i = threadIdx.x; i < d / 4; i += blockDim.x) {
      cp_async16(qs + 4 * i, qrow + 4 * i);
      cp_async16(scs + 4 * i, scale + 4 * i);
      cp_async16(rad + 4 * i, radius + 4 * i);
    }
  } else {
    for (int i = threadIdx.x; i < d; i += blockDim.x) {
      cp_async4(qs + i, qrow + i);
      cp_async4(scs + i, scale + i);
      cp_async4(rad + i, radius + i);
    }
  }
  float* tiles_end = tiles + static_cast<size_t>(cpb) * 2 * M * kPitch;
  int8_t* row = reinterpret_cast<int8_t*>(tiles_end) + static_cast<size_t>(warp) * row_pitch;
  if (live) {
    const int8_t* src = codes + static_cast<size_t>(id) * d;
    if (row_vec == 16) {
      for (int i = lane; i < d / 16; i += 32) cp_async16(row + 16 * i, src + 16 * i);
    } else if (row_vec == 4) {
      for (int i = lane; i < d / 4; i += 32) cp_async4(row + 4 * i, src + 4 * i);
    } else {
      for (int i = lane; i < d; i += 32) row[i] = __ldg(src + i);
    }
  }
  cp_async_wait_all();
  __syncthreads();
  if (!active) return;

  bool keep = false;
  int nd = 0;
  if (live) {
    float* tv = tiles + static_cast<size_t>(warp) * 2 * M * kPitch;
    screen_candidate<M>(row, qs, scs, rad, d, block_d, pr, base_l1, thr, sbv, lane, tv,
                        tv + M * kPitch, &keep, &nd);
  }
  if (lane == 0) {
    keep_out[slot] = keep;
    nd_out[slot] = nd;
  }
}

template <int M>
cudaError_t launch(const int* ids, int ids_stride, const float* q, const float* thresh,
                   const float* sb, int sb_stride, const int8_t* codes, const float* scale,
                   const float* radius, const float* p, float p_scalar, bool* keep, int* nd,
                   int B, int C, int n, int d, int block_d, bool base_l1, cudaStream_t stream) {
  // candidates per block: all of C if they fit in 8 warps, else C in equal chunks
  const int cap = kMaxThreads / 32;
  const int chunks = (C + cap - 1) / cap;
  const int cpb = (C + chunks - 1) / chunks;
  const int dpad = (d + 3) & ~3;
  const size_t floats = 3 * static_cast<size_t>(dpad) + static_cast<size_t>(cpb) * 2 * M * kPitch;
  const size_t smem = floats * sizeof(float) + static_cast<size_t>(cpb) * ((d + 15) & ~15);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        gather_lp_screen_kernel<M>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const auto aligned = [](const void* ptr, uintptr_t to) {
    return reinterpret_cast<uintptr_t>(ptr) % to == 0;
  };
  const bool vec_f32 = d % 4 == 0 && aligned(q, 16) && aligned(scale, 16) && aligned(radius, 16);
  const int row_vec = (d % 16 == 0 && aligned(codes, 16)) ? 16
                      : (d % 4 == 0 && aligned(codes, 4)) ? 4 : 1;
  gather_lp_screen_kernel<M><<<dim3(B, chunks), cpb * 32, smem, stream>>>(
      ids, ids_stride, q, thresh, sb, sb_stride, codes, scale, radius, p, p_scalar, keep, nd,
      C, n, d, block_d, cpb, base_l1, vec_f32, row_vec);
  return cudaGetLastError();
}

}  // namespace

// The arguments come packed in one int64 array (one ctypes argument in place of nineteen:
// the verification loop launches this kernel once per kappa batch):
//   a[0] ids (B, C) int32 with row stride a[1]; a[2] q (B, d) f32 in band coordinate order;
//   a[3] thresh (B,) f32; a[4] sb (B, C) f32 with row stride a[5]; a[6] codes (n, d) int8;
//   a[7] scale and a[8] radius (d,) f32; a[9] p (B,) f32 or 0 for the scalar p_scalar;
//   a[10] keep (B, C) bool and a[11] nd (B, C) int32 (contiguous); a[12..16] B, C, n, d,
//   block_d (d % block_d == 0); a[17] base_l1 (1 when sb holds L1 sums, 0 for squared L2);
//   a[18] the stream.
// Launches on the stream; returns cudaGetLastError().
extern "C" int gather_lp_screen_launch(const long long* a, float p_scalar) {
  const auto* ids = reinterpret_cast<const int*>(a[0]);
  const int ids_stride = static_cast<int>(a[1]);
  const auto* q = reinterpret_cast<const float*>(a[2]);
  const auto* thresh = reinterpret_cast<const float*>(a[3]);
  const auto* sb = reinterpret_cast<const float*>(a[4]);
  const int sb_stride = static_cast<int>(a[5]);
  const auto* codes = reinterpret_cast<const int8_t*>(a[6]);
  const auto* scale = reinterpret_cast<const float*>(a[7]);
  const auto* radius = reinterpret_cast<const float*>(a[8]);
  const auto* p = reinterpret_cast<const float*>(a[9]);
  auto* keep = reinterpret_cast<bool*>(a[10]);
  auto* nd = reinterpret_cast<int*>(a[11]);
  const int B = static_cast<int>(a[12]);
  const int C = static_cast<int>(a[13]);
  const int n = static_cast<int>(a[14]);
  const int d = static_cast<int>(a[15]);
  const int block_d = static_cast<int>(a[16]);
  const bool base_l1 = a[17] != 0;
  const auto stream = reinterpret_cast<cudaStream_t>(a[18]);
  if (B == 0 || C == 0) return 0;
  // blocks a chunk of the kill tests takes: 16 covers d / block_d <= 16 (Sun's 512 / 32)
  const cudaError_t err =
      d / block_d <= 16
          ? launch<16>(ids, ids_stride, q, thresh, sb, sb_stride, codes, scale, radius, p,
                       p_scalar, keep, nd, B, C, n, d, block_d, base_l1, stream)
          : launch<32>(ids, ids_stride, q, thresh, sb, sb_stride, codes, scale, radius, p,
                       p_scalar, keep, nd, B, C, n, d, block_d, base_l1, stream);
  return static_cast<int>(err);
}
