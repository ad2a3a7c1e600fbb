// B2 (small-m lane minima) and B6 (small-m top-K lists): the exact
// diff-form kernels for 1 <= m <= 4.

#include "kselect.cuh"
#include "knn_common.cuh"

namespace {

// ---------------------------------------------------------------------------
// B2 — replaces tpu_knn/kernels/smallm.py:_smallm_kernel (built by
// _build_smallm_candidates): for 1 <= m <= 4 and k <= 32, the exact
// diff-form score, whose error scales with d^2 itself (no norm-trick
// cancellation), so its scores are exact candidates. RT is the operand's
// type: float, or __nv_bfloat16 for a bf16 store (B2-bf16: upcast at the
// read, as tpu_knn's kernel does, smallm.py:94-97; half the bytes).
//
// Bound on the H100: device-memory reads, one pass over k*n*4 bytes (1 GiB
// at k=16, n=2^24, about 0.32 ms at 3.35 TB/s); the arithmetic is a few
// operations per byte. Design: the same lane-per-thread sweep as B1 with
// the queries in shared memory (broadcast reads). Each thread issues all k
// loads of a column before it uses them (KMAX, the next of 8/16/32 above k,
// is a compile-time bound with predicated loads), and the caller picks many
// partitions so that enough loads are in flight to cover device latency.
// ---------------------------------------------------------------------------
template <int M, int KMAX, typename RT>
__global__ void __launch_bounds__(kLanes)
smallm_candidates_kernel(const float* __restrict__ q, const RT* __restrict__ r,
                         int32_t* __restrict__ out_i, float* __restrict__ out_s,
                         int k, long long ld, int n, int groups_per_part) {
  __shared__ float qs[M * KMAX];
  const int part = blockIdx.x;
  const int lane = threadIdx.x;
  load_small_queries<M, KMAX>(q, qs, k);

  float best_s[M];
  int best_i[M];
#pragma unroll
  for (int i = 0; i < M; ++i) {
    best_s[i] = pos_inf();
    best_i[i] = kI32Max;
  }

  const long long first = static_cast<long long>(part) * groups_per_part * kLanes + lane;
  for (int g = 0; g < groups_per_part; ++g) {
    const long long col = first + static_cast<long long>(g) * kLanes;
    if (col >= n) break;
    float rv[KMAX];
    load_column<KMAX>(r + col, ld, k, rv);
    const int c = static_cast<int>(col);
#pragma unroll
    for (int i = 0; i < M; ++i) {
      const float acc = diff_score<KMAX>(rv, qs + i * KMAX);
      if (acc < best_s[i]) {
        best_s[i] = acc;
        best_i[i] = c;
      }
    }
  }

  const long long width = static_cast<long long>(gridDim.x) * kLanes;
#pragma unroll
  for (int i = 0; i < M; ++i) {
    const long long o = i * width + static_cast<long long>(part) * kLanes + lane;
    out_i[o] = best_i[i];
    out_s[o] = best_s[i];
  }
}

// ---------------------------------------------------------------------------
// B6 — replaces tpu_knn/kernels/topk.py:262 _smallm_topk_kernel (built by
// _build_smallm_topk_candidates): for 1 <= m <= 4 and k <= 32, per (row,
// partition) the kk lexicographically smallest (exact diff-form score,
// column) pairs with score <= the row's bound B, sorted, the rest of the
// list the seed (B, INT32_MAX) (kselect.cuh's list map and contract). B is
// the K-th smallest of a B2 pass's lane minima, a provable upper bound on
// the row's K-th score: the K elements behind it score <= B here too,
// since B6 scores a column with B2's arithmetic (load_column, diff_score)
// bit for bit, so every row ends with at least K real entries and the
// seeds lose the final selection.
//
// Bound on the H100: device-memory reads, as B2 (1 GiB at k=16, n=2^24,
// about 0.32 ms at 3.35 TB/s). Design: B2's sweep and load pattern (a
// block of 128 threads walks a partition's 128-column groups, each thread
// a column of each, all k loads of a column in flight) at B2's arithmetic
// and small state: each warp keeps its own list per row (KSelectState, 8
// KB a block at m = 4), so 8 blocks fit an SM (6 at k > 16) and keep loads
// in flight. The bound rejects nearly every element (about K a row
// pass across all of n), so a vote per column group skips the selection;
// the rare passing element goes to its warp's queue with a ballot. At the
// end warp i merges the four warps' lists of row i into the partition's.
// ---------------------------------------------------------------------------

constexpr int kSmallmWarps = kLanes / 32;
// Resident blocks of 128 threads an SM (__launch_bounds__): at KMAX <= 16
// (topk.B6_BLOCKS_PER_SM), and at KMAX = 32, whose 32 loads in flight and
// 4 rows' thresholds need more than 64 registers (B6_WIDE_BLOCKS_PER_SM).
constexpr int kSmallmTopkBlocksPerSm = 8;
constexpr int kSmallmTopkWideBlocksPerSm = 6;

template <int M, int KMAX>
__global__ void __launch_bounds__(kLanes, KMAX > 16 ? kSmallmTopkWideBlocksPerSm
                                                    : kSmallmTopkBlocksPerSm)
smallm_kselect_kernel(const float* __restrict__ q, const float* __restrict__ r,
                      const float* __restrict__ bound, int32_t* __restrict__ out_i,
                      float* __restrict__ out_s, int k, long long ld, int n,
                      int groups_per_part, int kk) {
  static_assert(M <= kSmallmWarps, "warp i merges row i");
  __shared__ float qs[M * KMAX];
  __shared__ KSelectState<kSmallmWarps * M> ks;  // warp w's list of row i at w*M + i
  const int part = blockIdx.x;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float ts[M];  // each row's kk-th entry, kept up to date by kselect_offer
  int tc[M];
#pragma unroll
  for (int i = 0; i < M; ++i) {
    ts[i] = bound[i];
    tc[i] = kI32Max;
    kselect_init(ks, warp * M + i, ts[i]);
  }
  load_small_queries<M, KMAX>(q, qs, k);

  const long long g0 = static_cast<long long>(part) * groups_per_part;
  const long long groups = (static_cast<long long>(n) + kLanes - 1) / kLanes;
  const int own = static_cast<int>(max(0LL, min(static_cast<long long>(groups_per_part),
                                                groups - g0)));
  const long long first = g0 * kLanes + threadIdx.x;
  for (int g = 0; g < own; ++g) {
    const long long col = first + static_cast<long long>(g) * kLanes;
    const bool live = col < n;
    float rv[KMAX];
    load_column<KMAX>(r + (live ? col : 0), ld, k, rv);
    const int c = static_cast<int>(col);
    float s[M][1];
    bool any = false;
#pragma unroll
    for (int i = 0; i < M; ++i) {
      s[i][0] = live ? diff_score<KMAX>(rv, qs + i * KMAX) : __int_as_float(0x7fc00000);
      any |= kselect_passes(s[i][0], c, ts[i], tc[i]);
    }
    if (__any_sync(kFullMask, any)) {  // warp-uniform; rare past the bound
#pragma unroll
      for (int i = 0; i < M; ++i) kselect_offer(ks, warp * M + i, kk, s[i], c, 0, ts[i], tc[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < M; ++i) kselect_flush(ks, warp * M + i, kk);
  __syncthreads();

  if (warp < M) {  // warp i: row i's four lists into the partition's one
    const int i = warp;
    float s = ks.ls[i][lane];
    int c = ks.li[i][lane];
#pragma unroll
    for (int w = 1; w < kSmallmWarps; ++w) {
      merge_lists(s, c, ks.ls[w * M + i][31 - lane], ks.li[w * M + i][31 - lane]);
    }
    kselect_write(s, c, out_i, out_s, static_cast<long long>(i) * gridDim.x * kk,
                  list_of(g0 * kLanes, groups_per_part), kk);
  }
}

// ---------------------------------------------------------------------------
// Launchers.
// ---------------------------------------------------------------------------

template <int M, typename RT>
int launch_smallm(const float* q, const RT* r, int32_t* out_i, float* out_s, int k,
                  long long ld, int n, int parts, int groups_per_part,
                  cudaStream_t stream) {
  if (k <= 8) {
    smallm_candidates_kernel<M, 8, RT><<<parts, kLanes, 0, stream>>>(
        q, r, out_i, out_s, k, ld, n, groups_per_part);
  } else if (k <= 16) {
    smallm_candidates_kernel<M, 16, RT><<<parts, kLanes, 0, stream>>>(
        q, r, out_i, out_s, k, ld, n, groups_per_part);
  } else {
    smallm_candidates_kernel<M, 32, RT><<<parts, kLanes, 0, stream>>>(
        q, r, out_i, out_s, k, ld, n, groups_per_part);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename RT>
int smallm_entry(const float* q, const RT* r, int32_t* out_i, float* out_s, int m, int k,
                 long long ld, int n, int parts, void* stream) {
  if (!valid_geometry(m, k, ld, n, parts) || k > 32) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int gpp = groups_per_part(n, parts);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (m) {
    case 1: return launch_smallm<1>(q, r, out_i, out_s, k, ld, n, parts, gpp, s);
    case 2: return launch_smallm<2>(q, r, out_i, out_s, k, ld, n, parts, gpp, s);
    case 3: return launch_smallm<3>(q, r, out_i, out_s, k, ld, n, parts, gpp, s);
    case 4: return launch_smallm<4>(q, r, out_i, out_s, k, ld, n, parts, gpp, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int M>
int launch_smallm_topk(const float* q, const float* r, const float* bound, int32_t* out_i,
                       float* out_s, int k, long long ld, int n, int parts, int groups_per_part,
                       int kk, cudaStream_t s) {
  if (k <= 8) {
    smallm_kselect_kernel<M, 8><<<parts, kLanes, 0, s>>>(q, r, bound, out_i, out_s, k, ld, n,
                                                         groups_per_part, kk);
  } else if (k <= 16) {
    smallm_kselect_kernel<M, 16><<<parts, kLanes, 0, s>>>(q, r, bound, out_i, out_s, k, ld, n,
                                                          groups_per_part, kk);
  } else {
    smallm_kselect_kernel<M, 32><<<parts, kLanes, 0, s>>>(q, r, bound, out_i, out_s, k, ld, n,
                                                          groups_per_part, kk);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// B2 launch: 1 <= m <= 4, 1 <= k <= 32.
int tk_smallm_candidates(const float* q, const float* r, int32_t* out_i, float* out_s,
                         int m, int k, long long ld, int n, int parts, void* stream) {
  return smallm_entry(q, r, out_i, out_s, m, k, ld, n, parts, stream);
}

// B2-bf16 launch: B2 over a bf16 SoA operand (a bf16 store).
int tk_smallm_candidates_bf16(const float* q, const void* r, int32_t* out_i, float* out_s,
                              int m, int k, long long ld, int n, int parts, void* stream) {
  return smallm_entry(q, static_cast<const __nv_bfloat16*>(r), out_i, out_s, m, k, ld, n,
                      parts, stream);
}

// B6 launch: 1 <= m <= 4, 1 <= k <= 32, 1 <= kk <= 32; bound (m,) f32;
// outputs are (m, parts*kk), kselect.cuh's list map.
int tk_smallm_topk_candidates(const float* q, const float* r, const float* bound,
                              int32_t* out_i, float* out_s, int m, int k, long long ld, int n,
                              int parts, int kk, void* stream) {
  if (!valid_geometry(m, k, ld, n, parts) || k > 32 || kk < 1 || kk > kListSlots) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int gpp = groups_per_part(n, parts);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (m) {
    case 1: return launch_smallm_topk<1>(q, r, bound, out_i, out_s, k, ld, n, parts, gpp, kk, s);
    case 2: return launch_smallm_topk<2>(q, r, bound, out_i, out_s, k, ld, n, parts, gpp, kk, s);
    case 3: return launch_smallm_topk<3>(q, r, bound, out_i, out_s, k, ld, n, parts, gpp, kk, s);
    case 4: return launch_smallm_topk<4>(q, r, bound, out_i, out_s, k, ld, n, parts, gpp, kk, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
