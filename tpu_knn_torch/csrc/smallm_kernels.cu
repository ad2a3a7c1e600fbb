// B2 (small-m lane minima) and B6 (small-m top-K lists): the exact
// diff-form kernels for 1 <= m <= 4, each with its bf16 instance (B2-bf16,
// B6-bf16) over a bf16 store's operand.

#include <type_traits>

#include "kselect.cuh"
#include "knn_common.cuh"

namespace {

// ---------------------------------------------------------------------------
// B2 — replaces tpu_knn/kernels/smallm.py:_smallm_kernel (built by
// _build_smallm_candidates): for 1 <= m <= 4 and k <= 32, the exact
// diff-form score, whose error scales with d^2 itself (no norm-trick
// cancellation), so its scores are exact candidates.
//
// Bound on the H100: device-memory reads, one pass over k*n*4 bytes (1 GiB
// at k=16, n=2^24, about 0.32 ms at 3.35 TB/s); the arithmetic is a few
// operations per byte. Design: the same lane-per-thread sweep as B1 with
// the queries in shared memory (broadcast reads). Each thread issues all k
// loads of a column before it uses them (KMAX, the next of 8/16/32 above k,
// is a compile-time bound with predicated loads), and the caller picks many
// partitions so that enough loads are in flight to cover device latency.
// ---------------------------------------------------------------------------
template <int M, int KMAX>
__global__ void __launch_bounds__(kLanes)
smallm_candidates_kernel(const float* __restrict__ q, const float* __restrict__ r,
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
// B2-bf16 — B2 over a bf16 store's SoA operand (tpu_knn's kernel upcasts at
// the read, smallm.py:94-97): the same candidates, bit for bit, as B2 over
// the same values stored in f32 at the same P (the upcast is exact, and
// each (row, column) is one fmaf(diff, diff, acc) chain over d = 0..k-1 in
// order; B2's rows past k add fmaf(0, 0, acc) == acc).
//
// Bound on the H100: device-memory reads, k*n*2 bytes (33.5 MB at k=16,
// n=2^20, about 0.010 ms); 2 flops a (row, coordinate) beside them, and
// the operand may sit in the 50 MB L2. Design: a thread owns V consecutive
// lanes of a group and reads them with one 2V-byte load a row (V = 8: 16
// bytes, where the operand's base and ld allow it; else the widest of 4,
// 2, 1 that they do, never a fallback), so a group is 128 / V threads and a
// block of kBf16Threads reads 2V groups side by side (slot s takes the
// partition's groups s, s + 2V, ...). A column's rows come bf16_rows(V)
// loads at a time (16 rows at V <= 4, 8 at V = 8: 128 bytes a thread in
// flight at V >= 4), all issued before any is used and kept as loaded
// (bf16 pairs in 32-bit words) until their fold; the per-(row, lane)
// minima of the slots are
// merged at the end (the lower score, the lower column on equal scores:
// the sequential fold's answer). The queries sit in shared memory as one
// float4 a coordinate (all m rows, zeros past m and k). V is capped at 4
// for m >= 3 (bf16_vec_cap): 8 lanes x 4 rows of (min, column) state and
// their sums would not fit kSmallmBf16BlocksPerSm blocks' registers.
// ---------------------------------------------------------------------------
constexpr int kSmallmMaxK = 32;
constexpr int kBf16ChunkWords = 32;
constexpr int kBf16MaxRows = 16;
// Threads of a block, and the resident blocks an SM that __launch_bounds__
// provides registers for (smallm.B2_BF16_BLOCKS_PER_SM sizes the grid to
// one wave of them: fewer, wider partitions than B2's, so the refine after
// it ranks fewer candidates).
constexpr int kBf16Threads = 256;
constexpr int kSmallmBf16BlocksPerSm = 2;

constexpr int kBf16WideMaxM = 2;
constexpr int kBf16NarrowVec = 4;

__host__ __device__ constexpr int bf16_vec_cap(int m) {
  return m <= kBf16WideMaxM ? 8 : kBf16NarrowVec;
}

// Rows a chunk: kBf16ChunkWords words of V-wide rows, at most kBf16MaxRows
// (a divisor of kSmallmMaxK).
__host__ __device__ constexpr int bf16_rows(int v) {
  return 2 * kBf16ChunkWords / v < kBf16MaxRows ? 2 * kBf16ChunkWords / v : kBf16MaxRows;
}

// One row of V bf16 values at p (2V-byte aligned) as loaded: value 2j in
// the low half of word j, 2j + 1 in its high half (V = 1: the value in the
// high half).
template <int V>
__device__ __forceinline__ void load_bf16_row(const __nv_bfloat16* p,
                                              unsigned (&w)[(V + 1) / 2]) {
  if constexpr (V == 8) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    w[0] = u.x;
    w[1] = u.y;
    w[2] = u.z;
    w[3] = u.w;
  } else if constexpr (V == 4) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    w[0] = u.x;
    w[1] = u.y;
  } else if constexpr (V == 2) {
    w[0] = __ldg(reinterpret_cast<const unsigned*>(p));
  } else {
    w[0] = static_cast<unsigned>(__ldg(reinterpret_cast<const unsigned short*>(p))) << 16;
  }
}

// Value v of a loaded row, upcast exactly (a bf16 is an f32's high half).
template <int V>
__device__ __forceinline__ float bf16_value(const unsigned (&w)[(V + 1) / 2], int v) {
  if constexpr (V == 1) {
    return __uint_as_float(w[0]);
  } else {
    return __uint_as_float(v % 2 == 0 ? w[v / 2] << 16 : w[v / 2] & 0xffff0000u);
  }
}

template <int M, int V>
__global__ void __launch_bounds__(kBf16Threads, kSmallmBf16BlocksPerSm)
smallm_bf16_candidates_kernel(const float* __restrict__ q, const __nv_bfloat16* __restrict__ r,
                              int32_t* __restrict__ out_i, float* __restrict__ out_s, int k,
                              long long ld, int n, int groups_per_part) {
  static_assert(M <= 4 && V <= bf16_vec_cap(M), "state of M rows x V lanes");
  constexpr int kGroupThreads = kLanes / V;
  constexpr int kSlots = kBf16Threads / kGroupThreads;
  constexpr int kRows = bf16_rows(V);
  constexpr int kWords = (V + 1) / 2;
  __shared__ float4 qs[kSmallmMaxK];  // qs[d] = (q[0][d], ..., q[M-1][d], 0...)
  for (int d = threadIdx.x; d < kSmallmMaxK; d += kBf16Threads) {
    float v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = i < M && d < k ? q[i * k + d] : 0.f;
    qs[d] = make_float4(v[0], v[1], v[2], v[3]);
  }
  __syncthreads();

  const int part = blockIdx.x;
  const int slot = threadIdx.x / kGroupThreads;
  const int lane0 = (threadIdx.x % kGroupThreads) * V;
  const long long g_first = static_cast<long long>(part) * groups_per_part;
  const long long groups = (static_cast<long long>(n) + kLanes - 1) / kLanes;
  const int own = static_cast<int>(max(0LL, min(static_cast<long long>(groups_per_part),
                                                groups - g_first)));
  float best_s[M][V];
  int best_i[M][V];
#pragma unroll
  for (int i = 0; i < M; ++i) {
#pragma unroll
    for (int v = 0; v < V; ++v) {
      best_s[i][v] = pos_inf();
      best_i[i][v] = kI32Max;
    }
  }
  for (int g = slot; g < own; g += kSlots) {
    const long long col = (g_first + g) * kLanes + lane0;
    // col < n <= ld, V | col and V | ld: the V columns lie inside the row.
    const bool live = col < n;
    const __nv_bfloat16* rc = r + col;
    float acc[M][V];
#pragma unroll
    for (int i = 0; i < M; ++i) {
#pragma unroll
      for (int v = 0; v < V; ++v) acc[i][v] = 0.f;
    }
    for (int d0 = 0; d0 < k; d0 += kRows) {
      unsigned w[kRows][kWords];
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        if (live && d0 + j < k) {
          load_bf16_row<V>(rc + static_cast<long long>(d0 + j) * ld, w[j]);
        } else {
#pragma unroll
          for (int h = 0; h < kWords; ++h) w[j][h] = 0u;
        }
      }
      // Rows past k: 0 against a 0 query coordinate, fmaf(0, 0, acc) ==
      // acc (acc is never -0).
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const float4 qd4 = qs[d0 + j];
        const float qd[4] = {qd4.x, qd4.y, qd4.z, qd4.w};
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const float x = bf16_value<V>(w[j], v);
#pragma unroll
          for (int i = 0; i < M; ++i) {
            const float diff = x - qd[i];
            acc[i][v] = fmaf(diff, diff, acc[i][v]);
          }
        }
      }
    }
#pragma unroll
    for (int v = 0; v < V; ++v) {
      if (col + v < n) {
#pragma unroll
        for (int i = 0; i < M; ++i) {
          if (acc[i][v] < best_s[i][v]) {
            best_s[i][v] = acc[i][v];
            best_i[i][v] = static_cast<int>(col) + v;
          }
        }
      }
    }
  }

  __shared__ float merge_s[kSlots][M][kLanes];
  __shared__ int merge_i[kSlots][M][kLanes];
#pragma unroll
  for (int i = 0; i < M; ++i) {
#pragma unroll
    for (int v = 0; v < V; ++v) {
      merge_s[slot][i][lane0 + v] = best_s[i][v];
      merge_i[slot][i][lane0 + v] = best_i[i][v];
    }
  }
  __syncthreads();
  const long long width = static_cast<long long>(gridDim.x) * kLanes;
  for (int e = threadIdx.x; e < M * kLanes; e += kBf16Threads) {
    const int i = e / kLanes;
    const int t = e % kLanes;
    float b = merge_s[0][i][t];
    int bi = merge_i[0][i][t];
#pragma unroll
    for (int sl = 1; sl < kSlots; ++sl) {
      const float s = merge_s[sl][i][t];
      const int c = merge_i[sl][i][t];
      if (s < b || (s == b && c < bi)) {
        b = s;
        bi = c;
      }
    }
    const long long o = i * width + static_cast<long long>(part) * kLanes + t;
    out_i[o] = bi;
    out_s[o] = b;
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
// B6-bf16 — B6 over a bf16 store's SoA operand (tpu_knn's kernel upcasts at
// the read, index.py:1625-1627): per (row, partition) the kk
// lexicographically smallest (exact diff-form score, column) pairs with
// score <= the row's bound, B6's contract, bit for bit as B6 over the same
// values stored in f32 at the same P: B2-bf16's scan and arithmetic (each
// (row, column) one fmaf(diff, diff, acc) chain over d = 0..k-1 in order,
// as load_column + diff_score form it) and B6's K-selection, whose kept set
// does not depend on the order of the offers.
//
// Bound on the H100: device-memory reads, k*n*2 bytes (0.5 GiB at k=16,
// n=2^24, about 0.16 ms at 3.35 TB/s). Design: B2-bf16's blocks and loads
// (256 threads, a thread owning V consecutive lanes of a group read with
// one 2V-byte load a row, 2V groups side by side, the rows of a column
// chunk all loaded before their fold; V from the base and ld, capped at 4
// for m >= 3) at B2-bf16's P (smallm.bf16_parts: 2 blocks an SM), with
// B6's selection in place of the lane fold: each of the 8 warps keeps its
// own list per row (KSelectState, 16.5 KB a block at m = 4), a vote per
// (column group, row set) skips the selection where no lane's V scores
// pass, and at the end warp i merges the 8 warps' lists of row i into the
// partition's. A block's trip count over its groups is uniform, so every
// warp reaches the warp-collective offers together.
// ---------------------------------------------------------------------------
constexpr int kBf16Warps = kBf16Threads / 32;

template <int M, int V>
__global__ void __launch_bounds__(kBf16Threads, kSmallmBf16BlocksPerSm)
smallm_bf16_kselect_kernel(const float* __restrict__ q, const __nv_bfloat16* __restrict__ r,
                           const float* __restrict__ bound, int32_t* __restrict__ out_i,
                           float* __restrict__ out_s, int k, long long ld, int n,
                           int groups_per_part, int kk) {
  static_assert(M <= 4 && V <= bf16_vec_cap(M), "state of M rows x V lanes");
  constexpr int kGroupThreads = kLanes / V;
  constexpr int kSlots = kBf16Threads / kGroupThreads;
  constexpr int kRows = bf16_rows(V);
  constexpr int kWords = (V + 1) / 2;
  __shared__ float4 qs[kSmallmMaxK];  // qs[d] = (q[0][d], ..., q[M-1][d], 0...)
  __shared__ KSelectState<kBf16Warps * M> ks;  // warp w's list of row i at w*M + i
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
  for (int d = threadIdx.x; d < kSmallmMaxK; d += kBf16Threads) {
    float v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = i < M && d < k ? q[i * k + d] : 0.f;
    qs[d] = make_float4(v[0], v[1], v[2], v[3]);
  }
  __syncthreads();

  const int part = blockIdx.x;
  const int slot = threadIdx.x / kGroupThreads;
  const int lane0 = (threadIdx.x % kGroupThreads) * V;
  const long long g_first = static_cast<long long>(part) * groups_per_part;
  const long long groups = (static_cast<long long>(n) + kLanes - 1) / kLanes;
  const int own = static_cast<int>(max(0LL, min(static_cast<long long>(groups_per_part),
                                                groups - g_first)));
  for (int g0 = 0; g0 < own; g0 += kSlots) {  // block-uniform
    const int g = g0 + slot;
    const long long col = (g_first + g) * kLanes + lane0;
    // col < n <= ld, V | col and V | ld: the V columns lie inside the row.
    const bool live = g < own && col < n;
    const __nv_bfloat16* rc = r + (live ? col : 0);
    float acc[M][V];
#pragma unroll
    for (int i = 0; i < M; ++i) {
#pragma unroll
      for (int v = 0; v < V; ++v) acc[i][v] = 0.f;
    }
    for (int d0 = 0; d0 < k; d0 += kRows) {
      unsigned w[kRows][kWords];
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        if (live && d0 + j < k) {
          load_bf16_row<V>(rc + static_cast<long long>(d0 + j) * ld, w[j]);
        } else {
#pragma unroll
          for (int h = 0; h < kWords; ++h) w[j][h] = 0u;
        }
      }
      // Rows past k: 0 against a 0 query coordinate, fmaf(0, 0, acc) ==
      // acc (acc is never -0).
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const float4 qd4 = qs[d0 + j];
        const float qd[4] = {qd4.x, qd4.y, qd4.z, qd4.w};
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const float x = bf16_value<V>(w[j], v);
#pragma unroll
          for (int i = 0; i < M; ++i) {
            const float diff = x - qd[i];
            acc[i][v] = fmaf(diff, diff, acc[i][v]);
          }
        }
      }
    }
    // The scores in place of the sums; a column past n (or a dead slot)
    // becomes NaN, which no compare admits.
    const int c = static_cast<int>(col);
    bool any = false;
#pragma unroll
    for (int i = 0; i < M; ++i) {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        acc[i][v] = live && col + v < n ? acc[i][v] : __int_as_float(0x7fc00000);
        any |= kselect_passes(acc[i][v], c + v, ts[i], tc[i]);
      }
    }
    if (__any_sync(kFullMask, any)) {  // warp-uniform; rare past the bound
#pragma unroll
      for (int i = 0; i < M; ++i) kselect_offer(ks, warp * M + i, kk, acc[i], c, 1, ts[i], tc[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < M; ++i) kselect_flush(ks, warp * M + i, kk);
  __syncthreads();

  if (warp < M) {  // warp i: row i's lists into the partition's one
    const int i = warp;
    float s = ks.ls[i][lane];
    int c = ks.li[i][lane];
#pragma unroll
    for (int w = 1; w < kBf16Warps; ++w) {
      merge_lists(s, c, ks.ls[w * M + i][31 - lane], ks.li[w * M + i][31 - lane]);
    }
    kselect_write(s, c, out_i, out_s, static_cast<long long>(i) * gridDim.x * kk,
                  list_of(g_first * kLanes, groups_per_part), kk);
  }
}

// ---------------------------------------------------------------------------
// Launchers.
// ---------------------------------------------------------------------------

template <int M>
int launch_smallm(const float* q, const float* r, int32_t* out_i, float* out_s, int k,
                  long long ld, int n, int parts, int groups_per_part, cudaStream_t stream) {
  if (k <= 8) {
    smallm_candidates_kernel<M, 8><<<parts, kLanes, 0, stream>>>(q, r, out_i, out_s, k, ld, n,
                                                                 groups_per_part);
  } else if (k <= 16) {
    smallm_candidates_kernel<M, 16><<<parts, kLanes, 0, stream>>>(q, r, out_i, out_s, k, ld, n,
                                                                  groups_per_part);
  } else {
    smallm_candidates_kernel<M, 32><<<parts, kLanes, 0, stream>>>(q, r, out_i, out_s, k, ld, n,
                                                                  groups_per_part);
  }
  return static_cast<int>(cudaGetLastError());
}

// The widest load the operand admits: 2V-byte aligned base, V | ld.
inline int bf16_vec(const void* r, long long ld) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(r);
  for (int v = 8; v > 1; v /= 2) {
    if (a % (2 * v) == 0 && ld % v == 0) return v;
  }
  return 1;
}

template <int M, int V>
int launch_smallm_bf16_vec(const float* q, const __nv_bfloat16* r, int32_t* out_i,
                           float* out_s, int k, long long ld, int n, int parts,
                           int groups_per_part, cudaStream_t stream) {
  if constexpr (V > bf16_vec_cap(M)) {
    return launch_smallm_bf16_vec<M, bf16_vec_cap(M)>(q, r, out_i, out_s, k, ld, n, parts,
                                                      groups_per_part, stream);
  } else {
    smallm_bf16_candidates_kernel<M, V><<<parts, kBf16Threads, 0, stream>>>(
        q, r, out_i, out_s, k, ld, n, groups_per_part);
    return static_cast<int>(cudaGetLastError());
  }
}

template <int M>
int launch_smallm_bf16(const float* q, const __nv_bfloat16* r, int32_t* out_i, float* out_s,
                       int k, long long ld, int n, int parts, int groups_per_part,
                       cudaStream_t stream) {
  switch (bf16_vec(r, ld)) {
    case 8: return launch_smallm_bf16_vec<M, 8>(q, r, out_i, out_s, k, ld, n, parts,
                                                groups_per_part, stream);
    case 4: return launch_smallm_bf16_vec<M, 4>(q, r, out_i, out_s, k, ld, n, parts,
                                                groups_per_part, stream);
    case 2: return launch_smallm_bf16_vec<M, 2>(q, r, out_i, out_s, k, ld, n, parts,
                                                groups_per_part, stream);
    default: return launch_smallm_bf16_vec<M, 1>(q, r, out_i, out_s, k, ld, n, parts,
                                                 groups_per_part, stream);
  }
}

// B2's and B2-bf16's entry: 1 <= m <= 4, 1 <= k <= 32.
template <typename RT>
int smallm_entry(const float* q, const RT* r, int32_t* out_i, float* out_s, int m, int k,
                 long long ld, int n, int parts, void* stream) {
  if (!valid_geometry(m, k, ld, n, parts) || k > kSmallmMaxK) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int gpp = groups_per_part(n, parts);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if constexpr (std::is_same_v<RT, float>) {
    switch (m) {
      case 1: return launch_smallm<1>(q, r, out_i, out_s, k, ld, n, parts, gpp, s);
      case 2: return launch_smallm<2>(q, r, out_i, out_s, k, ld, n, parts, gpp, s);
      case 3: return launch_smallm<3>(q, r, out_i, out_s, k, ld, n, parts, gpp, s);
      case 4: return launch_smallm<4>(q, r, out_i, out_s, k, ld, n, parts, gpp, s);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  } else {
    switch (m) {
      case 1: return launch_smallm_bf16<1>(q, r, out_i, out_s, k, ld, n, parts, gpp, s);
      case 2: return launch_smallm_bf16<2>(q, r, out_i, out_s, k, ld, n, parts, gpp, s);
      case 3: return launch_smallm_bf16<3>(q, r, out_i, out_s, k, ld, n, parts, gpp, s);
      case 4: return launch_smallm_bf16<4>(q, r, out_i, out_s, k, ld, n, parts, gpp, s);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
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

template <int M, int V>
int launch_smallm_topk_bf16_vec(const float* q, const __nv_bfloat16* r, const float* bound,
                                int32_t* out_i, float* out_s, int k, long long ld, int n,
                                int parts, int groups_per_part, int kk, cudaStream_t s) {
  if constexpr (V > bf16_vec_cap(M)) {
    return launch_smallm_topk_bf16_vec<M, bf16_vec_cap(M)>(q, r, bound, out_i, out_s, k, ld, n,
                                                           parts, groups_per_part, kk, s);
  } else {
    smallm_bf16_kselect_kernel<M, V><<<parts, kBf16Threads, 0, s>>>(
        q, r, bound, out_i, out_s, k, ld, n, groups_per_part, kk);
    return static_cast<int>(cudaGetLastError());
  }
}

template <int M>
int launch_smallm_topk_bf16(const float* q, const __nv_bfloat16* r, const float* bound,
                            int32_t* out_i, float* out_s, int k, long long ld, int n, int parts,
                            int groups_per_part, int kk, cudaStream_t s) {
  switch (bf16_vec(r, ld)) {
    case 8: return launch_smallm_topk_bf16_vec<M, 8>(q, r, bound, out_i, out_s, k, ld, n, parts,
                                                     groups_per_part, kk, s);
    case 4: return launch_smallm_topk_bf16_vec<M, 4>(q, r, bound, out_i, out_s, k, ld, n, parts,
                                                     groups_per_part, kk, s);
    case 2: return launch_smallm_topk_bf16_vec<M, 2>(q, r, bound, out_i, out_s, k, ld, n, parts,
                                                     groups_per_part, kk, s);
    default: return launch_smallm_topk_bf16_vec<M, 1>(q, r, bound, out_i, out_s, k, ld, n,
                                                      parts, groups_per_part, kk, s);
  }
}

// B6's and B6-bf16's entry: 1 <= m <= 4, 1 <= k <= 32, 1 <= kk <= 32.
template <typename RT>
int smallm_topk_entry(const float* q, const RT* r, const float* bound, int32_t* out_i,
                      float* out_s, int m, int k, long long ld, int n, int parts, int kk,
                      void* stream) {
  if (!valid_geometry(m, k, ld, n, parts) || k > kSmallmMaxK || kk < 1 || kk > kListSlots) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int gpp = groups_per_part(n, parts);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if constexpr (std::is_same_v<RT, float>) {
    switch (m) {
      case 1: return launch_smallm_topk<1>(q, r, bound, out_i, out_s, k, ld, n, parts, gpp, kk, s);
      case 2: return launch_smallm_topk<2>(q, r, bound, out_i, out_s, k, ld, n, parts, gpp, kk, s);
      case 3: return launch_smallm_topk<3>(q, r, bound, out_i, out_s, k, ld, n, parts, gpp, kk, s);
      case 4: return launch_smallm_topk<4>(q, r, bound, out_i, out_s, k, ld, n, parts, gpp, kk, s);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  } else {
    switch (m) {
      case 1: return launch_smallm_topk_bf16<1>(q, r, bound, out_i, out_s, k, ld, n, parts, gpp,
                                                kk, s);
      case 2: return launch_smallm_topk_bf16<2>(q, r, bound, out_i, out_s, k, ld, n, parts, gpp,
                                                kk, s);
      case 3: return launch_smallm_topk_bf16<3>(q, r, bound, out_i, out_s, k, ld, n, parts, gpp,
                                                kk, s);
      case 4: return launch_smallm_topk_bf16<4>(q, r, bound, out_i, out_s, k, ld, n, parts, gpp,
                                                kk, s);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
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
  return smallm_topk_entry(q, r, bound, out_i, out_s, m, k, ld, n, parts, kk, stream);
}

// B6-bf16 launch: B6 over a bf16 SoA operand (a bf16 store), at B2-bf16's
// blocks and load widths.
int tk_smallm_topk_candidates_bf16(const float* q, const void* r, const float* bound,
                                   int32_t* out_i, float* out_s, int m, int k, long long ld,
                                   int n, int parts, int kk, void* stream) {
  return smallm_topk_entry(q, static_cast<const __nv_bfloat16*>(r), bound, out_i, out_s, m, k,
                           ld, n, parts, kk, stream);
}

}  // extern "C"
