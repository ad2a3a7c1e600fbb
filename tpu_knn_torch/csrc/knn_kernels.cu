// Hand-written Hopper (sm_90a) kernels of tpu_knn_torch, bound with ctypes
// through a plain C interface (csrc/build.py compiles this file with nvcc).
//
// Every kernel produces the candidate contract of tpu_knn's Pallas kernels:
// the reference columns are cut into P contiguous partitions of whole
// 128-column groups, and lane l of partition p walks columns
// p*G*128 + l, p*G*128 + l + 128, ... (G groups per partition) in
// increasing order. The 1-NN kernels (B1, B2, B4) keep a running
// (min score, index) pair per lane with a strict `<`, so the earliest column
// wins among equal scores and a NaN never enters; a lane that saw no
// column reports (+inf, INT32_MAX). The top-K kernels (B5, B6) keep each
// lane's K lexicographically smallest (score, column) pairs, sorted. P = 1
// is exactly the TPU kernels' (m, 128) contract; P > 1 is v7's rebased
// (m, P*128) contract. Indices are global column numbers. Columns >= n are
// masked (never folded). The seeded top-K engine's kernels follow:
// B3 (value-only lane minima, merged to 128 lanes), B7 (per-cell integer
// moments of the columns under a bound) and the B8/B9 cell compactor.
//
// Operands: q is (m, k) row-major f32; r is the SoA operand, k rows of a
// (k_pad, ld) row-major f32 array (only rows 0..k-1 are read: the zero
// rows k..k_pad-1 are distance-neutral). Outputs are (m, width) int32/f32.
// The kernels allocate nothing and do not synchronise; each entry point
// returns the cudaError_t of its launch.
//
// A Hopper block has no carry into the next block, so where the TPU grid
// swept n in order on one core, here one block owns (row tile, partition)
// and loops over its partition's columns itself; P is chosen by the caller
// so that the grid fills the card's 132 SMs.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kLanes = 128;  // candidate lanes per partition = threads per block
constexpr int kI32Max = 2147483647;
constexpr int kMaxGridY = 65535;
constexpr int kDefaultSmem = 48 * 1024;

__device__ __forceinline__ float pos_inf() { return __int_as_float(0x7f800000); }
__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

// ---------------------------------------------------------------------------
// The score arithmetic of B1, B4 and B5: s = |r|^2 - 2 q.r in plain f32 FMA
// (tpu_knn's "highest" tier). All three kernels call this one function, so a
// (row, column) pair gets a bit-identical score from each of them, whatever
// tile or partition count a launch picks: |r|^2 and each q.r are one fmaf
// chain over d = 0..k-1 in order, and 2*acc is exact. The top-K "passes"
// engine rests on that (its bound is a score B4 reported on an earlier pass),
// and so does the exact agreement of the sweep (B5) and passes engines.
// ---------------------------------------------------------------------------

// The TM query rows of a block, transposed into shared memory: qT[d*TM + i].
template <int TM>
__device__ __forceinline__ void load_query_tile(const float* __restrict__ q, float* qT,
                                                int m, int k, int row0) {
  for (int e = threadIdx.x; e < k * TM; e += blockDim.x) {
    const int d = e / TM;
    const int i = e - d * TM;
    const int row = row0 + i;
    qT[e] = row < m ? q[static_cast<long long>(row) * k + d] : 0.f;
  }
  __syncthreads();
}

// One reference column against the TM rows: one 16-byte broadcast load of
// qT feeds four FMAs, and each loaded reference value feeds TM FMAs.
template <int TM>
__device__ __forceinline__ void column_scores(const float* qT, const float* __restrict__ rc,
                                              long long ld, int k, float (&s)[TM]) {
  float acc[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) acc[i] = 0.f;
  float norm = 0.f;
#pragma unroll 4
  for (int d = 0; d < k; ++d) {
    const float rv = __ldg(rc + d * ld);
    norm = fmaf(rv, rv, norm);
    const float* qd = qT + d * TM;
    if constexpr (TM % 4 == 0) {
#pragma unroll
      for (int i = 0; i < TM; i += 4) {
        const float4 qv = *reinterpret_cast<const float4*>(qd + i);
        acc[i] = fmaf(qv.x, rv, acc[i]);
        acc[i + 1] = fmaf(qv.y, rv, acc[i + 1]);
        acc[i + 2] = fmaf(qv.z, rv, acc[i + 2]);
        acc[i + 3] = fmaf(qv.w, rv, acc[i + 3]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < TM; ++i) acc[i] = fmaf(qd[i], rv, acc[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) s[i] = norm - 2.f * acc[i];
}

// The exact diff-form arithmetic of B2 and B6: sum_d (r[d,col] - q[d])^2,
// one fmaf chain over d in order. B6's bound is the K-th smallest of B2's
// lane minima, so the two kernels must score a column identically.
template <int KMAX>
__device__ __forceinline__ void load_column(const float* __restrict__ rc, long long ld, int k,
                                            float (&rv)[KMAX]) {
  // All k loads of a column are issued before they are used; rows
  // k..KMAX-1 load as 0 against a 0 query coordinate: distance-neutral.
#pragma unroll
  for (int d = 0; d < KMAX; ++d) rv[d] = d < k ? __ldg(rc + d * ld) : 0.f;
}

template <int KMAX>
__device__ __forceinline__ float diff_score(const float (&rv)[KMAX], const float* qi) {
  float acc = 0.f;
#pragma unroll
  for (int d = 0; d < KMAX; ++d) {
    const float diff = rv[d] - qi[d];
    acc = fmaf(diff, diff, acc);
  }
  return acc;
}

template <int M, int KMAX>
__device__ __forceinline__ void load_small_queries(const float* __restrict__ q, float* qs, int k) {
  for (int e = threadIdx.x; e < M * KMAX; e += kLanes) {
    const int i = e / KMAX;
    const int d = e - i * KMAX;
    qs[e] = d < k ? q[i * k + d] : 0.f;
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// B1 — replaces tpu_knn/kernels/fused.py:_fused_kernel (built by
// _build_fused_candidates), the "highest" tier, and
// B4 — replaces tpu_knn/kernels/fused.py:_fused_banded_kernel (built by
// _build_banded_candidates): B1's fold over only the elements that lie
// lexicographically above the row's bound (b_s, b_i), i.e.
// s > b_s || (s == b_s && col > b_i). One B4 launch is one pass of the
// top-K "passes" engine: the reported point's lane yields its runner-up on
// the next pass, so per-lane top-1 state serves any K.
//
// Bound on the H100: arithmetic. At (k=16, m=1024, n=2^20) it is m*n*k =
// 2^34 FMA, about 0.51 ms at the 67 TFLOP/s f32 peak, per launch; the
// operand is read once per row tile (64 MB per tile, mostly from L2).
// Design: a block owns TM query rows and one partition; thread t owns
// lane t and walks its columns, so a warp's loads of r[d, col] are
// coalesced (the operand is SoA). Per row a thread keeps its best score
// and index (and, for B4, the row's bound) in registers.
// ---------------------------------------------------------------------------
template <int TM, bool BANDED>
__global__ void __launch_bounds__(kLanes)
fused_candidates_kernel(const float* __restrict__ q, const float* __restrict__ r,
                        const float* __restrict__ bound_s, const int32_t* __restrict__ bound_i,
                        int32_t* __restrict__ out_i, float* __restrict__ out_s,
                        int m, int k, long long ld, int n, int groups_per_part,
                        int row_base) {
  extern __shared__ float4 smem4[];
  float* qT = reinterpret_cast<float*>(smem4);
  // B4's row bounds sit in shared memory, not registers: they are read
  // only for an element that would enter the fold, which after a lane's
  // first few columns is rare.
  __shared__ float sb_s[TM];
  __shared__ int sb_i[TM];
  const int part = blockIdx.x;
  const int row0 = row_base + blockIdx.y * TM;
  const int lane = threadIdx.x;
  if constexpr (BANDED) {
    for (int i = lane; i < TM; i += kLanes) {
      sb_s[i] = row0 + i < m ? bound_s[row0 + i] : pos_inf();
      sb_i[i] = row0 + i < m ? bound_i[row0 + i] : kI32Max;
    }
  }
  load_query_tile<TM>(q, qT, m, k, row0);  // ends with __syncthreads

  float best_s[TM];
  int best_i[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    best_s[i] = pos_inf();
    best_i[i] = kI32Max;
  }

  const long long first = static_cast<long long>(part) * groups_per_part * kLanes + lane;
  for (int g = 0; g < groups_per_part; ++g) {
    const long long col = first + static_cast<long long>(g) * kLanes;
    if (col >= n) break;  // columns only grow along the sweep
    float s[TM];
    column_scores<TM>(qT, r + col, ld, k, s);
    const int c = static_cast<int>(col);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      if (s[i] < best_s[i]) {
        if constexpr (BANDED) {
          // Fold only (s, c) lexicographically above the bound.
          if (!(s[i] > sb_s[i] || (s[i] == sb_s[i] && c > sb_i[i]))) continue;
        }
        best_s[i] = s[i];
        best_i[i] = c;
      }
    }
  }

  const long long width = static_cast<long long>(gridDim.x) * kLanes;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = row0 + i;
    if (row < m) {
      const long long o = row * width + static_cast<long long>(part) * kLanes + lane;
      out_i[o] = best_i[i];
      out_s[o] = best_s[i];
    }
  }
}

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
// B5 — replaces tpu_knn/kernels/topk.py:_sweep_kernel (with _kstate_insert;
// built by _build_sweep_candidates): per lane, the KB lexicographically
// smallest (score, column) pairs of its columns, sorted, from one sweep of
// the operand. KB is a bucket of 4/8/16/32 at or above the caller's K; the
// union of the lists always holds the global top-K (a lane holds at most K
// of them). Only scores below +inf enter (NaN never does); empty slots
// report (+inf, INT32_MAX). Output slot (part*KB + l)*128 + lane of a row
// holds level l of that lane.
//
// Bound on the H100: arithmetic, as B1 (m*n*k FMA; at (k=16, m=8, n=2^20)
// that is 2^27 FMA, 4 us, so the 64 MB operand read, ~0.02 ms, bounds it).
// Design: B1's sweep with a TM x KB state per thread in registers, TM =
// 32/KB rows per block so that the state stays at 64 registers. A
// per-element skip guard (s <= the lane's current KB-th score) runs the
// fully unrolled compare-exchange insertion chain only for elements that
// can enter; after the first few groups almost none can.
// ---------------------------------------------------------------------------
template <int KB>
__device__ __forceinline__ void kstate_insert(float (&ls)[KB], int (&li)[KB], float s, int c) {
  // The displaced element cascades down and the KB+1-th falls out. The
  // index clause matters only for cascaded elements: fresh ones arrive in
  // increasing column order.
#pragma unroll
  for (int l = 0; l < KB; ++l) {
    const bool beats = s < ls[l] || (s == ls[l] && c < li[l]);
    const float os = ls[l];
    const int oi = li[l];
    ls[l] = beats ? s : os;
    li[l] = beats ? c : oi;
    s = beats ? os : s;
    c = beats ? oi : c;
  }
}

template <int TM, int KB>
__global__ void __launch_bounds__(kLanes)
sweep_candidates_kernel(const float* __restrict__ q, const float* __restrict__ r,
                        int32_t* __restrict__ out_i, float* __restrict__ out_s,
                        int m, int k, long long ld, int n, int groups_per_part,
                        int row_base) {
  extern __shared__ float4 smem4[];
  float* qT = reinterpret_cast<float*>(smem4);
  const int part = blockIdx.x;
  const int row0 = row_base + blockIdx.y * TM;
  const int lane = threadIdx.x;
  load_query_tile<TM>(q, qT, m, k, row0);

  float ls[TM][KB];
  int li[TM][KB];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int l = 0; l < KB; ++l) {
      ls[i][l] = pos_inf();
      li[i][l] = kI32Max;
    }
  }

  const long long first = static_cast<long long>(part) * groups_per_part * kLanes + lane;
  for (int g = 0; g < groups_per_part; ++g) {
    const long long col = first + static_cast<long long>(g) * kLanes;
    if (col >= n) break;
    float s[TM];
    column_scores<TM>(qT, r + col, ld, k, s);
    const int c = static_cast<int>(col);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      if (s[i] <= ls[i][KB - 1] && s[i] < pos_inf()) kstate_insert<KB>(ls[i], li[i], s[i], c);
    }
  }

  const long long width = static_cast<long long>(gridDim.x) * KB * kLanes;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = row0 + i;
    if (row < m) {
#pragma unroll
      for (int l = 0; l < KB; ++l) {
        const long long o =
            row * width + (static_cast<long long>(part) * KB + l) * kLanes + lane;
        out_i[o] = li[i][l];
        out_s[o] = ls[i][l];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// B6 — replaces tpu_knn/kernels/topk.py:_smallm_topk_kernel (built by
// _build_smallm_topk_candidates): B5's per-lane K-lists over B2's exact
// diff-form scores, for 1 <= m <= 4 and k <= 32, with every list seeded
// at (B, INT32_MAX), where B is the row's bound (the K-th smallest of a B2
// pass's lane minima, a provable upper bound on the row's K-th score). So
// only elements with score <= B enter, and the sentinel entries that stay
// (index INT32_MAX >= n) lose the final selection.
//
// Bound on the H100: device-memory reads, as B2 (1 GiB at k=16, n=2^24,
// about 0.32 ms). Design: B2's sweep (all k loads of a column in flight).
// Insertions are rare, since the bound rejects almost every element, so
// the m x K lists live in shared memory (up to 4 x 32 x 128 x 8 bytes =
// 128 KB), laid out [row][level][lane] so that each thread touches only
// its own lane's column of it, without bank conflicts. Each row's current
// K-th score stays in a register for the skip guard. K is a runtime value.
// ---------------------------------------------------------------------------
__device__ __forceinline__ float kstate_insert_shared(float* ss, int* si, int kk, float s, int c) {
  for (int l = 0; l < kk; ++l) {
    const float os = ss[l * kLanes];
    const int oi = si[l * kLanes];
    if (s < os || (s == os && c < oi)) {
      ss[l * kLanes] = s;
      si[l * kLanes] = c;
      s = os;
      c = oi;
    }
  }
  return ss[(kk - 1) * kLanes];
}

template <int M, int KMAX>
__global__ void __launch_bounds__(kLanes)
smallm_topk_candidates_kernel(const float* __restrict__ q, const float* __restrict__ r,
                              const float* __restrict__ bound,
                              int32_t* __restrict__ out_i, float* __restrict__ out_s,
                              int k, long long ld, int n, int groups_per_part, int kk) {
  __shared__ float qs[M * KMAX];
  extern __shared__ float4 smem4[];
  float* st_s = reinterpret_cast<float*>(smem4);  // [M][kk][128]
  int* st_i = reinterpret_cast<int*>(st_s + M * kk * kLanes);
  const int part = blockIdx.x;
  const int lane = threadIdx.x;

  float worst[M];
#pragma unroll
  for (int i = 0; i < M; ++i) {
    worst[i] = bound[i];
    for (int l = 0; l < kk; ++l) {
      st_s[(i * kk + l) * kLanes + lane] = worst[i];
      st_i[(i * kk + l) * kLanes + lane] = kI32Max;
    }
  }
  load_small_queries<M, KMAX>(q, qs, k);

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
      if (acc <= worst[i] && acc < pos_inf()) {
        worst[i] = kstate_insert_shared(st_s + i * kk * kLanes + lane,
                                        st_i + i * kk * kLanes + lane, kk, acc, c);
      }
    }
  }

  const long long width = static_cast<long long>(gridDim.x) * kk * kLanes;
  for (int i = 0; i < M; ++i) {
    for (int l = 0; l < kk; ++l) {
      const long long o = i * width + (static_cast<long long>(part) * kk + l) * kLanes + lane;
      out_i[o] = st_i[(i * kk + l) * kLanes + lane];
      out_s[o] = st_s[(i * kk + l) * kLanes + lane];
    }
  }
}

// ---------------------------------------------------------------------------
// B3 — replaces tpu_knn/kernels/fused.py:_fused_minima_kernel (built by
// _build_minima_candidates): the seeded engine's bound pass. B1's sweep
// without the index fold: per row and lane, the smallest score (DEPTH 1)
// or the two smallest of the multiset (DEPTH 2), optionally only scores
// above the row's lo (NaN never enters: every compare is strict). The
// caller passes the prefix it wants read as n, so a launch reads only
// those columns. Each block writes its partition's 128 lanes to a
// partial array; minima_merge_kernel folds the partitions into the
// contract's (m, DEPTH*128) = [min1 lanes | min2 lanes] (the fold is a
// min, so the merged values do not depend on the partition count).
//
// Bound on the H100: arithmetic, as B1 (2*m*n*k flops; at ds11 with the
// half prefix 2^34 flops, 0.26 ms at the f32 peak). Design: B1's block
// (TM rows x one partition, a thread per lane); the band test reads lo
// from shared memory only for a score that would enter the fold.
// ---------------------------------------------------------------------------
template <int TM, int DEPTH>
__global__ void __launch_bounds__(kLanes)
minima_candidates_kernel(const float* __restrict__ q, const float* __restrict__ r,
                         const float* __restrict__ lo, float* __restrict__ partial, int m, int k,
                         long long ld, int n, int groups_per_part, int row_base) {
  extern __shared__ float4 smem4[];
  float* qT = reinterpret_cast<float*>(smem4);
  __shared__ float s_lo[TM];
  const int part = blockIdx.x;
  const int row0 = row_base + blockIdx.y * TM;
  const int lane = threadIdx.x;
  for (int i = lane; i < TM; i += kLanes) {
    s_lo[i] = lo != nullptr && row0 + i < m ? lo[row0 + i] : neg_inf();
  }
  load_query_tile<TM>(q, qT, m, k, row0);

  float m1[TM], m2[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) m1[i] = m2[i] = pos_inf();

  const long long first = static_cast<long long>(part) * groups_per_part * kLanes + lane;
  for (int g = 0; g < groups_per_part; ++g) {
    const long long col = first + static_cast<long long>(g) * kLanes;
    if (col >= n) break;
    float s[TM];
    column_scores<TM>(qT, r + col, ld, k, s);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      if constexpr (DEPTH == 1) {
        if (s[i] < m1[i] && s[i] > s_lo[i]) m1[i] = s[i];
      } else {
        // tpu_knn's fold (new1 = min(s, m1); the displaced value folds
        // into m2), written as one guarded branch.
        if (s[i] < m2[i] && s[i] > s_lo[i]) {
          if (s[i] < m1[i]) {
            m2[i] = m1[i];
            m1[i] = s[i];
          } else {
            m2[i] = s[i];
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = row0 + i;
    if (row < m) {
      float* o = partial + ((static_cast<long long>(row) * gridDim.x + part) * DEPTH) * kLanes;
      o[lane] = m1[i];
      if constexpr (DEPTH == 2) o[kLanes + lane] = m2[i];
    }
  }
}

// Folds `groups` 128-lane partials of a row ([group][depth][lane]) into
// the row's DEPTH*128 lane minima; one block per row.
template <int DEPTH>
__global__ void __launch_bounds__(kLanes)
minima_merge_kernel(const float* __restrict__ partial, float* __restrict__ out, int groups) {
  const long long row = blockIdx.x;
  const int lane = threadIdx.x;
  const float* p = partial + row * groups * DEPTH * kLanes + lane;
  float m1 = pos_inf(), m2 = pos_inf();
  for (int e = 0; e < groups * DEPTH; ++e) {
    const float s = p[static_cast<long long>(e) * kLanes];
    if (s < m2) {
      if (s < m1) {
        m2 = m1;
        m1 = s;
      } else {
        m2 = s;
      }
    }
  }
  out[row * DEPTH * kLanes + lane] = m1;
  if (DEPTH == 2) out[row * DEPTH * kLanes + kLanes + lane] = m2;
}

// ---------------------------------------------------------------------------
// B7 — replaces tpu_knn/kernels/topk.py:_extract_moment_kernel (built by
// _build_extract_candidates): per (row, cell of `cell` = 64/128/256
// columns), the exact integer moments cnt, sum l, sum l^2 [, sum l^3] of
// the columns l (= col % cell) whose score is <= the row's bound (and >
// its lo, for a band; columns >= n never qualify), packed as tpu_knn
// packs them: A = min(cnt,3) | e1<<2 | p2<<12 masked to 30 bits, bit 30 =
// (cnt > solvable), and p3 in the cubic mode. With rem_part, also the
// per-lane minima of the scores above the bound (the rounds engine's
// next bound source), merged by minima_merge_kernel.
//
// The TPU reduced the 0/1 mask on the matrix unit against a block-
// diagonal weight matrix. Here each warp reduces its 32 columns' (1, l,
// l^2, l^3) in 32-bit integers (__ballot_sync, then __reduce_add_sync
// only when some lane qualifies, which is rare), the warps of a cell meet
// in shared memory, and one thread per (row, cell) packs. Every sum is an
// exact integer below 2^31 for any cell (sum l^3 over 256 lanes <=
// 1.07e9), so the words equal tpu_knn's bit for bit.
//
// Bound on the H100: arithmetic, as B1 (2*m*n*k flops: 0.51 ms at ds11),
// plus a compare and a vote per (row, column). Design: a block of 256
// threads owns TM rows and a partition of 256-column chunks; cells never
// straddle a chunk, and two barriers per chunk hand the warp partials to
// the packing threads (who clear them for the next chunk).
// ---------------------------------------------------------------------------
constexpr int kChunk = 256;  // B7 threads per block = columns per step

template <int TM, bool REM>
__global__ void __launch_bounds__(kChunk)
extract_moments_kernel(const float* __restrict__ q, const float* __restrict__ r,
                       const float* __restrict__ bound, const float* __restrict__ lo,
                       int32_t* __restrict__ out_a, int32_t* __restrict__ out_p3,
                       float* __restrict__ rem_part, int m, int k, long long ld, int n, int nc,
                       int cell, int cubic, int chunks_per_part, int row_base) {
  extern __shared__ float4 smem4[];
  float* qT = reinterpret_cast<float*>(smem4);
  __shared__ float s_b[TM], s_lo[TM];
  __shared__ unsigned s_mom[TM][kChunk / 32][4];
  const int part = blockIdx.x;
  const int row0 = row_base + blockIdx.y * TM;
  const int t = threadIdx.x;
  const int warp = t >> 5;
  const int wl = t & 31;
  for (int i = t; i < TM; i += kChunk) {
    s_b[i] = row0 + i < m ? bound[row0 + i] : neg_inf();
    s_lo[i] = lo != nullptr && row0 + i < m ? lo[row0 + i] : neg_inf();
  }
  for (int e = t; e < TM * (kChunk / 32) * 4; e += kChunk) (&s_mom[0][0][0])[e] = 0u;
  load_query_tile<TM>(q, qT, m, k, row0);

  float rem[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) rem[i] = pos_inf();

  const int cells_per_chunk = kChunk / cell;
  const int warps_per_cell = cell / 32;
  const unsigned solvable = cubic ? 3u : 2u;
  const int chunks = (nc + cells_per_chunk - 1) / cells_per_chunk;
  const int c_end = min(chunks, (part + 1) * chunks_per_part);
  for (int c = part * chunks_per_part; c < c_end; ++c) {
    const long long col = static_cast<long long>(c) * kChunk + t;
    const bool live = col < n;
    const unsigned l = static_cast<unsigned>(col) & static_cast<unsigned>(cell - 1);
    float s[TM];
    if (live) {
      column_scores<TM>(qT, r + col, ld, k, s);
    } else {
#pragma unroll
      for (int i = 0; i < TM; ++i) s[i] = pos_inf();
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const bool qual = live && s[i] <= s_b[i] && s[i] > s_lo[i];
      const unsigned bal = __ballot_sync(0xffffffffu, qual);
      if (bal != 0u) {  // warp-uniform
        const unsigned v = qual ? l : 0u;
        const unsigned e1 = __reduce_add_sync(0xffffffffu, v);
        const unsigned p2 = __reduce_add_sync(0xffffffffu, v * v);
        const unsigned p3 = cubic ? __reduce_add_sync(0xffffffffu, v * v * v) : 0u;
        if (wl == 0) {
          s_mom[i][warp][0] = static_cast<unsigned>(__popc(bal));
          s_mom[i][warp][1] = e1;
          s_mom[i][warp][2] = p2;
          s_mom[i][warp][3] = p3;
        }
      }
      if constexpr (REM) {
        if (live && s[i] < rem[i] && s[i] > s_b[i]) rem[i] = s[i];
      }
    }
    __syncthreads();
    if (t < TM * cells_per_chunk) {
      const int i = t / cells_per_chunk;
      const int cc = t - i * cells_per_chunk;
      unsigned cnt = 0u, e1 = 0u, p2 = 0u, p3 = 0u;
      for (int w = cc * warps_per_cell; w < (cc + 1) * warps_per_cell; ++w) {
        cnt += s_mom[i][w][0];
        e1 += s_mom[i][w][1];
        p2 += s_mom[i][w][2];
        p3 += s_mom[i][w][3];
        s_mom[i][w][0] = s_mom[i][w][1] = s_mom[i][w][2] = s_mom[i][w][3] = 0u;
      }
      const long long cidx = static_cast<long long>(c) * cells_per_chunk + cc;
      const int row = row0 + i;
      if (row < m && cidx < nc) {
        const unsigned packed = (cnt < 3u ? cnt : 3u) | (e1 << 2) | (p2 << 12);
        const unsigned flag = cnt > solvable ? 1u : 0u;
        const long long o = static_cast<long long>(row) * nc + cidx;
        out_a[o] = static_cast<int32_t>((packed & 0x3FFFFFFFu) | (flag << 30));
        if (cubic) out_p3[o] = static_cast<int32_t>(p3);
      }
    }
    __syncthreads();
  }

  if constexpr (REM) {
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int row = row0 + i;
      if (row < m) {
        rem_part[(static_cast<long long>(row) * gridDim.x + part) * kChunk + t] = rem[i];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// B8 and B9 — replace tpu_knn/kernels/topk.py:_cell_compact_kernel and
// _cell_butterfly_kernel (both built by _build_cell_compactor, which picks
// one by part width only because of VMEM): positional compaction of the
// qualifying cells of each (row, part). Fields are (m, nc) int32, field 0
// nonzero exactly at qualifiers; each part (nc / parts cells) writes
// [cell position within the part, f0 (, f1)] of its qualifiers to its
// first `cap` slots in ascending cell order, drops qualifiers past cap and
// zero-fills the slots after the last one. Outputs are (m, parts*cap).
//
// Bound on the H100: device-memory bytes (field 0 read once, the outputs
// written once; 16 MB of A at ds11 K=8, about 5 us). Design: one warp per
// (row, part) walks its cells 128 at a time (four loads in flight per
// lane); __ballot_sync marks the qualifiers, a __popc prefix over the
// lanes below plus a running base gives each its slot. The walk stops once
// cap qualifiers are placed. Independent of cap and of part width, so one
// kernel serves both TPU bodies and the candidate-column compaction.
// ---------------------------------------------------------------------------
constexpr int kCompactWarps = 4;

__global__ void __launch_bounds__(kCompactWarps * 32)
compact_cells_kernel(const int32_t* __restrict__ f0, const int32_t* __restrict__ f1,
                     int32_t* __restrict__ o_pos, int32_t* __restrict__ o0,
                     int32_t* __restrict__ o1, int m, int nc, int parts, int cap) {
  const int wl = threadIdx.x & 31;
  const long long task = static_cast<long long>(blockIdx.x) * kCompactWarps + (threadIdx.x >> 5);
  if (task >= static_cast<long long>(m) * parts) return;  // a whole warp at once
  const long long row = task / parts;
  const int part = static_cast<int>(task - row * parts);
  const int pw = nc / parts;
  const long long in = row * nc + static_cast<long long>(part) * pw;
  const long long out = (row * parts + part) * cap;
  const unsigned below = (1u << wl) - 1u;
  int count = 0;
  for (int c0 = 0; c0 < pw && count < cap; c0 += 4 * 32) {
    int32_t v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int c = c0 + u * 32 + wl;
      v[u] = c < pw ? f0[in + c] : 0;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int c = c0 + u * 32 + wl;
      const unsigned bal = __ballot_sync(0xffffffffu, v[u] != 0);
      const int rank = count + __popc(bal & below);
      if (v[u] != 0 && rank < cap) {
        o_pos[out + rank] = c;
        o0[out + rank] = v[u];
        if (f1 != nullptr) o1[out + rank] = f1[in + c];
      }
      count += __popc(bal);
    }
  }
  for (int s = min(count, cap) + wl; s < cap; s += 32) {
    o_pos[out + s] = 0;
    o0[out + s] = 0;
    if (o1 != nullptr) o1[out + s] = 0;
  }
}

// ---------------------------------------------------------------------------
// Launchers.
// ---------------------------------------------------------------------------

template <typename Kernel>
int allow_smem(Kernel kernel, size_t smem) {
  if (smem <= kDefaultSmem) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
}

template <int TM, bool BANDED>
int launch_fused(const float* q, const float* r, const float* bound_s, const int32_t* bound_i,
                 int32_t* out_i, float* out_s, int m, int k, long long ld, int n, int parts,
                 int groups_per_part, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(TM) * k * sizeof(float);
  if (const int e = allow_smem(fused_candidates_kernel<TM, BANDED>, smem)) return e;
  const int tiles = (m + TM - 1) / TM;
  for (int t0 = 0; t0 < tiles; t0 += kMaxGridY) {
    const int ty = tiles - t0 < kMaxGridY ? tiles - t0 : kMaxGridY;
    fused_candidates_kernel<TM, BANDED><<<dim3(parts, ty), kLanes, smem, stream>>>(
        q, r, bound_s, bound_i, out_i, out_s, m, k, ld, n, groups_per_part, t0 * TM);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

template <bool BANDED>
int launch_fused_tile(const float* q, const float* r, const float* bound_s,
                      const int32_t* bound_i, int32_t* out_i, float* out_s, int m, int k,
                      long long ld, int n, int parts, int groups_per_part, int tile_m,
                      cudaStream_t s) {
  switch (tile_m) {
    case 32:
      return launch_fused<32, BANDED>(q, r, bound_s, bound_i, out_i, out_s, m, k, ld, n, parts,
                                      groups_per_part, s);
    case 8:
      return launch_fused<8, BANDED>(q, r, bound_s, bound_i, out_i, out_s, m, k, ld, n, parts,
                                     groups_per_part, s);
    case 1:
      return launch_fused<1, BANDED>(q, r, bound_s, bound_i, out_i, out_s, m, k, ld, n, parts,
                                     groups_per_part, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int M>
int launch_smallm(const float* q, const float* r, int32_t* out_i, float* out_s, int k,
                  long long ld, int n, int parts, int groups_per_part,
                  cudaStream_t stream) {
  if (k <= 8) {
    smallm_candidates_kernel<M, 8><<<parts, kLanes, 0, stream>>>(
        q, r, out_i, out_s, k, ld, n, groups_per_part);
  } else if (k <= 16) {
    smallm_candidates_kernel<M, 16><<<parts, kLanes, 0, stream>>>(
        q, r, out_i, out_s, k, ld, n, groups_per_part);
  } else {
    smallm_candidates_kernel<M, 32><<<parts, kLanes, 0, stream>>>(
        q, r, out_i, out_s, k, ld, n, groups_per_part);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int TM, int KB>
int launch_sweep(const float* q, const float* r, int32_t* out_i, float* out_s, int m, int k,
                 long long ld, int n, int parts, int groups_per_part, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(TM) * k * sizeof(float);
  if (const int e = allow_smem(sweep_candidates_kernel<TM, KB>, smem)) return e;
  const int tiles = (m + TM - 1) / TM;
  for (int t0 = 0; t0 < tiles; t0 += kMaxGridY) {
    const int ty = tiles - t0 < kMaxGridY ? tiles - t0 : kMaxGridY;
    sweep_candidates_kernel<TM, KB><<<dim3(parts, ty), kLanes, smem, stream>>>(
        q, r, out_i, out_s, m, k, ld, n, groups_per_part, t0 * TM);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

template <int M, int KMAX>
int launch_smallm_topk_k(const float* q, const float* r, const float* bound, int32_t* out_i,
                         float* out_s, int k, long long ld, int n, int parts,
                         int groups_per_part, int kk, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(M) * kk * kLanes * (sizeof(float) + sizeof(int));
  if (const int e = allow_smem(smallm_topk_candidates_kernel<M, KMAX>, smem)) return e;
  smallm_topk_candidates_kernel<M, KMAX><<<parts, kLanes, smem, stream>>>(
      q, r, bound, out_i, out_s, k, ld, n, groups_per_part, kk);
  return static_cast<int>(cudaGetLastError());
}

template <int M>
int launch_smallm_topk(const float* q, const float* r, const float* bound, int32_t* out_i,
                       float* out_s, int k, long long ld, int n, int parts, int groups_per_part,
                       int kk, cudaStream_t s) {
  if (k <= 8) {
    return launch_smallm_topk_k<M, 8>(q, r, bound, out_i, out_s, k, ld, n, parts,
                                      groups_per_part, kk, s);
  }
  if (k <= 16) {
    return launch_smallm_topk_k<M, 16>(q, r, bound, out_i, out_s, k, ld, n, parts,
                                       groups_per_part, kk, s);
  }
  return launch_smallm_topk_k<M, 32>(q, r, bound, out_i, out_s, k, ld, n, parts,
                                     groups_per_part, kk, s);
}

// Opt a kernel into dynamic shared memory beyond what fits beside its
// static shared memory by default.
template <typename Kernel>
int allow_dynamic_smem(Kernel kernel, size_t dynamic, size_t static_bytes) {
  if (dynamic + static_bytes <= kDefaultSmem) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(dynamic)));
}

template <int TM, int DEPTH>
int launch_minima(const float* q, const float* r, const float* lo, float* partial, float* out,
                  int m, int k, long long ld, int n, int parts, int groups_per_part,
                  cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(TM) * k * sizeof(float);
  auto kernel = minima_candidates_kernel<TM, DEPTH>;
  if (const int e = allow_dynamic_smem(kernel, smem, TM * sizeof(float))) return e;
  const int tiles = (m + TM - 1) / TM;
  for (int t0 = 0; t0 < tiles; t0 += kMaxGridY) {
    const int ty = tiles - t0 < kMaxGridY ? tiles - t0 : kMaxGridY;
    kernel<<<dim3(parts, ty), kLanes, smem, stream>>>(q, r, lo, partial, m, k, ld, n,
                                                      groups_per_part, t0 * TM);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  minima_merge_kernel<DEPTH><<<m, kLanes, 0, stream>>>(partial, out, parts);
  return static_cast<int>(cudaGetLastError());
}

template <int TM>
int launch_minima_depth(const float* q, const float* r, const float* lo, float* partial,
                        float* out, int m, int k, long long ld, int n, int parts, int gpp,
                        int depth, cudaStream_t s) {
  if (depth == 1) return launch_minima<TM, 1>(q, r, lo, partial, out, m, k, ld, n, parts, gpp, s);
  return launch_minima<TM, 2>(q, r, lo, partial, out, m, k, ld, n, parts, gpp, s);
}

template <int TM, bool REM>
int launch_extract(const float* q, const float* r, const float* bound, const float* lo,
                   int32_t* out_a, int32_t* out_p3, float* rem_part, float* rem_out, int m,
                   int k, long long ld, int n, int nc, int cell, int cubic, int parts,
                   int chunks_per_part, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(TM) * k * sizeof(float);
  auto kernel = extract_moments_kernel<TM, REM>;
  const size_t static_bytes = TM * (2 * sizeof(float) + (kChunk / 32) * 4 * sizeof(unsigned));
  if (const int e = allow_dynamic_smem(kernel, smem, static_bytes)) return e;
  const int tiles = (m + TM - 1) / TM;
  for (int t0 = 0; t0 < tiles; t0 += kMaxGridY) {
    const int ty = tiles - t0 < kMaxGridY ? tiles - t0 : kMaxGridY;
    kernel<<<dim3(parts, ty), kChunk, smem, stream>>>(q, r, bound, lo, out_a, out_p3, rem_part,
                                                      m, k, ld, n, nc, cell, cubic,
                                                      chunks_per_part, t0 * TM);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (REM) minima_merge_kernel<1><<<m, kLanes, 0, stream>>>(rem_part, rem_out,
                                                            parts * (kChunk / kLanes));
  return static_cast<int>(cudaGetLastError());
}

template <int TM>
int launch_extract_rem(const float* q, const float* r, const float* bound, const float* lo,
                       int32_t* out_a, int32_t* out_p3, float* rem_part, float* rem_out, int m,
                       int k, long long ld, int n, int nc, int cell, int cubic, int parts,
                       int cpp, cudaStream_t s) {
  if (rem_part != nullptr) {
    return launch_extract<TM, true>(q, r, bound, lo, out_a, out_p3, rem_part, rem_out, m, k, ld,
                                    n, nc, cell, cubic, parts, cpp, s);
  }
  return launch_extract<TM, false>(q, r, bound, lo, out_a, out_p3, rem_part, rem_out, m, k, ld,
                                   n, nc, cell, cubic, parts, cpp, s);
}

bool valid_geometry(int m, int k, long long ld, int n, int parts) {
  if (m < 1 || k < 1 || n < 1 || parts < 1 || ld < n) return false;
  const long long groups = (static_cast<long long>(n) + kLanes - 1) / kLanes;
  return parts <= groups;
}

int groups_per_part(int n, int parts) {
  const long long groups = (static_cast<long long>(n) + kLanes - 1) / kLanes;
  return static_cast<int>((groups + parts - 1) / parts);
}

}  // namespace

extern "C" {

// B1 launch: tile_m in {1, 8, 32} rows per block (tuning.cuda_tile_m).
int tk_fused_candidates(const float* q, const float* r, int32_t* out_i, float* out_s,
                        int m, int k, long long ld, int n, int parts, int tile_m,
                        void* stream) {
  if (!valid_geometry(m, k, ld, n, parts)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_fused_tile<false>(q, r, nullptr, nullptr, out_i, out_s, m, k, ld, n, parts,
                                  groups_per_part(n, parts), tile_m,
                                  static_cast<cudaStream_t>(stream));
}

// B4 launch: B1's geometry plus the per-row bound (bound_s (m,) f32,
// bound_i (m,) int32).
int tk_banded_candidates(const float* q, const float* r, const float* bound_s,
                         const int32_t* bound_i, int32_t* out_i, float* out_s, int m, int k,
                         long long ld, int n, int parts, int tile_m, void* stream) {
  if (!valid_geometry(m, k, ld, n, parts)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_fused_tile<true>(q, r, bound_s, bound_i, out_i, out_s, m, k, ld, n, parts,
                                 groups_per_part(n, parts), tile_m,
                                 static_cast<cudaStream_t>(stream));
}

// B2 launch: 1 <= m <= 4, 1 <= k <= 32.
int tk_smallm_candidates(const float* q, const float* r, int32_t* out_i, float* out_s,
                         int m, int k, long long ld, int n, int parts, void* stream) {
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

// B5 launch: kb in {4, 8, 16, 32} list slots per lane (32/kb rows per
// block); outputs are (m, parts*kb*128).
int tk_sweep_candidates(const float* q, const float* r, int32_t* out_i, float* out_s, int m,
                        int k, long long ld, int n, int parts, int kb, void* stream) {
  if (!valid_geometry(m, k, ld, n, parts)) return static_cast<int>(cudaErrorInvalidValue);
  const int gpp = groups_per_part(n, parts);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kb) {
    case 4: return launch_sweep<8, 4>(q, r, out_i, out_s, m, k, ld, n, parts, gpp, s);
    case 8: return launch_sweep<4, 8>(q, r, out_i, out_s, m, k, ld, n, parts, gpp, s);
    case 16: return launch_sweep<2, 16>(q, r, out_i, out_s, m, k, ld, n, parts, gpp, s);
    case 32: return launch_sweep<1, 32>(q, r, out_i, out_s, m, k, ld, n, parts, gpp, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// B6 launch: 1 <= m <= 4, 1 <= k <= 32, 1 <= kk <= 32; bound (m,) f32;
// outputs are (m, parts*kk*128).
int tk_smallm_topk_candidates(const float* q, const float* r, const float* bound,
                              int32_t* out_i, float* out_s, int m, int k, long long ld, int n,
                              int parts, int kk, void* stream) {
  if (!valid_geometry(m, k, ld, n, parts) || k > 32 || kk < 1 || kk > 32) {
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

// B3 launch: B1's geometry (tile_m in {1, 8, 32}), depth 1 or 2, lo (m,)
// f32 or null; partial is (m, parts*depth*128) scratch, out (m, depth*128).
int tk_minima_candidates(const float* q, const float* r, const float* lo, float* partial,
                         float* out, int m, int k, long long ld, int n, int parts, int tile_m,
                         int depth, void* stream) {
  if (!valid_geometry(m, k, ld, n, parts) || (depth != 1 && depth != 2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int gpp = groups_per_part(n, parts);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tile_m) {
    case 32: return launch_minima_depth<32>(q, r, lo, partial, out, m, k, ld, n, parts, gpp, depth, s);
    case 8: return launch_minima_depth<8>(q, r, lo, partial, out, m, k, ld, n, parts, gpp, depth, s);
    case 1: return launch_minima_depth<1>(q, r, lo, partial, out, m, k, ld, n, parts, gpp, depth, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// B7 launch: nc cells of `cell` in {64, 128, 256} columns cover the
// operand (ld >= nc*cell >= n); bound (m,) f32, lo (m,) f32 or null;
// out_a (m, nc) int32, out_p3 (m, nc) int32 when cubic; rem_part
// (m, parts*256) scratch and rem_out (m, 128), or both null.
int tk_extract_moments(const float* q, const float* r, const float* bound, const float* lo,
                       int32_t* out_a, int32_t* out_p3, float* rem_part, float* rem_out, int m,
                       int k, long long ld, int n, int nc, int cell, int cubic, int parts,
                       int tile_m, void* stream) {
  const long long width = static_cast<long long>(nc) * cell;
  const int chunks = static_cast<int>((width + kChunk - 1) / kChunk);
  if (m < 1 || k < 1 || n < 1 || n > width || ld < width || parts < 1 || parts > chunks ||
      (cell != 64 && cell != 128 && cell != 256) || (cubic && out_p3 == nullptr) ||
      ((rem_part == nullptr) != (rem_out == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int cpp = (chunks + parts - 1) / parts;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tile_m) {
    case 32:
      return launch_extract_rem<32>(q, r, bound, lo, out_a, out_p3, rem_part, rem_out, m, k, ld,
                                    n, nc, cell, cubic, parts, cpp, s);
    case 8:
      return launch_extract_rem<8>(q, r, bound, lo, out_a, out_p3, rem_part, rem_out, m, k, ld,
                                   n, nc, cell, cubic, parts, cpp, s);
    case 1:
      return launch_extract_rem<1>(q, r, bound, lo, out_a, out_p3, rem_part, rem_out, m, k, ld,
                                   n, nc, cell, cubic, parts, cpp, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The B8/B9 compactor: f0 (and f1, or null) (m, nc) int32 -> o_pos, o0
// (and o1) (m, parts*cap) int32; parts divides nc, 1 <= cap <= nc/parts.
int tk_compact_cells(const int32_t* f0, const int32_t* f1, int32_t* o_pos, int32_t* o0,
                     int32_t* o1, int m, int nc, int parts, int cap, void* stream) {
  if (m < 1 || nc < 1 || parts < 1 || nc % parts != 0 || cap < 1 || cap > nc / parts ||
      ((f1 == nullptr) != (o1 == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long warps = static_cast<long long>(m) * parts;
  const long long blocks = (warps + kCompactWarps - 1) / kCompactWarps;
  compact_cells_kernel<<<static_cast<unsigned>(blocks), kCompactWarps * 32, 0,
                         static_cast<cudaStream_t>(stream)>>>(f0, f1, o_pos, o0, o1, m, nc,
                                                              parts, cap);
  return static_cast<int>(cudaGetLastError());
}

const char* tk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
