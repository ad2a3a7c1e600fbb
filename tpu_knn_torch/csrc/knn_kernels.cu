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
// masked (never folded).
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
  for (int e = threadIdx.x; e < k * TM; e += kLanes) {
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

const char* tk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
