// B1 and B4 (the fused candidate sweep, plain and banded), B1's two ladder
// variants (AoS, v3; constant queries, v6) and B10 (staged slices, v5).

#include "knn_common.cuh"

namespace {

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
// The two B1 variants of the 1-NN ladder. Both give scores bit-identical to
// B1's (the shared column_scores, the same fmaf chain over d in order) and
// the same per-lane fold, so at the same partition count their candidates
// equal B1's.
//
// B1, AoS variant (v3) — replaces tpu_knn/kernels/fused.py:_fused_kernel
// built with soa=False (the reference v3, core.cu:231-312): B1 reading the
// caller's row-major (n, k) array directly, with no per-call SoA relayout.
// Per 128-column group the block copies the group's 128 x k floats (one
// contiguous run of memory, so the loads are coalesced) into shared memory
// transposed to [d][lane] (row stride kLanes + 1 against bank conflicts on
// the write), then scores from there. Bound on the H100: arithmetic, as B1.
// ---------------------------------------------------------------------------
constexpr int kSlabLd = kLanes + 1;

template <int TM>
__global__ void __launch_bounds__(kLanes)
aos_candidates_kernel(const float* __restrict__ q, const float* __restrict__ ref,
                      int32_t* __restrict__ out_i, float* __restrict__ out_s, int m, int k,
                      int n, int groups_per_part, int row_base) {
  extern __shared__ float4 smem4[];
  float* qT = reinterpret_cast<float*>(smem4);
  float* slab = qT + TM * k;  // [d][kSlabLd]
  const int part = blockIdx.x;
  const int row0 = row_base + blockIdx.y * TM;
  const int lane = threadIdx.x;
  load_query_tile<TM>(q, qT, m, k, row0);

  float best_s[TM];
  int best_i[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    best_s[i] = pos_inf();
    best_i[i] = kI32Max;
  }

  const long long g0 = static_cast<long long>(part) * groups_per_part;
  for (int g = 0; g < groups_per_part; ++g) {
    const long long base = (g0 + g) * kLanes;
    if (base >= n) break;  // uniform over the block
    const int rows = static_cast<int>(min(static_cast<long long>(kLanes), n - base));
    const float* src = ref + base * k;
    for (int e = lane; e < kLanes * k; e += kLanes) {
      const int c = e / k;
      const int d = e - c * k;
      slab[d * kSlabLd + c] = c < rows ? src[e] : 0.f;
    }
    __syncthreads();
    if (lane < rows) {
      float s[TM];
      column_scores<TM>(qT, SharedColumn{slab + lane, kSlabLd}, k, s);
      const int c = static_cast<int>(base) + lane;
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        if (s[i] < best_s[i]) {
          best_s[i] = s[i];
          best_i[i] = c;
        }
      }
    }
    __syncthreads();  // the slab is rewritten by the next group
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
// B1, constant-query variant (v6) — replaces tpu_knn/kernels/fused.py:
// _fused_kernel as v6 builds it (the whole query set resident for the
// sweep; the reference v6 put it in constant memory, core.cu:530-643,
// guard k*m <= 16384 floats at core.cu:603-607). The wrapper copies the
// query set, laid out per TM-row tile as B1's shared tile is ([tile][d][i]),
// into the 64 KB constant bank once per call; each block reads its rows
// through the constant cache, whose broadcast serves column_scores' reads
// (every thread of a warp reads the same query value). One bank per
// module: the wrapper (kernels/fused.py const_query_candidates) makes each
// launch's stream wait for the previous launch, on whatever stream it ran,
// before the copy refills the bank.
// ---------------------------------------------------------------------------
constexpr int kConstQueryFloats = 16384;
__constant__ __align__(16) float c_queries[kConstQueryFloats];

template <int TM>
__global__ void __launch_bounds__(kLanes)
const_query_candidates_kernel(const float* __restrict__ r, int32_t* __restrict__ out_i,
                              float* __restrict__ out_s, int m, int k, long long ld, int n,
                              int groups_per_part) {
  const int part = blockIdx.x;
  const int row0 = blockIdx.y * TM;
  const int lane = threadIdx.x;
  const float* qT = c_queries + static_cast<long long>(blockIdx.y) * k * TM;

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
    if (col >= n) break;
    float s[TM];
    column_scores<TM>(qT, r + col, ld, k, s);
    const int c = static_cast<int>(col);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      if (s[i] < best_s[i]) {
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
// B10 — replaces tpu_knn/kernels/dma_pipeline.py:_dma_kernel (built by
// _build_dma; the reference v5's explicit choice of memory space for the
// streamed operand, core.cu:424-529): B1's score and fold over explicitly
// staged slices of the SoA operand, emitting indices only.
//
// Each block walks its partition in slices of `slice` = slice_groups * 128
// columns. The k rows of a slice are copied into a ring of kDmaStages
// shared-memory stages with 16-byte cp.async copies (commit_group /
// wait_group); the copy of slice s + 1 is issued before slice s is scored,
// so the transfer overlaps the arithmetic. Scores come from shared memory
// through the shared column_scores (bit-identical to B1's); lane t folds
// columns t, t + 128, ... of each slice with a strict `<`, columns >= n or
// past the partition masked (never zero-filled into the fold: a zero column
// would score 0 and win). At the same partition count the indices equal
// B1's. Bound on the H100: arithmetic, as B1 (ds11: 2^34 FMA, 0.51 ms); at
// m = 1 the 1 GiB read of ds9 (0.32 ms).
// ---------------------------------------------------------------------------
constexpr int kDmaStages = 2;

// Issue the copies of the k rows of the slice starting at column c0 into
// `dst` ([d][slice]); 16-byte chunks at or past `end` are zero-filled
// without a read (their columns are masked in the fold).
__device__ __forceinline__ void stage_slice(float* dst, const float* __restrict__ r, long long ld,
                                            int k, long long c0, long long end, int slice) {
  const int chunks = slice / 4;
  for (int e = threadIdx.x; e < k * chunks; e += kLanes) {
    const int d = e / chunks;
    const int c = (e - d * chunks) * 4;
    const bool live = c0 + c < end;
    cp_async16(dst + d * slice + c, live ? r + d * ld + c0 + c : r, live ? 16 : 0);
  }
}

template <int TM>
__global__ void __launch_bounds__(kLanes)
dma_candidates_kernel(const float* __restrict__ q, const float* __restrict__ r,
                      int32_t* __restrict__ out_i, int m, int k, long long ld, int n,
                      int groups_per_part, int slice_groups, int row_base) {
  extern __shared__ float4 smem4[];
  float* qT = reinterpret_cast<float*>(smem4);
  const int slice = slice_groups * kLanes;
  float* ring = qT + ((TM * k + 3) / 4) * 4;  // [stage][d][slice], 16-byte aligned
  const int part = blockIdx.x;
  const int row0 = row_base + blockIdx.y * TM;
  const int lane = threadIdx.x;
  const long long p_begin = static_cast<long long>(part) * groups_per_part * kLanes;
  const long long p_end =
      min(static_cast<long long>(n), p_begin + static_cast<long long>(groups_per_part) * kLanes);
  const int n_slices = p_begin < p_end ? static_cast<int>((p_end - p_begin + slice - 1) / slice) : 0;

  // The first slice's copy is in flight while the query tile loads.
#pragma unroll
  for (int s = 0; s < kDmaStages - 1; ++s) {
    if (s < n_slices) {
      stage_slice(ring + s * k * slice, r, ld, k, p_begin + static_cast<long long>(s) * slice,
                  p_end, slice);
    }
    cp_async_commit();
  }
  load_query_tile<TM>(q, qT, m, k, row0);

  float best_s[TM];
  int best_i[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    best_s[i] = pos_inf();
    best_i[i] = kI32Max;
  }

  for (int s = 0; s < n_slices; ++s) {
    const int ahead = s + kDmaStages - 1;
    if (ahead < n_slices) {
      stage_slice(ring + (ahead % kDmaStages) * k * slice, r, ld, k,
                  p_begin + static_cast<long long>(ahead) * slice, p_end, slice);
    }
    cp_async_commit();
    cp_async_wait<kDmaStages - 1>();  // slice s has landed (this thread's copies)
    __syncthreads();                  // ... and every thread's
    const float* st = ring + (s % kDmaStages) * k * slice;
    const long long c0 = p_begin + static_cast<long long>(s) * slice;
    for (int j = 0; j < slice_groups; ++j) {
      const long long col = c0 + j * kLanes + lane;
      if (col >= p_end) break;
      float sc[TM];
      column_scores<TM>(qT, SharedColumn{st + j * kLanes + lane, slice}, k, sc);
      const int c = static_cast<int>(col);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        if (sc[i] < best_s[i]) {
          best_s[i] = sc[i];
          best_i[i] = c;
        }
      }
    }
    __syncthreads();  // the stage is refilled two slices on
  }
  cp_async_wait<0>();

  const long long width = static_cast<long long>(gridDim.x) * kLanes;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = row0 + i;
    if (row < m) out_i[row * width + static_cast<long long>(part) * kLanes + lane] = best_i[i];
  }
}

// ---------------------------------------------------------------------------
// Launchers.
// ---------------------------------------------------------------------------

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

template <int TM>
int launch_aos(const float* q, const float* ref, int32_t* out_i, float* out_s, int m, int k,
               int n, int parts, int groups_per_part, cudaStream_t stream) {
  const size_t smem = (static_cast<size_t>(TM) * k + static_cast<size_t>(k) * kSlabLd) *
                      sizeof(float);
  if (const int e = allow_smem(aos_candidates_kernel<TM>, smem)) return e;
  const int tiles = (m + TM - 1) / TM;
  for (int t0 = 0; t0 < tiles; t0 += kMaxGridY) {
    const int ty = tiles - t0 < kMaxGridY ? tiles - t0 : kMaxGridY;
    aos_candidates_kernel<TM><<<dim3(parts, ty), kLanes, smem, stream>>>(
        q, ref, out_i, out_s, m, k, n, groups_per_part, t0 * TM);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

template <int TM>
int launch_const_query(const float* q_tiled, const float* r, int32_t* out_i, float* out_s,
                       int m, int k, long long ld, int n, int parts, int groups_per_part,
                       cudaStream_t stream) {
  const int tiles = (m + TM - 1) / TM;
  const size_t bytes = static_cast<size_t>(tiles) * TM * k * sizeof(float);
  if (bytes > sizeof(c_queries)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaMemcpyToSymbolAsync(c_queries, q_tiled, bytes, 0,
                                          cudaMemcpyDeviceToDevice, stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  const_query_candidates_kernel<TM><<<dim3(parts, tiles), kLanes, 0, stream>>>(
      r, out_i, out_s, m, k, ld, n, groups_per_part);
  return static_cast<int>(cudaGetLastError());
}

template <int TM>
int launch_dma(const float* q, const float* r, int32_t* out_i, int m, int k, long long ld, int n,
               int parts, int groups_per_part, int slice_groups, cudaStream_t stream) {
  const size_t smem = (static_cast<size_t>((TM * k + 3) / 4) * 4 +
                       static_cast<size_t>(kDmaStages) * k * slice_groups * kLanes) *
                      sizeof(float);
  if (const int e = allow_smem(dma_candidates_kernel<TM>, smem)) return e;
  const int tiles = (m + TM - 1) / TM;
  for (int t0 = 0; t0 < tiles; t0 += kMaxGridY) {
    const int ty = tiles - t0 < kMaxGridY ? tiles - t0 : kMaxGridY;
    dma_candidates_kernel<TM><<<dim3(parts, ty), kLanes, smem, stream>>>(
        q, r, out_i, m, k, ld, n, groups_per_part, slice_groups, t0 * TM);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
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

// B1's AoS variant (v3): ref is the caller's row-major (n, k) array;
// tile_m in {1, 8, 32} with (tile_m + 129) * k floats of shared memory.
int tk_aos_candidates(const float* q, const float* ref, int32_t* out_i, float* out_s, int m,
                      int k, int n, int parts, int tile_m, void* stream) {
  if (!valid_geometry(m, k, n, n, parts)) return static_cast<int>(cudaErrorInvalidValue);
  const int gpp = groups_per_part(n, parts);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tile_m) {
    case 32: return launch_aos<32>(q, ref, out_i, out_s, m, k, n, parts, gpp, s);
    case 8: return launch_aos<8>(q, ref, out_i, out_s, m, k, n, parts, gpp, s);
    case 1: return launch_aos<1>(q, ref, out_i, out_s, m, k, n, parts, gpp, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// B1's constant-query variant (v6): q_tiled is the query set on the card,
// padded to whole tiles of tile_m rows and laid out [tile][d][i]; at most
// 16384 floats (the constant bank).
int tk_const_query_candidates(const float* q_tiled, const float* r, int32_t* out_i,
                              float* out_s, int m, int k, long long ld, int n, int parts,
                              int tile_m, void* stream) {
  if (!valid_geometry(m, k, ld, n, parts)) return static_cast<int>(cudaErrorInvalidValue);
  const int gpp = groups_per_part(n, parts);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tile_m) {
    case 32: return launch_const_query<32>(q_tiled, r, out_i, out_s, m, k, ld, n, parts, gpp, s);
    case 8: return launch_const_query<8>(q_tiled, r, out_i, out_s, m, k, ld, n, parts, gpp, s);
    case 1: return launch_const_query<1>(q_tiled, r, out_i, out_s, m, k, ld, n, parts, gpp, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// B10 (v5): B1's geometry plus slice_groups 128-column groups per staged
// slice; r 16-byte aligned with ld % 4 == 0; out_i (m, parts*128).
int tk_dma_candidates(const float* q, const float* r, int32_t* out_i, int m, int k,
                      long long ld, int n, int parts, int tile_m, int slice_groups,
                      void* stream) {
  if (!valid_geometry(m, k, ld, n, parts) || slice_groups < 1 || ld % 4 != 0 ||
      reinterpret_cast<uintptr_t>(r) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int gpp = groups_per_part(n, parts);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tile_m) {
    case 32: return launch_dma<32>(q, r, out_i, m, k, ld, n, parts, gpp, slice_groups, s);
    case 8: return launch_dma<8>(q, r, out_i, m, k, ld, n, parts, gpp, slice_groups, s);
    case 1: return launch_dma<1>(q, r, out_i, m, k, ld, n, parts, gpp, slice_groups, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* tk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
