// B1 and B4 (the tiled f32 candidate kernel, plain and banded, with their
// bf16 instances over a bf16 store's operand), B1's two ladder variants
// (AoS, v3; resident queries, v6) and B10 (v5, TMA-staged): all instances
// of the tiled template (tiled.cuh).

#include "knn_common.cuh"
#include "tiled.cuh"

namespace {

// ---------------------------------------------------------------------------
// B1 — replaces tpu_knn/kernels/fused.py:318 _fused_kernel (built by
// _build_fused_candidates), the "highest" tier, and
// B4 — replaces tpu_knn/kernels/fused.py:506 _fused_banded_kernel (built by
// _build_banded_candidates): B1's fold over only the elements that lie
// lexicographically above the row's bound (b_s, b_i), i.e.
// s > b_s || (s == b_s && col > b_i). One B4 launch is one pass of the
// top-K "passes" engine: the reported point's lane yields its runner-up on
// the next pass, so per-lane top-1 state serves any K.
//
// Bound on the H100: arithmetic, 2*m*n*k f32 operations on the CUDA cores
// (the "highest" tier admits no TF32): at ds11 = (k=16, m=1024, n=2^20)
// 2^35 operations, 0.51 ms at the 67 TFLOP/s f32 peak, per launch; 24.6 ms
// at k = 768.
//
// Design: the tiled template (tiled.cuh: register micro-tiles of TM x 8
// scores over a 3-stage cp.async ring of 16-row d-chunks, 8 warps a block)
// with the lane fold as its epilogue. A block owns 8*TM query rows, one
// partition and a quarter of its 128 lanes (blockIdx.x = partition * 4 +
// quarter); thread c of a warp owns lane quarter*32 + c, and a column tile
// is 8 of the partition's 128-column groups, so a lane's columns all fall
// to one thread and fold in increasing column order with a strict `<`, the
// sweep's contract as it stands. The fold keeps per-(row, lane) pairs in
// shared memory (freeing the registers the micro-tile needs); B4's band
// test there is one compare per element (fold_tile). Columns >= n or past
// the partition are staged as zeros and masked in the fold.
// tuning.tiled_geometry picks TM and P, filling the card at 2 blocks of 8
// warps per SM in whole waves.
//
// B1's two ladder variants are the same kernel under the template's two
// operand policies (tiled.cuh), so their scores and candidates are B1's bit
// for bit at the same P:
// - AoS (v3, AOS) — replaces tpu_knn/kernels/fused.py:318 _fused_kernel
//   built with soa=False (fused.py:340; the reference v3, core.cu:231-312):
//   B1 reading the caller's row-major (n, k) array, with no per-call SoA
//   relayout. The ring's copies transpose each d-chunk on the way in. Any k
//   fits. Bound: arithmetic, as B1; at m = 1 the (n, k) read.
// - Resident queries (v6, QRES) — replaces _fused_kernel as v6 builds it
//   (fused.py:1038-1077; the reference v6 put the query set in constant
//   memory, core.cu:530-643, guard k*m <= 16384 floats at core.cu:603-607):
//   each block's query rows stay in shared memory for the whole sweep, and
//   the ring carries only the operand. tuning.resident_geometry picks TM so
//   that two blocks still fit an SM where they can.
//
// B10 — replaces tpu_knn/kernels/dma_pipeline.py:44 _dma_kernel (built by
// _build_dma; the reference v5's explicit choice of memory space for the
// streamed operand, core.cu:424-529): B1's fold over an operand staged by
// hand-issued copies, emitting indices only. Where tpu_knn issued its
// HBM->VMEM copies itself (pltpu.make_async_copy and semaphores), B10 is
// B1's kernel under the template's TMA policy (tma_candidates_kernel): one
// thread asks the Tensor Memory Accelerator for each stage's operand and
// query boxes, and completion lands on the stage's mbarrier. B1's geometry
// (tuning.tiled_geometry) and fold, so at the same P its indices are B1's
// bit for bit; no f32 scores are written. Any k fits. Bound: as B1 (at
// m = 1 the read of the operand).
//
// B1's and B4's bf16 instances (tiled_bf16_candidates_kernel) — tpu_knn's
// same kernels over a bf16 store's SoA operand, upcast at the read
// (index.py:1625-1627): B1 and B4 under the template's BF16 policy, whose
// ring stages the operand as stored (half an f32 stage's bytes) and whose
// micro-tile upcasts each value at the shared-memory read. Their candidates
// are the f32 instances' bit for bit over the upcast operand at the same P.
// Bound: as B1 (arithmetic from m of a few hundred; below, the read of
// k*n*2 bytes).
// ---------------------------------------------------------------------------

// The block's static shared state: |r|^2 of the tile's columns, the fold's
// per-(row, lane) pairs and B4's row bounds.
template <int TM, bool BANDED>
struct TiledState {
  float norm_s[kTileCols];
  float best_s[kTiledWarps * TM * kSliceLanes];  // [row][lane]
  int best_i[kTiledWarps * TM * kSliceLanes];
  float b_s[BANDED ? kTiledWarps * TM : 1];
  int b_i[BANDED ? kTiledWarps * TM : 1];
};

// The epilogue of a column tile: s = |r|^2 - 2 acc for the thread's TM
// rows by its lane's 8 columns col0 + 128 j (live while j < live_groups
// and below n), folded row by row in column order into the running (best
// score, index) pairs that the thread keeps in shared memory (best_s/_i
// at its first row, rows kSliceLanes apart), with a strict `<`. B4 folds
// only what lies lexicographically above the row's bound (b_s, b_i). Its
// test is one compare per element: against b_s itself where every column
// of the tile lies past b_i (s >= b_s), against the next float above b_s
// where none does (s > b_s; a NaN bound admits nothing either way), and
// the per-column rule only in a tile that holds b_i among the thread's
// columns for some row, warp-wide.
template <int TM, bool BANDED, bool EXACT>
__device__ __forceinline__ void fold_rows(const float (&acc)[TM][kTileGroups],
                                          const float (&nj)[kTileGroups],
                                          const bool (&live)[kTileGroups], long long col0,
                                          const float* b_s, const int* b_i, float* best_s,
                                          int* best_i) {
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    float bs = best_s[i * kSliceLanes];
    int bi = best_i[i * kSliceLanes];
    float floor_s = neg_inf();
    if constexpr (BANDED && !EXACT) {
      floor_s = col0 > b_i[i] ? b_s[i] : nextafterf(b_s[i], pos_inf());
    }
#pragma unroll
    for (int j = 0; j < kTileGroups; ++j) {
      const float sc = nj[j] - 2.f * acc[i][j];
      const int cj = static_cast<int>(col0 + static_cast<long long>(j) * kLanes);
      bool take = live[j] && sc < bs;
      if constexpr (EXACT) {
        take = take && (sc > b_s[i] || (sc == b_s[i] && cj > b_i[i]));
      } else if constexpr (BANDED) {
        take = take && sc >= floor_s;
      }
      bs = take ? sc : bs;
      bi = take ? cj : bi;
    }
    best_s[i * kSliceLanes] = bs;
    best_i[i * kSliceLanes] = bi;
  }
}

template <int TM, bool BANDED>
__device__ __forceinline__ void fold_tile(const float (&acc)[TM][kTileGroups], const float* norms,
                                          long long col0, int live_groups, int n,
                                          const float* b_s, const int* b_i, float* best_s,
                                          int* best_i) {
  float nj[kTileGroups];
  bool live[kTileGroups];
  tile_slots(norms, col0, kLanes, live_groups, n, nj, live);
  if constexpr (BANDED) {
    const long long last = col0 + static_cast<long long>(kTileGroups - 1) * kLanes;
    bool straddle = false;
#pragma unroll
    for (int i = 0; i < TM; ++i) straddle |= col0 <= b_i[i] && b_i[i] < last;
    if (__any_sync(0xffffffffu, straddle)) {
      fold_rows<TM, true, true>(acc, nj, live, col0, b_s, b_i, best_s, best_i);
      return;
    }
  }
  fold_rows<TM, BANDED, false>(acc, nj, live, col0, b_s, b_i, best_s, best_i);
}

// B10's static state: B1's, and the TMA ring's barriers, one a stage.
template <int TM>
struct TmaState : TiledState<TM, false> {
  uint64_t full[kTiledStages];
};

// One block's candidates: rows row_base + blockIdx.y * 8*TM .., lane
// quarter blockIdx.x % 4 of partition blockIdx.x / 4, under the template's
// policy (AOS, QRES or TMA; TMA emits the indices only).
template <int TM, bool BANDED, bool AOS, bool QRES, bool TMA, typename T = float>
__device__ __forceinline__ void candidates_block(
    const float* __restrict__ qT, const T* __restrict__ r, const float* __restrict__ bound_s,
    const int32_t* __restrict__ bound_i, int32_t* __restrict__ out_i, float* __restrict__ out_s,
    int m, int ldq, int k, long long ld, int n, int groups_per_part, bool vec16, int row_base,
    TiledState<TM, BANDED>& state, float* ring, const TmaRing& tma) {
  constexpr int BM = kTiledWarps * TM;
  const int part = blockIdx.x / kSlices;
  const int quarter = blockIdx.x - part * kSlices;
  const int row0 = row_base + blockIdx.y * BM;
  const int warp = threadIdx.x / 32;  // the thread's row group: rows warp*TM ..
  const int lane = threadIdx.x % 32;  // of the block's 32
  float* best_s = state.best_s + warp * TM * kSliceLanes + lane;
  int* best_i = state.best_i + warp * TM * kSliceLanes + lane;
  if constexpr (BANDED) {
    for (int i = threadIdx.x; i < BM; i += kTiledThreads) {
      state.b_s[i] = row0 + i < m ? bound_s[row0 + i] : pos_inf();
      state.b_i[i] = row0 + i < m ? bound_i[row0 + i] : kI32Max;
    }
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {  // the thread's own entries: no barrier needed
    best_s[i * kSliceLanes] = pos_inf();
    best_i[i * kSliceLanes] = kI32Max;
  }

  tiled_sweep<TM, AOS, QRES, TMA, T>(
      qT, ldq, r, m, k, ld, n, vec16, lane_slice_columns(n, groups_per_part, part, quarter),
      row0, ring, state.norm_s,
      [&](const float (&acc)[TM][kTileGroups], long long col0, int live_groups) {
        fold_tile<TM, BANDED>(acc, state.norm_s + lane, col0 + lane, live_groups, n,
                              state.b_s + warp * TM, state.b_i + warp * TM, best_s, best_i);
      },
      tma);

  const long long width = static_cast<long long>(gridDim.x / kSlices) * kLanes;
  const long long quarter_col = static_cast<long long>(quarter) * kSliceLanes;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = row0 + warp * TM + i;
    if (row < m) {
      const long long o = row * width + static_cast<long long>(part) * kLanes + quarter_col + lane;
      out_i[o] = best_i[i * kSliceLanes];
      if constexpr (!TMA) out_s[o] = best_s[i * kSliceLanes];
    }
  }
}

template <int TM, bool BANDED, bool AOS, bool QRES>
__global__ void __launch_bounds__(kTiledThreads, kTiledBlocksPerSm)
tiled_candidates_kernel(const float* __restrict__ qT, const float* __restrict__ r,
                        const float* __restrict__ bound_s, const int32_t* __restrict__ bound_i,
                        int32_t* __restrict__ out_i, float* __restrict__ out_s, int m, int ldq,
                        int k, long long ld, int n, int groups_per_part, bool vec16,
                        int row_base) {
  extern __shared__ float4 smem4[];
  __shared__ TiledState<TM, BANDED> state;
  candidates_block<TM, BANDED, AOS, QRES, false>(qT, r, bound_s, bound_i, out_i, out_s, m, ldq,
                                                 k, ld, n, groups_per_part, vec16, row_base,
                                                 state, reinterpret_cast<float*>(smem4),
                                                 TmaRing{});
}

// B1 (BANDED false) and B4 under the BF16 policy: r is a bf16 SoA operand.
template <int TM, bool BANDED>
__global__ void __launch_bounds__(kTiledThreads, kTiledBlocksPerSm)
tiled_bf16_candidates_kernel(const float* __restrict__ qT, const __nv_bfloat16* __restrict__ r,
                             const float* __restrict__ bound_s,
                             const int32_t* __restrict__ bound_i, int32_t* __restrict__ out_i,
                             float* __restrict__ out_s, int m, int ldq, int k, long long ld,
                             int n, int groups_per_part, bool vec16, int row_base) {
  extern __shared__ float4 smem4[];
  __shared__ TiledState<TM, BANDED> state;
  candidates_block<TM, BANDED, false, false, false, __nv_bfloat16>(
      qT, r, bound_s, bound_i, out_i, out_s, m, ldq, k, ld, n, groups_per_part, vec16, row_base,
      state, reinterpret_cast<float*>(smem4), TmaRing{});
}

// B10: B1 under the TMA policy, indices only (out_i (m, P*128)).
template <int TM>
__global__ void __launch_bounds__(kTiledThreads, kTiledBlocksPerSm)
tma_candidates_kernel(const __grid_constant__ CUtensorMap r_map,
                      const __grid_constant__ CUtensorMap q_map, int32_t* __restrict__ out_i,
                      int m, int k, int n, int groups_per_part, int row_base) {
  static_assert(kTiledBlocksPerSm * (TiledRing<TM>::kBytes + kTmaAlign + sizeof(TmaState<TM>) +
                                     kSmemPerBlockReserved) <= kSmemPerSm,
                "B10's blocks per SM do not fit its shared memory");
  extern __shared__ float4 smem4[];
  __shared__ TmaState<TM> state;
  candidates_block<TM, false, false, false, true, float>(
      nullptr, nullptr, nullptr, nullptr, out_i, nullptr, m, 0, k, 0, n, groups_per_part, false,
      row_base, state, tma_ring(smem4), TmaRing{&r_map, &q_map, state.full});
}

// ---------------------------------------------------------------------------
// Launchers.
// ---------------------------------------------------------------------------

// B1 (BANDED false), B4, v3 (AOS: r is the (n, k) array) and v6 (QRES)
// at tm in {1, 4, 8} rows per warp; with a bf16 r (T), B1's and B4's bf16
// instances.
template <bool BANDED, bool AOS = false, bool QRES = false, typename T = float>
int launch_tiled(const float* qT, const T* r, const float* bound_s, const int32_t* bound_i,
                 int32_t* out_i, float* out_s, int m, int ldq, int k, long long ld, int n,
                 int parts, int tm, cudaStream_t stream) {
  const bool vec16 = !AOS && vec16_operand(r, ld);
  const int gpp = groups_per_part(n, parts);
  return with_tiled_rows(tm, [&](auto rows) {
    constexpr int TM = decltype(rows)::value;
    if constexpr (std::is_same_v<T, float>) {
      return launch_tiled_grid<TM, TiledState<TM, BANDED>, AOS, QRES>(
          tiled_candidates_kernel<TM, BANDED, AOS, QRES>, parts * kSlices, m,
          QRES ? resident_bytes<TM>(m, k) : 0, stream, qT, r, bound_s, bound_i, out_i, out_s, m,
          ldq, k, ld, n, gpp, vec16);
    } else {
      return launch_tiled_grid<TM, TiledState<TM, BANDED>, false, false, T>(
          tiled_bf16_candidates_kernel<TM, BANDED>, parts * kSlices, m, 0, stream, qT, r,
          bound_s, bound_i, out_i, out_s, m, ldq, k, ld, n, gpp, vec16);
    }
  });
}

}  // namespace

extern "C" {

// B1 launch: qT the queries transposed, (k, ldq) with ldq >= m a multiple
// of 4 and rows m..ldq-1 zero, 16-byte aligned; tm rows per warp (8*tm
// per block), as tuning.tiled_geometry picks it; out (m, parts*128).
int tk_fused_candidates(const float* qT, const float* r, int32_t* out_i, float* out_s, int m,
                        int ldq, int k, long long ld, int n, int parts, int tm, void* stream) {
  if (!valid_geometry(m, k, ld, n, parts) || !valid_queries_t(qT, ldq, m)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_tiled<false>(qT, r, nullptr, nullptr, out_i, out_s, m, ldq, k, ld, n, parts, tm,
                             static_cast<cudaStream_t>(stream));
}

// B4 launch: B1's geometry plus the per-row bound (bound_s (m,) f32,
// bound_i (m,) int32).
int tk_banded_candidates(const float* qT, const float* r, const float* bound_s,
                         const int32_t* bound_i, int32_t* out_i, float* out_s, int m, int ldq,
                         int k, long long ld, int n, int parts, int tm, void* stream) {
  if (!valid_geometry(m, k, ld, n, parts) || !valid_queries_t(qT, ldq, m)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_tiled<true>(qT, r, bound_s, bound_i, out_i, out_s, m, ldq, k, ld, n, parts, tm,
                            static_cast<cudaStream_t>(stream));
}

// B1's and B4's bf16 instances: their launches over a bf16 SoA operand.
int tk_fused_candidates_bf16(const float* qT, const void* r, int32_t* out_i, float* out_s, int m,
                             int ldq, int k, long long ld, int n, int parts, int tm,
                             void* stream) {
  if (!valid_geometry(m, k, ld, n, parts) || !valid_queries_t(qT, ldq, m)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_tiled<false>(qT, static_cast<const __nv_bfloat16*>(r), nullptr, nullptr, out_i,
                             out_s, m, ldq, k, ld, n, parts, tm,
                             static_cast<cudaStream_t>(stream));
}

int tk_banded_candidates_bf16(const float* qT, const void* r, const float* bound_s,
                              const int32_t* bound_i, int32_t* out_i, float* out_s, int m,
                              int ldq, int k, long long ld, int n, int parts, int tm,
                              void* stream) {
  if (!valid_geometry(m, k, ld, n, parts) || !valid_queries_t(qT, ldq, m)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_tiled<true>(qT, static_cast<const __nv_bfloat16*>(r), bound_s, bound_i, out_i,
                            out_s, m, ldq, k, ld, n, parts, tm,
                            static_cast<cudaStream_t>(stream));
}

// B1's AoS variant (v3): B1's launch over ref, the caller's row-major
// (n, k) array, in place of the SoA operand.
int tk_aos_candidates(const float* qT, const float* ref, int32_t* out_i, float* out_s, int m,
                      int ldq, int k, int n, int parts, int tm, void* stream) {
  if (!valid_geometry(m, k, n, n, parts) || !valid_queries_t(qT, ldq, m)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_tiled<false, true, false>(qT, ref, nullptr, nullptr, out_i, out_s, m, ldq, k, k,
                                          n, parts, tm, static_cast<cudaStream_t>(stream));
}

// B1 with resident queries (v6): B1's launch, tm as tuning.resident_geometry
// picks it; fails where a block's queries and ring exceed kSmemPerBlock.
int tk_const_query_candidates(const float* qT, const float* r, int32_t* out_i, float* out_s,
                              int m, int ldq, int k, long long ld, int n, int parts, int tm,
                              void* stream) {
  if (!valid_geometry(m, k, ld, n, parts) || !valid_queries_t(qT, ldq, m)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_tiled<false, false, true>(qT, r, nullptr, nullptr, out_i, out_s, m, ldq, k, ld,
                                          n, parts, tm, static_cast<cudaStream_t>(stream));
}

// B10 (v5): B1's launch (qT, tm and parts as for B1) under the TMA policy;
// r 16-byte aligned with ld % 128 == 0; out_i (m, parts*128), no scores.
int tk_dma_candidates(const float* qT, const float* r, int32_t* out_i, int m, int ldq, int k,
                      long long ld, int n, int parts, int tm, void* stream) {
  if (!valid_geometry(m, k, ld, n, parts) || !valid_queries_t(qT, ldq, m) || ld % kLanes != 0 ||
      reinterpret_cast<uintptr_t>(r) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int gpp = groups_per_part(n, parts);
  return with_tiled_rows(tm, [&](auto rows) {
    constexpr int TM = decltype(rows)::value;
    CUtensorMap r_map, q_map;
    if (const int e = encode_tma_maps<TM>(&r_map, &q_map, r, k, ld, qT, ldq)) return e;
    return launch_tiled_grid<TM, TmaState<TM>>(tma_candidates_kernel<TM>, parts * kSlices, m,
                                               kTmaAlign, static_cast<cudaStream_t>(stream),
                                               r_map, q_map, out_i, m, k, n, gpp);
  });
}

const char* tk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
