// B5: the top-K sweep, an instance of the tiled f32 template (tiled.cuh)
// with a K-list fold (kselect.cuh) as its epilogue, and its bf16 instance.

#include "kselect.cuh"
#include "knn_common.cuh"
#include "tiled.cuh"

namespace {

// ---------------------------------------------------------------------------
// B5 — replaces tpu_knn/kernels/topk.py:188 _sweep_kernel (with
// _kstate_insert; built by _build_sweep_candidates): per (row, partition),
// the kk lexicographically smallest (score, column) pairs of the
// partition's columns, sorted, from one sweep of the operand (kselect.cuh's
// list map and contract; empty slots (+inf, INT32_MAX)). The scores are
// B1's and B4's bit for bit (the template's s = |r|^2 - 2 acc), so the
// sweep and passes engines select the same top-K.
//
// Bound on the H100: device-memory reads at serving batch sizes (at
// (k=16, m=8, n=2^20) the 64 MiB operand, 0.020 ms at 3.35 TB/s, against
// 2^28 flops, 0.004 ms at the f32 peak); arithmetic from m of a few
// hundred up, as B1.
//
// Design: B1's blocks, ring and micro-tile (8 warps, 8*TM rows, 3-stage
// cp.async ring of 16-row d-chunks, tuning.sweep_geometry's TM and P), so
// all of a block's rows share each staged slice and the operand is read
// once per row tile, where the lane-per-thread kernel before it read it
// once per row group of 32/K rows. TM is 1 or 4, not 8: at TM = 8 the
// fold's merge beside the 64 scores it holds needs more than the 128
// registers that two blocks an SM leave a thread (ptxas spilled), so m > 32
// takes row tiles of 32. A block owns one partition of whole
// 128-column groups, swept as contiguous 256-column tiles (slot (j, c) =
// column col0 + 32 j + c, partition_columns), and each warp owns TM rows:
// the tile's 256 scores of a row all lie in one warp, which keeps that
// row's list alone (kselect.cuh), with no block-wide barrier. The epilogue
// compares each of the thread's TM x 8 scores against its row's kk-th
// entry; one vote skips the tile where nothing passes, else each (row, j)
// in which some lane's score passes offers its 32 lanes' scores to the
// queue with a ballot. A list's threshold tightens only when its queue is
// merged, so in partitions of 16 tiles most tiles pass something in some
// row of a block: that path, not the scores, is most of B5's time at
// TM = 4.
//
// B5's bf16 instance (sweep_bf16_kselect_kernel) — tpu_knn's sweep over a
// bf16 store's SoA operand, upcast at the read (index.py:1625-1627): the
// same block under the template's BF16 policy (a ring of bf16 stages,
// upcast at the shared-memory read), so its lists are B5's bit for bit over
// the upcast operand. Bound: the k*n*2 bytes of the operand at serving
// batch sizes (0.010 ms at (k=16, n=2^20)).
// ---------------------------------------------------------------------------

// The block's static shared state: |r|^2 of the tile's columns and the
// K-selection of its 8*TM rows (row warp*TM + i at warp*TM + i).
template <int TM>
struct SweepState {
  float norm_s[kTileCols];
  KSelectState<kTiledWarps * TM> ks;
};

// The epilogue of a column tile: the thread's TM rows by its 8 columns
// col + 32 j (col: the tile's first column plus the lane; live while j <
// live_groups and below n) as scores, then offered to the rows' lists
// (ks rows first ..; rows >= `rows` of the warp lie past m).
template <int TM, int ROWS>
__device__ __forceinline__ void sweep_tile(float (&s)[TM][kTileGroups], const float* norms,
                                           long long col, int live_groups, int n, int rows,
                                           int kk, KSelectState<ROWS>& ks, int first) {
  {
    // The scores in place of the accumulators; a dead slot or row becomes
    // NaN, which no compare admits.
    float nj[kTileGroups];
    bool live[kTileGroups];
    tile_slots(norms, col, kSliceLanes, live_groups, n, nj, live);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
#pragma unroll
      for (int j = 0; j < kTileGroups; ++j) {
        s[i][j] = live[j] && i < rows ? nj[j] - 2.f * s[i][j] : __int_as_float(0x7fc00000);
      }
    }
  }
  const int c0 = static_cast<int>(col);
  unsigned pass[TM];  // bit j: s[i][j] passes row i's threshold
  bool any = false;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    float ts;
    int tc;
    kselect_threshold(ks, first + i, kk, ts, tc);
    pass[i] = 0u;
#pragma unroll
    for (int j = 0; j < kTileGroups; ++j) {
      pass[i] |= static_cast<unsigned>(kselect_passes(s[i][j], c0 + j * kSliceLanes, ts, tc))
                 << j;
    }
    any |= pass[i] != 0u;
  }
  if (!__any_sync(kFullMask, any)) return;  // warp-uniform
  // Only the rows, and in them the j, in which some lane's score passes,
  // one row a turn through one copy of the offer's code (row i's scores
  // picked out of the registers by selects), a list that is not full yet
  // bounded first (kselect_bound). On one H100 the three took B5 at
  // (k=16, m=32, n=2^20) K=8 from 0.16 to 0.14 ms of device time.
#pragma unroll 1
  for (int i = 0; i < TM; ++i) {
    float v[kTileGroups];
    unsigned p = pass[0];
#pragma unroll
    for (int j = 0; j < kTileGroups; ++j) v[j] = s[0][j];
#pragma unroll
    for (int r = 1; r < TM; ++r) {
      const bool here = i == r;
      p = here ? pass[r] : p;
#pragma unroll
      for (int j = 0; j < kTileGroups; ++j) v[j] = here ? s[r][j] : v[j];
    }
    const unsigned live = __reduce_or_sync(kFullMask, p);
    if (live != 0u) {  // warp-uniform
      float ts;
      int tc;
      kselect_threshold(ks, first + i, kk, ts, tc);
      if (ts == pos_inf()) kselect_bound(ks, first + i, kk, v, c0, kSliceLanes, ts, tc);
      kselect_offer(ks, first + i, kk, v, c0, kSliceLanes, ts, tc, live);
    }
  }
}

// One block's lists: rows row_base + blockIdx.y * 8*TM .., partition
// blockIdx.x, over an operand of type T.
template <int TM, typename T>
__device__ __forceinline__ void sweep_block(const float* __restrict__ qT, const T* __restrict__ r,
                                            int32_t* __restrict__ out_i,
                                            float* __restrict__ out_s, int m, int ldq, int k,
                                            long long ld, int n, int groups_per_part, int kk,
                                            bool vec16, int row_base, SweepState<TM>& state,
                                            float* ring) {
  constexpr int BM = kTiledWarps * TM;
  const int part = blockIdx.x;
  const int row0 = row_base + blockIdx.y * BM;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int first = warp * TM;
  const int rows = min(TM, m - (row0 + first));  // the warp's rows below m
#pragma unroll
  for (int i = 0; i < TM; ++i) kselect_init(state.ks, first + i, pos_inf());

  const TileColumns tc = partition_columns(n, groups_per_part, part);
  tiled_sweep<TM, false, false, false, T>(
      qT, ldq, r, m, k, ld, n, vec16, tc, row0, ring, state.norm_s,
      [&](float (&acc)[TM][kTileGroups], long long col0, int live_groups) {
        sweep_tile<TM>(acc, state.norm_s + lane, col0 + lane, live_groups, n, rows, kk,
                       state.ks, first);
      });

  const int list = list_of(tc.first, groups_per_part);
  const long long width = static_cast<long long>(gridDim.x) * kk;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    if (i < rows) {  // warp-uniform
      kselect_flush(state.ks, first + i, kk);
      kselect_write(state.ks.ls[first + i][lane], state.ks.li[first + i][lane], out_i, out_s,
                    (row0 + first + i) * width, list, kk);
    }
  }
}

template <int TM>
__global__ void __launch_bounds__(kTiledThreads, kTiledBlocksPerSm)
sweep_kselect_kernel(const float* __restrict__ qT, const float* __restrict__ r,
                     int32_t* __restrict__ out_i, float* __restrict__ out_s, int m, int ldq,
                     int k, long long ld, int n, int groups_per_part, int kk, bool vec16,
                     int row_base) {
  extern __shared__ float4 smem4[];
  __shared__ SweepState<TM> state;
  sweep_block<TM>(qT, r, out_i, out_s, m, ldq, k, ld, n, groups_per_part, kk, vec16, row_base,
                  state, reinterpret_cast<float*>(smem4));
}

template <int TM>
__global__ void __launch_bounds__(kTiledThreads, kTiledBlocksPerSm)
sweep_bf16_kselect_kernel(const float* __restrict__ qT, const __nv_bfloat16* __restrict__ r,
                          int32_t* __restrict__ out_i, float* __restrict__ out_s, int m, int ldq,
                          int k, long long ld, int n, int groups_per_part, int kk, bool vec16,
                          int row_base) {
  extern __shared__ float4 smem4[];
  __shared__ SweepState<TM> state;
  sweep_block<TM>(qT, r, out_i, out_s, m, ldq, k, ld, n, groups_per_part, kk, vec16, row_base,
                  state, reinterpret_cast<float*>(smem4));
}

// B5 (float r) and its bf16 instance at tm (1 or 4, tuning.SWEEP_ROWS).
template <typename T>
int launch_sweep(const float* qT, const T* r, int32_t* out_i, float* out_s, int m, int ldq,
                 int k, long long ld, int n, int parts, int kk, int tm, cudaStream_t stream) {
  if (!valid_geometry(m, k, ld, n, parts) || !valid_queries_t(qT, ldq, m) || kk < 1 ||
      kk > kListSlots) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool vec16 = vec16_operand(r, ld);
  const int gpp = groups_per_part(n, parts);
  const auto launch = [&](auto rows) {
    constexpr int TM = decltype(rows)::value;
    if constexpr (std::is_same_v<T, float>) {
      return launch_tiled_grid<TM, SweepState<TM>>(sweep_kselect_kernel<TM>, parts, m, 0, stream,
                                                   qT, r, out_i, out_s, m, ldq, k, ld, n, gpp,
                                                   kk, vec16);
    } else {
      return launch_tiled_grid<TM, SweepState<TM>, false, false, T>(
          sweep_bf16_kselect_kernel<TM>, parts, m, 0, stream, qT, r, out_i, out_s, m, ldq, k,
          ld, n, gpp, kk, vec16);
    }
  };
  switch (tm) {  // tuning.SWEEP_ROWS
    case 4: return launch(std::integral_constant<int, 4>{});
    case 1: return launch(std::integral_constant<int, 1>{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// B5 launch: qT the queries transposed, (k, ldq) as for B1; tm (1 or 4)
// rows per warp and `parts` partitions as tuning.sweep_geometry picks them; 1 <= kk
// <= 32; outputs (m, parts*kk), kselect.cuh's list map.
int tk_sweep_candidates(const float* qT, const float* r, int32_t* out_i, float* out_s, int m,
                        int ldq, int k, long long ld, int n, int parts, int kk, int tm,
                        void* stream) {
  return launch_sweep(qT, r, out_i, out_s, m, ldq, k, ld, n, parts, kk, tm,
                      static_cast<cudaStream_t>(stream));
}

// B5's bf16 instance: B5's launch over a bf16 SoA operand.
int tk_sweep_candidates_bf16(const float* qT, const void* r, int32_t* out_i, float* out_s, int m,
                             int ldq, int k, long long ld, int n, int parts, int kk, int tm,
                             void* stream) {
  return launch_sweep(qT, static_cast<const __nv_bfloat16*>(r), out_i, out_s, m, ldq, k, ld, n,
                      parts, kk, tm, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
