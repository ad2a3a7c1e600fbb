// The seeded top-K engine's kernels: B3 (value-only lane minima and their
// merge), B7 (per-cell integer moments) and the B8/B9 cell compactor. B3
// and B7 are the tiled f32 score template (tiled.cuh) with epilogues of
// their own, so they score every column bit for bit as B1 and B4 do; each
// has a bf16 instance under the template's BF16 policy (a bf16 store's
// operand staged as stored and upcast at the shared-memory read), whose
// outputs are the f32 instance's bit for bit over the upcast operand.

#include "knn_common.cuh"
#include "tiled.cuh"

namespace {

// ---------------------------------------------------------------------------
// B3 — replaces tpu_knn/kernels/fused.py:613 _fused_minima_kernel (built by
// _build_minima_candidates): the seeded engine's bound pass. B1's sweep
// without the index fold: per row and lane, the smallest score (DEPTH 1)
// or the two smallest of the multiset (DEPTH 2), optionally only scores
// above the row's lo (NaN never enters: every compare is strict). The
// caller passes the prefix it wants read as n, so a launch reads only
// those columns. Each block writes its quarter of its partition's 128
// lanes to a partial array; minima_merge_kernel folds the partitions into
// the contract's (m, DEPTH*128) = [min1 lanes | min2 lanes] (the fold is a
// min, so the merged values do not depend on the partition count).
//
// Bound on the H100: arithmetic, as B1 (2*m*n*k flops; at ds11 with the
// half prefix 2^34 flops, 0.26 ms at the f32 peak). Design: B1's blocks,
// tiles and ring (tiled.cuh, lane_slice_columns), the lane fold reduced to
// values: per (row, lane) the running minima sit in shared memory, as B1's
// pairs do, and each score costs a compare against them and lo.
// ---------------------------------------------------------------------------

// B3's static shared state: |r|^2 of the tile's columns, the per-(row,
// lane) minima ([row][lane]) and the rows' lo.
template <int TM, int DEPTH>
struct MinimaState {
  float norm_s[kTileCols];
  float min1[kTiledWarps * TM * kSliceLanes];
  float min2[DEPTH == 2 ? kTiledWarps * TM * kSliceLanes : 1];
  float lo[kTiledWarps * TM];
};

// The epilogue of a column tile: the thread's TM rows by its lane's 8
// columns col0 + 128 j folded into the lane's minima (min1/min2 at its
// first row, rows kSliceLanes apart), only scores above the row's lo.
template <int TM, int DEPTH>
__device__ __forceinline__ void fold_minima(const float (&acc)[TM][kTileGroups],
                                            const float* norms, long long col0, int live_groups,
                                            int n, const float* lo, float* min1, float* min2) {
  float nj[kTileGroups];
  bool live[kTileGroups];
  tile_slots(norms, col0, kLanes, live_groups, n, nj, live);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    float m1 = min1[i * kSliceLanes];
    float m2 = DEPTH == 2 ? min2[i * kSliceLanes] : 0.f;
#pragma unroll
    for (int j = 0; j < kTileGroups; ++j) {
      const float sc = nj[j] - 2.f * acc[i][j];
      if constexpr (DEPTH == 1) {
        m1 = live[j] && sc < m1 && sc > lo[i] ? sc : m1;
      } else if (live[j] && sc < m2 && sc > lo[i]) {
        // tpu_knn's fold (new1 = min(s, m1); the displaced value folds
        // into m2), written as one guarded branch.
        m2 = sc < m1 ? m1 : sc;
        m1 = sc < m1 ? sc : m1;
      }
    }
    min1[i * kSliceLanes] = m1;
    if constexpr (DEPTH == 2) min2[i * kSliceLanes] = m2;
  }
}

// One block's partial minima (rows row_base + blockIdx.y * 8*TM .., lane
// quarter blockIdx.x % 4 of partition blockIdx.x / 4) over an operand of
// type T.
template <int TM, int DEPTH, typename T>
__device__ __forceinline__ void minima_block(const float* __restrict__ qT,
                                             const T* __restrict__ r,
                                             const float* __restrict__ lo,
                                             float* __restrict__ partial, int m, int ldq, int k,
                                             long long ld, int n, int groups_per_part,
                                             bool vec16, int row_base,
                                             MinimaState<TM, DEPTH>& state, float* ring) {
  constexpr int BM = kTiledWarps * TM;
  const int parts = gridDim.x / kSlices;
  const int part = blockIdx.x / kSlices;
  const int quarter = blockIdx.x - part * kSlices;
  const int row0 = row_base + blockIdx.y * BM;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* min1 = state.min1 + warp * TM * kSliceLanes + lane;
  float* min2 = state.min2 + (DEPTH == 2 ? warp * TM * kSliceLanes + lane : 0);
  for (int i = threadIdx.x; i < BM; i += kTiledThreads) {
    state.lo[i] = lo != nullptr && row0 + i < m ? lo[row0 + i] : neg_inf();
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {  // the thread's own entries: no barrier needed
    min1[i * kSliceLanes] = pos_inf();
    if constexpr (DEPTH == 2) min2[i * kSliceLanes] = pos_inf();
  }

  tiled_sweep<TM, false, false, false, T>(
      qT, ldq, r, m, k, ld, n, vec16, lane_slice_columns(n, groups_per_part, part, quarter),
      row0, ring, state.norm_s,
      [&](const float (&acc)[TM][kTileGroups], long long col0, int live_groups) {
        fold_minima<TM, DEPTH>(acc, state.norm_s + lane, col0 + lane, live_groups, n,
                               state.lo + warp * TM, min1, min2);
      });

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = row0 + warp * TM + i;
    if (row < m) {
      float* o = partial + ((static_cast<long long>(row) * parts + part) * DEPTH) * kLanes +
                 quarter * kSliceLanes + lane;
      o[0] = min1[i * kSliceLanes];
      if constexpr (DEPTH == 2) o[kLanes] = min2[i * kSliceLanes];
    }
  }
}

template <int TM, int DEPTH>
__global__ void __launch_bounds__(kTiledThreads, kTiledBlocksPerSm)
tiled_minima_kernel(const float* __restrict__ qT, const float* __restrict__ r,
                    const float* __restrict__ lo, float* __restrict__ partial, int m, int ldq,
                    int k, long long ld, int n, int groups_per_part, bool vec16, int row_base) {
  extern __shared__ float4 smem4[];
  __shared__ MinimaState<TM, DEPTH> state;
  minima_block<TM, DEPTH>(qT, r, lo, partial, m, ldq, k, ld, n, groups_per_part, vec16, row_base,
                          state, reinterpret_cast<float*>(smem4));
}

// B3's bf16 instance: r is a bf16 SoA operand.
template <int TM, int DEPTH>
__global__ void __launch_bounds__(kTiledThreads, kTiledBlocksPerSm)
bf16_minima_kernel(const float* __restrict__ qT, const __nv_bfloat16* __restrict__ r,
                   const float* __restrict__ lo, float* __restrict__ partial, int m, int ldq,
                   int k, long long ld, int n, int groups_per_part, bool vec16, int row_base) {
  extern __shared__ float4 smem4[];
  __shared__ MinimaState<TM, DEPTH> state;
  minima_block<TM, DEPTH>(qT, r, lo, partial, m, ldq, k, ld, n, groups_per_part, vec16, row_base,
                          state, reinterpret_cast<float*>(smem4));
}

// ---------------------------------------------------------------------------
// B7 — replaces tpu_knn/kernels/topk.py:509 _extract_moment_kernel (built by
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
// diagonal weight matrix. Every sum here is an exact integer below 2^31
// for any cell (sum l^3 over 256 lanes <= 1.07e9), so the words equal
// tpu_knn's bit for bit.
//
// Bound on the H100: arithmetic, as B1 (2*m*n*k flops: 0.51 ms at ds11),
// plus a compare and a vote per (row, column). Design: the tiled template
// (tiled.cuh) with a column tile of one contiguous 256-column chunk:
// thread c of a warp owns columns c + 32 j of it, so a cell of 64, 128 or
// 256 columns is 2, 4 or 8 of one warp's j and each (row, cell) reduces
// inside the warp: one __any_sync per row skips the (row, chunk)s that
// hold no score under the bound (nearly all), else a __ballot_sync per
// (row, j), __reduce_add_sync of l, l^2 (and l^3) only when some lane
// qualifies, summed over the cell's j in registers; one write per (row,
// cell), all of a warp's words in one store. No shared memory or barrier is spent on the
// reduction. The remainder minima are kept per lane (col % 128: thread
// c's 8 columns fall into 4 lanes) in shared memory. A block owns 8*TM
// rows and a partition of whole chunks (tuning.moments_geometry), so no
// cell straddles a partition; chunks past n are scored as zeros and
// write zero words.
// ---------------------------------------------------------------------------

// B7's static shared state: |r|^2 of the tile's columns, the rows' bound
// and lo, and (REM) the per-(row, lane) remainder minima ([row][lane]).
template <int TM, bool REM>
struct MomentState {
  float norm_s[kTileCols];
  float bound[kTiledWarps * TM];
  float lo[kTiledWarps * TM];
  float rem[REM ? kTiledWarps * TM * kLanes : 1];
};

// The epilogue of a chunk (its first column col0): the moments of the
// warp's TM rows (row0 ..) over each of the chunk's cells, written to
// out_a (and out_p3) at (row, chunk's cell); with REM the remainder
// minima of the thread's 4 lanes (rem at its first row and lane c).
// Every lane reaches every ballot; rows >= m vote false (bound -inf).
template <int TM, bool REM>
__device__ __forceinline__ void moment_tile(float (&s)[TM][kTileGroups], const float* norms,
                                            long long col0, int n, int m, int row0, int nc,
                                            int cell, bool cubic, const float* bound,
                                            const float* lo, float* rem,
                                            int32_t* __restrict__ out_a,
                                            int32_t* __restrict__ out_p3) {
  static_assert(TM * (kTileCols / 64) <= 32, "a warp's words fit its lanes");
  const int lane = threadIdx.x % 32;
  {
    // The scores (s = |r|^2 - 2 acc) in place of the accumulators,
    // so the norms and liveness need no registers past this point; a column
    // >= n becomes NaN, which no compare below admits.
    float nj[kTileGroups];
    bool live[kTileGroups];
    tile_slots(norms, col0 + lane, kSliceLanes, kTileGroups, n, nj, live);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
#pragma unroll
      for (int j = 0; j < kTileGroups; ++j) {
        s[i][j] = live[j] ? nj[j] - 2.f * s[i][j] : __int_as_float(0x7fc00000);
      }
    }
  }
  const int per_cell = cell / kSliceLanes;  // j per cell: 2, 4 or 8
  const int cells = kTileCols / cell;       // cells per chunk: 4, 2 or 1
  const int cell_shift = __ffs(per_cell) - 1;
  const unsigned solvable = cubic ? 3u : 2u;
  unsigned word = 0u, word3 = 0u;  // lane i*cells + c's: row i, cell c
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const float b = bound[i], l = lo[i];
    // Nearly every (row, chunk) holds no score under the bound: one vote per
    // row skips it (its words stay 0), and only a row in which some lane
    // may qualify takes the vote per column.
    float least = pos_inf();
#pragma unroll
    for (int j = 0; j < kTileGroups; ++j) least = fminf(least, s[i][j]);
    if (__any_sync(0xffffffffu, least <= b)) {  // warp-uniform
      unsigned cnt = 0u, e1 = 0u, p2 = 0u, p3 = 0u;
#pragma unroll
      for (int j = 0; j < kTileGroups; ++j) {
        const float sc = s[i][j];
        const bool qual = sc <= b && sc > l;
        const unsigned bal = __ballot_sync(0xffffffffu, qual);
        if (bal != 0u) {  // warp-uniform
          const unsigned v = qual ? static_cast<unsigned>(j * kSliceLanes + lane) &
                                        static_cast<unsigned>(cell - 1)
                                  : 0u;
          cnt += static_cast<unsigned>(__popc(bal));
          e1 += __reduce_add_sync(0xffffffffu, v);
          p2 += __reduce_add_sync(0xffffffffu, v * v);
          if (cubic) p3 += __reduce_add_sync(0xffffffffu, v * v * v);
        }
        if (((j + 1) & (per_cell - 1)) == 0) {  // the cell's last j
          if (lane == i * cells + (j >> cell_shift)) {
            const unsigned packed = (cnt < 3u ? cnt : 3u) | (e1 << 2) | (p2 << 12);
            word = (packed & 0x3FFFFFFFu) | ((cnt > solvable ? 1u : 0u) << 30);
            word3 = p3;
          }
          cnt = e1 = p2 = p3 = 0u;
        }
      }
    }
    if constexpr (REM) {  // lane q's two columns, j = q and q + 4, one lane at a time
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float v = rem[i * kLanes + q * kSliceLanes];
#pragma unroll
        for (int j = q; j < kTileGroups; j += 4) v = s[i][j] < v && s[i][j] > b ? s[i][j] : v;
        rem[i * kLanes + q * kSliceLanes] = v;
      }
    }
  }
  const int i = lane / cells;
  const int row = row0 + i;
  const long long cidx = col0 / cell + (lane - i * cells);
  if (i < TM && row < m && cidx < nc) {
    const long long o = static_cast<long long>(row) * nc + cidx;
    out_a[o] = static_cast<int32_t>(word);
    if (cubic) out_p3[o] = static_cast<int32_t>(word3);
  }
}

// One block's moments (rows row_base + blockIdx.y * 8*TM .., partition
// blockIdx.x of whole chunks) over an operand of type T.
template <int TM, bool REM, typename T>
__device__ __forceinline__ void moments_block(
    const float* __restrict__ qT, const T* __restrict__ r, const float* __restrict__ bound,
    const float* __restrict__ lo, int32_t* __restrict__ out_a, int32_t* __restrict__ out_p3,
    float* __restrict__ rem_part, int m, int ldq, int k, long long ld, int n, int nc, int cell,
    bool cubic, int chunks_per_part, bool vec16, int row_base, MomentState<TM, REM>& state,
    float* ring) {
  constexpr int BM = kTiledWarps * TM;
  const int part = blockIdx.x;
  const int row0 = row_base + blockIdx.y * BM;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long c0 = static_cast<long long>(part) * chunks_per_part;
  const long long chunks = (static_cast<long long>(nc) * cell + kTileCols - 1) / kTileCols;
  const int own = static_cast<int>(max(0LL, min(static_cast<long long>(chunks_per_part),
                                                chunks - c0)));
  for (int i = threadIdx.x; i < BM; i += kTiledThreads) {
    state.bound[i] = row0 + i < m ? bound[row0 + i] : neg_inf();
    state.lo[i] = lo != nullptr && row0 + i < m ? lo[row0 + i] : neg_inf();
  }
  float* rem = state.rem + (REM ? warp * TM * kLanes + lane : 0);
  if constexpr (REM) {
#pragma unroll
    for (int i = 0; i < TM; ++i) {  // the thread's own entries: no barrier needed
#pragma unroll
      for (int q = 0; q < 4; ++q) rem[i * kLanes + q * kSliceLanes] = pos_inf();
    }
  }

  tiled_sweep<TM, false, false, false, T>(
      qT, ldq, r, m, k, ld, n, vec16,
      TileColumns{c0 * kTileCols, kTileCols, kSliceLanes, own * kTileGroups}, row0, ring,
      state.norm_s, [&](float (&acc)[TM][kTileGroups], long long col0, int) {
        moment_tile<TM, REM>(acc, state.norm_s + lane, col0, n, m, row0 + warp * TM, nc, cell,
                             cubic, state.bound + warp * TM, state.lo + warp * TM, rem, out_a,
                             out_p3);
      });

  if constexpr (REM) {
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int row = row0 + warp * TM + i;
      if (row < m) {
        float* o = rem_part + (static_cast<long long>(row) * gridDim.x + part) * kLanes + lane;
#pragma unroll
        for (int q = 0; q < 4; ++q) o[q * kSliceLanes] = rem[i * kLanes + q * kSliceLanes];
      }
    }
  }
}

template <int TM, bool REM>
__global__ void __launch_bounds__(kTiledThreads, kTiledBlocksPerSm)
tiled_moments_kernel(const float* __restrict__ qT, const float* __restrict__ r,
                     const float* __restrict__ bound, const float* __restrict__ lo,
                     int32_t* __restrict__ out_a, int32_t* __restrict__ out_p3,
                     float* __restrict__ rem_part, int m, int ldq, int k, long long ld, int n,
                     int nc, int cell, bool cubic, int chunks_per_part, bool vec16,
                     int row_base) {
  extern __shared__ float4 smem4[];
  __shared__ MomentState<TM, REM> state;
  moments_block<TM, REM>(qT, r, bound, lo, out_a, out_p3, rem_part, m, ldq, k, ld, n, nc, cell,
                         cubic, chunks_per_part, vec16, row_base, state,
                         reinterpret_cast<float*>(smem4));
}

// B7's bf16 instance: r is a bf16 SoA operand.
template <int TM, bool REM>
__global__ void __launch_bounds__(kTiledThreads, kTiledBlocksPerSm)
bf16_moments_kernel(const float* __restrict__ qT, const __nv_bfloat16* __restrict__ r,
                    const float* __restrict__ bound, const float* __restrict__ lo,
                    int32_t* __restrict__ out_a, int32_t* __restrict__ out_p3,
                    float* __restrict__ rem_part, int m, int ldq, int k, long long ld, int n,
                    int nc, int cell, bool cubic, int chunks_per_part, bool vec16,
                    int row_base) {
  extern __shared__ float4 smem4[];
  __shared__ MomentState<TM, REM> state;
  moments_block<TM, REM>(qT, r, bound, lo, out_a, out_p3, rem_part, m, ldq, k, ld, n, nc, cell,
                         cubic, chunks_per_part, vec16, row_base, state,
                         reinterpret_cast<float*>(smem4));
}

// ---------------------------------------------------------------------------
// B8 and B9 — replace tpu_knn/kernels/topk.py:817 _cell_compact_kernel and
// :899 _cell_butterfly_kernel (both built by _build_cell_compactor, which
// picks one by part width only because of VMEM): positional compaction of
// the qualifying cells of each (row, part). Fields are (m, nc) int32, field
// 0 nonzero exactly at qualifiers; each part (nc / parts cells) writes
// [cell position within the part, f0 (, f1)] of its qualifiers to its
// first `cap` slots in ascending cell order, drops qualifiers past cap and
// zero-fills the slots after the last one. Outputs are (m, parts*cap).
//
// Bound on the H100: device-memory bytes (field 0 read once, the outputs
// written once; 16 MB of field 0 at ds11 K=8, about 5 us; 64 MB at
// (16, 1024, 2^22) K=8, 20 us). The kernel is there only if enough bytes
// are in flight: about 25 KB an SM (3.35 TB/s x ~1 us of latency over 132
// SMs). Design: a group of W warps (T = 32 W threads) walks one (row, part)
// in rounds of 16 T cells, each thread loading 4 int4 of 4 consecutive cells
// (int4 u of thread t at cells 4 (u T + t) of the round, so each load
// instruction of a warp reads 512 contiguous bytes); a 256-thread block
// holds 8 / W groups, each on its own task, so a block keeps 16 KB in
// flight whatever W is (64 KB an SM). A round's ranks: per-thread counts
// of the 4 int4 packed as 16-bit fields of one 64-bit word, an inclusive
// __shfl_up scan in each warp, the warps' totals through shared memory
// (double-buffered, one group barrier a round), and a running base; a
// qualifier whose rank is below cap writes its slot (f1 gathered only
// there). The walk stops once the base reaches cap (group-uniform). W is
// the fewest warps whose round covers the part, but no more than keeps
// the grid to one wave of resident blocks (kCompactBlocksPerSm an SM):
// where tasks are many, a block walks several rounds of each of its tasks
// instead of the card running waves of one-round blocks, which measured
// slower (at m = 1024: ds11 K=8, part width 4096, and (16, 1024, 2^22)
// K=8, 16384, take W = 4, 2 and 8 rounds a row; the K=64 and 128 fields,
// width 2048, W = 1).
// int4 loads need the part's first cell and the part width at multiples
// of 4 cells and a 16-byte base; else the same kernel reads the cells one
// by one (`vec` false).
// ---------------------------------------------------------------------------
constexpr int kCompactThreads = 256;
constexpr int kCompactWarps = kCompactThreads / 32;
constexpr int kCompactQuads = 4;        // int4 a thread a round
constexpr int kCompactBlocksPerSm = 4;  // __launch_bounds__: at most 64 registers

// The 4 cells c .. c + 3 of a part of pw cells at p (zero past pw).
__device__ __forceinline__ int4 load_cells(const int32_t* __restrict__ p, int c, int pw,
                                           bool vec) {
  if (vec) return c < pw ? __ldg(reinterpret_cast<const int4*>(p + c)) : make_int4(0, 0, 0, 0);
  return make_int4(c < pw ? __ldg(p + c) : 0, c + 1 < pw ? __ldg(p + c + 1) : 0,
                   c + 2 < pw ? __ldg(p + c + 2) : 0, c + 3 < pw ? __ldg(p + c + 3) : 0);
}

__device__ __forceinline__ int field16(unsigned long long x, int u) {
  return static_cast<int>((x >> (16 * u)) & 0xffffu);
}

template <int W>
__global__ void __launch_bounds__(kCompactThreads, kCompactBlocksPerSm)
compact_cells_kernel(const int32_t* __restrict__ f0, const int32_t* __restrict__ f1,
                     int32_t* __restrict__ o_pos, int32_t* __restrict__ o0,
                     int32_t* __restrict__ o1, int m, int nc, int parts, int cap, bool vec) {
  constexpr int T = 32 * W;
  constexpr int kRound = kCompactQuads * 4 * T;
  __shared__ unsigned long long warp_sums[2][kCompactWarps];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int group = warp / W;
  const int t = threadIdx.x - group * T;  // the thread's place in its group
  const long long task = static_cast<long long>(blockIdx.x) * (kCompactWarps / W) + group;
  if (task >= static_cast<long long>(m) * parts) return;  // a whole group at once
  const long long row = task / parts;
  const int part = static_cast<int>(task - row * parts);
  const int pw = nc / parts;
  const int32_t* in0 = f0 + row * nc + static_cast<long long>(part) * pw;
  const int32_t* in1 = f1 == nullptr ? nullptr : f1 + row * nc + static_cast<long long>(part) * pw;
  const long long out = (row * parts + part) * cap;
  int count = 0;
  for (int c0 = 0, buf = 0; c0 < pw && count < cap; c0 += kRound, buf ^= 1) {
    int4 v[kCompactQuads];
    unsigned long long own = 0;  // qualifiers of int4 u in field u
#pragma unroll
    for (int u = 0; u < kCompactQuads; ++u) {
      v[u] = load_cells(in0, c0 + 4 * (u * T + t), pw, vec);
      own |= static_cast<unsigned long long>((v[u].x != 0) + (v[u].y != 0) + (v[u].z != 0) +
                                             (v[u].w != 0))
             << (16 * u);
    }
    unsigned long long incl = own;
#pragma unroll
    for (int d = 1; d < 32; d *= 2) {
      const unsigned long long y = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += y;
    }
    if (lane == 31) warp_sums[buf][warp] = incl;
    if constexpr (W == 1) {
      __syncwarp();
    } else {
      asm volatile("bar.sync %0, %1;\n" ::"r"(group + 1), "r"(T) : "memory");
    }
    unsigned long long below = incl - own, total = 0;  // fields: before the thread, round
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const unsigned long long x = warp_sums[buf][group * W + w];
      below += group * W + w < warp ? x : 0;
      total += x;
    }
    int rank = count;  // of the thread's first qualifier in int4 u
#pragma unroll
    for (int u = 0; u < kCompactQuads; ++u) {
      int r = rank + field16(below, u);
      const int c = c0 + 4 * (u * T + t);
      const int32_t e[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (e[i] != 0) {
          if (r < cap) {
            o_pos[out + r] = c + i;
            o0[out + r] = e[i];
            if (in1 != nullptr) o1[out + r] = __ldg(in1 + c + i);
          }
          ++r;
        }
      }
      rank += field16(total, u);
    }
    count = rank;
  }
  for (int sl = min(count, cap) + t; sl < cap; sl += T) {
    o_pos[out + sl] = 0;
    o0[out + sl] = 0;
    if (o1 != nullptr) o1[out + sl] = 0;
  }
}

// ---------------------------------------------------------------------------
// Launchers.
// ---------------------------------------------------------------------------

template <int DEPTH, typename T>
int launch_minima(const float* qT, const T* r, const float* lo, float* partial, float* out,
                  int m, int ldq, int k, long long ld, int n, int parts, int tm,
                  cudaStream_t stream) {
  const bool vec16 = vec16_operand(r, ld);
  const int gpp = groups_per_part(n, parts);
  const int e = with_tiled_rows(tm, [&](auto rows) {
    constexpr int TM = decltype(rows)::value;
    if constexpr (std::is_same_v<T, float>) {
      return launch_tiled_grid<TM, MinimaState<TM, DEPTH>>(
          tiled_minima_kernel<TM, DEPTH>, parts * kSlices, m, 0, stream, qT, r, lo, partial, m,
          ldq, k, ld, n, gpp, vec16);
    } else {
      return launch_tiled_grid<TM, MinimaState<TM, DEPTH>, false, false, T>(
          bf16_minima_kernel<TM, DEPTH>, parts * kSlices, m, 0, stream, qT, r, lo, partial, m,
          ldq, k, ld, n, gpp, vec16);
    }
  });
  if (e != 0) return e;
  minima_merge_kernel<DEPTH><<<m, kLanes, 0, stream>>>(partial, out, parts);
  return static_cast<int>(cudaGetLastError());
}

template <bool REM, typename T>
int launch_moments(const float* qT, const T* r, const float* bound, const float* lo,
                   int32_t* out_a, int32_t* out_p3, float* rem_part, float* rem_out, int m,
                   int ldq, int k, long long ld, int n, int nc, int cell, bool cubic, int parts,
                   int chunks_per_part, int tm, cudaStream_t stream) {
  const bool vec16 = vec16_operand(r, ld);
  const int e = with_tiled_rows(tm, [&](auto rows) {
    constexpr int TM = decltype(rows)::value;
    if constexpr (std::is_same_v<T, float>) {
      return launch_tiled_grid<TM, MomentState<TM, REM>>(
          tiled_moments_kernel<TM, REM>, parts, m, 0, stream, qT, r, bound, lo, out_a, out_p3,
          rem_part, m, ldq, k, ld, n, nc, cell, cubic, chunks_per_part, vec16);
    } else {
      return launch_tiled_grid<TM, MomentState<TM, REM>, false, false, T>(
          bf16_moments_kernel<TM, REM>, parts, m, 0, stream, qT, r, bound, lo, out_a, out_p3,
          rem_part, m, ldq, k, ld, n, nc, cell, cubic, chunks_per_part, vec16);
    }
  });
  if (e != 0 || !REM) return e;
  minima_merge_kernel<1><<<m, kLanes, 0, stream>>>(rem_part, rem_out, parts);
  return static_cast<int>(cudaGetLastError());
}

// B3's entry (both instances): depth 1 or 2.
template <typename T>
int minima_entry(const float* qT, const T* r, const float* lo, float* partial, float* out, int m,
                 int ldq, int k, long long ld, int n, int parts, int tm, int depth,
                 void* stream) {
  if (!valid_geometry(m, k, ld, n, parts) || !valid_queries_t(qT, ldq, m) ||
      (depth != 1 && depth != 2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (depth == 1) return launch_minima<1>(qT, r, lo, partial, out, m, ldq, k, ld, n, parts, tm, s);
  return launch_minima<2>(qT, r, lo, partial, out, m, ldq, k, ld, n, parts, tm, s);
}

// B7's entry (both instances).
template <typename T>
int moments_entry(const float* qT, const T* r, const float* bound, const float* lo,
                  int32_t* out_a, int32_t* out_p3, float* rem_part, float* rem_out, int m,
                  int ldq, int k, long long ld, int n, int nc, int cell, int cubic, int parts,
                  int tm, void* stream) {
  const long long width = static_cast<long long>(nc) * cell;
  const int chunks = static_cast<int>((width + kTileCols - 1) / kTileCols);
  if (m < 1 || k < 1 || n < 1 || n > width || ld < width || parts < 1 || parts > chunks ||
      (cell != 64 && cell != 128 && cell != 256) || (cubic && out_p3 == nullptr) ||
      ((rem_part == nullptr) != (rem_out == nullptr)) || !valid_queries_t(qT, ldq, m)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int cpp = (chunks + parts - 1) / parts;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rem_part != nullptr) {
    return launch_moments<true>(qT, r, bound, lo, out_a, out_p3, rem_part, rem_out, m, ldq, k,
                                ld, n, nc, cell, cubic != 0, parts, cpp, tm, s);
  }
  return launch_moments<false>(qT, r, bound, lo, out_a, out_p3, rem_part, rem_out, m, ldq, k,
                               ld, n, nc, cell, cubic != 0, parts, cpp, tm, s);
}

}  // namespace

extern "C" {

// B3 launch: qT the queries transposed (as for B1), tm rows per warp and
// parts partitions as tuning.tiled_geometry picks them, depth 1 or 2, lo
// (m,) f32 or null; partial is (m, parts*depth*128) scratch, out (m,
// depth*128).
int tk_minima_candidates(const float* qT, const float* r, const float* lo, float* partial,
                         float* out, int m, int ldq, int k, long long ld, int n, int parts, int tm,
                         int depth, void* stream) {
  return minima_entry(qT, r, lo, partial, out, m, ldq, k, ld, n, parts, tm, depth, stream);
}

// B3's bf16 instance: B3's launch over a bf16 SoA operand.
int tk_minima_candidates_bf16(const float* qT, const void* r, const float* lo, float* partial,
                              float* out, int m, int ldq, int k, long long ld, int n, int parts,
                              int tm, int depth, void* stream) {
  return minima_entry(qT, static_cast<const __nv_bfloat16*>(r), lo, partial, out, m, ldq, k, ld,
                      n, parts, tm, depth, stream);
}

// B7 launch: nc cells of `cell` in {64, 128, 256} columns cover the
// operand (ld >= nc*cell >= n); qT as for B1; parts partitions of whole
// 256-column chunks and tm rows per warp, as tuning.moments_geometry
// picks them; bound (m,) f32, lo (m,) f32 or null; out_a (m, nc) int32,
// out_p3 (m, nc) int32 when cubic; rem_part (m, parts*128) scratch and
// rem_out (m, 128), or both null.
int tk_extract_moments(const float* qT, const float* r, const float* bound, const float* lo,
                       int32_t* out_a, int32_t* out_p3, float* rem_part, float* rem_out, int m,
                       int ldq, int k, long long ld, int n, int nc, int cell, int cubic,
                       int parts, int tm, void* stream) {
  return moments_entry(qT, r, bound, lo, out_a, out_p3, rem_part, rem_out, m, ldq, k, ld, n, nc,
                       cell, cubic, parts, tm, stream);
}

// B7's bf16 instance: B7's launch over a bf16 SoA operand.
int tk_extract_moments_bf16(const float* qT, const void* r, const float* bound, const float* lo,
                            int32_t* out_a, int32_t* out_p3, float* rem_part, float* rem_out,
                            int m, int ldq, int k, long long ld, int n, int nc, int cell,
                            int cubic, int parts, int tm, void* stream) {
  return moments_entry(qT, static_cast<const __nv_bfloat16*>(r), bound, lo, out_a, out_p3,
                       rem_part, rem_out, m, ldq, k, ld, n, nc, cell, cubic, parts, tm, stream);
}

// The B8/B9 compactor: f0 (and f1, or null) (m, nc) int32 -> o_pos, o0
// (and o1) (m, parts*cap) int32; parts divides nc, 1 <= cap <= nc/parts.
int tk_compact_cells(const int32_t* f0, const int32_t* f1, int32_t* o_pos, int32_t* o0,
                     int32_t* o1, int m, int nc, int parts, int cap, void* stream) {
  if (m < 1 || nc < 1 || parts < 1 || nc % parts != 0 || cap < 1 || cap > nc / parts ||
      ((f1 == nullptr) != (o1 == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int pw = nc / parts;
  const bool vec = nc % 4 == 0 && pw % 4 == 0 && reinterpret_cast<uintptr_t>(f0) % 16 == 0;
  const long long tasks = static_cast<long long>(m) * parts;
  auto launch = [&](auto kernel, int warps) {
    const long long per_block = kCompactWarps / warps;
    kernel<<<static_cast<unsigned>((tasks + per_block - 1) / per_block), kCompactThreads, 0,
             static_cast<cudaStream_t>(stream)>>>(f0, f1, o_pos, o0, o1, m, nc, parts, cap, vec);
    return static_cast<int>(cudaGetLastError());
  };
  // W: the fewest warps whose round (512 cells a warp) covers the part, but
  // no more than keeps the launch to one wave of resident blocks, so that
  // where tasks are many a block walks several rounds of each of its tasks
  // instead of the card running waves of one-round blocks.
  int device = 0, sms = 0;
  if (const cudaError_t e = cudaGetDevice(&device)) return static_cast<int>(e);
  if (const cudaError_t e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) {
    return static_cast<int>(e);
  }
  const long long resident = static_cast<long long>(kCompactBlocksPerSm) * sms;
  int w = 1;
  while (w < kCompactWarps && 512 * w < pw && tasks * 2 * w <= resident * kCompactWarps) w *= 2;
  switch (w) {
    case 1: return launch(compact_cells_kernel<1>, 1);
    case 2: return launch(compact_cells_kernel<2>, 2);
    case 4: return launch(compact_cells_kernel<4>, 4);
    default: return launch(compact_cells_kernel<8>, 8);
  }
}

}  // extern "C"
