// The tiled f32 score template that B1 "highest", B4, B1's two ladder
// variants (v3, v6; fused_kernels.cu), B3 and B7 (seeded_kernels.cu) and B5
// (sweep_kernels.cu) share:
// register micro-tiles of scores over an operand staged in shared memory by
// a ring of cp.async copies.
//
// A block is 8 warps (kTiledThreads) and owns 8*TM query rows: warp w owns
// rows w*TM .. w*TM+TM-1, thread c of a warp 8 columns of each column tile,
// the tile's slots (group j, lane c), j < kTileGroups. Each thread scores
// a TM x 8 register micro-tile (micro_tile_chunk in knn_common.cuh): per
// coordinate TM/4 + 8 shared-memory loads for 8*TM FMAs. The k rows of a
// column tile pass through a ring of kTiledStages shared-memory stages in
// chunks of kChunk rows, the block's queries beside them: 16-byte cp.async
// copies (4-byte ones for an operand whose ld or base is not 16-byte
// aligned), the queries from the transposed copy the wrappers make
// (tpu_knn_torch.kernels.fused.transposed_queries), so they too arrive in
// 16-byte pieces. The copy of step s + 2 is in flight while step s is
// scored; any k fits, the accumulators staying in registers across chunks.
// The 8*TM rows share each staged slice, and |r|^2 is computed once per
// column (thread t keeps slot t's) and handed over through shared memory.
// After a tile's last chunk, each kernel's epilogue turns the accumulators
// into scores s = |r|^2 - 2 acc (knn_common.cuh's score arithmetic) and
// folds them: B1/B4 into per-lane (score, index) pairs, B3 into per-lane
// minima, B7 into per-cell moments, B5 into per-row K-lists (kselect.cuh).
// A warp whose rows all lie past m skips the arithmetic and the epilogue.
//
// Four policies change only where the operands come from (TiledRing):
// - AOS (v3): the operand is the caller's row-major (n, k) array. Warp j
//   stages group j's 32 slots, two columns per copy instruction: half-warp
//   h takes slot 2i + h, its lane the chunk's d, so each instruction reads
//   two runs of 16 consecutive floats (4-byte copies: any k, any base) and
//   lands them transposed as [d][slot]. The stage's rows are kTileCols + 2
//   floats apart, which makes those 32 writes fall in 32 banks.
// - QRES (v6): the block's query rows stay in shared memory for the whole
//   sweep, copied once before it (after the ring, [d][row], rows past k
//   zero to a whole chunk, resident_ld(m) floats apart), so the ring
//   carries only the operand.
// - TMA (B10, v5): the SoA stages and the block's queries arrive by the
//   Tensor Memory Accelerator in the SoA layout, [d][group][lane] and
//   [d][row]: thread 0 arms the stage's mbarrier with the two boxes' bytes
//   and issues one cp.async.bulk.tensor per operand; every thread waits on
//   the stage's phase parity where the cp.async policies wait on their
//   groups (TmaRing, stage_tma, encode_tma_maps).
// - BF16 (the bf16 instances of B1, B4, B3, B7 and B5): the SoA operand is
//   a bf16 store's, (k_pad, ld) bf16. The ring stages it as stored, half
//   the bytes of an f32 stage: 16-byte cp.async copies of 8 columns where
//   ld % 8 == 0 and the base is 16-byte aligned, else each slot's values
//   loaded and stored one by one. micro_tile_chunk and column_norm_chunk
//   upcast each value at the shared-memory read (staged_f32, exact), so an
//   instance's scores, and every epilogue after them, are the f32
//   instance's bit for bit over the upcast operand.
//
// Where a slot's column lies is the kernel's choice (TileColumns): B1, B4
// and B3 give a block a quarter of one partition's 128 lanes and a tile 8 of
// the partition's 128-column groups (slot (j, c) = column col0 + 128 j + c,
// so a lane's columns all fall to one thread); B7 and B5 give a tile one
// contiguous 256-column chunk (slot (j, c) = column col0 + 32 j + c, so a
// cell of 64, 128 or 256 columns is 2, 4 or 8 of one warp's j, and a row's
// 256 scores of the tile all lie in one warp).

#pragma once

#include <cuda.h>

#include <type_traits>

#include "knn_common.cuh"

namespace {

constexpr int kTiledThreads = 256;
constexpr int kTiledWarps = kTiledThreads / 32;
constexpr int kSliceLanes = 32;
constexpr int kSlices = kLanes / kSliceLanes;
constexpr int kTileGroups = 8;
constexpr int kTileCols = kTileGroups * kSliceLanes;  // staged columns per tile
constexpr int kChunk = 16;       // d-rows per ring stage
constexpr int kTiledStages = 3;  // ring depth: two chunks in flight behind the one scored
constexpr int kTiledBlocksPerSm = 2;  // __launch_bounds__; tuning.TILED_BLOCKS_PER_SM
// cp.async.bulk.tensor writes to 128-byte aligned shared memory: a TMA
// kernel takes this many more bytes of dynamic shared memory and starts
// its ring at the first aligned one (tma_ring).
constexpr int kTmaAlign = 128;
static_assert(kTileCols == kTiledThreads, "one thread per column slot keeps |r|^2");

// One ring stage of a tiled kernel with TM rows per warp: a kChunk-row
// chunk of the column tile, kRLd values of the operand's type T a row
// (kTileCols, or kTileCols + 2 for the AoS copies' banks), kROps floats in
// all, and unless the queries are resident (QRES) the block's 8*TM f32
// queries after it.
template <int TM, bool AOS = false, bool QRES = false, typename T = float>
struct TiledRing {
  static constexpr int kRLd = AOS ? kTileCols + 2 : kTileCols;
  static constexpr int kROps = static_cast<int>(kChunk * kRLd * sizeof(T) / sizeof(float));
  static constexpr int kStage = kROps + (QRES ? 0 : kChunk * kTiledWarps * TM);
  // The ring's bytes (dynamic shared memory, the same at every k; QRES
  // kernels add resident_bytes). kTiledBlocksPerSm blocks of it and its
  // kernel's static state must fit one SM's kSmemPerSm, less
  // kSmemPerBlockReserved per block; launch_tiled_grid checks that when it
  // is compiled.
  static constexpr size_t kBytes = static_cast<size_t>(kTiledStages) * kStage * sizeof(float);
};
static_assert(TiledRing<1, true>::kStage % 4 == 0 &&
                  TiledRing<1, false, false, __nv_bfloat16>::kROps % 4 == 0,
              "the stage's queries stay 16-byte aligned");
static_assert(2 * kChunk == kSliceLanes && kTiledWarps == kTileGroups,
              "the AoS copies: a half-warp per column, a warp per group");

// The row stride of a QRES block's resident queries: its rows (at most
// 8*TM), rounded to whole float4s where TM >= 4 reads them so.
template <int TM>
__host__ __device__ constexpr int resident_ld(int m) {
  const int rows = m < kTiledWarps * TM ? m : kTiledWarps * TM;
  return TM == 1 ? rows : (rows + 3) / 4 * 4;
}

// Their bytes: the k rows, zero to a whole chunk.
template <int TM>
constexpr size_t resident_bytes(int m, int k) {
  return static_cast<size_t>((k + kChunk - 1) / kChunk * kChunk) * resident_ld<TM>(m) *
         sizeof(float);
}

// The columns of a block's column tiles: tile t's slot (j, c) holds column
// first + t * tile_step + j * group_step + c, live while j < groups - t * 8
// and the column is below n.
struct TileColumns {
  long long first;
  long long tile_step;
  int group_step;
  int groups;
};

// B1's, B4's and B3's slice: lane quarter `quarter` of partition `part`,
// groups_per_part 128-column groups from part * groups_per_part.
__device__ __forceinline__ TileColumns lane_slice_columns(int n, int groups_per_part, int part,
                                                          int quarter) {
  const long long g0 = static_cast<long long>(part) * groups_per_part;
  const long long groups = (static_cast<long long>(n) + kLanes - 1) / kLanes;
  return {g0 * kLanes + quarter * kSliceLanes, static_cast<long long>(kTileGroups) * kLanes,
          kLanes, static_cast<int>(max(0LL, min(static_cast<long long>(groups_per_part),
                                                groups - g0)))};
}

// B5's partition: groups_per_part 128-column groups from part *
// groups_per_part, all of their columns, as contiguous 256-column tiles
// (slot (j, c) = column first + 256 t + 32 j + c; groups counts 32-column
// units, so a partition of an odd number of groups ends half-way through
// its last tile).
__device__ __forceinline__ TileColumns partition_columns(int n, int groups_per_part, int part) {
  const long long g0 = static_cast<long long>(part) * groups_per_part;
  const long long groups = (static_cast<long long>(n) + kLanes - 1) / kLanes;
  const long long own = max(0LL, min(static_cast<long long>(groups_per_part), groups - g0));
  return {g0 * kLanes, kTileCols, kSliceLanes, static_cast<int>(own * (kLanes / kSliceLanes))};
}

// Issue the copies of one step (a d-chunk of one column tile) into `st`:
// the operand as [d][group][lane] (SoA: 16-byte copies of 4 f32 or 8 bf16
// lanes where `vec16`, else 4-byte ones for f32 and plain loads and stores
// for bf16; AoS: see the top of this file), then, unless the queries are
// resident, the block's queries as [d][row] from the transposed queries qT
// (k, ldq) in 16-byte copies. Slots past k, n, the live groups or the rows
// are zero-filled without a read.
template <int TM, bool AOS, bool QRES, typename T>
__device__ __forceinline__ void stage_tiled(float* st, const float* __restrict__ qT, int ldq,
                                            const T* __restrict__ r, int k, long long ld,
                                            int n, bool vec16, long long col0, int group_step,
                                            int live_groups, int d0, int row0) {
  using Ring = TiledRing<TM, AOS, QRES, T>;
  constexpr int kRLd = Ring::kRLd;
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));  // lanes a 16-byte copy
  static_assert(!AOS || std::is_same_v<T, float>, "the AoS policy stages f32 points");
  if constexpr (AOS) {
    const int j = threadIdx.x / kSliceLanes;
    const int d = threadIdx.x % kChunk;
    const int h = threadIdx.x % kSliceLanes / kChunk;
    const long long col = col0 + static_cast<long long>(j) * group_step + h;
    const bool row_live = j < live_groups && d0 + d < k;
    const float* src = r + col * k + d0 + d;
    float* dst = st + d * kRLd + j * kSliceLanes + h;
#pragma unroll 4
    for (int i = 0; i < kSliceLanes; i += 2) {
      const bool live = row_live && col + i < n;
      cp_async4(dst + i, live ? src + static_cast<long long>(i) * k : r, live ? 4 : 0);
    }
  } else if (vec16) {
    constexpr int kQuads = kTileCols / kVec;
    T* sr = reinterpret_cast<T*>(st);
    for (int e = threadIdx.x; e < kChunk * kQuads; e += kTiledThreads) {
      const int d = e / kQuads;
      const int j = (e - d * kQuads) / (kSliceLanes / kVec);
      const int c = (e - d * kQuads - j * (kSliceLanes / kVec)) * kVec;
      const long long col = col0 + static_cast<long long>(j) * group_step + c;
      const bool live = d0 + d < k && j < live_groups && col < n;
      cp_async16(sr + e * kVec, live ? r + static_cast<long long>(d0 + d) * ld + col : r,
                 live ? 16 : 0);
    }
  } else if constexpr (!std::is_same_v<T, float>) {
    // Thread t stages slot t, every d, with plain loads: a bf16 row whose
    // 8-column runs are not 16-byte aligned (no 2-byte cp.async exists).
    T* sr = reinterpret_cast<T*>(st);
    const int j = threadIdx.x / kSliceLanes;
    const long long col =
        col0 + static_cast<long long>(j) * group_step + threadIdx.x % kSliceLanes;
    const bool col_live = j < live_groups && col < n;
#pragma unroll 4
    for (int d = 0; d < kChunk; ++d) {
      const bool live = col_live && d0 + d < k;
      sr[d * kRLd + threadIdx.x] =
          live ? r[static_cast<long long>(d0 + d) * ld + col] : __ushort_as_bfloat16(0);
    }
  } else {
    // Thread t stages slot t: lane t % 32 of group t / 32, every d.
    const int j = threadIdx.x / kSliceLanes;
    const long long col =
        col0 + static_cast<long long>(j) * group_step + threadIdx.x % kSliceLanes;
    const bool col_live = j < live_groups && col < n;
#pragma unroll 4
    for (int d = 0; d < kChunk; ++d) {
      const bool live = col_live && d0 + d < k;
      cp_async4(st + d * kRLd + threadIdx.x,
                live ? r + static_cast<long long>(d0 + d) * ld + col : r, live ? 4 : 0);
    }
  }
  if constexpr (!QRES) {
    constexpr int BM = kTiledWarps * TM;
    float* qs = st + Ring::kROps;
    constexpr int kRowQuads = BM / 4;
    for (int e = threadIdx.x; e < kChunk * kRowQuads; e += kTiledThreads) {
      const int d = e / kRowQuads;
      const int c = (e - d * kRowQuads) * 4;
      const bool live = d0 + d < k && row0 + c < ldq;
      cp_async16(qs + d * BM + c,
                 live ? qT + static_cast<long long>(d0 + d) * ldq + row0 + c : qT,
                 live ? 16 : 0);
    }
  }
}

// Issue the copies of a QRES block's resident queries: rows row0 ..
// row0 + ldr - 1 of qT (k, ldq) as [d][row], ldr = resident_ld<TM>(m),
// over whole chunks of d; rows past ldq or k are zero-filled without a
// read. 16-byte copies where TM >= 4 (ldr and row0 are multiples of 4),
// else 4-byte ones.
template <int TM>
__device__ __forceinline__ void stage_resident(float* qres, int ldr,
                                               const float* __restrict__ qT, int ldq, int k,
                                               int row0) {
  constexpr int kW = TM == 1 ? 1 : 4;
  const int per_d = ldr / kW;
  const int rows = (k + kChunk - 1) / kChunk * kChunk;
  for (int e = threadIdx.x; e < rows * per_d; e += kTiledThreads) {
    const int d = e / per_d;
    const int c = (e - d * per_d) * kW;
    const bool live = d < k && row0 + c < ldq;
    const float* src = live ? qT + static_cast<long long>(d) * ldq + row0 + c : qT;
    if constexpr (kW == 4) {
      cp_async16(qres + d * ldr + c, src, live ? 16 : 0);
    } else {
      cp_async4(qres + d * ldr + c, src, live ? 4 : 0);
    }
  }
}

// ---- the TMA policy --------------------------------------------------------

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbarrier_init(uint64_t* bar, unsigned arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(arrivals)
               : "memory");
}

// Make the barriers' initialisation visible to the async proxy (the TMA
// unit's completions) and, after a __syncthreads, to every thread.
__device__ __forceinline__ void fence_mbarrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Order this thread's (and, after a barrier, the block's) earlier
// generic-proxy accesses of shared memory before its later async-proxy
// ones: a stage's last reads before the TMA refills it.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbarrier_arrive_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of `bar` with parity `parity` has completed. A
// phase that never completes (a copy the TMA unit refused) traps after
// about a second of polling, so the launch fails instead of hanging.
__device__ __forceinline__ void mbarrier_wait_parity(uint64_t* bar, unsigned parity) {
  const unsigned b = smem_u32(bar);
  for (unsigned polls = 0;; ++polls) {
    unsigned done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(b), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == (1u << 24)) __trap();
  }
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// The TMA policy's ring in the kernel's dynamic shared memory `smem`
// (kTmaAlign bytes more than the ring's): its first 128-byte aligned byte.
__device__ __forceinline__ float* tma_ring(void* smem) {
  const uintptr_t p = reinterpret_cast<uintptr_t>(smem);
  return reinterpret_cast<float*>((p + kTmaAlign - 1) & ~static_cast<uintptr_t>(kTmaAlign - 1));
}

// The TMA policy's operands: the tensor maps of the SoA operand and of the
// transposed queries (kernel parameters, __grid_constant__), and the
// ring's barriers, one a stage (the kernel's static shared memory).
struct TmaRing {
  const CUtensorMap* r;
  const CUtensorMap* q;
  uint64_t* full;
};

// Issue (one thread) the copies of one step into stage `st`, whose barrier
// is `bar`: the operand's box (32 lanes, 8 groups, kChunk rows) at the
// tile's first slot col0 (lane col0 % 128 of group col0 / 128: the slot
// layout of lane_slice_columns, groups 128 columns apart) lands as
// [d][group][lane], the queries' box (8*TM rows, kChunk rows of d) as
// [d][row], both the SoA stage of TiledRing<TM>. Groups past the map's
// ld / 128 and rows past k or ldq come back zero; groups past the slice
// or n are masked by the epilogue's liveness, as in the cp.async policy.
// The barrier expects both boxes' bytes in full: the zero fill counts.
template <int TM>
__device__ __forceinline__ void stage_tma(float* st, const TmaRing& tma, uint64_t* bar,
                                          long long col0, int d0, int row0) {
  constexpr unsigned kBytes = (kChunk * kTileCols + kChunk * kTiledWarps * TM) * sizeof(float);
  fence_proxy_async();
  mbarrier_arrive_expect_tx(bar, kBytes);
  tma_load_3d(st, tma.r, bar, static_cast<int>(col0 % kLanes), static_cast<int>(col0 / kLanes),
              d0);
  tma_load_2d(st + kChunk * kTileCols, tma.q, bar, row0, d0);
}

// |r|^2 and liveness of the thread's 8 slots of a tile: slot j is column
// col0 + j * step (col0 the thread's own first column), its norm
// norms[j * kSliceLanes] (norms at the thread's lane).
__device__ __forceinline__ void tile_slots(const float* norms, long long col0, int step,
                                           int live_groups, int n, float (&nj)[kTileGroups],
                                           bool (&live)[kTileGroups]) {
#pragma unroll
  for (int j = 0; j < kTileGroups; ++j) {
    nj[j] = norms[j * kSliceLanes];
    live[j] = j < live_groups && col0 + static_cast<long long>(j) * step < n;
  }
}

// One block's sweep over its column tiles (tc) for the rows row0 ..: each
// step stages a d-chunk of a tile (the ring) and adds it into the
// thread's TM x 8 accumulators; after a tile's last chunk, with |r|^2 of
// the tile's slots in norm_s, epi(acc, col0, live_groups) runs in every
// warp that owns a row below m (col0: the tile's slot (0, 0); live_groups:
// its groups still inside the slice; acc is the epilogue's to overwrite).
// The caller's state writes before the call are visible to every thread
// in the epilogue. With QRES the resident queries follow the ring in
// `ring`'s shared memory and are copied with the first step. With TMA the
// stages come from tma's maps (qT, r, ld and vec16 are not read), `ring`
// is tma_ring's and the slots are lane_slice_columns'. T is the SoA
// operand's type (float, or __nv_bfloat16 under the BF16 policy).
template <int TM, bool AOS = false, bool QRES = false, bool TMA = false, typename T = float,
          typename Epilogue>
__device__ __forceinline__ void tiled_sweep(const float* __restrict__ qT, int ldq,
                                            const T* __restrict__ r, int m, int k,
                                            long long ld, int n, bool vec16,
                                            const TileColumns& tc, int row0, float* ring,
                                            float* norm_s, Epilogue&& epi,
                                            const TmaRing& tma = TmaRing{}) {
  static_assert(!TMA || (!AOS && !QRES && std::is_same_v<T, float>),
                "the TMA policy stages the f32 SoA operand and queries");
  using Ring = TiledRing<TM, AOS, QRES, T>;
  constexpr int kStage = Ring::kStage;
  constexpr int kRLd = Ring::kRLd;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int tiles = (tc.groups + kTileGroups - 1) / kTileGroups;
  const int chunks = (k + kChunk - 1) / kChunk;
  const int steps = tiles * chunks;
  const bool warp_live = row0 + warp * TM < m;  // warp-uniform
  float* qres = ring + kTiledStages * kStage;
  const int ldr = QRES ? resident_ld<TM>(m) : 0;
  if constexpr (QRES) stage_resident<TM>(qres, ldr, qT, ldq, k, row0);
  if constexpr (TMA) {
    if (threadIdx.x == 0) {
#pragma unroll
      for (int s = 0; s < kTiledStages; ++s) mbarrier_init(tma.full + s, 1);
      fence_mbarrier_init();
    }
    __syncthreads();
  }

  int it = 0, ic = 0;  // the next step to issue, as (tile, chunk)
  auto issue = [&](int s) {
    float* st = ring + (s % kTiledStages) * kStage;
    const long long col0 = tc.first + it * tc.tile_step;
    if constexpr (TMA) {
      if (threadIdx.x == 0) {
        stage_tma<TM>(st, tma, tma.full + s % kTiledStages, col0, ic * kChunk, row0);
      }
    } else {
      stage_tiled<TM, AOS, QRES, T>(st, qT, ldq, r, k, ld, n, vec16, col0, tc.group_step,
                                 tc.groups - it * kTileGroups, ic * kChunk, row0);
    }
    if (++ic == chunks) {
      ic = 0;
      ++it;
    }
  };
#pragma unroll
  for (int s = 0; s < kTiledStages - 1; ++s) {
    if (s < steps) issue(s);
    if constexpr (!TMA) cp_async_commit();
  }

  float acc[TM][kTileGroups];
  float norm = 0.f;  // |r|^2 of slot threadIdx.x's column
  int t = 0, c = 0;  // the step being scored, as (tile, chunk)
  for (int s = 0; s < steps; ++s) {
    if constexpr (TMA) {
      // Step s has landed: the (s / kTiledStages)-th phase of its stage.
      mbarrier_wait_parity(tma.full + s % kTiledStages, (s / kTiledStages) & 1);
    } else {
      cp_async_wait<kTiledStages - 2>();  // step s has landed (this thread's copies)
    }
    __syncthreads();  // ... every thread's, and step s - 1 is done with its stage
    if (s + kTiledStages - 1 < steps) issue(s + kTiledStages - 1);
    if constexpr (!TMA) cp_async_commit();
    if (c == 0) {
#pragma unroll
      for (int i = 0; i < TM; ++i) {
#pragma unroll
        for (int j = 0; j < kTileGroups; ++j) acc[i][j] = 0.f;
      }
      norm = 0.f;
    }
    const float* st = ring + (s % kTiledStages) * kStage;
    const T* sr = reinterpret_cast<const T*>(st);
    norm = column_norm_chunk<kChunk>(sr + threadIdx.x, kRLd, norm);
    if (warp_live) {
      if constexpr (QRES) {
        micro_tile_chunk<TM, kTileGroups, kChunk>(qres + c * kChunk * ldr + warp * TM, ldr,
                                                  sr + lane, kRLd, kSliceLanes, acc);
      } else {
        micro_tile_chunk<TM, kTileGroups, kChunk>(st + Ring::kROps + warp * TM,
                                                  kTiledWarps * TM, sr + lane, kRLd,
                                                  kSliceLanes, acc);
      }
    }
    if (c == chunks - 1) {
      norm_s[threadIdx.x] = norm;
      __syncthreads();
      if (warp_live) epi(acc, tc.first + t * tc.tile_step, tc.groups - t * kTileGroups);
    }
    if (++c == chunks) {
      c = 0;
      ++t;
    }
  }
  if constexpr (!TMA) cp_async_wait<0>();
}

// The transposed queries (fused.transposed_queries) a tiled kernel stages:
// (k, ldq), ldq >= m a multiple of 4, rows m..ldq-1 zero, 16-byte aligned.
inline bool valid_queries_t(const float* qT, int ldq, int m) {
  return ldq >= m && ldq % 4 == 0 && reinterpret_cast<uintptr_t>(qT) % 16 == 0;
}

// Whether the SoA operand's rows stage in 16-byte copies (4 f32 or 8 bf16
// lanes): ld a multiple of that many values and a 16-byte aligned base.
template <typename T>
inline bool vec16_operand(const T* r, long long ld) {
  return ld % (16 / static_cast<long long>(sizeof(T))) == 0 &&
         reinterpret_cast<uintptr_t>(r) % 16 == 0;
}

// cuTensorMapEncodeTiled, from the driver through the runtime (the library
// does not link libcuda); null where the driver does not have it.
using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled_fn() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found{};
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &found);
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

// The TMA policy's tensor maps for a launch of TM rows per warp: the SoA
// operand r (k rows of ld floats; the caller checks ld % 128 == 0 and a
// 16-byte aligned r) as (128 lanes, ld / 128 groups, k rows) in boxes of
// (32, 8, kChunk), and the transposed queries qT (k, ldq; valid_queries_t)
// as (ldq, k) in boxes of (8*TM, kChunk). Past the dims (rows past k or
// ldq, groups past ld / 128) a box reads zeros and nothing outside the
// arrays. Returns a cudaError_t: cudaErrorInvalidValue where an encode
// fails.
template <int TM>
int encode_tma_maps(CUtensorMap* r_map, CUtensorMap* q_map, const float* r, int k, long long ld,
                    const float* qT, int ldq) {
  const EncodeTiledFn encode = encode_tiled_fn();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  constexpr cuuint32_t kOnes[3] = {1, 1, 1};
  const cuuint64_t r_dims[3] = {kLanes, static_cast<cuuint64_t>(ld / kLanes),
                                static_cast<cuuint64_t>(k)};
  const cuuint64_t r_strides[2] = {kLanes * sizeof(float), static_cast<cuuint64_t>(ld) * 4};
  const cuuint32_t r_box[3] = {kSliceLanes, kTileGroups, kChunk};
  const cuuint64_t q_dims[2] = {static_cast<cuuint64_t>(ldq), static_cast<cuuint64_t>(k)};
  const cuuint64_t q_strides[1] = {static_cast<cuuint64_t>(ldq) * 4};
  const cuuint32_t q_box[2] = {kTiledWarps * TM, kChunk};
  const CUresult er = encode(r_map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(r),
                             r_dims, r_strides, r_box, kOnes, CU_TENSOR_MAP_INTERLEAVE_NONE,
                             CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  const CUresult eq = encode(q_map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(qT),
                             q_dims, q_strides, q_box, kOnes, CU_TENSOR_MAP_INTERLEAVE_NONE,
                             CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return er == CUDA_SUCCESS && eq == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// Launch a tiled kernel whose static shared memory is `State` over
// ceil(m / (8*TM)) row tiles (grid.y, in slices of kMaxGridY; the kernel's
// last argument is the slice's first row) and grid_x blocks per row tile,
// with its ring (over an operand of type T) and `extra` more bytes (a QRES
// kernel's queries, a TMA kernel's kTmaAlign) of dynamic shared memory.
template <int TM, typename State, bool AOS = false, bool QRES = false, typename T = float,
          typename... Params, typename... Args>
int launch_tiled_grid(void (*kernel)(Params...), int grid_x, int m, size_t extra,
                      cudaStream_t stream, Args... args) {
  constexpr int BM = kTiledWarps * TM;
  constexpr size_t ring = TiledRing<TM, AOS, QRES, T>::kBytes;
  static_assert(kTiledBlocksPerSm * (ring + sizeof(State) + kSmemPerBlockReserved) <= kSmemPerSm,
                "a tiled kernel's blocks per SM do not fit its shared memory");
  const size_t smem = ring + extra;
  if (smem + sizeof(State) > kSmemPerBlock) return static_cast<int>(cudaErrorInvalidValue);
  if (const int e = allow_smem(kernel, smem, sizeof(State))) return e;
  const int tiles = (m + BM - 1) / BM;
  for (int t0 = 0; t0 < tiles; t0 += kMaxGridY) {
    const int ty = tiles - t0 < kMaxGridY ? tiles - t0 : kMaxGridY;
    kernel<<<dim3(grid_x, ty), kTiledThreads, smem, stream>>>(args..., t0 * BM);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

// Call f(std::integral_constant<int, TM>) for the rows per warp the tiled
// kernels are built for (tuning.TILED_ROWS: 1, 4, 8).
template <typename F>
int with_tiled_rows(int tm, F&& f) {
  switch (tm) {
    case 8: return f(std::integral_constant<int, 8>{});
    case 4: return f(std::integral_constant<int, 4>{});
    case 1: return f(std::integral_constant<int, 1>{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
