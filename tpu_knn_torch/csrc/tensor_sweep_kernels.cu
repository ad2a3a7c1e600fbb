// B5 at a score tier — replaces tpu_knn/kernels/topk.py:188 _sweep_kernel
// (with _kstate_insert; built by _build_sweep_candidates) in its score tiers
// other than "highest": per (row, partition), the kk lexicographically
// smallest (score, column) pairs of the partition's columns, sorted, from
// one sweep of the operand (kselect.cuh's list map and contract; empty
// slots (+inf, INT32_MAX)). The scores are B1's and B4's at the tier bit
// for bit (one mainloop), so the sweep and passes engines select the same
// top-K.
//
// Bound on the H100: tensor-core operations, as B1's tiers (T * 2 * m * n *
// k16 at 989 TFLOP/s); at serving batch sizes the operand's bytes. What
// holds it above that is the work beside the mma.sync: a K-selection that
// stops the mainloop at every tile, and a score tile written whole each
// step, would cost more than the scores themselves.
//
// Design: the shared mainloop (tensor_mainloop.cuh) with the contiguous
// layout: a block owns one partition of whole 128-column groups (the list
// map's), a column tile one group. The lists are filtered where the scores
// are made:
// - each row's admission score (that of its list's kk-th entry or bound,
//   kselect_threshold) is published in shared memory and read with each
//   tile's positions; a take keeps a score only if it is at most that (one
//   compare; the column's tie rule is kselect's, at the selection): as one
//   of its row's kRowSlots (score, slot) entries of the tile in shared
//   memory, or, past those and while the list has no bound yet (its first
//   tile, where every score passes), as its slot's bit in the row's 128-bit
//   mask and its score in the block's candidate tile in global memory; and
//   the row's bit in the block's row summary (shared atomics). After the
//   first tile almost nothing passes (about kk ln(columns / kk) entries a
//   list in all, a few hundred at ds11);
// - the selection runs after the barrier that starts the next step
//   (kDeferTileEnd), beside the next tile's mmas, so a tile takes no
//   barrier of its own (but the first, once a block: the second tile's
//   takes then see every list bounded): entries, masks, summaries and
//   candidate tiles alternate by tile parity. Warp w owns rows w, w + W,
//   ... (W warps, so at small m every warp holds live rows), reads their
//   summary bits (one load: nothing more where no row kept a slot), and
//   for each row with a bit offers the kept slots to kselect.cuh's list (a
//   list not full yet bounded first, kselect_bound), empties them and
//   publishes the row's admission score. A take reads one a tile stale at
//   most: looser, so it keeps a superset of what the current one keeps,
//   and the lists do not depend on which entries were offered beyond
//   those. (Dealing the rows with a kept slot out to the warps by rank, and
//   merging a list's queue as soon as it held kk entries, measured slower
//   on the card: PERF.md §6);
// - slots past the block's columns score +inf (kDeadNormInf) and rows past
//   m get a -inf admission score, so neither is ever kept;
// - two block shapes: 128 rows of 16 warps, one an SM (the lists and the
//   filter's state take 87 KB beside the ring), and for m <= kServeRows
//   (the serving shapes, m * K <= 256) 32 rows of 4 warps, two an SM, so
//   the warps of a block all hold live rows.

#include "kselect.cuh"
#include "tensor_mainloop.cuh"

namespace {

constexpr int kServeRows = 32;  // tiers.B5_SERVE_ROWS
constexpr int kRowSlots = 8;    // a row's entries of a tile in shared memory

template <int BM>
struct SweepEpi {
  static constexpr bool kContig = true;
  static constexpr int kRows = BM;
  static constexpr bool kDeferTileEnd = true;
  static constexpr bool kRegState = false;
  static constexpr bool kDeadNormInf = true;
  static constexpr int kBlocksPerSm = BM == kServeRows ? 2 : 1;
  static constexpr int blocks_per_sm(int, int) { return kBlocksPerSm; }
  static constexpr int kWarps = BM / 8;  // each owns 8 rows: w, w + kWarps, ...
  // The K-selection of the block's rows, each row's admission score, its
  // entries of two tiles (kRowSlots (score, slot) pairs a row and tile),
  // their counts, its masks of two tiles (4 words a row and tile), then the
  // row summaries of two tiles (4 words a tile: bit 8 (r % kWarps) + r /
  // kWarps for row r, so a warp's rows are one byte).
  static constexpr size_t kThrOff = sizeof(KSelectState<BM>);
  static constexpr size_t kEntryOff = kThrOff + static_cast<size_t>(BM) * 4;
  static constexpr size_t kCountOff = kEntryOff + static_cast<size_t>(2) * BM * kRowSlots * 8;
  static constexpr size_t kMaskOff = kCountOff + static_cast<size_t>(2) * BM * 4;
  static constexpr size_t kSumOff = kMaskOff + static_cast<size_t>(2) * BM * 16;
  static constexpr size_t kStateBytes = kSumOff + 2 * 16;
  static_assert(BM <= 128 && BM % 32 == 0, "a summary is 4 words, a warp's rows one byte");
  static_assert(kThrOff % 16 == 0, "the admission scores, entries and masks are aligned");
  struct Args {
    int32_t* out_i;
    float* out_s;
    float* cand;  // (blocks, 2, BM, 128) scratch: each block's candidate tiles
    int kk;
  };
  // A position's row's admission score: a take keeps s <= ts.
  struct Pos {
    float ts;
  };
  static __device__ __forceinline__ KSelectState<BM>& lists(unsigned fold) {
    return *shared_ptr<KSelectState<BM>>(fold);
  }
  static __device__ __forceinline__ float* threshold(unsigned fold, int rl) {
    return shared_ptr<float>(fold + kThrOff) + rl;
  }
  static __device__ __forceinline__ int2* entries(unsigned fold, int set, int rl) {
    return shared_ptr<int2>(fold + kEntryOff) + (set * BM + rl) * kRowSlots;
  }
  static __device__ __forceinline__ int* count(unsigned fold, int set, int rl) {
    return shared_ptr<int>(fold + kCountOff) + set * BM + rl;
  }
  static __device__ __forceinline__ uint4* mask(unsigned fold, int set, int rl) {
    return shared_ptr<uint4>(fold + kMaskOff) + set * BM + rl;
  }
  static __device__ __forceinline__ unsigned* summary(unsigned fold, int set) {
    return shared_ptr<unsigned>(fold + kSumOff) + 4 * set;
  }

  // The block's candidate tile of tile parity `set` (row-major, 128 a row).
  static __device__ __forceinline__ float* cand(const Args& e, int set) {
    const long long b = static_cast<long long>(blockIdx.y) * gridDim.x + blockIdx.x;
    return e.cand + (b * 2 + set) * BM * kTCols;
  }
  static __device__ __forceinline__ void init(unsigned fold, const Args&, const TensorParams& p) {
    const int warp = threadIdx.x / 32;
#pragma unroll 1
    for (int i = 0; i < 8; ++i) kselect_init(lists(fold), warp + kWarps * i, pos_inf());
    const int row0 = tensor_block<TensorLayout<true>, kRows>(p.groups, p.groups_per_part).row0;
    for (int x = threadIdx.x; x < BM; x += block_threads<BM>()) {
      *threshold(fold, x) = row0 + x < p.m ? pos_inf() : neg_inf();
#pragma unroll
      for (int set = 0; set < 2; ++set) {
        *count(fold, set, x) = 0;
        *mask(fold, set, x) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    if (threadIdx.x < 8) summary(fold, 0)[threadIdx.x] = 0u;  // both tiles'
  }
  static __device__ __forceinline__ Pos load(unsigned fold, const Args&, int, int, int rl) {
    return {*threshold(fold, rl)};
  }
  static __device__ __forceinline__ void take(unsigned fold, const Args& e, Pos& p, float sc,
                                              int col, int slot, int rl, bool) {
    if (sc <= p.ts) {
      const int set = (col >> 7) & 1;  // the parity of the tile's group
      // An unbounded list's tile: every score passes, to the candidate tile.
      const int i = p.ts == pos_inf() ? kRowSlots : atomicAdd(count(fold, set, rl), 1);
      if (i < kRowSlots) {
        entries(fold, set, rl)[i] = make_int2(__float_as_int(sc), slot);
      } else {
        cand(e, set)[rl * kTCols + slot] = sc;
        atomicOr(reinterpret_cast<unsigned*>(mask(fold, set, rl)) + (slot >> 5),
                 1u << (slot & 31));
      }
      const int bit = 8 * (rl % kWarps) + rl / kWarps;
      atomicOr(summary(fold, set) + (bit >> 5), 1u << (bit & 31));
    }
  }
  static __device__ __forceinline__ void store(unsigned, const Args&, int, int, const Pos&) {}
  static __device__ __forceinline__ int dep(const Pos& p) { return __float_as_int(p.ts); }
  // Tile t's selection (tile_end), after the barrier that follows its last
  // takes (kDeferTileEnd), while the next tile fills the other set: each of
  // warp w's rows with a kept slot (its summary bit) offers its masked
  // slots of the candidate tile (a list without a bound is bounded by them
  // first) and its entries (lane i the i-th; the rest +inf, which no list
  // admits), then empties both and publishes its admission score.
  static __device__ __forceinline__ void select(unsigned fold, const Args& e,
                                                const TensorParams& p, int t) {
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const TensorBlock blk = tensor_block<TensorLayout<true>, kRows>(p.groups, p.groups_per_part);
    const int set = ((blk.first >> 7) + t) & 1;
    unsigned* sum = summary(fold, set) + (warp >> 2);
    const int shift = (warp & 3) * 8;
    const unsigned rows = *sum >> shift & 0xffu;  // warp-uniform
    if (rows == 0u) return;
    __syncwarp();
    if (lane == 0) atomicAnd(sum, ~(0xffu << shift));
    const int c0 = blk.first + t * kTCols;  // the tile's first column
#pragma unroll 1
    for (unsigned bits = rows; bits != 0u; bits &= bits - 1u) {
      const int r = warp + kWarps * (__ffs(bits) - 1);
      float ts;
      int tc;
      kselect_threshold(lists(fold), r, e.kk, ts, tc);
      const uint4 mk = *mask(fold, set, r);
      const unsigned words[kTGroups] = {mk.x, mk.y, mk.z, mk.w};
      unsigned live = 0u;
#pragma unroll
      for (int j = 0; j < kTGroups; ++j) live |= static_cast<unsigned>(words[j] != 0u) << j;
      if (live != 0u) {  // warp-uniform: slots in the candidate tile
        const float* tile = cand(e, set) + r * kTCols;
        float v[kTGroups];
#pragma unroll
        for (int j = 0; j < kTGroups; ++j) {
          v[j] = words[j] >> lane & 1u ? tile[j * kTSliceLanes + lane] : pos_inf();
        }
        __syncwarp();
        if (lane == 0) *mask(fold, set, r) = make_uint4(0u, 0u, 0u, 0u);
        if (ts == pos_inf()) {
          kselect_bound(lists(fold), r, e.kk, v, c0 + lane, kTSliceLanes, ts, tc);
        }
        kselect_offer(lists(fold), r, e.kk, v, c0 + lane, kTSliceLanes, ts, tc, live);
      }
      const int kept = min(*count(fold, set, r), kRowSlots);
      if (kept > 0) {  // warp-uniform
        const int2 en = lane < kept ? entries(fold, set, r)[lane]
                                    : make_int2(__float_as_int(pos_inf()), 0);
        const float v1[1] = {__int_as_float(en.x)};
        if (ts == pos_inf()) kselect_bound(lists(fold), r, e.kk, v1, c0 + en.y, 0, ts, tc);
        kselect_offer(lists(fold), r, e.kk, v1, c0 + en.y, 0, ts, tc);
      }
      __syncwarp();
      if (lane == 0) {
        *count(fold, set, r) = 0;
        *threshold(fold, r) = ts;
      }
    }
  }
  // The first tile's selection bounds every list before the second tile's
  // takes (a barrier, once a block), so only one tile floods the lists.
  static __device__ __forceinline__ void tile_end(unsigned fold, const Args& e,
                                                  const TensorParams& p, int t) {
    select(fold, e, p, t);
    if (t == 0) __syncthreads();
  }
  // Each warp's lists (its rows below m) to slots blockIdx.y * kk .. of
  // their rows.
  static __device__ __forceinline__ void finish(unsigned fold, const Args& e,
                                                const TensorParams& p) {
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const int row0 = tensor_block<TensorLayout<true>, kRows>(p.groups, p.groups_per_part).row0;
    const long long width = static_cast<long long>(gridDim.y) * e.kk;
    KSelectState<BM>& ks = lists(fold);
#pragma unroll 1
    for (int r = warp; r < BM && row0 + r < p.m; r += kWarps) {
      kselect_flush(ks, r, e.kk);
      kselect_write(ks.ls[r][lane], ks.li[r][lane], e.out_i, e.out_s, (row0 + r) * width,
                    blockIdx.y, e.kk);
    }
  }
};

}  // namespace

extern "C" {

// B5 at a tier: qp the query parts as for tk_tensor_candidates; r the f32
// (mode 0) or bf16 (mode 1) SoA operand, rn scratch of n floats; 1 <= kk
// <= 32; the term list as for tk_tensor_candidates (modes 0 and 1); cand
// scratch of ceil(m / rows) * parts * 2 * rows * 128 floats, rows 32 where
// m <= 32 (tiers.sweep_cand_floats), else 128. Outputs (m, parts*kk),
// kselect.cuh's list map.
int tk_tensor_sweep(const void* qp, const void* r, const float* rn, float* cand, int32_t* out_i,
                    float* out_s, int m, int k, long long ld, int n, int parts, int kk, int mode,
                    int nterms, int term_q, int term_r, void* stream) {
  if (!tensor_entry_valid(qp, r, rn, m, k, ld, n, parts, mode) || kk < 1 || kk > kListSlots ||
      cand == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const TensorArgs a = tensor_args(qp, r, nullptr, rn, m, k, ld, n, parts, term_q, term_r, stream);
  return m <= kServeRows
             ? dispatch_tensor<SweepEpi<kServeRows>>(
                   a, SweepEpi<kServeRows>::Args{out_i, out_s, cand, kk}, mode, nterms)
             : dispatch_tensor<SweepEpi<128>>(a, SweepEpi<128>::Args{out_i, out_s, cand, kk},
                                              mode, nterms);
}

}  // extern "C"
