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
// k16 at 989 TFLOP/s); at serving batch sizes the operand's bytes.
//
// Design: the shared mainloop (tensor_mainloop.cuh) with the contiguous
// layout: a block owns one partition of whole 128-column groups (the list
// map's), a column tile one group. Each tile's 64 x 128 scores go to a
// score tile in shared memory (a dead slot as NaN, which no compare
// admits); after a barrier, warp w keeps the lists of rows 8 w .. 8 w + 7
// (kselect.cuh's K-selection, one warp per list, the row's 128 scores four
// a lane): one vote skips a row in which nothing passes its threshold, a
// list not full yet is bounded first (kselect_bound), and the rest is
// offered with a ballot (kselect_offer). The lists and the score tile take
// 67 KB, so the kernel runs one block an SM.

#include "kselect.cuh"
#include "tensor_mainloop.cuh"

namespace {

struct SweepEpi {
  static constexpr bool kContig = true;
  static constexpr int kRows = kTBM;
  static constexpr bool kDeferTileEnd = false;
  static constexpr int kBlocksPerSm = 1;
  static constexpr int blocks_per_sm(int, int) { return kBlocksPerSm; }
  // The K-selection of the block's 64 rows, then the score tile [row][slot]
  // (rows kScoreLd floats apart: a warp's stores of one position hit 2
  // banks each, its row reads none twice).
  static constexpr int kScoreLd = kTCols + 8;
  static constexpr size_t kTileOff = sizeof(KSelectState<kTBM>);
  static constexpr size_t kStateBytes = kTileOff + static_cast<size_t>(kTBM) * kScoreLd * 4;
  struct Args {
    int32_t* out_i;
    float* out_s;
    int kk;
  };
  struct Pos {
    int rl;  // the position's row in the block
  };
  static __device__ __forceinline__ KSelectState<kTBM>& lists(unsigned fold) {
    return *shared_ptr<KSelectState<kTBM>>(fold);
  }
  static __device__ __forceinline__ void init(unsigned fold, const Args&, const TensorParams&) {
    const int warp = threadIdx.x / 32;
#pragma unroll 1
    for (int r = 0; r < kTBM / 8; ++r) kselect_init(lists(fold), warp * 8 + r, pos_inf());
  }
  static __device__ __forceinline__ Pos load(unsigned, const Args&, int, int, int rl) {
    return {rl};
  }
  static __device__ __forceinline__ void take(unsigned fold, const Args&, Pos& p, float sc, int,
                                              int slot, int, bool live) {
    shared_ptr<float>(fold + kTileOff)[p.rl * kScoreLd + slot] =
        live ? sc : __int_as_float(0x7fc00000);
  }
  static __device__ __forceinline__ void store(unsigned, const Args&, int, int, const Pos&) {}
  static __device__ __forceinline__ int dep(const Pos& p) { return p.rl; }
  static __device__ __forceinline__ void tile_end(unsigned fold, const Args& e,
                                                  const TensorParams& p, int t) {
    __syncthreads();  // the tile's scores are written
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const TensorBlock blk = tensor_block<TensorLayout<true>, kRows>(p.groups, p.groups_per_part);
    const int c0 = blk.first + t * kTCols + lane;  // column of slot (0, lane)
    const float* tile = shared_ptr<const float>(fold + kTileOff);
#pragma unroll 1
    for (int r = warp * 8; r < warp * 8 + 8 && blk.row0 + r < p.m; ++r) {  // warp-uniform
      float v[kTGroups];
#pragma unroll
      for (int j = 0; j < kTGroups; ++j) v[j] = tile[r * kScoreLd + j * kTSliceLanes + lane];
      float ts;
      int tc;
      kselect_threshold(lists(fold), r, e.kk, ts, tc);
      unsigned pass = 0u;
#pragma unroll
      for (int j = 0; j < kTGroups; ++j) {
        pass |= static_cast<unsigned>(kselect_passes(v[j], c0 + j * kTSliceLanes, ts, tc)) << j;
      }
      const unsigned live = __reduce_or_sync(kFullMask, pass);
      if (live != 0u) {  // warp-uniform
        if (ts == pos_inf()) kselect_bound(lists(fold), r, e.kk, v, c0, kTSliceLanes, ts, tc);
        kselect_offer(lists(fold), r, e.kk, v, c0, kTSliceLanes, ts, tc, live);
      }
    }
  }
  // Each warp's lists (its rows below m) to slots blockIdx.y * kk .. of
  // their rows.
  static __device__ __forceinline__ void finish(unsigned fold, const Args& e,
                                                const TensorParams& p) {
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const int row0 = tensor_block<TensorLayout<true>, kRows>(p.groups, p.groups_per_part).row0;
    const long long width = static_cast<long long>(gridDim.y) * e.kk;
    KSelectState<kTBM>& ks = lists(fold);
#pragma unroll 1
    for (int r = warp * 8; r < warp * 8 + 8 && row0 + r < p.m; ++r) {
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
// <= 32; the term list as for tk_tensor_candidates (modes 0 and 1).
// Outputs (m, parts*kk), kselect.cuh's list map.
int tk_tensor_sweep(const void* qp, const void* r, const float* rn, int32_t* out_i, float* out_s,
                    int m, int k, long long ld, int n, int parts, int kk, int mode, int nterms,
                    int term_q, int term_r, void* stream) {
  if (!tensor_entry_valid(qp, r, rn, m, k, ld, n, parts, mode) || kk < 1 || kk > kListSlots) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return dispatch_tensor<SweepEpi>(
      tensor_args(qp, r, nullptr, rn, m, k, ld, n, parts, term_q, term_r, stream),
      SweepEpi::Args{out_i, out_s, kk}, mode, nterms);
}

}  // extern "C"
