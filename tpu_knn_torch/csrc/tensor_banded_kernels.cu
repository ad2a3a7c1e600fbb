// B4 at a score tier — replaces tpu_knn/kernels/fused.py:506
// _fused_banded_kernel (built by _build_banded_candidates) in its score
// tiers other than "highest" (_score_tile's "packed", "bf16x3", "bf16x4",
// "qsplit2" and "default"): per (row, lane), the lexicographically
// smallest (score, column) strictly above the row's band (bound_s[row],
// bound_i[row]), with B1's lowest-index tie rule. One launch is one pass of
// the top-K passes engine at the tier.
//
// Bound on the H100: tensor-core operations, as B1's tiers (T * 2 * m * n *
// k16 at 989 TFLOP/s); the CUDA cores' instruction rate beside the
// mma.sync and the block's barriers hold it above that
// (tensor_mainloop.cuh, PERF.md).
//
// Design: the shared mainloop (tensor_mainloop.cuh) with B1's lane-slice
// layout and fold slots, in 128-row blocks of 16 warps, one an SM (each
// staged r chunk serves 128 rows); a packed tier's terms are summed in the
// tensor core. The epilogue is B1's (score, index) fold with the band's
// test beside it (tiled B4's exact form: s > bs, or s == bs and col > bi; a
// NaN score or bound admits nothing). Each block stages its 128 rows'
// bounds once; a position's bound rides in its state. The scores are B1's
// and B5's at the tier bit for bit (one mainloop), so the passes and sweep
// engines select the same top-K.

#include "tensor_mainloop.cuh"

namespace {

struct BandedEpi {
  static constexpr bool kContig = false;
  static constexpr int kRows = 128;
  static constexpr bool kDeferTileEnd = false;
  static constexpr bool kRegState = false;
  static constexpr bool kDeadNormInf = false;
  static constexpr int kBlocksPerSm = 1;
  static constexpr int blocks_per_sm(int, int) { return kBlocksPerSm; }
  // The fold slots, then the block's rows' bound scores and columns.
  static constexpr size_t kBoundOff = fold_slot_bytes<kRows>();
  static constexpr size_t kStateBytes = kBoundOff + 2 * kRows * sizeof(float);
  struct Args {
    const float* bound_s;
    const int32_t* bound_i;
    int32_t* out_i;
    float* out_s;
  };
  struct Pos {
    int2 best;
    float bs;
    int bi;
  };
  static __device__ __forceinline__ void init(unsigned fold, const Args& e, const TensorParams& p) {
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      st_slot(fold_slot<kRows>(fold, q, threadIdx.x),
              make_int2(__float_as_int(pos_inf()), kI32Max));
    }
    if (threadIdx.x < kRows) {
      const int row = tensor_block<TensorLayout<false>, kRows>(p.groups, p.groups_per_part).row0 +
                      static_cast<int>(threadIdx.x);
      float* bs = shared_ptr<float>(fold + kBoundOff);
      int* bi = shared_ptr<int>(fold + kBoundOff + kRows * sizeof(float));
      bs[threadIdx.x] = row < p.m ? e.bound_s[row] : pos_inf();
      bi[threadIdx.x] = row < p.m ? e.bound_i[row] : kI32Max;
    }
  }
  static __device__ __forceinline__ Pos load(unsigned fold, const Args&, int q, int tid,
                                             int rl) {
    return {ld_slot(fold_slot<kRows>(fold, q, tid)), shared_ptr<const float>(fold + kBoundOff)[rl],
            shared_ptr<const int>(fold + kBoundOff + kRows * sizeof(float))[rl]};
  }
  static __device__ __forceinline__ void take(unsigned, const Args&, Pos& p, float sc, int col,
                                              int, int, bool live) {
    if (live && sc < __int_as_float(p.best.x) && (sc > p.bs || (sc == p.bs && col > p.bi))) {
      p.best = make_int2(__float_as_int(sc), col);
    }
  }
  static __device__ __forceinline__ void store(unsigned fold, const Args&, int q, int tid,
                                               const Pos& p) {
    st_slot(fold_slot<kRows>(fold, q, tid), p.best);
  }
  static __device__ __forceinline__ int dep(const Pos& p) { return p.best.x; }
  static __device__ __forceinline__ void tile_end(unsigned, const Args&, const TensorParams&,
                                                  int) {}
  static __device__ __forceinline__ void finish(unsigned fold, const Args& e,
                                                const TensorParams& p) {
    write_candidates<kRows>(fold, e.out_i, e.out_s, p.m, p.groups, p.groups_per_part);
  }
};

}  // namespace

extern "C" {

// B4 at a tier: qp the query parts as for tk_tensor_candidates; r the f32
// (mode 0) or bf16 (mode 1) SoA operand, rn scratch of n floats (the norm
// pass's); bound_s (m,) f32 and bound_i (m,) int32; the term list as for
// tk_tensor_candidates (modes 0 and 1). Outputs (m, parts*128) int32 + f32,
// B1's candidate contract over the columns above each row's band.
int tk_tensor_banded(const void* qp, const void* r, const float* rn, const float* bound_s,
                     const int32_t* bound_i, int32_t* out_i, float* out_s, int m, int k,
                     long long ld, int n, int parts, int mode, int nterms, int term_q, int term_r,
                     void* stream) {
  if (!tensor_entry_valid(qp, r, rn, m, k, ld, n, parts, mode) || bound_s == nullptr ||
      bound_i == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return dispatch_tensor<BandedEpi>(
      tensor_args(qp, r, nullptr, rn, m, k, ld, n, parts, term_q, term_r, stream),
      BandedEpi::Args{bound_s, bound_i, out_i, out_s}, mode, nterms);
}

}  // extern "C"
