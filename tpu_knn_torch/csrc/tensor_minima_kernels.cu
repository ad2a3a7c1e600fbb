// B3 at a score tier — replaces tpu_knn/kernels/fused.py:613
// _fused_minima_kernel (built by _build_minima_candidates) in its score
// tiers other than "highest": the seeded engine's bound pass. Per row and
// lane, the smallest score (depth 1) or the two smallest of the multiset
// (depth 2), at depth 1 optionally only scores above the row's lo (NaN
// never enters: every compare is strict). The caller passes the prefix it
// wants read as n. Each block writes its slice of its partition's 128 lanes
// to a partial array; minima_merge_kernel folds the partitions into the
// contract's (m, depth*128) = [min1 lanes | min2 lanes].
//
// Bound on the H100: tensor-core operations, as B1's tiers (T * 2 * m * n *
// k16 at 989 TFLOP/s).
//
// Design: the shared mainloop (tensor_mainloop.cuh) with B1's lane-slice
// layout, in 128-row blocks of 16 warps, one an SM; the fold slots hold
// (min1, min2) in place of B1's (score, index), folded as the tiled B3 folds
// them, the depth a uniform branch of one instance. The scores are B7's at
// the tier bit for bit (one mainloop), so the seeded engine's bound and its
// qualifiers come from one arithmetic.

#include "tensor_mainloop.cuh"

namespace {

struct MinimaEpi {
  static constexpr bool kContig = false;
  static constexpr int kRows = 128;
  static constexpr bool kDeferTileEnd = false;
  static constexpr int kBlocksPerSm = 1;
  static constexpr int blocks_per_sm(int, int) { return kBlocksPerSm; }
  // The fold slots (min1, min2), then the block's rows' lo.
  static constexpr size_t kLoOff = fold_slot_bytes<kRows>();
  static constexpr size_t kStateBytes = kLoOff + kRows * sizeof(float);
  struct Args {
    const float* lo;  // null at depth 2 (tpu_knn's banded pass is depth 1 only)
    float* partial;
    int depth;
  };
  // A position's minimum and, at depth 2, its second smallest; at depth 1
  // its row's lo in the second word: two registers a position, as B1's
  // pairs, which keeps the packed3 instances within 128 registers.
  struct Pos {
    float m1, x;
  };
  static __device__ __forceinline__ void init(unsigned fold, const Args& e, const TensorParams& p) {
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      st_slot(fold_slot<kRows>(fold, q, threadIdx.x),
              make_int2(__float_as_int(pos_inf()), __float_as_int(pos_inf())));
    }
    if (threadIdx.x < kRows) {
      const int row = tensor_block<TensorLayout<false>, kRows>(p.groups, p.groups_per_part).row0 +
                      static_cast<int>(threadIdx.x);
      shared_ptr<float>(fold + kLoOff)[threadIdx.x] =
          e.lo != nullptr && row < p.m ? e.lo[row] : neg_inf();
    }
  }
  static __device__ __forceinline__ Pos load(unsigned fold, const Args& e, int q, int tid,
                                             int rl) {
    const int2 v = ld_slot(fold_slot<kRows>(fold, q, tid));
    return {__int_as_float(v.x), e.depth == 2 ? __int_as_float(v.y)
                                              : shared_ptr<const float>(fold + kLoOff)[rl]};
  }
  static __device__ __forceinline__ void take(unsigned, const Args& e, Pos& p, float sc, int,
                                              int, int, bool live) {
    if (e.depth == 2) {  // uniform
      if (live && sc < p.x) {
        // tpu_knn's fold (new1 = min(s, m1); the displaced value folds
        // into m2), written as one guarded branch.
        p.x = sc < p.m1 ? p.m1 : sc;
        p.m1 = sc < p.m1 ? sc : p.m1;
      }
    } else if (live && sc < p.m1 && sc > p.x) {
      p.m1 = sc;
    }
  }
  static __device__ __forceinline__ void store(unsigned fold, const Args& e, int q, int tid,
                                               const Pos& p) {
    st_slot(fold_slot<kRows>(fold, q, tid),
            make_int2(__float_as_int(p.m1), __float_as_int(e.depth == 2 ? p.x : pos_inf())));
  }
  static __device__ __forceinline__ int dep(const Pos& p) { return __float_as_int(p.m1); }
  static __device__ __forceinline__ void tile_end(unsigned, const Args&, const TensorParams&,
                                                  int) {}
  // Position (i, h, l) of thread tid to partial[row][part][depth][lane]
  // (rows as write_candidates lays them out).
  static __device__ __forceinline__ void finish(unsigned fold, const Args& e,
                                                const TensorParams& p) {
    const int tid = threadIdx.x;
    const TensorBlock blk = tensor_block<TensorLayout<false>, kRows>(p.groups, p.groups_per_part);
    const int lane0 = blk.first % kLanes + (tid >> 5 & 3) * 8 + 2 * (tid & 3);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = blk.row0 + (tid >> 7) * 32 + 16 * i + (tid & 31) / 4 + 8 * h;
        if (row < p.m) {
          float* o = e.partial +
                     (static_cast<long long>(row) * gridDim.y + blockIdx.y) * e.depth * kLanes +
                     lane0;
#pragma unroll
          for (int l = 0; l < 2; ++l) {
            const int2 v = ld_slot(fold_slot<kRows>(fold, 4 * i + 2 * h + l, tid));
            o[l] = __int_as_float(v.x);
            if (e.depth == 2) o[kLanes + l] = __int_as_float(v.y);
          }
        }
      }
    }
  }
};

}  // namespace

extern "C" {

// B3 at a tier: qp the query parts as for tk_tensor_candidates; r the f32
// (mode 0) or bf16 (mode 1) SoA operand, rn scratch of n floats; depth 1 or
// 2; lo (m,) f32 or null, null at depth 2; the term list as for
// tk_tensor_candidates (modes 0 and 1). partial is (m, parts*depth*128) scratch, out (m,
// depth*128): the per-lane minima of the first n columns.
int tk_tensor_minima(const void* qp, const void* r, const float* rn, const float* lo,
                     float* partial, float* out, int m, int k, long long ld, int n, int parts,
                     int depth, int mode, int nterms, int term_q, int term_r, void* stream) {
  if (!tensor_entry_valid(qp, r, rn, m, k, ld, n, parts, mode) || (depth != 1 && depth != 2) ||
      (depth == 2 && lo != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const TensorArgs a = tensor_args(qp, r, nullptr, rn, m, k, ld, n, parts, term_q, term_r, stream);
  if (const int err = dispatch_tensor<MinimaEpi>(a, MinimaEpi::Args{lo, partial, depth}, mode,
                                                 nterms)) {
    return err;
  }
  if (depth == 1) {
    minima_merge_kernel<1><<<m, kLanes, 0, a.stream>>>(partial, out, parts);
  } else {
    minima_merge_kernel<2><<<m, kLanes, 0, a.stream>>>(partial, out, parts);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
