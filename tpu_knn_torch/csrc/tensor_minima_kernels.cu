// B3 at a score tier — replaces tpu_knn/kernels/fused.py:613
// _fused_minima_kernel (built by _build_minima_candidates) in its score
// tiers other than "highest": the seeded engine's bound pass. Per row and
// lane, the smallest score (depth 1) or the two smallest of the multiset
// (depth 2), at depth 1 optionally only scores above the row's lo (NaN
// never enters: every compare is strict). The caller passes the prefix it
// wants read as n. Out is the contract's (m, depth*128) = [min1 lanes |
// min2 lanes].
//
// Bound on the H100: tensor-core operations, as B1's tiers (T * 2 * m * n *
// k16 at 989 TFLOP/s). What holds the shared mainloop above it is the CUDA
// cores' instruction rate beside the mma.sync (tensor_mainloop.cuh,
// PERF.md): every instruction the fold spends a score is paid 2^30 times at
// ds11.
//
// Design: the shared mainloop (tensor_mainloop.cuh) with B1's lane-slice
// layout, in 128-row blocks of 16 warps, one an SM, reduced to tpu_knn's
// "one compare + one select" a score (fused.py:620-624):
// - one instance per (depth, band): depth 1, depth 1 above lo, depth 2, so
//   no score pays a branch on the depth;
// - each position's running minima stay in registers across tiles
//   (kRegState: one float a position at depth 1, two at depth 2 or with
//   lo, whose row's lo is read once), not in shared slots reloaded and
//   stored each tile, in the one-chunk instances (k16 == 16: the seeded
//   engine's ds11 launches, where the fold is paid every 16-deep step);
//   with several chunks a tile the accumulators leave them no room within
//   128 registers (ptxas spilled), so those keep B1's fold slots, loaded
//   and stored once a tile of k16 / KC steps;
// - a slot past the block's columns is staged with a +inf |r|^2
//   (kDeadNormInf), so it scores +inf, which no strict compare admits, and
//   no score is tested for its column;
// - at depth 1 the partitions meet in the output itself: each block folds
//   its positions into out (filled with +inf first) with an atomic min on
//   the float's bits (an integer min for a sign bit of 0, an unsigned max
//   for 1: the same order as the floats, -0 below +0), so the result does
//   not depend on the blocks' order and no partial array or merge pass is
//   needed; depth 2 writes per-partition pairs that minima_merge_kernel
//   folds.
// The scores are B1's, B4's, B5's and B7's at the tier bit for bit (one
// mainloop), so the seeded engine's bound and its qualifiers come from one
// arithmetic.

#include <type_traits>

#include "tensor_mainloop.cuh"

namespace {

// min(*addr, v) in place for floats that are never NaN: their bits order
// as signed integers where the sign is 0 and in reverse as unsigned ones
// where it is 1 (-0.0 included, below +0.0).
__device__ __forceinline__ void atomic_min_float(float* addr, float v) {
  const int bits = __float_as_int(v);
  if (bits >= 0) {
    atomicMin(reinterpret_cast<int*>(addr), bits);
  } else {
    atomicMax(reinterpret_cast<unsigned*>(addr), static_cast<unsigned>(bits));
  }
}

// Fill n floats with +inf (B3's depth-1 output, before the blocks' atomic
// minima).
__global__ void __launch_bounds__(256) minima_init_kernel(float* __restrict__ out, long long n) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < n) out[i] = pos_inf();
}

template <int DEPTH, bool BANDED>
struct MinimaEpi {
  static_assert((DEPTH == 1 || DEPTH == 2) && (DEPTH == 1 || !BANDED),
                "depth 1 or 2; tpu_knn's banded bound pass is depth 1");
  static constexpr bool kContig = false;
  static constexpr int kRows = 128;
  static constexpr bool kDeferTileEnd = false;
  static constexpr bool kRegState = true;
  static constexpr bool kDeadNormInf = true;
  static constexpr int kBlocksPerSm = 1;
  static constexpr int blocks_per_sm(int, int) { return kBlocksPerSm; }
  // The multi-chunk instances' fold slots (min1 and min2), then the
  // block's rows' lo.
  static constexpr size_t kLoOff = fold_slot_bytes<kRows>();
  static constexpr size_t kStateBytes = kLoOff + kRows * sizeof(float);
  struct Args {
    const float* lo;  // BANDED: (m,) f32
    float* out;       // depth 1: (m, 128), +inf filled; depth 2: (m, parts*2*128) partial
  };
  struct Min1 {
    float m1;
  };
  struct Band {
    float m1, lo;
  };
  struct Min2 {
    float m1, m2;
  };
  using Pos = std::conditional_t<DEPTH == 2, Min2, std::conditional_t<BANDED, Band, Min1>>;

  static __device__ __forceinline__ void init(unsigned fold, const Args& e, const TensorParams& p) {
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      st_slot(fold_slot<kRows>(fold, q, threadIdx.x),
              make_int2(__float_as_int(pos_inf()), __float_as_int(pos_inf())));
    }
    if (BANDED && threadIdx.x < kRows) {
      const int row = tensor_block<TensorLayout<false>, kRows>(p.groups, p.groups_per_part).row0 +
                      static_cast<int>(threadIdx.x);
      shared_ptr<float>(fold + kLoOff)[threadIdx.x] = row < p.m ? e.lo[row] : neg_inf();
    }
  }
  // A multi-chunk instance's position state from its slot (and its row's
  // lo), and back.
  static __device__ __forceinline__ Pos load(unsigned fold, const Args&, int q, int tid, int rl) {
    const int2 v = ld_slot(fold_slot<kRows>(fold, q, tid));
    if constexpr (DEPTH == 2) {
      return {__int_as_float(v.x), __int_as_float(v.y)};
    } else if constexpr (BANDED) {
      return {__int_as_float(v.x), shared_ptr<const float>(fold + kLoOff)[rl]};
    } else {
      return {__int_as_float(v.x)};
    }
  }
  static __device__ __forceinline__ void store(unsigned fold, const Args&, int q, int tid,
                                               const Pos& p) {
    int y = __float_as_int(pos_inf());
    if constexpr (DEPTH == 2) y = __float_as_int(p.m2);
    st_slot(fold_slot<kRows>(fold, q, tid), make_int2(__float_as_int(p.m1), y));
  }
  // The first state of a position of block row rl.
  static __device__ __forceinline__ Pos start(const Args& e, const TensorParams& p, int rl) {
    if constexpr (DEPTH == 2) {
      return {pos_inf(), pos_inf()};
    } else if constexpr (BANDED) {
      const int row = tensor_block<TensorLayout<false>, kRows>(p.groups, p.groups_per_part).row0 +
                      rl;
      return {pos_inf(), row < p.m ? e.lo[row] : neg_inf()};
    } else {
      return {pos_inf()};
    }
  }
  static __device__ __forceinline__ void take(unsigned, const Args&, Pos& p, float sc, int, int,
                                              int, bool) {
    if constexpr (DEPTH == 2) {
      // tpu_knn's fold (new1 = min(s, m1); the displaced value folds into
      // m2) as selects: s < m1 implies s < m2.
      const bool top = sc < p.m1;
      p.m2 = sc < p.m2 ? (top ? p.m1 : sc) : p.m2;
      p.m1 = top ? sc : p.m1;
    } else if constexpr (BANDED) {
      p.m1 = sc < p.m1 && sc > p.lo ? sc : p.m1;
    } else {
      p.m1 = sc < p.m1 ? sc : p.m1;
    }
  }
  static __device__ __forceinline__ int dep(const Pos& p) { return __float_as_int(p.m1); }
  static __device__ __forceinline__ void tile_end(unsigned, const Args&, const TensorParams&,
                                                  int) {}
  // A multi-chunk instance's positions from their slots (the lo that load
  // reads beside them is not used), written as the registers' below.
  static __device__ __forceinline__ void finish(unsigned fold, const Args& e,
                                                const TensorParams& p) {
    Pos s[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) s[q] = load(fold, e, q, threadIdx.x, 0);
    finish(e, p, s);
  }
  // Position (i, h, l) of thread tid is row row0 + 32 (tid / 128) + 16 i +
  // (tid % 32) / 4 + 8 h, lane slice * 32 + 8 (tid / 32 % 4) + 2 (tid % 4) +
  // l (write_candidates' layout): depth 1 folds it into out[row][lane],
  // depth 2 writes it to partial[row][part][depth][lane].
  static __device__ __forceinline__ void finish(const Args& e, const TensorParams& p,
                                                const Pos (&s)[8]) {
    const int tid = threadIdx.x;
    const TensorBlock blk = tensor_block<TensorLayout<false>, kRows>(p.groups, p.groups_per_part);
    const int lane0 = blk.first % kLanes + (tid >> 5 & 3) * 8 + 2 * (tid & 3);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = blk.row0 + (tid >> 7) * 32 + 16 * i + (tid & 31) / 4 + 8 * h;
        if (row < p.m) {
#pragma unroll
          for (int l = 0; l < 2; ++l) {
            const Pos& v = s[4 * i + 2 * h + l];
            if constexpr (DEPTH == 2) {
              float* o = e.out +
                         (static_cast<long long>(row) * gridDim.y + blockIdx.y) * 2 * kLanes +
                         lane0 + l;
              o[0] = v.m1;
              o[kLanes] = v.m2;
            } else if (v.m1 < pos_inf()) {
              atomic_min_float(e.out + static_cast<long long>(row) * kLanes + lane0 + l, v.m1);
            }
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
// tk_tensor_candidates (modes 0 and 1). partial is (m, parts*2*128)
// scratch at depth 2 (null at depth 1); out (m, depth*128): the per-lane
// minima of the first n columns.
int tk_tensor_minima(const void* qp, const void* r, const float* rn, const float* lo,
                     float* partial, float* out, int m, int k, long long ld, int n, int parts,
                     int depth, int mode, int nterms, int term_q, int term_r, void* stream) {
  if (!tensor_entry_valid(qp, r, rn, m, k, ld, n, parts, mode) || (depth != 1 && depth != 2) ||
      (depth == 2 && (lo != nullptr || partial == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const TensorArgs a = tensor_args(qp, r, nullptr, rn, m, k, ld, n, parts, term_q, term_r, stream);
  if (depth == 2) {
    if (const int err = dispatch_tensor<MinimaEpi<2, false>>(
            a, MinimaEpi<2, false>::Args{nullptr, partial}, mode, nterms)) {
      return err;
    }
    minima_merge_kernel<2><<<m, kLanes, 0, a.stream>>>(partial, out, parts);
    return static_cast<int>(cudaGetLastError());
  }
  const long long outs = static_cast<long long>(m) * kLanes;
  minima_init_kernel<<<static_cast<unsigned>((outs + 255) / 256), 256, 0, a.stream>>>(out, outs);
  if (const cudaError_t err = cudaGetLastError()) return static_cast<int>(err);
  return lo != nullptr
             ? dispatch_tensor<MinimaEpi<1, true>>(a, MinimaEpi<1, true>::Args{lo, out}, mode,
                                                   nterms)
             : dispatch_tensor<MinimaEpi<1, false>>(a, MinimaEpi<1, false>::Args{nullptr, out},
                                                    mode, nterms);
}

}  // extern "C"
