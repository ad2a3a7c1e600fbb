// The tensor-core candidate kernel: B1's bf16-split score tiers and B12.
//
// B1 (tiers) — replaces tpu_knn/kernels/fused.py:318 _fused_kernel (built
// by _build_fused_candidates) in its score tiers other than "highest":
// _score_tile / _qr_dot's "packed" (packed3, packed2), "bf16x3", "bf16x4",
// "qsplit2" and "default"/"bf16_raw".
// B12 — replaces tpu_knn/kernels/fused.py:290 _fused_presplit_kernel (the
// "bf16x3_presplit" tier): the same fold over pre-split bf16 (hi, lo) rows
// and an f32 |r|^2 row.
//
// A tier is a term list: T products (q part i_t) . (r part j_t) of bf16
// parts of the 3-way split x ~ hi + mid + lo (index 0, 1, 2; the 2-way
// split's lo is the 3-way split's mid). Each tier is one bf16 GEMM over a
// contraction of T * k16 rows (k padded to 16), on the tensor cores
// (mma.sync.m16n8k16, bf16 x bf16 -> f32), with B1's candidate contract
// (knn_common.cuh): s = |r|^2 - 2 q.r folded per lane with a strict `<`.
// An instance is built for each term list the wrapper sends (tiers.term_list;
// instance_terms in tensor_mainloop.cuh), so every fragment a term reads is
// chosen when the kernel is compiled.
//
// The ring, the split, the fragments, the terms and their sum are the
// shared mainloop's (tensor_mainloop.cuh, which holds the design and the
// bound); this file holds B1's epilogue, the per-lane (score, index) fold,
// and the C entry of B1's tiers and B12. Scores and indices are those of
// the first port bit for bit at the same P (probes/tier_kernel.py save /
// compare).

#include "tensor_mainloop.cuh"

namespace {

// B1's epilogue: per (row, lane) the running (score, index) pair, a strict
// `<` in column order (knn_common.cuh's candidate contract), in the fold
// slots (kFoldSlotBytes), written to the candidate outputs at the end.
struct CandidatesEpi {
  static constexpr bool kContig = false;
  static constexpr int kRows = 128;       // tiers.TENSOR_TILE_M
  static constexpr bool kDeferTileEnd = false;
  static constexpr bool kRegState = false;
  static constexpr bool kDeadNormInf = false;
  static constexpr int kBlocksPerSm = 1;  // tiers.TENSOR_BLOCKS_PER_SM
  static constexpr int blocks_per_sm(int, int) { return kBlocksPerSm; }
  static constexpr size_t kStateBytes = fold_slot_bytes<kRows>();
  struct Args {
    int32_t* out_i;
    float* out_s;
  };
  using Pos = int2;
  static __device__ __forceinline__ void init(unsigned fold, const Args&, const TensorParams&) {
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      st_slot(fold_slot<kRows>(fold, q, threadIdx.x),
              make_int2(__float_as_int(pos_inf()), kI32Max));
    }
  }
  static __device__ __forceinline__ Pos load(unsigned fold, const Args&, int q, int tid,
                                             int) {
    return ld_slot(fold_slot<kRows>(fold, q, tid));
  }
  static __device__ __forceinline__ void take(unsigned, const Args&, Pos& best, float sc, int col,
                                              int, int, bool live) {
    if (live && sc < __int_as_float(best.x)) best = make_int2(__float_as_int(sc), col);
  }
  static __device__ __forceinline__ void store(unsigned fold, const Args&, int q, int tid,
                                               Pos best) {
    st_slot(fold_slot<kRows>(fold, q, tid), best);
  }
  static __device__ __forceinline__ int dep(const Pos& best) { return best.x; }
  static __device__ __forceinline__ void tile_end(unsigned, const Args&, const TensorParams&,
                                                  int) {}
  static __device__ __forceinline__ void finish(unsigned fold, const Args& e,
                                                const TensorParams& p) {
    write_candidates<kRows>(fold, e.out_i, e.out_s, p.m, p.groups, p.groups_per_part);
  }
};

}  // namespace

extern "C" {

// The tensor-core candidate kernel. qp holds the query parts, (nq, m, k16)
// bf16 (the 3-way split of the zero-padded queries, nq the parts the terms
// use). mode 0: r is the (>= k, ld) f32 SoA operand; mode 1: the bf16 SoA
// operand of a quantized store (terms with an r part other than 0 dropped
// by the caller); for both, rn is scratch of n floats that the entry fills
// with the operand's |r|^2 row before the kernel reads it. mode 2 (B12): r
// and r_lo are the (k16, ld) bf16 hi and lo rows and rn the (1, ld) f32
// norm row. qp, r and r_lo 16-byte aligned, and ld a whole number of
// 16-byte units. nterms terms, term t's q part at bits 2t of term_q and its
// r part at bits 2t of term_r: one of the lists tiers.term_list gives
// (instance_terms; 8 and 9 terms only at k16 = 16, where they arise), else
// cudaErrorInvalidValue. Outputs (m, parts*128) int32 + f32.
int tk_tensor_candidates(const void* qp, const void* r, const void* r_lo, const float* rn,
                         int32_t* out_i, float* out_s, int m, int k, long long ld, int n,
                         int parts, int mode, int nterms, int term_q, int term_r,
                         void* stream) {
  if (rn == nullptr || !valid_geometry(m, k, ld, n, parts) || parts > kMaxGridY || n > (1 << 30) ||
      !tensor_operands_aligned(qp, r, r_lo, ld, mode)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const TensorArgs a = tensor_args(qp, r, r_lo, rn, m, k, ld, n, parts, term_q, term_r, stream);
  const CandidatesEpi::Args e{out_i, out_s};
  if (mode == kModePresplit) {
    if (nterms != 3 || r_lo == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    return launch_tensor_kc<3, kModePresplit, false, CandidatesEpi>(a, e);
  }
  return dispatch_tensor<CandidatesEpi>(a, e, mode, nterms);
}

}  // extern "C"
