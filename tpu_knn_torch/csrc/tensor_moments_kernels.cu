// B7 at a score tier — replaces tpu_knn/kernels/topk.py:509
// _extract_moment_kernel (built by _build_extract_candidates) in its score
// tiers other than "highest": per (row, cell of `cell` = 64/128/256
// columns), the exact integer moments cnt, sum l, sum l^2 [, sum l^3] of
// the columns l (= col % cell) whose score is <= the row's bound (and > its
// lo, for a band; columns >= n never qualify), packed as tpu_knn packs
// them: A = min(cnt,3) | e1<<2 | p2<<12 masked to 30 bits, bit 30 = (cnt >
// solvable), and p3 in the cubic mode. With rem_part, also the per-lane
// minima of the scores above the bound (the rounds engine's next bound
// source), merged by minima_merge_kernel. The words equal tpu_knn's and the
// tiled B7's bit for bit (every sum is an exact integer below 2^31).
//
// Bound on the H100: tensor-core operations, as B1's tiers (T * 2 * m * n *
// k16 at 989 TFLOP/s), plus a compare per (row, column); the CUDA cores'
// instruction rate and the tile's end hold it above that
// (tensor_mainloop.cuh, PERF.md).
//
// Design: the shared mainloop (tensor_mainloop.cuh) with the contiguous
// layout, in 128-row blocks of 16 warps, one an SM; a packed tier's terms
// are summed in the tensor core. A block owns one partition of whole
// 256-column chunks, a column tile one 128-column group, so a cell of 64 or
// 128 columns lies in one tile and one of 256 in two consecutive tiles of
// one block. A qualifier (nearly no score is one) sets its slot's bit in
// its row's 128-bit mask of the tile in shared memory (one shared atomic
// OR: the epilogue's hot path stays within 128 registers; two masks, the
// tiles of even and odd groups); after the barrier that starts the next
// step, one thread per (row, cell of the tile) sums l, l^2 and l^3 over
// the set bits (integer sums, so their order does not matter) while the
// next tile sets the other mask, clears the bits, and at the cell's last
// tile packs its word and writes it (a 256-column cell carries its first
// tile's sums in shared memory). The
// scores are B3's at the tier bit for bit (one mainloop), so the bound B3
// gives and the qualifiers B7 counts come from one arithmetic. Two
// instances (BANDED): without a band (the single-round engine) a position
// keeps only its row's bound, the state is 7 KB; with a band and the
// remainder minima (the rounds engine) a position keeps its row's lo too,
// and a [row][lane] tile of shared memory that each position's owner
// folds, written out at the end, takes 70 KB.

#include <type_traits>

#include "tensor_mainloop.cuh"

namespace {

template <bool BANDED>
struct MomentsEpi {
  static constexpr bool kContig = true;
  static constexpr int kRows = 128;
  static constexpr bool kDeferTileEnd = true;  // tile_end below
  static constexpr bool kRegState = false;
  static constexpr bool kDeadNormInf = false;
  static constexpr int kBlocksPerSm = 1;
  static constexpr int blocks_per_sm(int, int) { return kBlocksPerSm; }
  // The block's rows' bound and lo, each row's qualifier masks of two
  // tiles (set g & 1 for the tile of 128-column group g, 4 words a row), a
  // 256-column cell's sums over its first tile (cnt, sum l, sum l^2, sum
  // l^3 a row), then (BANDED) the remainder tile [row][lane] (rows kRemLd
  // floats apart, as the sweep's score tile).
  static constexpr int kRemLd = kTCols + 8;
  static constexpr size_t kLoOff = kRows * sizeof(float);
  static constexpr size_t kMaskOff = 2 * kRows * sizeof(float);
  static constexpr size_t kSumOff = kMaskOff + 2 * kRows * 4 * sizeof(unsigned);
  static constexpr size_t kRemOff = kSumOff + kRows * 4 * sizeof(unsigned);
  static constexpr size_t kStateBytes =
      kRemOff + (BANDED ? static_cast<size_t>(kRows) * kRemLd * 4 : 0);
  struct Args {
    const float* bound;
    const float* lo;
    int32_t* out_a;
    int32_t* out_p3;
    float* rem_part;
    int nc, cell, cubic;
  };
  // The position's row's bound and (BANDED) lo: one register a position
  // without a band, which keeps the two-blocks instance within 128.
  struct Band {
    float b, lo;
  };
  struct Bound {
    float b;
  };
  using Pos = std::conditional_t<BANDED, Band, Bound>;
  static __device__ __forceinline__ void init(unsigned fold, const Args& e, const TensorParams& p) {
    const int tid = threadIdx.x;
    if (tid < kRows) {
      const int row =
          tensor_block<TensorLayout<true>, kRows>(p.groups, p.groups_per_part).row0 + tid;
      shared_ptr<float>(fold)[tid] = row < p.m ? e.bound[row] : neg_inf();
      shared_ptr<float>(fold + kLoOff)[tid] =
          e.lo != nullptr && row < p.m ? e.lo[row] : neg_inf();
    }
    for (int x = tid; x < kRows * 12; x += block_threads<kRows>()) {
      shared_ptr<unsigned>(fold + kMaskOff)[x] = 0u;  // both masks and the sums
    }
    if constexpr (BANDED) {
      for (int x = tid; x < kRows * kRemLd; x += block_threads<kRows>()) {
        shared_ptr<float>(fold + kRemOff)[x] = pos_inf();
      }
    }
  }
  static __device__ __forceinline__ Pos load(unsigned fold, const Args&, int, int, int rl) {
    if constexpr (BANDED) {
      return {shared_ptr<const float>(fold)[rl], shared_ptr<const float>(fold + kLoOff)[rl]};
    } else {
      return {shared_ptr<const float>(fold)[rl]};
    }
  }
  static __device__ __forceinline__ void take(unsigned fold, const Args& e, Pos& p, float sc,
                                              int col, int slot, int rl, bool live) {
    bool qual = live && sc <= p.b;
    if constexpr (BANDED) qual = qual && sc > p.lo;
    if (qual) {
      atomicOr(shared_ptr<unsigned>(fold + kMaskOff) + ((col >> 7) & 1) * kRows * 4 + rl * 4 +
                   (slot >> 5),
               1u << (slot & 31));
    }
    if constexpr (BANDED) {
      if (live && sc > p.b && e.rem_part != nullptr) {
        float* rm = shared_ptr<float>(fold + kRemOff) + rl * kRemLd + slot;
        if (sc < *rm) *rm = sc;
      }
    }
  }
  static __device__ __forceinline__ void store(unsigned, const Args&, int, int, const Pos&) {}
  static __device__ __forceinline__ int dep(const Pos& p) { return __float_as_int(p.b); }
  // Tile t's cells, run after the barrier that follows its last takes (the
  // mainloop's next step, kDeferTileEnd), while the next tile sets the other
  // mask: thread (row, cell of the tile) sums its cell's set bits (l = the
  // column's place in the cell), clears them, and where the cell ends here
  // (a 256-column cell at the second tile of its chunk) writes its word;
  // else it keeps the sums for the next tile.
  static __device__ __forceinline__ void tile_end(unsigned fold, const Args& e,
                                                  const TensorParams& p, int t) {
    const int per_tile = e.cell == 64 ? 2 : 1;
    const int tid = threadIdx.x;
    if (tid >= kRows * per_tile) return;
    const int rl = tid / per_tile;
    const int cs = tid - rl * per_tile;
    const int words = e.cell == 64 ? 2 : 4;
    const TensorBlock blk = tensor_block<TensorLayout<true>, kRows>(p.groups, p.groups_per_part);
    const int set = ((blk.first >> 7) + t) & 1;  // the mask of the tile's group
    unsigned* mask =
        shared_ptr<unsigned>(fold + kMaskOff) + set * kRows * 4 + rl * 4 + cs * words;
    unsigned* sums = shared_ptr<unsigned>(fold + kSumOff) + rl * 4;
    const bool second_half = e.cell == 256 && (t & 1);
    unsigned n_q = 0u, e1 = 0u, p2 = 0u, p3 = 0u;
    if (second_half) {
      n_q = sums[0];
      e1 = sums[1];
      p2 = sums[2];
      p3 = sums[3];
    }
    for (int w = 0; w < words; ++w) {
      for (unsigned bits = mask[w]; bits != 0u; bits &= bits - 1u) {
        const unsigned l = (second_half ? 128u : 0u) + 32u * w + (__ffs(bits) - 1);
        n_q += 1u;
        e1 += l;
        p2 += l * l;
        p3 += l * l * l;
      }
      mask[w] = 0u;
    }
    if (e.cell == 256 && !second_half) {  // the cell goes on in the next tile
      sums[0] = n_q;
      sums[1] = e1;
      sums[2] = p2;
      sums[3] = p3;
      return;
    }
    const int row = blk.row0 + rl;
    const int cidx = (blk.first + t * kTCols) / e.cell + cs;
    if (row < p.m && cidx < e.nc) {
      const unsigned solvable = e.cubic ? 3u : 2u;
      const unsigned packed = (n_q < 3u ? n_q : 3u) | (e1 << 2) | (p2 << 12);
      const long long o = static_cast<long long>(row) * e.nc + cidx;
      e.out_a[o] =
          static_cast<int32_t>((packed & 0x3FFFFFFFu) | ((n_q > solvable ? 1u : 0u) << 30));
      if (e.cubic) e.out_p3[o] = static_cast<int32_t>(p3);
    }
  }
  // (BANDED) The remainder tile's rows below m to rem_part[row][part][lane].
  static __device__ __forceinline__ void finish(unsigned fold, const Args& e,
                                                const TensorParams& p) {
    if constexpr (BANDED) {
      if (e.rem_part == nullptr) return;
      __syncthreads();
      const int row0 = tensor_block<TensorLayout<true>, kRows>(p.groups, p.groups_per_part).row0;
      const float* rem = shared_ptr<const float>(fold + kRemOff);
      for (int x = threadIdx.x; x < kRows * kLanes; x += block_threads<kRows>()) {
        const int rl = x / kLanes;
        const int lane = x - rl * kLanes;
        if (row0 + rl < p.m) {
          e.rem_part[(static_cast<long long>(row0 + rl) * gridDim.y + blockIdx.y) * kLanes +
                     lane] = rem[rl * kRemLd + lane];
        }
      }
    }
  }
};

}  // namespace

extern "C" {

// B7 at a tier: nc cells of `cell` in {64, 128, 256} columns cover the
// operand (ld >= nc*cell >= n); qp the query parts as for
// tk_tensor_candidates; r the f32 (mode 0) or bf16 (mode 1) SoA operand, rn
// scratch of n floats; parts partitions of whole 256-column chunks; bound
// (m,) f32, lo (m,) f32 or null; out_a (m, nc) int32, out_p3 (m, nc) int32
// when cubic; rem_part (m, parts*128) scratch and rem_out (m, 128), or both
// null (without both, and without lo, the two-blocks-an-SM instance); the
// term list as for tk_tensor_candidates (modes 0 and 1). parts as
// tiers.tensor_topk_parts gives them for the instance.
int tk_tensor_moments(const void* qp, const void* r, const float* rn, const float* bound,
                      const float* lo, int32_t* out_a, int32_t* out_p3, float* rem_part,
                      float* rem_out, int m, int k, long long ld, int n, int nc, int cell,
                      int cubic, int parts, int mode, int nterms, int term_q, int term_r,
                      void* stream) {
  const long long width = static_cast<long long>(nc) * cell;
  const long long chunks = (width + 255) / 256;
  if ((mode != kModeF32 && mode != kModeBF16) || rn == nullptr || bound == nullptr || m < 1 ||
      k < 1 || n < 1 || n > width || ld < width || width > (1 << 30) || parts < 1 ||
      parts > chunks || parts > kMaxGridY || (cell != 64 && cell != 128 && cell != 256) ||
      (cubic && out_p3 == nullptr) || ((rem_part == nullptr) != (rem_out == nullptr)) ||
      !tensor_operands_aligned(qp, r, nullptr, ld, mode)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  TensorArgs a = tensor_args(qp, r, nullptr, rn, m, k, ld, n, 1, term_q, term_r, stream);
  // The grid: parts partitions of whole chunks, two 128-column groups each.
  a.parts = parts;
  a.groups = static_cast<int>(2 * chunks);
  a.gpp = static_cast<int>(2 * ((chunks + parts - 1) / parts));
  if (lo == nullptr && rem_part == nullptr) {
    return dispatch_tensor<MomentsEpi<false>>(
        a, MomentsEpi<false>::Args{bound, lo, out_a, out_p3, rem_part, nc, cell, cubic != 0},
        mode, nterms);
  }
  if (const int err = dispatch_tensor<MomentsEpi<true>>(
          a, MomentsEpi<true>::Args{bound, lo, out_a, out_p3, rem_part, nc, cell, cubic != 0},
          mode, nterms)) {
    return err;
  }
  if (rem_part == nullptr) return 0;
  minima_merge_kernel<1><<<m, kLanes, 0, a.stream>>>(rem_part, rem_out, parts);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
