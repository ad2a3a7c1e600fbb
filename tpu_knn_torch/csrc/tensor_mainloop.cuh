// The tensor-core score mainloop that B1's bf16-split tiers and B12
// (tensor_kernels.cu) and the tier instances of B4, B3, B5 and B7
// (tensor_banded_kernels.cu, tensor_minima_kernels.cu,
// tensor_sweep_kernels.cu, tensor_moments_kernels.cu) share: the ring, the
// split, the ldmatrix fragments, the mma.sync terms and their sum, with the
// fold of the scores left to an epilogue, as tiled.cuh leaves its
// epilogues to the f32 kernels.
//
// A tier is a term list: T products (q part i_t) . (r part j_t) of bf16
// parts of the 3-way split x ~ hi + mid + lo (index 0, 1, 2; the 2-way
// split's lo is the 3-way split's mid). Each tier is one bf16 GEMM over a
// contraction of T * k16 rows (k padded to 16), on the tensor cores
// (mma.sync.m16n8k16, bf16 x bf16 -> f32), and every kernel of this header
// scores s = |r|^2 - 2 q.r. An instance is built for each term list the
// wrapper sends (tiers.term_list; instance_terms below), so every fragment
// a term reads is chosen when the kernel is compiled.
//
// Every instance of every epilogue runs the same arithmetic for a (row,
// column) pair: the same mma per 16-deep step, the same sum of the terms,
// the same norm pass. So B1, B4 and B5 at a tier give a column the same
// score bit for bit, as do B3 and B7: the passes and sweep engines agree
// exactly, and the seeded engine's bound (B3) and qualifiers (B7) come from
// one arithmetic. The bits do not depend on a block's rows.
//
// Bound on the H100: tensor-core operations, T * 2 * m * n * k16 at 989
// TFLOP/s (at k = 768, m = 1024, n = 2^20: 3.3 ms for qsplit2's T = 2, 5.0
// ms for bf16x3; at ds11 0.28 ms for packed3's T = 8), beside which the SoA
// operand is read once. What holds an instance above it is the CUDA
// cores' instruction rate beside the mma.sync and the block's barriers
// (PERF.md): the fold, the split and the copies take tens of instructions
// a score, and the tiers other than packed keep one f32 add a term on
// purpose (T adds per output and 16-deep step, about 4.8 ms at bf16x3, k =
// 768), as tpu_knn orders them. The design, for 16 warps an SM (at most
// 128 registers a thread; ptxas spills in no instance, which chip_smoke.py
// checks):
// - a block owns its epilogue's kRows query rows (BM): 128 for B1's tiers,
//   B12, B4, B3, B5 and B7 and the 1-NN ladder's v3 and B10, so each staged
//   r chunk serves 128 rows (the rows of two 64-row blocks, half their r
//   bytes from L2 a score), one 16-warp block an SM; 64 for v6's live-row
//   instance (its live rows need <= 101 KB); 32 for B5, v3 and B10 at m <=
//   32 and v6's live rows there where their parts fit 15 KB (four warps,
//   all on live rows), two blocks an SM. Warp w owns rows
//   32 (w / 4) .. + 31 and lanes 8 (w % 4)
//   .. + 7 of the slot groups, whatever BM is: a warp's arithmetic is the
//   same at every height;
// - a block walks a column tile of 128 staged columns at a time: slot (j,
//   c), group j < 4 and lane c < 32. Where a slot's column lies is the
//   epilogue's choice (TensorLayout): B1, B4 and B3 give a block one lane
//   slice (32 of the 128 lanes) of one partition, slot (j, c) = lane c of
//   the tile's group j, so a lane's columns all fall to one thread; B5 and
//   B7 give a block a whole partition, slot (j, c) = column 32 j + c of one
//   contiguous 128-column group, so a K-list partition or a seeded cell
//   lies within one block. A warp's mma fragments are 2 m16 blocks by 4 n8
//   tiles (one per group), so each B fragment feeds 2 * T mmas, and each
//   thread's accumulators are all four groups of the same 8 (row, lane)
//   positions. Consecutive blocks are the slices and row tiles of one
//   partition, so a partition's row tiles read its columns from L2;
// - the r chunks (KC rows: 32 where k16 allows, else 16; 16 for T = 4 but
//   packed2's one chunk) stream through a
//   ring of cp.async stages (16-byte copies, the copy of step s + depth - 1
//   in flight while step s is multiplied), as they are stored (f32, a
//   quantized store's bf16, or B12's hi and lo), rows >= k, columns >= n and
//   groups past the partition zero-filled without a read; the tile's |r|^2
//   row rides with its last chunk. The ring is the deepest (<= 4 stages) at
//   which the epilogue's blocks fit an SM, checked when the kernel is
//   compiled. How a stage's r part arrives is the staging policy's
//   (SoaStaging here; the 1-NN ladder's AoS and TMA policies in
//   tensor_ladder_kernels.cu);
// - an f32 chunk is split once, by the whole block, after it lands: every
//   thread splits pairs of values into the tier's bf16 part planes (hi,
//   mid, lo: cvt.rn.bf16x2, round to nearest even, tpu_knn's split bit for
//   bit). A block that runs alone on its SM splits chunk s + 1 while step
//   s is multiplied, into the other of two sets of planes (plane_sets), so
//   a step takes one barrier and the split's CUDA-core work runs beside
//   the mmas (under a policy with mbarriers, after a wait on stage s +
//   1's); else it splits each chunk at its step. A bf16 operand's lower
//   parts are zero and the caller drops those terms; B12's hi and lo are
//   multiplied as staged;
// - the q parts are split once per call by the caller and copied once per
//   block into shared memory where they fit (q_resident_limit: 30 KB a 64
//   rows, as the ring's q chunks one after another); at embedding width
//   each q chunk rides in the ring beside r;
// - fragments come from ldmatrix: A (x4) from the staged q parts, B (x4,
//   .trans) from the k-major part planes, two n8 tiles at a time; rows of
//   272 bytes (q: 16 mod 32 bytes) keep both conflict-free. A warp loads a
//   q part's A fragments once per 16-deep step, whatever number of terms
//   read it;
// - |r|^2 is one fmaf chain over the upcast column, d = 0..k-1 in order,
//   computed once per call for the f32 and bf16 operands (the norm pass
//   before the kernel) instead of by each of the m / BM row tiles; B12
//   reads its stored f32 row. A staging policy with kNorms (v3's, B10's,
//   v6's live rows') has the block chain it over the staged chunks instead, the same fmaf
//   chain over the same values (zeros past k add +0), so the same bits:
//   at a few query rows the norm pass would read the operand a second
//   time;
// - where a column tile is one 16-deep chunk (k16 == 16, the ds11 shapes),
//   each (m16, n8) tile is folded as soon as its terms are summed
//   (mma_fold_tile), so no accumulator outlives a tile;
// - register economy, for 128 registers without spills: the copy, split and
//   fold offsets are recomputed from threadIdx and blockIdx each step
//   (fresh_tid, tensor_block), the copy loops stay rolled, the fold state is
//   addressed in the shared space, and in the one-chunk path each tile's
//   mmas (a packed tier's pair of tiles) take their zero from the previous
//   fold;
// - numerics: a packed tier (packed3, packed2: tpu_knn's one dot over the
//   concatenated parts, _qr_dot_packed) chains its T terms through the
//   tensor core's accumulator, the term of the smallest parts first and hh
//   last, so the tensor core's f32 accumulation (alignment to the largest
//   exponent, truncation) rounds each partial sum at the size of the terms
//   summed so far and the large ones once; the step's sum is added to the
//   f32 total on the CUDA cores. Every other tier keeps each term of a
//   16-deep step in an mma into a fragment of its own that starts at zero,
//   so the tensor core only ever sums 16 exact products, and adds the terms
//   on the CUDA cores (round to nearest) in tpu_knn's order, hh + (hl + lh)
//   and then the rest, and the step's sum to the f32 total. Both stay
//   within tiers.tier_error_gate (PERF.md, tier_numerics.py).
//
// The epilogue (EPI) sees each (row, column) score once, as s = |r|^2 -
// 2 acc, through a per-position interface: a thread's 8 positions q = 4 i +
// 2 h + l (row 16 i + g + 8 h of its warp's 32, lane 2 tg + l of its
// octet) each load a state (EPI::load), take the position's score in every
// group of the tile in column order (EPI::take, with the slot's column, its
// place in the tile and the row's place in the block), and store it back
// (EPI::store); each is handed the epilogue's arguments (a kernel
// parameter, read where used). EPI::init runs before the first tile, EPI::tile_end after
// each tile's last chunk (every thread of the block, so it may hold a
// barrier; with EPI::kDeferTileEnd after the barrier that ends the tile's
// last step, beside the next tile's takes), EPI::finish after the last
// tile. Two traits change what the mainloop hands an epilogue:
// - EPI::kRegState keeps the 8 positions' states in registers across tiles
//   in the one-chunk instances (ONE; RegState: EPI::start gives each its
//   first state, the takes fold into it in place of load and store, and
//   EPI::finish receives them; with several chunks a tile the accumulators
//   leave them no room within 128 registers, so load and store stay);
// - EPI::kDeadNormInf stages +inf as the |r|^2 of every slot past the
//   block's columns (a column >= n, or a group past its partition), so such
//   a slot scores +inf and its epilogue needs no test of the slot's column.

#pragma once

#include "knn_common.cuh"

namespace {

constexpr int kTBM = 64;                          // query rows of a 64-row block
constexpr int kTThreads = 256;                    // its 8 warps: 2 row halves x 4 lane octets
constexpr int kTSliceLanes = 32;                  // partition lanes per lane slice
constexpr int kTSlices = kLanes / kTSliceLanes;   // lane slices of a partition
constexpr int kTGroups = 4;                       // groups per column tile
constexpr int kTCols = kTGroups * kTSliceLanes;   // staged columns per tile
constexpr int kTPad = 8;                          // bf16 padding of a staged q row
constexpr int kTPlaneLd = kTCols + 8;             // bf16 per staged r row / part plane row
constexpr int kTMaxStages = 4;
constexpr size_t kQResidentBytes = 30 * 1024;     // resident q parts of a 64-row block

// A block of BM query rows (the epilogue's kRows: 32, 64, or 128 for B1's
// tiers, B12, B4, B3, B5 and B7) runs 4 * BM threads: warp w owns rows 32 (w /
// 4) .. + 31 and lanes 8 (w % 4) .. + 7 of the slot groups.
template <int BM>
__host__ __device__ constexpr int block_threads() {
  return 4 * BM;
}

// The resident q parts' limit of a BM-row block: kQResidentBytes a 64
// rows, so whether a width's parts are resident does not depend on BM.
template <int BM>
__host__ __device__ constexpr size_t q_resident_limit() {
  return kQResidentBytes * BM / kTBM;
}

enum OperandMode { kModeF32 = 0, kModeBF16 = 1, kModePresplit = 2 };
// Bytes of a column tile's |r|^2 row, staged with the tile's last chunk.
constexpr int kTNormBytes = kTCols * sizeof(float);
static_assert(kTCols <= kTThreads, "a block's last kTCols threads stage one |r|^2 each");

// Where a block's slots lie (TileColumns in tiled.cuh): slot (j, c) of the
// block's tile t is column first + t * kTileStride + j * kGroupStride + c.
// Lane slices (CONTIG false): kSlices blocks per (row tile, partition), a
// tile 4 of the partition's 128-column groups; contiguous (CONTIG true):
// one block per (row tile, partition), a tile one 128-column group.
template <bool CONTIG>
struct TensorLayout {
  static constexpr int kSlices = CONTIG ? 1 : kTSlices;
  static constexpr int kTileStride = CONTIG ? kTCols : kTGroups * kLanes;
  static constexpr int kGroupStride = CONTIG ? kTSliceLanes : kLanes;
  static constexpr int kUnitGroups = CONTIG ? kTGroups : 1;  // slot groups per 128-column group
};

// A term list: term t's q part at bits 2t of q, its r part at bits 2t of r
// (tiers._pack_terms); kPackedSum in r: the terms are one packed dot
// (tpu_knn's _qr_dot_packed), summed in the tensor core (tile_terms).
struct Terms {
  int q;
  int r;
};
constexpr int kPackedSum = 1 << 30;

// The term list of each instance, as tiers.term_list gives it: over a bf16
// operand the terms with an r part other than 0 are dropped by the caller.
template <int MODE, int T>
__host__ __device__ constexpr Terms instance_terms() {
  if (MODE == kModeBF16) return T == 1 ? Terms{0, 0} : T == 2 ? Terms{4, 0} : Terms{36, 0};
  switch (T) {
    case 1: return {0, 0};                  // default: hh
    case 2: return {4, 0};                  // qsplit2: hh, lh
    case 3: return {16, 4};                 // bf16x3 (and B12): hh, hl, lh
    case 4: return {80, 68};                // bf16x4, packed2: hh, hl, lh, ll
    case 8: return {42304, 18724};          // packed3 at k_pad 16: 3 x 3 but lo.lo
    default: return {173376, 149796};       // packed3 at k_pad 8: 3 x 3
  }
}

template <int MODE, int T>
__host__ __device__ constexpr int term_q(int t) {
  return (instance_terms<MODE, T>().q >> (2 * t)) & 3;
}

template <int MODE, int T>
__host__ __device__ constexpr int term_r(int t) {
  return (instance_terms<MODE, T>().r >> (2 * t)) & 3;
}

template <int MODE, int T>
__host__ __device__ constexpr int q_parts() {
  int p = 0;
  for (int t = 0; t < T; ++t) p = term_q<MODE, T>(t) + 1 > p ? term_q<MODE, T>(t) + 1 : p;
  return p;
}

// The r part planes the mmas read: the f32 mode's split, B12's (hi, lo),
// or a bf16 operand as staged.
template <int MODE, int T>
__host__ __device__ constexpr int r_planes() {
  if (MODE != kModeF32) return MODE == kModePresplit ? 2 : 1;
  int p = 0;
  for (int t = 0; t < T; ++t) p = term_r<MODE, T>(t) + 1 > p ? term_r<MODE, T>(t) + 1 : p;
  return p;
}

// The shared-memory plan of an instance (tiers.tensor_smem mirrors it):
// the epilogue's state and in f32 mode a copy of a tile's |r|^2 row for
// each set of part planes (fixed_bytes), the ring's stages (the r chunk,
// B12's hi and lo both, the tile's |r|^2 row, and the q chunk where q is
// not resident), the f32 mode's part planes (two sets where the split runs
// a step ahead, plane_sets), and the resident q parts.
template <int MODE, class EPI>
__host__ __device__ constexpr size_t fixed_bytes(int sets = 1) {
  return EPI::kStateBytes + (MODE == kModeF32 ? sets * kTNormBytes : 0);
}

template <int MODE, int T, int KC>
__host__ __device__ constexpr size_t r_stage_bytes() {
  return (MODE == kModeF32
              ? static_cast<size_t>(KC) * kTCols * 4
              : static_cast<size_t>(MODE == kModePresplit ? 2 : 1) * KC * kTPlaneLd * 2) +
         kTNormBytes;
}

template <int MODE, int T, int KC, int BM>
__host__ __device__ constexpr size_t q_chunk_bytes() {
  return static_cast<size_t>(q_parts<MODE, T>()) * BM * (KC + kTPad) * 2;
}

template <int MODE, int T, int KC>
__host__ __device__ constexpr size_t planes_bytes() {
  return MODE == kModeF32 ? static_cast<size_t>(r_planes<MODE, T>()) * KC * kTPlaneLd * 2 : 0;
}

// Resident q parts are stored as the ring's q chunks are, one after the
// other, so every A fragment's address is a compile-time offset.
template <int MODE, int T, int KC, int BM>
__host__ __device__ constexpr size_t q_resident_bytes(int k16) {
  return static_cast<size_t>(k16 / KC) * q_chunk_bytes<MODE, T, KC, BM>();
}

template <int MODE, int T, int KC, int BM>
__host__ __device__ constexpr bool q_resident(int k16) {
  return q_resident_bytes<MODE, T, KC, BM>(k16) <= q_resident_limit<BM>();
}

template <int MODE, int T, int KC, int BM>
__host__ __device__ constexpr size_t stage_bytes(bool resident) {
  return r_stage_bytes<MODE, T, KC>() + (resident ? 0 : q_chunk_bytes<MODE, T, KC, BM>());
}

// The q bytes a block's plan holds beside a ring of `stages`: resident q
// parts of up to q_resident_limit, or a q chunk in every stage; LIVE (v6's
// live-row instances) the epilogue's budget for the live rows' parts,
// EPI::kLiveQBytes.
template <int MODE, int T, int KC, class EPI, bool LIVE>
__host__ __device__ constexpr size_t q_budget(int stages) {
  if constexpr (LIVE) {
    return EPI::kLiveQBytes;
  } else {
    const size_t q = stages * q_chunk_bytes<MODE, T, KC, EPI::kRows>();
    const size_t res = q_resident_limit<EPI::kRows>();
    return q > res ? q : res;
  }
}

// The most any k16 takes at a ring depth with `sets` sets of part planes.
template <int MODE, int T, int KC, class EPI, bool LIVE = false>
__host__ __device__ constexpr size_t most_smem(int stages, int sets) {
  return fixed_bytes<MODE, EPI>(sets) + stages * r_stage_bytes<MODE, T, KC>() +
         sets * planes_bytes<MODE, T, KC>() + q_budget<MODE, T, KC, EPI, LIVE>(stages);
}

// Whether an instance's blocks per SM (EPI::blocks_per_sm(T, KC), its
// __launch_bounds__) fit an SM's shared memory at a ring depth.
template <int MODE, int T, int KC, class EPI, bool LIVE = false>
__host__ __device__ constexpr bool fits_blocks(int stages, int sets) {
  return EPI::blocks_per_sm(T, KC) * (most_smem<MODE, T, KC, EPI, LIVE>(stages, sets) +
                                      kSmemPerBlockReserved) <=
             kSmemPerSm &&
         most_smem<MODE, T, KC, EPI, LIVE>(stages, sets) <= kSmemPerBlock;
}

// The deepest ring up to kTMaxStages at which the blocks fit.
template <int MODE, int T, int KC, class EPI, bool LIVE = false>
__host__ __device__ constexpr int deepest_ring(int sets) {
  int stages = kTMaxStages;
  while (stages > 2 && !fits_blocks<MODE, T, KC, EPI, LIVE>(stages, sets)) --stages;
  return stages;
}

// Whether an f32 instance splits each chunk a step ahead, into the other
// of two sets of part planes (tensor_mainloop): where it runs one block an
// SM (no other block's work covers its barriers) and its block fits with
// both sets beside a ring of at least 3 stages (chunk s + 1 has then
// landed while step s is multiplied).
template <int MODE, int T, int KC, class EPI, bool LIVE = false>
__host__ __device__ constexpr int plane_sets() {
  return MODE == kModeF32 && EPI::blocks_per_sm(T, KC) == 1 &&
                 deepest_ring<MODE, T, KC, EPI, LIVE>(2) >= 3
             ? 2
             : 1;
}

// The ring's depth: the deepest at which the blocks fit with their planes.
template <int MODE, int T, int KC, class EPI, bool LIVE = false>
__host__ __device__ constexpr int ring_stages() {
  return deepest_ring<MODE, T, KC, EPI, LIVE>(plane_sets<MODE, T, KC, EPI, LIVE>());
}

template <int MODE, int T, int KC, class EPI>
size_t tensor_smem(int k16) {
  constexpr int BM = EPI::kRows;
  const bool res = q_resident<MODE, T, KC, BM>(k16);
  constexpr int sets = plane_sets<MODE, T, KC, EPI>();
  return fixed_bytes<MODE, EPI>(sets) +
         ring_stages<MODE, T, KC, EPI>() * stage_bytes<MODE, T, KC, BM>(res) +
         sets * planes_bytes<MODE, T, KC>() +
         (res ? q_resident_bytes<MODE, T, KC, BM>(k16) : 0);
}

__device__ __forceinline__ uint32_t pack_bf16x2(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// threadIdx.x, read anew where it is called: the copy, split and fold
// offsets derived from it are then recomputed each step instead of being
// held in registers (or spilled) across the loop.
__device__ __forceinline__ int fresh_tid() {
  int t;
  asm volatile("mov.u32 %0, %%tid.x;\n" : "=r"(t));
  return t;
}

__device__ __forceinline__ int fresh_ctaid_x() {
  int v;
  asm volatile("mov.u32 %0, %%ctaid.x;\n" : "=r"(v));
  return v;
}

__device__ __forceinline__ int fresh_ctaid_y() {
  int v;
  asm volatile("mov.u32 %0, %%ctaid.y;\n" : "=r"(v));
  return v;
}

// The arguments of every instance (kernel parameters): qp the query parts
// (nq, m, k16) bf16, r (and B12's r_lo) the operand, rn its |r|^2 row; the
// block grid covers `groups` 128-column groups in partitions of
// groups_per_part; zero is 0 (see mma_fold_tile).
struct TensorParams {
  const __nv_bfloat16* qp;
  const void* r;
  const __nv_bfloat16* r_lo;
  const float* rn;
  int m, k, k16;
  long long ld;
  int n, groups, groups_per_part, zero;
};

// Where a block's rows and slots lie (grid x: row tile * kSlices + slice,
// grid y: partition), recomputed where it is used (see fresh_tid). Columns
// fit an int: they lie below n plus one column tile.
struct TensorBlock {
  int row0;     // its first query row
  int first;    // the column of tile 0's slot (0, 0)
  int jgroups;  // its slot groups, 4 a full tile
};

template <class L, int BM>
__device__ __forceinline__ TensorBlock tensor_block(int groups, int groups_per_part) {
  const int x = fresh_ctaid_x();
  const int g0 = fresh_ctaid_y() * groups_per_part;
  return {x / L::kSlices * BM, g0 * kLanes + x % L::kSlices * kTSliceLanes,
          max(0, min(groups_per_part, groups - g0)) * L::kUnitGroups};
}

// The states of a thread's 8 positions where the epilogue keeps them in
// registers across tiles (REG: EPI::kRegState in a one-chunk instance),
// else nothing.
template <class EPI, bool REG>
struct RegState {
  typename EPI::Pos q[8];
};

template <class EPI>
struct RegState<EPI, false> {};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// A generic pointer to the shared-space address `addr` (an epilogue's state
// in plain C++ loads and stores, which the compiler orders against the
// block's barriers).
template <typename P>
__device__ __forceinline__ P* shared_ptr(unsigned addr) {
  return static_cast<P*>(__cvta_shared_to_generic(addr));
}

// A thread's fold slot (two 32-bit words) at a shared-space address: the
// slot addresses are then the block's shared offsets, with no generic base
// for ptxas to hold in a register across the loop.
__device__ __forceinline__ int2 ld_slot(unsigned addr) {
  int2 v;
  asm volatile("ld.shared.v2.s32 {%0,%1}, [%2];\n" : "=r"(v.x), "=r"(v.y) : "r"(addr));
  return v;
}

__device__ __forceinline__ void st_slot(unsigned addr, int2 v) {
  asm volatile("st.shared.v2.s32 [%0], {%1,%2};\n" ::"r"(addr), "r"(v.x), "r"(v.y) : "memory");
}

// Four 8x8 b16 matrices; lanes 8i .. 8i + 7 give the rows of matrix i.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&d)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
               : "r"(smem_addr(row)));
}

// The same, each matrix transposed: from k-major rows, B fragments.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&d)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
               : "r"(smem_addr(row)));
}

// d = A . B for one m16n8k16 tile (A row-major 16x16, B column-major
// 16x8), the 16 products summed from zero.
__device__ __forceinline__ void mma_bf16_zero(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                              uint32_t b1, float zero = 0.f) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(zero));
}

// d = A . B + d for one m16n8k16 tile: the tensor core adds the 16
// products to the accumulator it is given.
__device__ __forceinline__ void mma_bf16_acc(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The first NR r parts of two f32 values (adjacent columns) as bf16x2
// words: hi, mid, lo of the 3-way split, each rounded to nearest even
// (x - hi and r1 - mid are exact in f32).
template <int NR>
__device__ __forceinline__ void split_pair(float x0, float x1, uint32_t (&b)[3]) {
  const __nv_bfloat162 hi = __floats2bfloat162_rn(x0, x1);
  b[0] = pack_bf16x2(hi);
  if constexpr (NR > 1) {
    const float2 h = __bfloat1622float2(hi);
    const float r0 = x0 - h.x;
    const float r1 = x1 - h.y;
    const __nv_bfloat162 mid = __floats2bfloat162_rn(r0, r1);
    b[1] = pack_bf16x2(mid);
    if constexpr (NR > 2) {
      const float2 md = __bfloat1622float2(mid);
      b[2] = pack_bf16x2(__floats2bfloat162_rn(r0 - md.x, r1 - md.y));
    }
  }
}

// A packed tier's T terms of NT (m16, n8) tiles that share their A
// fragments, the tiles' chains interleaved (each mma waits on its tile's
// previous one only): d[jj] = the sum of the tile's terms, term T - 1 from
// zero first, hh last. b(jj, p, h): half h of tile jj's B fragment of r
// plane p.
template <int MODE, int T, int NT, typename AFrag, typename BFrag>
__device__ __forceinline__ void packed_chain(float (&d)[NT][4], AFrag&& a, BFrag&& b,
                                             float zero) {
#pragma unroll
  for (int jj = 0; jj < NT; ++jj) {
    mma_bf16_zero(d[jj], a(term_q<MODE, T>(T - 1)), b(jj, term_r<MODE, T>(T - 1), 0),
                  b(jj, term_r<MODE, T>(T - 1), 1), zero);
  }
#pragma unroll
  for (int t = T - 2; t >= 0; --t) {
#pragma unroll
    for (int jj = 0; jj < NT; ++jj) {
      mma_bf16_acc(d[jj], a(term_q<MODE, T>(t)), b(jj, term_r<MODE, T>(t), 0),
                   b(jj, term_r<MODE, T>(t), 1));
    }
  }
}

// The T terms of one (m16, n8) tile, and the step's sum into acc. a(p):
// the A fragment of q part p; b(p, h): half h of the B fragment of r plane
// p. A packed tier (PACKED: tpu_knn's one dot over the concatenated parts)
// chains its terms through the tensor core's accumulator, from the last
// term (the smallest parts) to hh, so each mma adds its 16 products to the
// sum of the smaller terms before it (packed_chain). Every other tier sums
// each term's 16 products in a fragment of its own (an mma from zero) and
// adds the terms on the CUDA cores in tpu_knn's order, hh + (hl + lh), then
// the rest left to right.
template <int MODE, int T, bool PACKED, typename AFrag, typename BFrag>
__device__ __forceinline__ void tile_terms(float (&acc)[4], AFrag&& a, BFrag&& b,
                                           float zero = 0.f) {
  if constexpr (PACKED) {
    float d[1][4];
    packed_chain<MODE, T, 1>(d, a, [&](int, int p, int h) { return b(p, h); }, zero);
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[e] += d[0][e];
    return;
  }
  float step[4];
  float cross[4];
#pragma unroll
  for (int t = 0; t < T; ++t) {
    float dt[4];
    mma_bf16_zero(dt, a(term_q<MODE, T>(t)), b(term_r<MODE, T>(t), 0), b(term_r<MODE, T>(t), 1),
                  zero);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (t == 0) {
        step[e] = dt[e];
      } else if (T >= 3 && t == 1) {
        cross[e] = dt[e];
      } else if (T >= 3 && t == 2) {
        step[e] += cross[e] + dt[e];
      } else {
        step[e] += dt[e];
      }
    }
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += step[e];
}

// One KC-row chunk of a warp's 32 x (4 x 8) tile, 16 deep at a time: the A
// fragments of each q part, the B fragments of each r plane for a pair of
// n8 tiles, and the T terms of each (m16, n8) tile. sq: the q parts' rows of
// this chunk ([part][row][KC + kTPad]); sb: the r part planes
// ([part][KC][kTPlaneLd]); BM the block's rows. LIVE: sq holds the lr
// live rows of each part ([part][lr][KC + kTPad]), and a fragment row past
// them reads the last live row (its scores are never folded into an
// output).
template <int MODE, int T, bool PACKED, int KC, int NQ, int NR, int BM, bool LIVE = false>
__device__ __forceinline__ void mma_chunk(const __nv_bfloat16* sq, const __nv_bfloat16* sb,
                                          int wr, int wc, float (&acc)[2][kTGroups][4],
                                          int lr = BM) {
  constexpr int QLD = KC + kTPad;
  const int lane = fresh_tid() & 31;
  const int frag_row = (lane & 7) + ((lane >> 3) & 1) * 8;  // A: row of m16; B: k of k16
  const int frag_hi = lane >> 4;                            // A: k + 8; B: the pair's 2nd tile
  const __nv_bfloat16* qa = sq + (wr + frag_row) * QLD + 8 * frag_hi;
  // LIVE: the A rows of the warp's two m16 blocks, clamped to the live rows.
  const __nv_bfloat16* qa_live[2];
  if constexpr (LIVE) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      qa_live[i] = sq + min(wr + 16 * i + frag_row, lr - 1) * QLD + 8 * frag_hi;
    }
  }
  const __nv_bfloat16* rb = sb + frag_row * kTPlaneLd + frag_hi * kTSliceLanes + wc;
  // The 16-deep steps of a chunk one after another at T <= 3 (ptxas then
  // keeps every instance within 128 registers without spilling).
  constexpr int kKsUnroll = T <= 3 ? 1 : KC / 16;
#pragma unroll kKsUnroll
  for (int ks = 0; ks < KC; ks += 16) {
    uint32_t a[NQ][2][4];
#pragma unroll
    for (int p = 0; p < NQ; ++p) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if constexpr (LIVE) {
          ldmatrix_x4(a[p][i], qa_live[i] + p * lr * QLD + ks);
        } else {
          ldmatrix_x4(a[p][i], qa + (p * BM + 16 * i) * QLD + ks);
        }
      }
    }
#pragma unroll
    for (int jp = 0; jp < kTGroups / 2; ++jp) {
      uint32_t b[NR][4];
#pragma unroll
      for (int p = 0; p < NR; ++p) {
        ldmatrix_x4_trans(b[p], rb + (p * KC + ks) * kTPlaneLd + 2 * jp * kTSliceLanes);
      }
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          tile_terms<MODE, T, PACKED>(acc[i][2 * jp + jj],
                              [&](int p) -> const uint32_t(&)[4] { return a[p][i]; },
                              [&](int p, int h) { return b[p][2 * jj + h]; });
        }
      }
    }
  }
}

// A column tile that is one 16-deep chunk (k16 == 16: the ds11 shapes, and
// the packed3 term lists, which arise only there): each (m16, n8) tile is
// folded as soon as its terms are summed, so no accumulator lives beyond
// one tile and the epilogue states of the 4 positions of an m16 block sit
// in registers while its 4 groups pass. The arithmetic is mma_chunk's (acc
// from +0, one 16-deep step); the epilogue takes each position's groups in
// column order. sq: the q parts ([part][row][16 + kTPad]); sb: the r part
// planes ([part][16][kTPlaneLd]); fold: the epilogue's state; regs: the
// positions' states where the epilogue keeps them in registers; norms: the
// tile's |r|^2 row; col_t: the column of the tile's slot (0, 0).
template <int MODE, int T, bool PACKED, int NQ, int NR, class EPI>
__device__ __forceinline__ void mma_fold_tile(const __nv_bfloat16* sq, const __nv_bfloat16* sb,
                                              const float* norms, unsigned fold,
                                              RegState<EPI, EPI::kRegState>& regs,
                                              const typename EPI::Args& e,
                                              int wr, int wc, int col_t, int live_groups, int n,
                                              int zero) {
  using L = TensorLayout<EPI::kContig>;
  constexpr int QLD = 16 + kTPad;
  const int tid = fresh_tid();
  const int lane = tid & 31;
  const int frag_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int frag_hi = lane >> 4;
  const __nv_bfloat16* qa = sq + (wr + frag_row) * QLD + 8 * frag_hi;
  const __nv_bfloat16* rb = sb + frag_row * kTPlaneLd + frag_hi * kTSliceLanes + wc;
  const int lane0 = wc + 2 * (lane & 3);  // the slot lane of position l = 0
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    uint32_t a[NQ][4];
#pragma unroll
    for (int p = 0; p < NQ; ++p) ldmatrix_x4(a[p], qa + (p * EPI::kRows + 16 * i) * QLD);
    typename EPI::Pos best[2][2];  // positions (i, h, l): rows 16 i + g + 8 h, lanes lane0 + l
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int l = 0; l < 2; ++l) {
        if constexpr (EPI::kRegState) {
          best[h][l] = regs.q[4 * i + 2 * h + l];
        } else {
          best[h][l] =
              EPI::load(fold, e, 4 * i + 2 * h + l, tid, wr + 16 * i + (lane >> 2) + 8 * h);
        }
      }
    }
#pragma unroll
    for (int jp = 0; jp < kTGroups / 2; ++jp) {
      uint32_t b[NR][4];
#pragma unroll
      for (int p = 0; p < NR; ++p) {
        ldmatrix_x4_trans(b[p], rb + p * 16 * kTPlaneLd + 2 * jp * kTSliceLanes);
      }
      // A packed tier's two tiles of the pair, their chains interleaved
      // (from +0.0 through the previous fold, as below).
      [[maybe_unused]] float pair[2][4];
      if constexpr (PACKED) {
        const float c0 = __int_as_float(EPI::dep(best[0][0]) & zero);
        packed_chain<MODE, T, 2>(pair, [&](int p) -> const uint32_t(&)[4] { return a[p]; },
                                 [&](int jj, int p, int h) { return b[p][2 * jj + h]; }, c0);
      }
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int j = 2 * jp + jj;
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
        if constexpr (PACKED) {
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[e] = pair[jj][e];
        } else {
          // +0.0 (zero is 0), but through the previous tile's fold: ptxas
          // then keeps one tile's mmas in flight, not all of them, and
          // stays within 128 registers at T = 8 and 9.
          const float c0 = __int_as_float(EPI::dep(best[0][0]) & zero);
          tile_terms<MODE, T, false>(acc, [&](int p) -> const uint32_t(&)[4] { return a[p]; },
                                     [&](int p, int h) { return b[p][2 * jj + h]; }, c0);
        }
#pragma unroll
        for (int l = 0; l < 2; ++l) {
          const float nr2 = norms[j * kTSliceLanes + lane0 + l];
          const int col = col_t + j * L::kGroupStride + lane0 + l;
          const bool live = j < live_groups && col < n;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            EPI::take(fold, e, best[h][l], nr2 - 2.f * acc[2 * h + l], col,
                      j * kTSliceLanes + lane0 + l, wr + 16 * i + (lane >> 2) + 8 * h, live);
          }
        }
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int l = 0; l < 2; ++l) {
        if constexpr (EPI::kRegState) {
          regs.q[4 * i + 2 * h + l] = best[h][l];
        } else {
          EPI::store(fold, e, 4 * i + 2 * h + l, tid, best[h][l]);
        }
      }
    }
  }
}

// |r|^2 of every column of an f32 or bf16 SoA operand: one fmaf chain over
// the upcast column, d = 0..k-1 in order, one thread per column (a column's
// norm, once per call, for every row tile that folds it).
template <typename RT>
__global__ void __launch_bounds__(256)
tensor_candidates_norms_kernel(const RT* __restrict__ r, float* __restrict__ rn, int k,
                               long long ld, int n) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= n) return;
  float norm = 0.f;
#pragma unroll 8
  for (int d = 0; d < k; ++d) {
    const float x = load_f32(r + d * ld + col);
    norm = fmaf(x, x, norm);
  }
  rn[col] = norm;
}

// How a ring stage's r part arrives (the staging policy ST of the
// mainloop): SoaStaging, the k-major SoA operand in 16-byte cp.async copies
// (B1's tiers, B12 and the top-K instances); the 1-NN ladder's AoS (v3) and
// TMA (B10) policies live with their instances (tensor_ladder_kernels.cu).
// A policy gives issue (the copies of one step's r part into stage st; tid
// and blk the calling thread's and block's), wait (after the thread's
// cp.async wait: until step s's r part has landed in the stage whose
// barrier is bar, in its phase of parity `parity`; a policy without
// barriers has nothing to wait for) and split (an f32 chunk as staged into
// the part planes, once for the block). kBarriers: the policy arms one
// mbarrier a ring stage (init before the first issue). kNorms: no |r|^2
// row is staged; the block chains each column's |r|^2 over the staged
// chunks (norm_chain: slot ci's KC values in d order, fmaf into acc).
struct SoaStaging {
  static constexpr bool kBarriers = false;
  static constexpr bool kNorms = false;

  // Thread tid (of NT) copies piece tid % PIECES (group j, lanes cc ..)
  // of staged rows tid / PIECES + ROW_STEP u (row x of the stage: array x
  // / KC, B12's hi or lo, and d x % KC), so one column test serves all its
  // copies; where a round has more threads than rows, the rest copy none.
  template <int MODE, int KC, class L, int NT>
  static __device__ __forceinline__ void issue(char* st, const TensorParams& p, int it, int ic,
                                               int tid, const TensorBlock& blk, const void*,
                                               uint64_t*) {
    constexpr int ARRAYS = MODE == kModePresplit ? 2 : 1;
    constexpr int ESIZE = MODE == kModeF32 ? 4 : 2;
    constexpr int RLD = MODE == kModeF32 ? kTCols : kTPlaneLd;  // elements per staged r row
    constexpr int VEC = 16 / ESIZE;                              // elements per 16-byte copy
    constexpr int GROUP_PIECES = kTSliceLanes / VEC;             // copies per group of a row
    constexpr int PIECES = kTGroups * GROUP_PIECES;              // copies per staged row
    constexpr int ROWS = ARRAYS * KC;
    constexpr int ROW_STEP = NT / PIECES;
    static_assert(ROW_STEP > KC ? ROW_STEP % KC == 0 : KC % ROW_STEP == 0,
                  "a round's rows are whole chunks or divide one");
    constexpr int ROUNDS = (ROWS + ROW_STEP - 1) / ROW_STEP;
    const int d0 = ic * KC;
    const int rows = MODE == kModePresplit ? p.k16 : p.k;
    const int piece = tid % PIECES;
    const int drow = tid / PIECES;
    const int j = piece / GROUP_PIECES;
    const int cc = (piece % GROUP_PIECES) * VEC;
    const int col = blk.first + it * L::kTileStride + j * L::kGroupStride + cc;
    const int avail = j < blk.jgroups - it * kTGroups ? min(p.n - col, VEC) * ESIZE : 0;
    const int bytes = avail > 0 ? avail : 0;
    char* dst = st + (drow * RLD + j * kTSliceLanes + cc) * ESIZE;
    if constexpr (ROW_STEP > KC) {  // a round spans arrays: row x is array x / KC, d x % KC
      const int dd = drow % KC;
      const long long off = (static_cast<long long>(d0 + dd) * p.ld + col) * ESIZE;
      const bool live = bytes > 0 && d0 + dd < rows;
#pragma unroll 1
      for (int u = 0; u < ROUNDS; ++u) {
        const int x = drow + u * ROW_STEP;
        if (ROWS % ROW_STEP == 0 || x < ROWS) {
          const char* base =
              static_cast<const char*>(x < KC ? p.r : static_cast<const void*>(p.r_lo));
          cp_async16(dst + u * ROW_STEP * RLD * ESIZE, live ? base + off : base,
                     live ? bytes : 0);
        }
      }
    } else {
      const long long off = (static_cast<long long>(d0 + drow) * p.ld + col) * ESIZE;
#pragma unroll 1
      for (int u = 0; u < ROUNDS; ++u) {
        const int a = u * ROW_STEP / KC;   // the array (B12: hi, lo) and row of round u
        const int dd = u * ROW_STEP % KC;
        const char* base =
            static_cast<const char*>(a == 0 ? p.r : static_cast<const void*>(p.r_lo));
        const bool live = bytes > 0 && d0 + drow + dd < rows;
        cp_async16(dst + (a * KC + dd) * RLD * ESIZE, live ? base + off + dd * p.ld * ESIZE : base,
                   live ? bytes : 0);
      }
    }
  }

  static __device__ __forceinline__ uint64_t* bar(__nv_bfloat16*, int) { return nullptr; }
  static __device__ __forceinline__ void init(__nv_bfloat16*, int) {}
  static __device__ __forceinline__ void wait(uint64_t*, unsigned) {}

  // Whether an instance whose plan keeps two sets of part planes splits a
  // step ahead (AHEAD in tensor_mainloop).
  template <int T, bool RES>
  static __host__ __device__ constexpr bool ahead() {
    return true;
  }

  // Slot ci's |r|^2 chain over an f32 [d][slot] stage (a policy with
  // kNorms over the SoA stage: B10's).
  template <int KC>
  static __device__ __forceinline__ float norm_chain(const char* st, int ci, float acc,
                                                     const TensorParams&) {
    const float* sf = reinterpret_cast<const float*>(st) + ci;
#pragma unroll 8
    for (int d = 0; d < KC; ++d) acc = fmaf(sf[d * kTCols], sf[d * kTCols], acc);
    return acc;
  }

  // The chunk's split into the part planes ([part][KC][kTPlaneLd]), once
  // for the block, from the staged [d][slot] rows: thread tid (of NT)
  // splits columns 2 (tid % 64) and the next of rows tid / 64 + NT / 64 u.
  template <int NR, int KC, int NT>
  static __device__ __forceinline__ void split(const char* st, __nv_bfloat16* planes,
                                               const TensorParams&) {
    constexpr int PAIRS = kTCols / 2;
    constexpr int PAIR_ROWS = NT / PAIRS;
    static_assert(KC % PAIR_ROWS == 0, "whole rounds of pairs");
    const int tid = fresh_tid();
    const int off = (tid / PAIRS) * kTCols + (tid % PAIRS) * 2;
    const int poff = (tid / PAIRS) * kTPlaneLd + (tid % PAIRS) * 2;
#pragma unroll
    for (int u = 0; u < KC / PAIR_ROWS; ++u) {
      const float2 x = *reinterpret_cast<const float2*>(reinterpret_cast<const float*>(st) +
                                                        off + u * PAIR_ROWS * kTCols);
      uint32_t b[3];
      split_pair<NR>(x.x, x.y, b);
#pragma unroll
      for (int q = 0; q < NR; ++q) {
        *reinterpret_cast<uint32_t*>(planes + poff + (q * KC + u * PAIR_ROWS) * kTPlaneLd) = b[q];
      }
    }
  }
};

// The resident q parts of a LIVE instance (v6 at embedding width: q parts
// of the live rows only; tensor_ladder_kernels.cu) that runs one block an
// SM: at most this many bytes (its EPI::kLiveQBytes), the most any shape
// v6's guard admits needs (102,816 bytes at (k, m) = (321, 51): 16-row
// chunks of two parts, 24 bf16 a row).
constexpr size_t kQResidentLiveBytes = 101 * 1024;

// A LIVE instance's shared memory at q bytes of live rows' parts: its
// plan's fixed bytes, ring and part planes (ring_stages, plane_sets at
// EPI::kLiveQBytes), then the parts.
template <int MODE, int T, int KC, class EPI>
__host__ __device__ constexpr size_t live_smem(size_t q) {
  constexpr int sets = plane_sets<MODE, T, KC, EPI, true>();
  return fixed_bytes<MODE, EPI>(sets) + ring_stages<MODE, T, KC, EPI, true>() *
         r_stage_bytes<MODE, T, KC>() + sets * planes_bytes<MODE, T, KC>() + q;
}

// The live rows of the BM-row block whose first row is row0 (a LIVE
// instance's resident q parts: [chunk][part][row < live][KC + kTPad]).
template <int BM>
__device__ __forceinline__ int live_rows(int m, int row0) { return min(BM, m - row0); }

// The mainloop of every instance. PACKED: the term list is a packed tier's
// (tile_terms). RES: the q parts are resident (q_resident), else they ride
// in the ring. ONE: KC == k16 == 16, every
// step a whole column tile (mma_fold_tile). EPI: the epilogue (see the
// header's last paragraph), e its arguments; its kRows is the block's
// rows, BM, and 4 BM its threads. ST: the staging policy of the
// r parts, sp its argument (B10: the operand's tensor map). LIVE: the q
// parts of the block's live rows only are resident (at most
// EPI::kLiveQBytes, the plan's budget for them; a row past them reads the
// last live row's parts, and its scores are never folded into an output).
template <int T, int MODE, bool PACKED, int KC, bool RES, bool ONE, class EPI, class ST, bool LIVE>
__device__ __forceinline__ void tensor_mainloop(const TensorParams& p,
                                                const typename EPI::Args& e, const void* sp) {
  static_assert(!ONE || (KC == 16 && RES), "a one-chunk tile is 16 deep, its q parts resident");
  static_assert(!LIVE || (RES && !ONE), "live-row q parts are resident, over several chunks");
  using L = TensorLayout<EPI::kContig>;
  constexpr int BM = EPI::kRows;
  constexpr int NT = block_threads<BM>();
  constexpr int NQ = q_parts<MODE, T>();
  constexpr int NR = r_planes<MODE, T>();
  constexpr int STAGES = ring_stages<MODE, T, KC, EPI, LIVE>();
  constexpr int SETS = plane_sets<MODE, T, KC, EPI, LIVE>();
  static_assert(fits_blocks<MODE, T, KC, EPI, LIVE>(STAGES, SETS),
                "the epilogue's tensor-core blocks do not fit an SM's shared memory");
  // AHEAD: chunk s + 1 is split while step s is multiplied, into the other
  // set of part planes, so a step takes one barrier (a policy with
  // mbarriers waits on stage s + 1's before it).
  constexpr bool AHEAD = SETS == 2 && ST::template ahead<T, RES>();
  // NORMS: the staging policy stages no |r|^2 row; prepare chains each
  // column's |r|^2 over the tile's chunks, the partial sum kept in the
  // previous step's copy of the row (see prepare).
  constexpr bool NORMS = ST::kNorms;
  static_assert(!NORMS || MODE == kModeF32, "the block chains |r|^2 over f32 chunks");
  static_assert(!AHEAD || STAGES >= 3, "chunk s + 1 lands while step s is multiplied");
  constexpr int R_STAGE = static_cast<int>(r_stage_bytes<MODE, T, KC>());
  constexpr int PLANES = static_cast<int>(planes_bytes<MODE, T, KC>()) / 2;  // bf16 a set
  extern __shared__ float4 smem4[];
  // The epilogue's state at shared offset `fold`, then (f32) a copy of a
  // tile's |r|^2 row for each set of part planes.
  const unsigned fold = smem_addr(smem4);
  float* const sn_f32 =
      reinterpret_cast<float*>(reinterpret_cast<char*>(smem4) + EPI::kStateBytes);
  char* const ring = reinterpret_cast<char*>(smem4) + fixed_bytes<MODE, EPI>(SETS);
  constexpr int NORM_OFF = R_STAGE - kTNormBytes;  // a stage's |r|^2 row
  constexpr int stage = static_cast<int>(stage_bytes<MODE, T, KC, BM>(RES));
  __nv_bfloat16* const planes = reinterpret_cast<__nv_bfloat16*>(ring + STAGES * stage);
  __nv_bfloat16* const sq_res = planes + SETS * PLANES;

  const int nchunks = p.k16 / KC;
  // The block's steps (column tiles x chunks), recomputed where used.
  auto steps = [&] {
    return (tensor_block<L, BM>(p.groups, p.groups_per_part).jgroups + kTGroups - 1) / kTGroups *
           nchunks;
  };

  // Copies of the q parts' rows [row0, row0 + BM), contraction columns
  // [d0, d0 + KC), into dst[p][row][KC + kTPad] (rows >= m zero-filled):
  // thread tid copies piece tid % QCPR of row tid / QCPR of each round.
  constexpr int QCPR = KC / 8;                     // copies per q row of a chunk
  constexpr int QROWS = NT / QCPR;                 // q rows (part * BM + row) per round
  constexpr int QROUNDS = (NQ * BM + QROWS - 1) / QROWS;
  constexpr int Q_CHUNK = static_cast<int>(q_chunk_bytes<MODE, T, KC, BM>()) / 2;
  auto copy_q = [&](__nv_bfloat16* dst, int d0) {
    const int tid = fresh_tid();
    const int qc = (tid % QCPR) * 8;
#pragma unroll 1
    for (int u = 0; u < QROUNDS; ++u) {
      const int pr = u * QROWS + tid / QCPR;  // part * BM + row
      if (NQ * BM % QROWS == 0 || pr < NQ * BM) {
        const int row = tensor_block<L, BM>(p.groups, p.groups_per_part).row0 + pr % BM;
        const bool live = row < p.m;
        const __nv_bfloat16* src =
            p.qp + (static_cast<long long>(pr / BM) * p.m + row) * p.k16 + d0 + qc;
        cp_async16(dst + pr * (KC + kTPad) + qc, live ? src : p.qp, live ? 16 : 0);
      }
    }
  };

  // LIVE: the same copies of the block's lr live rows, into
  // dst[p][row < lr][KC + kTPad].
  auto copy_q_live = [&](__nv_bfloat16* dst, int d0, int lr) {
    const int tid = fresh_tid();
    const int qc = (tid % QCPR) * 8;
    const int row0 = tensor_block<L, BM>(p.groups, p.groups_per_part).row0;
#pragma unroll 1
    for (int pr = tid / QCPR; pr < NQ * lr; pr += QROWS) {
      const int part = pr / lr;
      const __nv_bfloat16* src =
          p.qp + (static_cast<long long>(part) * p.m + row0 + pr - part * lr) * p.k16 + d0 + qc;
      cp_async16(dst + pr * (KC + kTPad) + qc, src, 16);
    }
  };

  // The ring's barriers, where the staging policy keeps them (TMA: in the
  // part planes' row padding).
  auto bar = [&](int slot) { return ST::bar(planes, slot); };

  // Issue the copies of the step at (tile it, chunk ic) into ring slot:
  // the r part by the staging policy, then the tile's |r|^2 row with its
  // last chunk, and the q chunk where q is not resident.
  auto issue = [&](int it, int ic, int slot) {
    char* st = ring + slot * stage;
    const int d0 = ic * KC;
    const int tid = fresh_tid();
    const TensorBlock blk = tensor_block<L, BM>(p.groups, p.groups_per_part);
    ST::template issue<MODE, KC, L, NT>(st, p, it, ic, tid, blk, sp, bar(slot));
    if (!NORMS && ic == nchunks - 1 && tid >= NT - kTCols) {  // the tile's |r|^2 row
      const int ci = tid - (NT - kTCols);
      const int jn = ci / kTSliceLanes;
      const int cn = blk.first + it * L::kTileStride + jn * L::kGroupStride + ci % kTSliceLanes;
      const bool live = jn < blk.jgroups - it * kTGroups && cn < p.n;
      if constexpr (EPI::kDeadNormInf) {
        // The stage's slot was last read at step s - 1, which the barrier
        // before this issue ends; the store is seen after the next one.
        if (live) {
          cp_async4(st + NORM_OFF + ci * 4, p.rn + cn, 4);
        } else {
          *reinterpret_cast<float*>(st + NORM_OFF + ci * 4) = pos_inf();
        }
      } else {
        cp_async4(st + NORM_OFF + ci * 4, live ? p.rn + cn : p.rn, live ? 4 : 0);
      }
    }
    if constexpr (!RES) copy_q(reinterpret_cast<__nv_bfloat16*>(st + R_STAGE), d0);
  };

  if constexpr (ST::kBarriers) {
    ST::init(planes, STAGES);
    __syncthreads();
  }
  if constexpr (LIVE) {  // lands with step 0's copies
    const int lr = live_rows<BM>(p.m, tensor_block<L, BM>(p.groups, p.groups_per_part).row0);
    for (int cc = 0; cc < nchunks; ++cc) {
      copy_q_live(sq_res + cc * NQ * lr * (KC + kTPad), cc * KC, lr);
    }
  } else if constexpr (RES) {
    for (int cc = 0; cc < nchunks; ++cc) copy_q(sq_res + cc * Q_CHUNK, cc * KC);
  }
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps()) issue(s / nchunks, s % nchunks, s);
    cp_async_commit();
  }

  // (f32) Step x's chunk into its part planes and, at a tile's last chunk,
  // the tile's |r|^2 row into its copy: set x % 2 of each where the split
  // runs a step ahead, else the one set. NORMS: column ci's chain over
  // chunk x, from 0 at a tile's first chunk, else from the partial sum
  // that chunk x - 1 left in its copy of the row (no step reads a copy but
  // at a tile's last chunk, and only thread ci writes or reads slot ci).
  auto prepare = [&](int x) {
    const char* stx = ring + (x % STAGES) * stage;
    const int set = AHEAD ? x & 1 : 0;
    if constexpr (NORMS) {
      if (fresh_tid() >= NT - kTCols) {
        const int ci = fresh_tid() - (NT - kTCols);
        const float acc = x % nchunks == 0 ? 0.f : sn_f32[(AHEAD ? (x - 1) & 1 : 0) * kTCols + ci];
        sn_f32[set * kTCols + ci] = ST::template norm_chain<KC>(stx, ci, acc, p);
      }
    } else if (x % nchunks == nchunks - 1 && fresh_tid() >= NT - kTCols) {
      const int ci = fresh_tid() - (NT - kTCols);
      sn_f32[set * kTCols + ci] = reinterpret_cast<const float*>(stx + NORM_OFF)[ci];
    }
    ST::template split<NR, KC, NT>(stx, planes + set * PLANES, p);
  };
  if constexpr (AHEAD) {  // step 0's chunk, before the loop
    cp_async_wait<STAGES - 2>();
    if constexpr (ST::kBarriers) {
      if (steps() > 0) ST::wait(bar(0), 0);
    }
    __syncthreads();
    if (steps() > 0) prepare(0);
  }

  // The epilogue's state, before the first tile (the loop's first barrier
  // orders it before every read); where it lives in registers, each
  // position's first state.
  EPI::init(fold, e, p);
  constexpr bool REG = EPI::kRegState && ONE;
  RegState<EPI, REG> regs;
  if constexpr (REG) {
    const int rtid = fresh_tid();
#pragma unroll
    for (int q = 0; q < 8; ++q) {  // q = 4 i + 2 h + l: row 32 (w / 4) + 16 i + g + 8 h
      regs.q[q] = EPI::start(e, p, (rtid >> 7) * 32 + 16 * (q >> 2) + (rtid & 31) / 4 +
                                       8 * (q >> 1 & 1));
    }
  }
  // The thread's 8 (row, lane) positions: rows wr + 16 i + g + 8 h, slot
  // lanes wc + 2 tg + l (position 4 i + 2 h + l); acc[i][j][2 h + l] is
  // that position's slot in group j of the tile, zeroed at each tile's
  // first chunk (so no accumulator is live from a tile's fold, through
  // EPI::tile_end, to the next tile).
  float acc[2][kTGroups][4];

  int t = 0, c = 0;  // the step being multiplied, as (tile, chunk)
  for (int s = 0; s < steps(); ++s) {
    if constexpr (AHEAD) {
      cp_async_wait<STAGES - 3>();  // step s + 1 has landed (this thread's copies)
      if constexpr (ST::kBarriers) {
        if (s + 1 < steps()) ST::wait(bar((s + 1) % STAGES), ((s + 1) / STAGES) & 1);
      }
    } else {
      cp_async_wait<STAGES - 2>();  // step s has landed (this thread's copies)
      ST::wait(bar(s % STAGES), (s / STAGES) & 1);
    }
    __syncthreads();  // ... and every thread's; step s - 1 is done with
    if constexpr (EPI::kDeferTileEnd) {
      if (c == 0 && t > 0) EPI::tile_end(fold, e, p, t - 1);  // its last takes are in
    }
    if (s + STAGES - 1 < steps()) {
      int it = t, ic = c + STAGES - 1;  // the step to issue, STAGES - 1 ahead
      while (ic >= nchunks) {
        ic -= nchunks;
        ++it;
      }
      issue(it, ic, (s + STAGES - 1) % STAGES);
    }
    cp_async_commit();
    const char* st = ring + (s % STAGES) * stage;
    const bool last = c == nchunks - 1;
    if constexpr (AHEAD) {
      if (s + 1 < steps()) prepare(s + 1);
    } else if constexpr (MODE == kModeF32) {
      prepare(s);
      __syncthreads();  // the planes are written
    }
    // The tile's |r|^2 row, at the last chunk: the stage's, or in f32 mode
    // its copy; the step's part planes (f32) or its stage.
    const int set = AHEAD ? s & 1 : 0;
    const float* sn = MODE == kModeF32 ? sn_f32 + set * kTCols
                                       : reinterpret_cast<const float*>(st + NORM_OFF);
    const __nv_bfloat16* sb =
        MODE == kModeF32 ? planes + set * PLANES : reinterpret_cast<const __nv_bfloat16*>(st);
    const int wtid = fresh_tid();
    const int wr = (wtid >> 7) * 32;     // the warp's first row of the tile
    const int wc = (wtid >> 5 & 3) * 8;  // its first lane of the slot groups
    if (tensor_block<L, BM>(p.groups, p.groups_per_part).row0 + wr < p.m) {
      int lr = BM;
      const __nv_bfloat16* sq;
      if constexpr (LIVE) {
        lr = live_rows<BM>(p.m, tensor_block<L, BM>(p.groups, p.groups_per_part).row0);
        sq = sq_res + c * NQ * lr * (KC + kTPad);
      } else {
        sq = RES ? sq_res + c * Q_CHUNK : reinterpret_cast<const __nv_bfloat16*>(st + R_STAGE);
      }
      if constexpr (ONE) {
        const TensorBlock blk = tensor_block<L, BM>(p.groups, p.groups_per_part);
        mma_fold_tile<MODE, T, PACKED, NQ, NR, EPI>(sq, sb, sn, fold, regs, e, wr, wc,
                                                    blk.first + t * L::kTileStride,
                                                    blk.jgroups - t * kTGroups, p.n, p.zero);
      } else {
        if (c == 0) {
#pragma unroll
          for (int i = 0; i < 2; ++i) {
#pragma unroll
            for (int j = 0; j < kTGroups; ++j) {
#pragma unroll
              for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;
            }
          }
        }
        mma_chunk<MODE, T, PACKED, KC, NQ, NR, BM, LIVE>(sq, sb, wr, wc, acc, lr);
        if (last) {
          // The tile's scores s = |r|^2 - 2 acc to the epilogue, position
          // by position, its groups in column order.
          const TensorBlock blk = tensor_block<L, BM>(p.groups, p.groups_per_part);
          const int live_groups = blk.jgroups - t * kTGroups;
          const int col_t = blk.first + t * L::kTileStride;
#pragma unroll
          for (int l = 0; l < 2; ++l) {
            const int lane = wc + 2 * (wtid & 3) + l;
            float nr2[kTGroups];
#pragma unroll
            for (int j = 0; j < kTGroups; ++j) nr2[j] = sn[j * kTSliceLanes + lane];
#pragma unroll
            for (int i = 0; i < 2; ++i) {
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int q = 4 * i + 2 * h + l;
                const int rl = wr + 16 * i + (wtid & 31) / 4 + 8 * h;
                typename EPI::Pos best = EPI::load(fold, e, q, wtid, rl);
#pragma unroll
                for (int j = 0; j < kTGroups; ++j) {
                  const int col = col_t + j * L::kGroupStride + lane;
                  EPI::take(fold, e, best, nr2[j] - 2.f * acc[i][j][2 * h + l], col,
                            j * kTSliceLanes + lane, rl, j < live_groups && col < p.n);
                }
                EPI::store(fold, e, q, wtid, best);
              }
            }
          }
        }
      }
    }
    if (!EPI::kDeferTileEnd && last) EPI::tile_end(fold, e, p, t);
    if (++c == nchunks) {
      c = 0;
      ++t;
    }
  }
  if constexpr (EPI::kDeferTileEnd) {  // the last tile's
    __syncthreads();
    if (t > 0) EPI::tile_end(fold, e, p, t - 1);
  }
  cp_async_wait<0>();
  if constexpr (REG) {
    EPI::finish(e, p, regs.q);
  } else {
    EPI::finish(fold, e, p);
  }
}

// B1's tiers, B12 and the top-K instances: the mainloop over the SoA
// operand.
template <int T, int MODE, bool PACKED, int KC, bool RES, bool ONE, class EPI>
__global__ void __launch_bounds__(block_threads<EPI::kRows>(), EPI::blocks_per_sm(T, KC))
tensor_kernel(const TensorParams p, const typename EPI::Args e) {
  tensor_mainloop<T, MODE, PACKED, KC, RES, ONE, EPI, SoaStaging, false>(p, e, nullptr);
}

// The host side of a launch.
struct TensorArgs {
  const __nv_bfloat16* qp;
  const void* r;
  const __nv_bfloat16* r_lo;
  const float* rn;
  int m, k, k16;
  long long ld;
  int n, parts, groups, gpp;
  Terms terms;
  cudaStream_t stream;
};

// The arguments of a launch whose grid covers [0, n) in `parts`
// partitions of whole 128-column groups.
inline TensorArgs tensor_args(const void* qp, const void* r, const void* r_lo, const float* rn,
                              int m, int k, long long ld, int n, int parts, int term_q,
                              int term_r, void* stream) {
  return TensorArgs{static_cast<const __nv_bfloat16*>(qp), r,
                    static_cast<const __nv_bfloat16*>(r_lo), rn, m, k, (k + 15) / 16 * 16, ld, n,
                    parts, (n + kLanes - 1) / kLanes, groups_per_part(n, parts),
                    Terms{term_q, term_r}, static_cast<cudaStream_t>(stream)};
}

// Whether a launch's pointers and row stride suit the 16-byte copies.
inline bool tensor_operands_aligned(const void* qp, const void* r, const void* r_lo,
                                    long long ld, int mode) {
  const int esize = mode == kModeF32 ? 4 : 2;
  return (ld * esize) % 16 == 0 && reinterpret_cast<uintptr_t>(qp) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(r) % 16 == 0 && reinterpret_cast<uintptr_t>(r_lo) % 16 == 0;
}

template <int T, int MODE, bool PACKED, int KC, bool RES, bool ONE, class EPI>
int launch_tensor(const TensorArgs& a, const typename EPI::Args& e) {
  if constexpr (MODE != kModePresplit) {
    // The norm row the kernel folds with, into the caller's scratch.
    const int blocks = (a.n + 255) / 256;
    if (MODE == kModeF32) {
      tensor_candidates_norms_kernel<<<blocks, 256, 0, a.stream>>>(static_cast<const float*>(a.r),
                                                         const_cast<float*>(a.rn), a.k, a.ld, a.n);
    } else {
      tensor_candidates_norms_kernel<<<blocks, 256, 0, a.stream>>>(
          static_cast<const __nv_bfloat16*>(a.r), const_cast<float*>(a.rn), a.k, a.ld, a.n);
    }
    if (const cudaError_t err = cudaGetLastError()) return static_cast<int>(err);
  }
  using L = TensorLayout<EPI::kContig>;
  const size_t smem = tensor_smem<MODE, T, KC, EPI>(a.k16);
  auto kernel = tensor_kernel<T, MODE, PACKED, KC, RES, ONE, EPI>;
  if (const int err = allow_smem(kernel, smem)) return err;
  const int tiles = (a.m + EPI::kRows - 1) / EPI::kRows;
  const TensorParams p{a.qp, a.r, a.r_lo, a.rn, a.m, a.k, a.k16, a.ld, a.n, a.groups, a.gpp, 0};
  kernel<<<dim3(tiles * L::kSlices, a.parts), block_threads<EPI::kRows>(), smem, a.stream>>>(p,
                                                                                             e);
  return static_cast<int>(cudaGetLastError());
}

template <int T, int MODE, int KC, class EPI>
int launch_tensor_res(const TensorArgs& a, const typename EPI::Args& e) {
  return q_resident<MODE, T, KC, EPI::kRows>(a.k16)
             ? launch_tensor<T, MODE, false, KC, true, false, EPI>(a, e)
             : launch_tensor<T, MODE, false, KC, false, false, EPI>(a, e);
}

// Whether a term list's terms are checked against the instance's, packed
// flag included.
template <int MODE, int T, bool PACKED>
bool instance_matches(const Terms& terms) {
  constexpr Terms want = instance_terms<MODE, T>();
  return terms.q == want.q && terms.r == (want.r | (PACKED ? kPackedSum : 0));
}

template <int T, int MODE, bool PACKED, class EPI>
int launch_tensor_kc(const TensorArgs& a, const typename EPI::Args& e) {
  if (!instance_matches<MODE, T, PACKED>(a.terms)) return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (PACKED) {
    // A packed tier's one width: k16 == 16 for packed3's three q parts (one
    // 16-row chunk per column tile), 32 for packed2's two (one 32-row chunk,
    // the q parts resident).
    if constexpr (q_parts<MODE, T>() == 3) {
      if (a.k16 == 16) return launch_tensor<T, MODE, true, 16, true, true, EPI>(a, e);
    } else {
      if (a.k16 == 32) return launch_tensor<T, MODE, true, 32, true, false, EPI>(a, e);
    }
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    // One 16-row chunk per column tile at k16 == 16; else 32-row chunks
    // where k16 allows, else 16 (k16 an odd multiple of 16). At T = 4 16-row
    // chunks only: at 32 its terms' registers spilled (the same 16-deep
    // steps in the same order, so the same scores).
    if (a.k16 == 16) return launch_tensor<T, MODE, false, 16, true, true, EPI>(a, e);
    if constexpr (T == 4) {
      return launch_tensor_res<T, MODE, 16, EPI>(a, e);
    } else {
      return a.k16 % 32 == 0 ? launch_tensor_res<T, MODE, 32, EPI>(a, e)
                             : launch_tensor_res<T, MODE, 16, EPI>(a, e);
    }
  }
}

// The instance for (mode, nterms, packed flag) of the f32 and bf16 operand
// modes (the tiers over an f32 or bf16 SoA operand), else
// cudaErrorInvalidValue: packed3's lists (8 and 9 terms over f32, their 3
// over bf16) are packed only, packed2's 4 over f32 (2 over bf16) are also
// bf16x4's (bf16x3's, bf16x4's and qsplit2's).
template <class EPI>
int dispatch_tensor(const TensorArgs& a, const typename EPI::Args& e, int mode, int nterms) {
  const bool packed = (a.terms.r & kPackedSum) != 0;
  switch (mode) {
    case kModeF32:
      switch (nterms) {
        case 1: return launch_tensor_kc<1, kModeF32, false, EPI>(a, e);
        case 2: return launch_tensor_kc<2, kModeF32, false, EPI>(a, e);
        case 3: return launch_tensor_kc<3, kModeF32, false, EPI>(a, e);
        case 4:
          return packed ? launch_tensor_kc<4, kModeF32, true, EPI>(a, e)
                        : launch_tensor_kc<4, kModeF32, false, EPI>(a, e);
        case 8: return launch_tensor_kc<8, kModeF32, true, EPI>(a, e);
        case 9: return launch_tensor_kc<9, kModeF32, true, EPI>(a, e);
        default: return static_cast<int>(cudaErrorInvalidValue);
      }
    case kModeBF16:
      switch (nterms) {
        case 1: return launch_tensor_kc<1, kModeBF16, false, EPI>(a, e);
        case 2:
          return packed ? launch_tensor_kc<2, kModeBF16, true, EPI>(a, e)
                        : launch_tensor_kc<2, kModeBF16, false, EPI>(a, e);
        case 3: return launch_tensor_kc<3, kModeBF16, true, EPI>(a, e);
        default: return static_cast<int>(cudaErrorInvalidValue);
      }
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The common checks of an entry: an f32 or bf16 operand (mode 0 or 1) with
// rn scratch, a geometry the grid can take, 16-byte aligned operands.
inline bool tensor_entry_valid(const void* qp, const void* r, const float* rn, int m, int k,
                               long long ld, int n, int parts, int mode) {
  return (mode == kModeF32 || mode == kModeBF16) && rn != nullptr &&
         valid_geometry(m, k, ld, n, parts) && parts <= kMaxGridY && n <= (1 << 30) &&
         tensor_operands_aligned(qp, r, nullptr, ld, mode);
}

// B1's (score, index) fold slots of a BM-row block: each thread's 8
// positions' running pairs, [position][thread], at the start of an
// epilogue's state. B1 and B4 keep them so.
template <int BM>
__host__ __device__ constexpr size_t fold_slot_bytes() {
  return static_cast<size_t>(8) * block_threads<BM>() * sizeof(int2);
}

template <int BM>
__device__ __forceinline__ unsigned fold_slot(unsigned fold, int q, int tid) {
  return fold + (q * block_threads<BM>() + tid) * 8;
}

// Write the lane-slice epilogues' pairs (B1, B4) to the (m, parts*128)
// candidate outputs: position (i, h, l) of thread tid is row row0 + 32 *
// (tid / 128) + 16 i + (tid % 32) / 4 + 8 h, lane slice * 32 + 8 * (tid / 32
// % 4) + 2 (tid % 4) + l; BM the block's rows.
template <int BM>
__device__ __forceinline__ void write_candidates(unsigned fold, int32_t* __restrict__ out_i,
                                                 float* __restrict__ out_s, int m, int groups,
                                                 int groups_per_part) {
  const int tid = threadIdx.x;
  const TensorBlock blk = tensor_block<TensorLayout<false>, BM>(groups, groups_per_part);
  const long long width = static_cast<long long>(gridDim.y) * kLanes;
  const int lane0 = blk.first % kLanes + (tid >> 5 & 3) * 8 + 2 * (tid & 3);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = blk.row0 + (tid >> 7) * 32 + 16 * i + (tid & 31) / 4 + 8 * h;
      if (row < m) {
        const int2 b0 = ld_slot(fold_slot<BM>(fold, 4 * i + 2 * h, tid));
        const int2 b1 = ld_slot(fold_slot<BM>(fold, 4 * i + 2 * h + 1, tid));
        const long long o = row * width + static_cast<long long>(blockIdx.y) * kLanes + lane0;
        *reinterpret_cast<int2*>(out_i + o) = make_int2(b0.y, b1.y);
        *reinterpret_cast<float2*>(out_s + o) =
            make_float2(__int_as_float(b0.x), __int_as_float(b1.x));
      }
    }
  }
}

}  // namespace
