// The 1-NN ladder's rungs at tpu_knn's score tier: B1's v3 and v6 variants
// and B10 as instances of the tensor-core mainloop (tensor_mainloop.cuh),
// for every term-list tier (tiers.term_list; "highest" stays on the tiled
// f32 kernels of fused_kernels.cu).
//
// v3 at a tier — replaces tpu_knn/kernels/fused.py:318 _fused_kernel built
// with soa=False (fused.py:340, _score_tile over the AoS block) at the tier
// fused_knn resolves: the mainloop under the AoS staging policy, reading
// the caller's row-major (n, k) array with no per-call SoA relayout. A lane
// slice's 32 columns of one group are 32 consecutive points, so a stage's
// chunk of them is KC values of each point (one contiguous span of 128 k
// bytes at k == KC, else KC values every k): 16-byte cp.async copies of
// four values where the array's base and row stride allow, else 4-byte
// ones, into a [slot][d] stage whose 16-byte quads are XOR-swizzled by slot
// (AosStaging::offset), so the split's float4 reads of eight consecutive
// slots fall in eight distinct quads of the 128 banks. The split that runs
// once per staged f32 chunk transposes it: a thread reads four d of one
// slot, trades two of them with the neighbouring slot's thread (one shuffle
// each), and writes two rows of the column pair's bf16x2 part words into
// the k-major planes, which the ldmatrix/mma path then reads as B1's. The
// copies and the split serve any block of 4 BM threads (BM 32 or 128). The
// ring keeps B1's bytes and depth. ‖r‖² is one fmaf chain over each
// point's values, d = 0..k-1, chained by the block over the staged chunks
// (kNorms: B1's norm pass's chain over the same values, zeros past k), so
// where the term lists agree v3's scores are B1's bit for bit, and the
// launch reads the array once.
// tpu_knn does not pad k in an AoS block (fused.py:402-405), so "packed"
// takes _packed_terms(k): 9 terms at k = 9..14 (B1's packed3 at k_pad 8),
// where the SoA path takes 8.
//
// B10 at a tier — replaces tpu_knn/kernels/dma_pipeline.py:44 _dma_kernel
// at the tier dma_knn resolves: the mainloop under the TMA staging policy,
// indices only. A stage's r part is KC rows x 4 groups of 32 lanes, the
// groups 128 floats apart: one 3-D tensor map (lanes, groups at a 512-byte
// stride, rows at ld) with box (32, 4, KC) lands it as [d][group][lane],
// B1's SoA stage, so the split and everything after it are B1's and B10's
// indices equal B1's at the same P bit for bit. Thread 0 arms the stage's
// mbarrier with the box's bytes (rows past k and groups past ld / 128 come
// back zero and count) and issues the copy; every thread waits on the
// stage's phase parity after its cp.async wait (the q parts stay on
// cp.async), the stage of step s + 1 during step s where the split runs a
// step ahead. ‖r‖² is chained by the block over the staged chunks, as
// v3's (kNorms). The barriers sit in the first plane set's row padding
// (bf16 columns 128..135, which neither set's split writes and no
// fragment reads), so the plan is B1's to the byte and the ring as deep.
//
// v6 at a tier — replaces _fused_kernel as tpu_knn's v6 builds it
// (fused_knn(soa=True, tile_m=round_up(m, 8)), fused.py:1044-1050): the q
// parts stay resident in shared memory at every shape v6's guard admits (k
// m <= 16384 floats). Where a 64-row block's parts fit kQResidentBytes
// (every k <= 80, ds11 among them) that is B1's own tier launch
// (tk_tensor_candidates). Above, the live-row instance (tensor_live_kernel)
// keeps the parts of the block's live rows only (LIVE: at most 16384 + 64 *
// 15 values a part, 101 KB with the pad, kQResidentLiveBytes); a fragment
// row past the live rows reads the last live row, and its scores are never
// written. It stages the SoA operand under LiveStaging, which chains each
// column's |r|^2 in the block over the staged chunks (kNorms, B10's chain
// over the SoA stage: B1's norm pass's bits, without its second read of the
// operand), and its plan follows m (LiveEpi<BM, BPS>, chosen on the host,
// tiers.tensor_live_epilogue): 64-row blocks of 8 warps, one an SM, the
// split a step ahead (two plane sets beside a 4-stage ring even at
// kQResidentLiveBytes of parts); at m <= 32 where the live rows' parts fit
// a 32-row block's q_resident_limit (15 KB: m = 1 up to k = 2048 at
// bf16x3), 32-row blocks of 4 warps, two an SM, each chunk split at its
// step (at (768, 1, 2^20) 1.82 ms against the 64-row block's 2.18). A
// 32-row block alone on an SM (4 warps, twice the split a thread) measured
// 3.35 ms at (768, 16 and 21, 2^20) against 2.18 (PERF.md §6), so m <= 32
// takes 64-row blocks where two 32-row ones do not fit. Each plan is
// checked at compile time at its budget (EPI::kLiveQBytes); a launch
// checks the live rows' bytes against it.
//
// Bound on the H100: as B1's tiers, tensor-core operations T * 2 * m * n *
// k16 at 989 TFLOP/s, beside which the operand is read once (at m of a few
// rows the read, 4 k n bytes: ds8, ds9).
//
// Block heights (chosen by m on the host, tiers.ladder_epilogue): v3 and
// B10 run B1's block above m = 32, 128 rows of 16 warps, one an SM, whose
// ring keeps two plane sets, so the split runs a step ahead; at m <= 32,
// 32-row blocks of 4 warps (every warp on live rows), two an SM, 20-30%
// faster at m = 1 than the 128-row blocks (PERF.md §6). v6's live rows:
// tiers.tensor_live_epilogue, as above.

#include <type_traits>

#include "tensor_mainloop.cuh"
#include "tiled.cuh"

namespace {

// ---- the staging policies --------------------------------------------------

// The AoS policy (v3): the r part of a stage is [slot][KC] f32, slot s's
// 16-byte quad qd at quad qd ^ swizzle(s) of its row, so the eight slots of
// a float4 read phase (or of a copy phase) land in eight distinct quads of
// 128 bytes: with 4 quads a row (KC 16) two rows share 128 bytes and the
// swizzle is (s / 2) % 4, with 8 (KC 32) it is s % 8. Bytes: B1's stage.
// Or, in a one-chunk instance (ONE: k16 == KC == 16) where the points are
// packed k < 16 floats apart with k % 4 != 0 (ds8, ds10: k = 3), each
// group's 32 points as the contiguous span they are, [slot][k] (spans): 8 k
// 16-byte copies a group in place of one 4-byte copy a value, the split
// and the norm chain reading slot s's values k floats apart (an odd k hits
// 32 distinct banks).
template <bool ONE>
struct AosStaging : SoaStaging {
  static constexpr bool kNorms = true;

  static __device__ __forceinline__ bool spans(const TensorParams& p) {
    return ONE && p.ld == p.k && p.k % 4 != 0 && (reinterpret_cast<uintptr_t>(p.r) & 15) == 0;
  }

  template <int KC>
  static __device__ __forceinline__ int offset(int s, int qd) {
    constexpr int Q = KC / 4;  // quads a slot
    static_assert(Q == 4 || Q == 8, "16- or 32-row chunks");
    return s * KC + 4 * (qd ^ ((s / (8 / Q)) & (Q - 1)));
  }

  // The chunk's copies: spans, thread tid copies quads e = tid + NT u of
  // the tile's 4 spans (span j's quad e % 8 k); with 16-byte copies (ld % 4
  // == 0, a 16-byte aligned array) quad e % Q of slot e / Q, e = tid + NT
  // u, consecutive threads reading consecutive quads of one point; else
  // one value a copy, consecutive threads consecutive d. Values past k, and
  // slots past the live groups or n, are zero-filled without a read.
  template <int MODE, int KC, class L, int NT>
  static __device__ __forceinline__ void issue(char* st, const TensorParams& p, int it, int ic,
                                               int tid, const TensorBlock& blk, const void*,
                                               uint64_t*) {
    static_assert(MODE == kModeF32, "the AoS policy stages the f32 points");
    constexpr int Q = KC / 4;
    static_assert(kTCols * Q % NT == 0 && NT % kTCols == 0, "whole rounds of copies");
    const int d0 = ic * KC;
    const float* r = static_cast<const float*>(p.r);
    float* sf = reinterpret_cast<float*>(st);
    const int live_groups = blk.jgroups - it * kTGroups;
    const int col0 = blk.first + it * L::kTileStride;
    if (spans(p)) {
      const int quads = 8 * p.k;
#pragma unroll 1
      for (int e = tid; e < kTGroups * quads; e += NT) {
        const int j = e / quads;
        const int qq = e - j * quads;
        const int col = col0 + j * L::kGroupStride;
        const int points = j < live_groups ? min(max(p.n - col, 0), kTSliceLanes) : 0;
        const int vals = min(max(points * p.k - 4 * qq, 0), 4);
        cp_async16(sf + j * kTSliceLanes * p.k + 4 * qq,
                   vals ? r + static_cast<long long>(col) * p.k + 4 * qq : r, 4 * vals);
      }
    } else if (p.ld % 4 == 0 && (reinterpret_cast<uintptr_t>(p.r) & 15) == 0) {
#pragma unroll 1
      for (int u = 0; u < kTCols * Q / NT; ++u) {
        const int e = u * NT + tid;
        const int s = e / Q;
        const int qd = e % Q;
        const int j = s / kTSliceLanes;
        const int col = col0 + j * L::kGroupStride + s % kTSliceLanes;
        const int d = d0 + 4 * qd;
        const int vals = j < live_groups && col < p.n ? min(max(p.k - d, 0), 4) : 0;
        cp_async16(sf + offset<KC>(s, qd), vals ? r + static_cast<long long>(col) * p.ld + d : r,
                   4 * vals);
      }
    } else {
#pragma unroll 1
      for (int u = 0; u < kTCols * KC / NT; ++u) {
        const int e = u * NT + tid;
        const int s = e / KC;
        const int dd = e % KC;
        const int j = s / kTSliceLanes;
        const int col = col0 + j * L::kGroupStride + s % kTSliceLanes;
        const bool live = j < live_groups && col < p.n && d0 + dd < p.k;
        cp_async4(sf + offset<KC>(s, dd / 4) + dd % 4,
                  live ? r + static_cast<long long>(col) * p.ld + d0 + dd : r, live ? 4 : 0);
      }
    }
  }

  // The split, transposing: thread tid reads quad qd = tid / 128 + NT / 128
  // u of slot s = tid % 128 (four d of one column); the even slot of a column
  // pair keeps rows 4 qd, 4 qd + 1 and the odd one rows 4 qd + 3, 4 qd + 2,
  // each trading the other two values with its neighbour, and writes the
  // pair's part words of its two rows into the planes [part][KC][kTPlaneLd]
  // (the SoA split's values, so its bits).
  template <int NR, int KC, int NT>
  static __device__ __forceinline__ void split(const char* st, __nv_bfloat16* planes,
                                               const TensorParams& p) {
    constexpr int ROUNDS = kTCols * (KC / 4) / NT;
    const float* sf = reinterpret_cast<const float*>(st);
    const bool span = spans(p);
#pragma unroll
    for (int u = 0; u < ROUNDS; ++u) {
      const int tid = fresh_tid();
      const int s = tid % kTCols;
      const int qd = tid / kTCols + (NT / kTCols) * u;
      const float4 v = span ? span_quad(sf, s, qd, p.k)
                            : *reinterpret_cast<const float4*>(sf + offset<KC>(s, qd));
      const bool odd = s & 1;
      const float g0 = __shfl_xor_sync(0xffffffffu, odd ? v.x : v.z, 1);
      const float g1 = __shfl_xor_sync(0xffffffffu, odd ? v.y : v.w, 1);
      const int row = 4 * qd + (odd ? 3 : 0);
      const int step = odd ? -1 : 1;
      __nv_bfloat16* dst = planes + row * kTPlaneLd + (s & ~1);
      uint32_t b[3];
      split_pair<NR>(odd ? g1 : v.x, odd ? v.w : g0, b);
#pragma unroll
      for (int q = 0; q < NR; ++q) *reinterpret_cast<uint32_t*>(dst + q * KC * kTPlaneLd) = b[q];
      split_pair<NR>(odd ? g0 : v.y, odd ? v.z : g1, b);
#pragma unroll
      for (int q = 0; q < NR; ++q) {
        *reinterpret_cast<uint32_t*>(dst + (q * KC + step) * kTPlaneLd) = b[q];
      }
    }
  }

  // Values 4 qd .. 4 qd + 3 of slot s of a spans stage, zeros past k.
  static __device__ __forceinline__ float4 span_quad(const float* sf, int s, int qd, int k) {
    const float* v = sf + s * k + 4 * qd;
    const int left = k - 4 * qd;
    return make_float4(left > 0 ? v[0] : 0.f, left > 1 ? v[1] : 0.f, left > 2 ? v[2] : 0.f,
                       left > 3 ? v[3] : 0.f);
  }

  // Slot s's |r|^2 chain over the chunk: its values in d order.
  template <int KC>
  static __device__ __forceinline__ float norm_chain(const char* st, int s, float acc,
                                                     const TensorParams& p) {
    const float* sf = reinterpret_cast<const float*>(st);
    if (spans(p)) {
#pragma unroll 1
      for (int d = 0; d < p.k; ++d) acc = fmaf(sf[s * p.k + d], sf[s * p.k + d], acc);
      return acc;
    }
#pragma unroll 1
    for (int qd = 0; qd < KC / 4; ++qd) {
      const float4 v = *reinterpret_cast<const float4*>(sf + offset<KC>(s, qd));
      acc = fmaf(v.x, v.x, acc);
      acc = fmaf(v.y, v.y, acc);
      acc = fmaf(v.z, v.z, acc);
      acc = fmaf(v.w, v.w, acc);
    }
    return acc;
  }

  // At T = 4 with the q chunks in the ring (bf16x4 at k > 80) the
  // transposing split a step ahead spilled at 128 registers (ptxas): that
  // instance splits each chunk at its step.
  template <int T, bool RES>
  static __host__ __device__ constexpr bool ahead() {
    return RES || T != 4;
  }
};

// The TMA policy (B10): the SoA stage by one tensor-map copy a step, B1's
// split after it.
struct TmaStaging : SoaStaging {
  static constexpr bool kBarriers = true;
  static constexpr bool kNorms = true;

  // Stage slot's barrier: 8 bytes of the padding of the first plane set's
  // row slot / 2.
  static __device__ __forceinline__ uint64_t* bar(__nv_bfloat16* planes, int slot) {
    return reinterpret_cast<uint64_t*>(planes + (slot >> 1) * kTPlaneLd + kTCols + 4 * (slot & 1));
  }

  static __device__ __forceinline__ void init(__nv_bfloat16* planes, int stages) {
    if (threadIdx.x == 0) {
      for (int s = 0; s < stages; ++s) mbarrier_init(bar(planes, s), 1);
      fence_mbarrier_init();
    }
  }

  static __device__ __forceinline__ void wait(uint64_t* b, unsigned parity) {
    mbarrier_wait_parity(b, parity);
  }

  // One box (32 lanes, 4 groups, KC rows) at the block's lane slice, the
  // tile's first group and the chunk's first row (sp: the tensor map).
  template <int MODE, int KC, class L, int NT>
  static __device__ __forceinline__ void issue(char* st, const TensorParams&, int it, int ic,
                                               int tid, const TensorBlock& blk, const void* sp,
                                               uint64_t* b) {
    static_assert(MODE == kModeF32 && L::kSlices == kTSlices,
                  "the TMA policy stages f32 lane slices");
    if (tid == 0) {
      fence_proxy_async();
      mbarrier_arrive_expect_tx(b, KC * kTCols * sizeof(float));
      tma_load_3d(st, static_cast<const CUtensorMap*>(sp), b, blk.first % kLanes,
                  blk.first / kLanes + it * kTGroups, ic * KC);
    }
  }
};

// The live-row policy (v6): the SoA stage, each column's |r|^2 chained in
// the block over it (SoaStaging::norm_chain), no norm pass.
struct LiveStaging : SoaStaging {
  static constexpr bool kNorms = true;
};

static_assert((kTMaxStages + 1) / 2 <= 16 && 4 * sizeof(__nv_bfloat16) == sizeof(uint64_t) &&
                  kTPlaneLd - kTCols == 8,
              "the padding of the planes' first 16 rows holds two barriers a row");

// ---- the epilogue: B1's per-lane fold (tensor_kernels.cu CandidatesEpi) ----

constexpr int kLadderRows = 128;      // v3's and B10's block (tiers.TENSOR_LADDER_TILE_M)
constexpr int kLadderServeRows = 32;  // theirs at m <= 32 (tiers.LADDER_SERVE_ROWS)

// The outputs: scores and indices (v3, v6) or the indices only (B10).
struct LadderArgs {
  int32_t* out_i;
  float* out_s;
};

// B1's fold at BM rows (kLadderRows, kLadderServeRows, or kTBM for v6's
// live rows), writing scores and indices (SCORES) or the indices only;
// two blocks an SM at kLadderServeRows (each splitting a chunk at its
// step: a step ahead there measured 1-3% slower at m = 1), else one.
template <bool SCORES, int BM>
struct LadderEpi {
  static constexpr bool kContig = false;
  static constexpr int kRows = BM;
  static constexpr bool kDeferTileEnd = false;
  static constexpr bool kRegState = false;
  static constexpr bool kDeadNormInf = false;
  static constexpr int kBlocksPerSm = BM == kLadderServeRows ? 2 : 1;
  static constexpr int blocks_per_sm(int, int) { return kBlocksPerSm; }
  static constexpr size_t kStateBytes = fold_slot_bytes<kRows>();
  using Args = LadderArgs;
  using Pos = int2;
  static __device__ __forceinline__ void init(unsigned fold, const Args&, const TensorParams&) {
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      st_slot(fold_slot<kRows>(fold, q, threadIdx.x),
              make_int2(__float_as_int(pos_inf()), kI32Max));
    }
  }
  static __device__ __forceinline__ Pos load(unsigned fold, const Args&, int q, int tid, int) {
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
    if constexpr (SCORES) {
      write_candidates<kRows>(fold, e.out_i, e.out_s, p.m, p.groups, p.groups_per_part);
    } else {
      // write_candidates' positions, the indices only.
      const int tid = threadIdx.x;
      const TensorBlock blk = tensor_block<TensorLayout<false>, kRows>(p.groups, p.groups_per_part);
      const long long width = static_cast<long long>(gridDim.y) * kLanes;
      const int lane0 = blk.first % kLanes + (tid >> 5 & 3) * 8 + 2 * (tid & 3);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = blk.row0 + (tid >> 7) * 32 + 16 * i + (tid & 31) / 4 + 8 * h;
          if (row < p.m) {
            const long long o =
                row * width + static_cast<long long>(blockIdx.y) * kLanes + lane0;
            *reinterpret_cast<int2*>(e.out_i + o) =
                make_int2(ld_slot(fold_slot<kRows>(fold, 4 * i + 2 * h, tid)).y,
                          ld_slot(fold_slot<kRows>(fold, 4 * i + 2 * h + 1, tid)).y);
          }
        }
      }
    }
  }
};

template <int BM>
using AosEpi = LadderEpi<true, BM>;
template <int BM>
using DmaEpi = LadderEpi<false, BM>;

// v6's live rows at BM rows, BPS blocks an SM: B1's fold, and the budget
// of the live rows' q parts the plan holds (kLiveQBytes: one block an SM
// kQResidentLiveBytes, two a 32-row block's q_resident_limit).
template <int BM, int BPS>
struct LiveEpi : LadderEpi<true, BM> {
  static constexpr int kBlocksPerSm = BPS;
  static constexpr int blocks_per_sm(int, int) { return kBlocksPerSm; }
  static constexpr size_t kLiveQBytes = BPS == 1 ? kQResidentLiveBytes : q_resident_limit<BM>();
};

// ---- the kernels -------------------------------------------------------------

template <int T, bool PACKED, int KC, bool RES, bool ONE, int BM>
__global__ void __launch_bounds__(block_threads<BM>(), AosEpi<BM>::blocks_per_sm(T, KC))
tensor_aos_kernel(const TensorParams p, const LadderArgs e) {
  tensor_mainloop<T, kModeF32, PACKED, KC, RES, ONE, AosEpi<BM>, AosStaging<ONE>, false>(
      p, e, nullptr);
}

template <int T, bool PACKED, int KC, bool RES, bool ONE, int BM>
__global__ void __launch_bounds__(block_threads<BM>(), DmaEpi<BM>::blocks_per_sm(T, KC))
tensor_tma_kernel(const TensorParams p, const LadderArgs e,
                  const __grid_constant__ CUtensorMap map) {
  // The ring's boxes land 128-byte aligned: the dynamic shared memory of a
  // kernel without static shared memory starts so.
  extern __shared__ float4 smem4[];
  if (smem_addr(smem4) % 128 != 0) __trap();
  tensor_mainloop<T, kModeF32, PACKED, KC, RES, ONE, DmaEpi<BM>, TmaStaging, false>(p, e, &map);
}

template <int T, int KC, int BM, int BPS>
__global__ void __launch_bounds__(block_threads<BM>(), BPS)
tensor_live_kernel(const TensorParams p, const LadderArgs e) {
  tensor_mainloop<T, kModeF32, false, KC, true, false, LiveEpi<BM, BPS>, LiveStaging, true>(
      p, e, nullptr);
}

// ---- the launches --------------------------------------------------------------

// kLadderLive: v6's live rows, 64-row blocks one an SM; kLadderLivePair:
// 32-row blocks two an SM.
enum LadderPolicy { kLadderAos = 0, kLadderTma = 1, kLadderLive = 2, kLadderLivePair = 3 };

template <int POL, int BM>
using LadderEpiOf = std::conditional_t<
    POL == kLadderAos, AosEpi<BM>,
    std::conditional_t<POL == kLadderTma, DmaEpi<BM>,
                       LiveEpi<BM, POL == kLadderLivePair ? 2 : 1>>>;

// The bytes of a LIVE block's resident q parts: nq parts of the live rows
// of its first block (min(m, BM)), every chunk, rows KC + kTPad apart.
inline size_t live_q_bytes(int nq, int m, int k16, int kc, int bm) {
  return static_cast<size_t>(nq) * (m < bm ? m : bm) * (k16 / kc) * (kc + kTPad) * 2;
}

// The operand's tensor map for a TMA instance with KC-row chunks: (128
// lanes, ld / 128 groups, k rows) in boxes of (32, 4, KC); past the dims a
// box reads zeros and nothing outside the array.
inline int encode_ladder_map(CUtensorMap* map, const void* r, int k, long long ld, int kc) {
  const EncodeTiledFn encode = encode_tiled_fn();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  constexpr cuuint32_t kOnes[3] = {1, 1, 1};
  const cuuint64_t dims[3] = {kLanes, static_cast<cuuint64_t>(ld / kLanes),
                              static_cast<cuuint64_t>(k)};
  const cuuint64_t strides[2] = {kLanes * sizeof(float), static_cast<cuuint64_t>(ld) * 4};
  const cuuint32_t box[3] = {kTSliceLanes, kTGroups, static_cast<cuuint32_t>(kc)};
  const CUresult err = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(r),
                              dims, strides, box, kOnes, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return err == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// Every instance (BM rows) chains |r|^2 in the block: no norm pass.
template <int T, bool PACKED, int KC, bool RES, bool ONE, int POL, int BM>
int launch_ladder(const TensorArgs& a, const LadderArgs& e) {
  using EPI = LadderEpiOf<POL, BM>;
  const TensorParams p{a.qp, a.r, a.r_lo, a.rn, a.m, a.k, a.k16, a.ld, a.n, a.groups, a.gpp, 0};
  const dim3 grid((a.m + BM - 1) / BM * kTSlices, a.parts);
  if constexpr (POL == kLadderAos) {
    const size_t smem = tensor_smem<kModeF32, T, KC, EPI>(a.k16);
    auto kernel = tensor_aos_kernel<T, PACKED, KC, RES, ONE, BM>;
    if (const int err = allow_smem(kernel, smem)) return err;
    kernel<<<grid, block_threads<BM>(), smem, a.stream>>>(p, e);
  } else if constexpr (POL == kLadderTma) {
    CUtensorMap map;
    if (const int err = encode_ladder_map(&map, a.r, a.k, a.ld, KC)) return err;
    const size_t smem = tensor_smem<kModeF32, T, KC, EPI>(a.k16);
    auto kernel = tensor_tma_kernel<T, PACKED, KC, RES, ONE, BM>;
    if (const int err = allow_smem(kernel, smem)) return err;
    kernel<<<grid, block_threads<BM>(), smem, a.stream>>>(p, e, map);
  } else {
    const size_t q = live_q_bytes(q_parts<kModeF32, T>(), a.m, a.k16, KC, BM);
    if (q > EPI::kLiveQBytes) return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = live_smem<kModeF32, T, KC, EPI>(q);
    static_assert(!PACKED, "a packed tier's q parts fit a 64-row block");
    auto kernel = tensor_live_kernel<T, KC, BM, EPI::kBlocksPerSm>;
    if (const int err = allow_smem(kernel, smem)) return err;
    kernel<<<grid, block_threads<BM>(), smem, a.stream>>>(p, e);
  }
  return static_cast<int>(cudaGetLastError());
}

// B1's choice of chunk and residency (launch_tensor_kc): a packed tier at
// its one width (packed3 at k16 == 16, a 16-row chunk a tile; packed2 at
// 32, q resident); else one 16-row chunk a tile at k16 == 16, else 32-row
// chunks where k16 allows, else 16, the q parts resident where they fit
// kQResidentBytes; LIVE (kLadderLive, kLadderLivePair): always resident,
// never packed (a packed tier's q parts fit a 64-row block: B1's own
// launch). BM: the block's rows.
template <int T, bool PACKED, int POL, int BM>
int launch_ladder_kc(const TensorArgs& a, const LadderArgs& e) {
  if (!instance_matches<kModeF32, T, PACKED>(a.terms)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if constexpr (PACKED && POL >= kLadderLive) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else if constexpr (PACKED) {
    if constexpr (q_parts<kModeF32, T>() == 3) {
      if (a.k16 == 16) return launch_ladder<T, true, 16, true, true, POL, BM>(a, e);
    } else if (a.k16 == 32) {
      // B10 in 16-row chunks, as at T = 4 below: the same 16-deep steps.
      return launch_ladder<T, true, POL == kLadderTma ? 16 : 32, true, false, POL, BM>(a, e);
    }
    return static_cast<int>(cudaErrorInvalidValue);
  } else if constexpr (POL >= kLadderLive) {
    return a.k16 % 32 == 0 ? launch_ladder<T, false, 32, true, false, POL, BM>(a, e)
                           : launch_ladder<T, false, 16, true, false, POL, BM>(a, e);
  } else {
    if (a.k16 == 16) return launch_ladder<T, false, 16, true, true, POL, BM>(a, e);
    // At T = 4 16-row chunks, as B1's (launch_tensor_kc): the same 16-deep
    // steps in the same order, the same scores.
    if constexpr (T != 4) {
      if (a.k16 % 32 == 0) {
        return q_resident<kModeF32, T, 32, BM>(a.k16)
                   ? launch_ladder<T, false, 32, true, false, POL, BM>(a, e)
                   : launch_ladder<T, false, 32, false, false, POL, BM>(a, e);
      }
    }
    return q_resident<kModeF32, T, 16, BM>(a.k16)
               ? launch_ladder<T, false, 16, true, false, POL, BM>(a, e)
               : launch_ladder<T, false, 16, false, false, POL, BM>(a, e);
  }
}

// The f32 instances every term list of the ladder's tiers takes ("packed"'s
// 9, 8 or 4 terms, bf16x3, bf16x4, default/bf16_raw), at BM rows.
template <int POL, int BM>
int dispatch_ladder_rows(const TensorArgs& a, const LadderArgs& e, int nterms) {
  const bool packed = (a.terms.r & kPackedSum) != 0;
  switch (nterms) {
    case 1: return launch_ladder_kc<1, false, POL, BM>(a, e);
    case 3: return launch_ladder_kc<3, false, POL, BM>(a, e);
    case 4:
      return packed ? launch_ladder_kc<4, true, POL, BM>(a, e)
                    : launch_ladder_kc<4, false, POL, BM>(a, e);
    case 8: return launch_ladder_kc<8, true, POL, BM>(a, e);
    case 9: return launch_ladder_kc<9, true, POL, BM>(a, e);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// v3's and B10's block height by m (tiers.ladder_epilogue): 32 rows at m
// <= 32, else 128.
template <int POL>
int dispatch_ladder(const TensorArgs& a, const LadderArgs& e, int nterms) {
  return a.m <= kLadderServeRows ? dispatch_ladder_rows<POL, kLadderServeRows>(a, e, nterms)
                                 : dispatch_ladder_rows<POL, kLadderRows>(a, e, nterms);
}

// The q parts a term list reads (q_parts, from the packed list).
inline int term_q_parts(int nterms, int term_q) {
  int nq = 0;
  for (int t = 0; t < nterms; ++t) {
    const int part = (term_q >> (2 * t)) & 3;
    nq = part + 1 > nq ? part + 1 : nq;
  }
  return nq;
}

}  // namespace

extern "C" {

int tk_tensor_candidates(const void* qp, const void* r, const void* r_lo, const float* rn,
                         int32_t* out_i, float* out_s, int m, int k, long long ld, int n,
                         int parts, int mode, int nterms, int term_q, int term_r, void* stream);

// v3 at a tier: B1's tier candidates over ref, the caller's row-major (n, k)
// f32 array with row stride ld >= k (any base; 16-byte copies where ld % 4
// == 0 and the base is 16-byte aligned). qp, the term list and the outputs
// as tk_tensor_candidates' (mode 0); no norm scratch (the block chains
// |r|^2).
int tk_tensor_aos_candidates(const void* qp, const float* ref, int32_t* out_i, float* out_s,
                             int m, int k, long long ld, int n, int parts, int nterms,
                             int term_q, int term_r, void* stream) {
  if (ld < k || !valid_geometry(m, k, n, n, parts) || parts > kMaxGridY || n > (1 << 30) ||
      reinterpret_cast<uintptr_t>(qp) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const TensorArgs a = tensor_args(qp, ref, nullptr, nullptr, m, k, ld, n, parts, term_q, term_r,
                                   stream);
  return dispatch_ladder<kLadderAos>(a, LadderArgs{out_i, out_s}, nterms);
}

// B10 at a tier: B1's tier candidates over the (>= k, ld) f32 SoA operand r
// staged by the Tensor Memory Accelerator, indices only (out_i (m,
// parts*128)); r 16-byte aligned with ld % 128 == 0; no norm scratch.
int tk_tensor_dma_candidates(const void* qp, const float* r, int32_t* out_i, int m, int k,
                             long long ld, int n, int parts, int nterms, int term_q, int term_r,
                             void* stream) {
  if (!valid_geometry(m, k, ld, n, parts) || parts > kMaxGridY || n > (1 << 30) ||
      !tensor_operands_aligned(qp, r, nullptr, ld, kModeF32) || ld % kLanes != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const TensorArgs a = tensor_args(qp, r, nullptr, nullptr, m, k, ld, n, parts, term_q, term_r,
                                   stream);
  return dispatch_ladder<kLadderTma>(a, LadderArgs{out_i, nullptr}, nterms);
}

// v6 at a tier: B1's tier candidates (tk_tensor_candidates' arguments, mode
// 0) with the q parts resident at every shape: B1's own launch (rn its
// norm scratch) where a 64-row block's parts fit kQResidentBytes, else the
// LIVE instance (rn unused, null: the block chains |r|^2) of plan `live`
// (tiers.tensor_live_epilogue's choice by m, its index in
// tiers.LIVE_PLANS): 0 64-row blocks, one an SM; 1 32-row blocks, two an
// SM; the live rows' parts within the plan's budget (EPI::kLiveQBytes),
// else cudaErrorInvalidValue.
int tk_tensor_resident_candidates(const void* qp, const float* r, const float* rn,
                                  int32_t* out_i, float* out_s, int m, int k, long long ld, int n,
                                  int parts, int nterms, int term_q, int term_r, int live,
                                  void* stream) {
  if (!valid_geometry(m, k, ld, n, parts) || parts > kMaxGridY || n > (1 << 30) ||
      !tensor_operands_aligned(qp, r, nullptr, ld, kModeF32)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int k16 = (k + 15) / 16 * 16;
  const int nq = term_q_parts(nterms, term_q);
  const int kc = k16 % 32 == 0 && nterms != 4 ? 32 : 16;  // launch_tensor_kc's chunk
  const size_t rows64 = static_cast<size_t>(nq) * kTBM * (k16 / kc) * (kc + kTPad) * 2;
  if (k16 == 16 || rows64 <= kQResidentBytes) {
    if (rn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    return tk_tensor_candidates(qp, r, nullptr, rn, out_i, out_s, m, k, ld, n, parts, kModeF32,
                                nterms, term_q, term_r, stream);
  }
  const TensorArgs a = tensor_args(qp, r, nullptr, nullptr, m, k, ld, n, parts, term_q, term_r,
                                   stream);
  const LadderArgs e{out_i, out_s};
  switch (live) {
    case 0: return dispatch_ladder_rows<kLadderLive, kTBM>(a, e, nterms);
    case 1: return dispatch_ladder_rows<kLadderLivePair, kLadderServeRows>(a, e, nterms);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
