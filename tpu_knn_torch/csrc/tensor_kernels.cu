// The tensor-core candidate kernel: B1's bf16-split score tiers and B12.
//
// B1 (tiers) — replaces tpu_knn/kernels/fused.py:_fused_kernel (built by
// _build_fused_candidates) in its score tiers other than "highest":
// _score_tile / _qr_dot's "packed" (packed3, packed2), "bf16x3", "bf16x4",
// "qsplit2" and "default"/"bf16_raw".
// B12 — replaces tpu_knn/kernels/fused.py:_fused_presplit_kernel (the
// "bf16x3_presplit" tier): the same fold over pre-split bf16 (hi, lo) rows
// and an f32 |r|^2 row.
//
// A tier is a term list: T products (q part i_t) . (r part j_t) of bf16
// parts of the 3-way split x ~ hi + mid + lo (index 0, 1, 2; the 2-way
// split's lo is the 3-way split's mid). Each tier is one bf16 GEMM over a
// contraction of T * k16 rows (k padded to 16), on the tensor cores
// (mma.sync.m16n8k16, bf16 x bf16 -> f32), with B1's candidate contract
// (knn_common.cuh): s = |r|^2 - 2 q.r folded per lane with a strict `<`.
//
// Bound on the H100: tensor-core operations at embedding width (k = 768,
// m = 1024, n = 2^20: T * 2 * m * n * k16 = 3.3 ms at 989 TFLOP/s for
// qsplit2's T = 2, 5.0 ms for bf16x3) and at ds11 (k = 16: 0.28 ms for the
// packed tier's T = 8); the SoA operand read once. The design (mma.sync, no
// wgmma or TMA yet):
// - a block owns 64 query rows and one partition of 128-column groups and
//   walks the partition's groups in increasing order, each group's
//   contraction in KC-row chunks; 8 warps, warp w owns rows 16 * (w / 2)
//   .. + 15 and lanes 64 * (w % 2) .. + 63 of a group. Consecutive blocks
//   share a partition (the row tile is the grid's fast axis), so the row
//   tiles of a partition read its columns from L2;
// - the r chunks stream through a ring of kTStages shared-memory stages by
//   16-byte cp.async copies, issued kTStages - 1 chunks ahead of the one
//   being multiplied, as they are stored (f32, a quantized store's bf16, or
//   B12's hi and lo), rows >= k and columns >= n zero-filled without a read;
// - the q parts are split once per call by the caller and copied once per
//   block into shared memory where the contraction fits (k16 <= ~360 at two
//   parts); at embedding width the q chunk rides in the ring beside r;
// - the r parts of an f32 operand are split as each B fragment is read from
//   shared memory (cvt.rn.bf16x2: round to nearest even, tpu_knn's split bit
//   for bit); a bf16 operand's lower parts are zero and the caller drops
//   those terms; B12's hi and lo are read as stored;
// - |r|^2 is one fmaf chain over the upcast column, d = 0..k-1 in order,
//   read from the staged chunks by the column's owner thread; B12 reads its
//   f32 row;
// - numerics: each term of a 16-deep step is one mma into a fragment of its
//   own that starts at zero, so the tensor core's f32 accumulation
//   (alignment to the largest exponent, truncation) only ever sums 16 exact
//   products; the terms are added on the CUDA cores (round to nearest) in
//   tpu_knn's order, hh + (hl + lh) and then the rest, and the step's sum
//   to the f32 total. What is left beside the tier's split is an f32 sum
//   of k16 / 16 steps and the 16-product sums within them, which phase 1 of
//   chip_smoke.py measures against an f64 recomputation;
// - the epilogue keeps the running (min, index) pair of exactly the
//   (row, lane) positions the mma accumulator fragment gives each thread
//   (2 rows x 2 lanes x 8 column tiles), so the fold needs no exchange
//   between threads until the final write.

#include "knn_common.cuh"

namespace {

constexpr int kTBM = 64;            // query rows per block
constexpr int kTThreads = 256;      // 8 warps: 4 row blocks x 2 lane halves
constexpr int kTPad = 8;            // bf16 padding of each staged q row (bank spread)
constexpr int kTNTiles = 8;         // n8 column tiles per warp (64 lanes)
constexpr int kTStages = 4;         // ring stages: chunks in flight + the one in use
constexpr int kQResidentBytes = 96 * 1024;

enum OperandMode { kModeF32 = 0, kModeBF16 = 1, kModePresplit = 2 };

// 2 bits per term t at bit 2t: the q part and the r part of term t.
struct TermList {
  int q;
  int r;
};

__device__ __forceinline__ uint32_t ld32(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16x2(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two 16-bit values (the lower k index in the low half) as one register.
__device__ __forceinline__ uint32_t pack_u16(unsigned short lo, unsigned short hi) {
  return static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);
}

// d = A . B for one m16n8k16 tile (A row-major 16x16, B column-major
// 16x8), the 16 products summed from zero.
__device__ __forceinline__ void mma_bf16_zero(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                              uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
}

// The first nr r parts of two f32 values (k rows d and d + 1 of one
// column) as bf16x2 registers: hi, mid, lo of the 3-way split, each
// rounded to nearest even (x - hi and r1 - mid are exact in f32).
__device__ __forceinline__ void split_pair(float x0, float x1, int nr, uint32_t (&b)[3]) {
  const __nv_bfloat162 hi = __floats2bfloat162_rn(x0, x1);
  b[0] = pack_bf16x2(hi);
  if (nr > 1) {
    const float2 h = __bfloat1622float2(hi);
    const float r0 = x0 - h.x;
    const float r1 = x1 - h.y;
    const __nv_bfloat162 mid = __floats2bfloat162_rn(r0, r1);
    b[1] = pack_bf16x2(mid);
    if (nr > 2) {
      const float2 md = __bfloat1622float2(mid);
      b[2] = pack_bf16x2(__floats2bfloat162_rn(r0 - md.x, r1 - md.y));
    }
  }
}

// Elements and bytes of one staged r row (128 columns plus padding that
// spreads a fragment's reads over the banks; the bytes a multiple of 16).
template <int MODE>
__host__ __device__ constexpr int r_row_elems() {
  return MODE == kModeF32 ? kLanes + 4 : kLanes + 8;
}

template <int MODE>
__host__ __device__ constexpr int r_row_bytes() {
  return r_row_elems<MODE>() * (MODE == kModeF32 ? 4 : 2);
}

__host__ __device__ inline bool tensor_q_resident(int k16, int nq) {
  return nq * kTBM * (k16 + kTPad) * 2 <= kQResidentBytes;
}

// One ring stage: the r chunk (B12's hi and lo both), and the q chunk
// where q is not resident.
template <int MODE, int KC>
__host__ __device__ size_t tensor_stage_bytes(int k16, int nq) {
  const size_t r = static_cast<size_t>(KC) * r_row_bytes<MODE>() * (MODE == kModePresplit ? 2 : 1);
  return r + (tensor_q_resident(k16, nq) ? 0 : static_cast<size_t>(nq) * kTBM * (KC + kTPad) * 2);
}

// Shared memory: the ring, the resident q parts, and the group's |r|^2 row.
template <int MODE, int KC>
size_t tensor_smem(int k16, int nq) {
  const size_t q =
      tensor_q_resident(k16, nq) ? static_cast<size_t>(nq) * kTBM * (k16 + kTPad) * 2 : 0;
  return kTStages * tensor_stage_bytes<MODE, KC>(k16, nq) + q + kLanes * sizeof(float);
}

template <int T, int MODE, int KC>
__global__ void __launch_bounds__(kTThreads)
tensor_candidates_kernel(const __nv_bfloat16* __restrict__ qp, const void* __restrict__ r_main,
                         const __nv_bfloat16* __restrict__ r_lo, const float* __restrict__ rn,
                         int32_t* __restrict__ out_i, float* __restrict__ out_s, int m, int k,
                         int k16, long long ld, int n, int groups_per_part, TermList terms,
                         int nq, int nr, int q_resident) {
  constexpr int RB = r_row_bytes<MODE>();
  constexpr int RE = r_row_elems<MODE>();
  constexpr int ESIZE = MODE == kModeF32 ? 4 : 2;
  constexpr int CPR = kLanes * ESIZE / 16;   // 16-byte copies per staged row
  constexpr int ARRAYS = MODE == kModePresplit ? 2 : 1;
  extern __shared__ float4 smem4[];
  char* ring = reinterpret_cast<char*>(smem4);
  const size_t stage_bytes = tensor_stage_bytes<MODE, KC>(k16, nq);
  const int qld = q_resident ? k16 + kTPad : KC + kTPad;
  __nv_bfloat16* sq_res = reinterpret_cast<__nv_bfloat16*>(ring + kTStages * stage_bytes);
  float* sn = reinterpret_cast<float*>(sq_res + (q_resident ? nq * kTBM * qld : 0));

  const int row0 = blockIdx.x * kTBM;
  const int part = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int g = (tid & 31) >> 2;     // fragment row group
  const int tg = tid & 3;            // thread in the group
  const int wr = (warp >> 1) * 16;   // the warp's first row of the tile
  const int wc = (warp & 1) * 64;    // the warp's first lane of the group

  const long long p0 = static_cast<long long>(part) * groups_per_part * kLanes;
  const long long left = (static_cast<long long>(n) - p0 + kLanes - 1) / kLanes;
  const int n_groups =
      left <= 0 ? 0 : static_cast<int>(left < groups_per_part ? left : groups_per_part);
  const int nchunks = k16 / KC;
  const int steps = n_groups * nchunks;

  // Copies of the q parts' rows [row0, row0 + 64), contraction columns
  // [d0, d0 + width), into dst[p][row][ldq] (rows >= m zero-filled).
  auto copy_q = [&](__nv_bfloat16* dst, int d0, int width, int ldq) {
    const int cpr = width / 8;
    for (int e = tid; e < nq * kTBM * cpr; e += kTThreads) {
      const int p = e / (kTBM * cpr);
      const int rem = e - p * kTBM * cpr;
      const int row = rem / cpr;
      const int c = (rem - row * cpr) * 8;
      const bool live = row0 + row < m;
      const __nv_bfloat16* src =
          qp + (static_cast<long long>(p) * m + (live ? row0 + row : 0)) * k16 + d0 + c;
      cp_async16(dst + (p * kTBM + row) * ldq + c, src, live ? 16 : 0);
    }
  };

  // Issue the copies of step s: chunk s % nchunks of group s / nchunks.
  auto stage = [&](int s) {
    char* st = ring + (s % kTStages) * stage_bytes;
    const int gi = s / nchunks;
    const int d0 = (s - gi * nchunks) * KC;
    const long long col0 = p0 + static_cast<long long>(gi) * kLanes;
    const int rows = MODE == kModePresplit ? k16 : k;
    for (int e = tid; e < ARRAYS * KC * CPR; e += kTThreads) {
      const int a = e / (KC * CPR);
      const int rem = e - a * KC * CPR;
      const int d = rem / CPR;
      const int c = (rem - d * CPR) * (16 / ESIZE);
      const long long col = col0 + c;
      const long long avail = d0 + d < rows ? (static_cast<long long>(n) - col) * ESIZE : 0;
      const int bytes = avail <= 0 ? 0 : (avail >= 16 ? 16 : static_cast<int>(avail));
      const char* src = static_cast<const char*>(a == 0 ? r_main : static_cast<const void*>(r_lo));
      if (bytes > 0) src += (static_cast<long long>(d0 + d) * ld + col) * ESIZE;
      cp_async16(st + (a * KC + d) * RB + c * ESIZE, src, bytes);
    }
    if (!q_resident) {
      copy_q(reinterpret_cast<__nv_bfloat16*>(st + ARRAYS * KC * RB), d0, KC, KC + kTPad);
    }
  };

  if (q_resident) copy_q(sq_res, 0, k16, qld);  // lands with step 0's copies
#pragma unroll
  for (int s = 0; s < kTStages - 1; ++s) {
    if (s < steps) stage(s);
    cp_async_commit();
  }

  float best_s[kTNTiles][4];
  int best_i[kTNTiles][4];
  float acc[kTNTiles][4];
#pragma unroll
  for (int nt = 0; nt < kTNTiles; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      best_s[nt][e] = pos_inf();
      best_i[nt][e] = kI32Max;
      acc[nt][e] = 0.f;
    }
  }
  float norm = 0.f;  // column tid's |r|^2 (tid < 128)

  for (int s = 0; s < steps; ++s) {
    cp_async_wait<kTStages - 2>();  // step s has landed (this thread's copies)
    __syncthreads();                // ... and every thread's; step s - 1's stage is free
    if (s + kTStages - 1 < steps) stage(s + kTStages - 1);
    cp_async_commit();
    const char* st = ring + (s % kTStages) * stage_bytes;
    const int gi = s / nchunks;
    const int c = s - gi * nchunks;
    const __nv_bfloat16* sq =
        q_resident ? sq_res + c * KC
                   : reinterpret_cast<const __nv_bfloat16*>(st + ARRAYS * KC * RB);
    if (MODE != kModePresplit && tid < kLanes) {
#pragma unroll 8
      for (int d = 0; d < KC; ++d) {
        float x;
        if constexpr (MODE == kModeF32) {
          x = reinterpret_cast<const float*>(st + d * RB)[tid];
        } else {
          x = __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(st + d * RB)[tid]);
        }
        norm = fmaf(x, x, norm);
      }
    }
#pragma unroll
    for (int ks = 0; ks < KC; ks += 16) {
      uint32_t a[T][4];
#pragma unroll
      for (int t = 0; t < T; ++t) {
        const int qi = (terms.q >> (2 * t)) & 3;
        const __nv_bfloat16* qa = sq + (qi * kTBM + wr + g) * qld + ks + 2 * tg;
        a[t][0] = ld32(qa);
        a[t][1] = ld32(qa + 8 * qld);
        a[t][2] = ld32(qa + 8);
        a[t][3] = ld32(qa + 8 * qld + 8);
      }
      const int k0 = ks + 2 * tg;
#pragma unroll
      for (int nt = 0; nt < kTNTiles; ++nt) {
        const int col = wc + nt * 8 + g;
        uint32_t b0[3] = {0u, 0u, 0u};
        uint32_t b1[3] = {0u, 0u, 0u};
        if constexpr (MODE == kModeF32) {
          const float* f = reinterpret_cast<const float*>(st);
          split_pair(f[k0 * RE + col], f[(k0 + 1) * RE + col], nr, b0);
          split_pair(f[(k0 + 8) * RE + col], f[(k0 + 9) * RE + col], nr, b1);
        } else {
#pragma unroll
          for (int arr = 0; arr < ARRAYS; ++arr) {
            const unsigned short* h =
                reinterpret_cast<const unsigned short*>(st + arr * KC * RB);
            b0[arr] = pack_u16(h[k0 * RE + col], h[(k0 + 1) * RE + col]);
            b1[arr] = pack_u16(h[(k0 + 8) * RE + col], h[(k0 + 9) * RE + col]);
          }
        }
        // Each term's 16 products in a fragment of its own, the terms
        // added on the CUDA cores in tpu_knn's order: hh + (hl + lh),
        // then the rest left to right (packed's one dot has no order of
        // its own).
        float step[4];
        float cross[4];
#pragma unroll
        for (int t = 0; t < T; ++t) {
          const int rj = (terms.r >> (2 * t)) & 3;
          float dt[4];
          mma_bf16_zero(dt, a[t], rj == 0 ? b0[0] : (rj == 1 ? b0[1] : b0[2]),
                        rj == 0 ? b1[0] : (rj == 1 ? b1[1] : b1[2]));
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
        for (int e = 0; e < 4; ++e) acc[nt][e] += step[e];
      }
    }
    if (c == nchunks - 1) {
      // The group's last chunk: fold s = |r|^2 - 2 acc into the lanes.
      const long long base = p0 + static_cast<long long>(gi) * kLanes;
      if (tid < kLanes) {
        const long long col = base + tid;
        sn[tid] = MODE == kModePresplit ? (col < n ? __ldg(rn + col) : 0.f) : norm;
      }
      norm = 0.f;
      __syncthreads();
      // Fragment element e is row g + 8 * (e / 2), lane 2 * tg + e % 2 of
      // column tile nt.
#pragma unroll
      for (int nt = 0; nt < kTNTiles; ++nt) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int lane = wc + nt * 8 + 2 * tg + j;
          const long long col = base + lane;
          const float nr2 = sn[lane];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float sc = nr2 - 2.f * acc[nt][2 * h + j];
            if (col < n && sc < best_s[nt][2 * h + j]) {
              best_s[nt][2 * h + j] = sc;
              best_i[nt][2 * h + j] = static_cast<int>(col);
            }
            acc[nt][2 * h + j] = 0.f;
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  const long long width = static_cast<long long>(gridDim.y) * kLanes;
#pragma unroll
  for (int nt = 0; nt < kTNTiles; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = row0 + wr + g + 8 * (e >> 1);
      if (row < m) {
        const long long o = row * width + static_cast<long long>(part) * kLanes + wc +
                            nt * 8 + 2 * tg + (e & 1);
        out_i[o] = best_i[nt][e];
        out_s[o] = best_s[nt][e];
      }
    }
  }
}

struct TensorArgs {
  const __nv_bfloat16* qp;
  const void* r;
  const __nv_bfloat16* r_lo;
  const float* rn;
  int32_t* out_i;
  float* out_s;
  int m, k, k16;
  long long ld;
  int n, parts, gpp;
  TermList terms;
  int nq, nr;
  cudaStream_t stream;
};

template <int T, int MODE, int KC>
int launch_tensor(const TensorArgs& a) {
  const size_t smem = tensor_smem<MODE, KC>(a.k16, a.nq);
  auto kernel = tensor_candidates_kernel<T, MODE, KC>;
  if (const int e = allow_smem(kernel, smem)) return e;
  const int tiles = (a.m + kTBM - 1) / kTBM;
  kernel<<<dim3(tiles, a.parts), kTThreads, smem, a.stream>>>(
      a.qp, a.r, a.r_lo, a.rn, a.out_i, a.out_s, a.m, a.k, a.k16, a.ld, a.n, a.gpp, a.terms,
      a.nq, a.nr, tensor_q_resident(a.k16, a.nq) ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

template <int T, int MODE>
int launch_tensor_kc(const TensorArgs& a) {
  // 32-row chunks where k16 allows, else 16 (k16 an odd multiple of 16).
  return a.k16 % 32 == 0 ? launch_tensor<T, MODE, 32>(a) : launch_tensor<T, MODE, 16>(a);
}

}  // namespace

extern "C" {

// The tensor-core candidate kernel. qp holds the query parts, (nq, m, k16)
// bf16 (the 3-way split of the zero-padded queries, nq the parts the terms
// use). mode 0: r is the (>= k, ld) f32 SoA operand; mode 1: the bf16 SoA
// operand of a quantized store (terms with an r part other than 0 must be
// dropped by the caller); mode 2 (B12): r and r_lo are the (k16, ld) bf16
// hi and lo rows and rn the (1, ld) f32 norm row. qp, r and r_lo 16-byte
// aligned, and ld a whole number of 16-byte units. nterms terms, term t's q
// part at bits 2t of term_q and its r part at bits 2t of term_r. Outputs
// (m, parts*128) int32 + f32.
int tk_tensor_candidates(const void* qp, const void* r, const void* r_lo, const float* rn,
                         int32_t* out_i, float* out_s, int m, int k, long long ld, int n,
                         int parts, int mode, int nterms, int term_q, int term_r,
                         void* stream) {
  const int esize = mode == kModeF32 ? 4 : 2;
  if (!valid_geometry(m, k, ld, n, parts) || nterms < 1 || nterms > 9 || parts > kMaxGridY ||
      (ld * esize) % 16 != 0 || reinterpret_cast<uintptr_t>(qp) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(r) % 16 != 0 || reinterpret_cast<uintptr_t>(r_lo) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  TensorArgs a{static_cast<const __nv_bfloat16*>(qp), r, static_cast<const __nv_bfloat16*>(r_lo),
               rn, out_i, out_s, m, k, (k + 15) / 16 * 16, ld, n, parts,
               groups_per_part(n, parts), TermList{term_q, term_r}, 0, 0,
               static_cast<cudaStream_t>(stream)};
  for (int t = 0; t < nterms; ++t) {
    const int qi = (term_q >> (2 * t)) & 3;
    const int rj = (term_r >> (2 * t)) & 3;
    if (qi > 2 || rj > 2) return static_cast<int>(cudaErrorInvalidValue);
    a.nq = qi + 1 > a.nq ? qi + 1 : a.nq;
    a.nr = rj + 1 > a.nr ? rj + 1 : a.nr;
  }
  switch (mode) {
    case kModeF32:
      switch (nterms) {
        case 1: return launch_tensor_kc<1, kModeF32>(a);
        case 2: return launch_tensor_kc<2, kModeF32>(a);
        case 3: return launch_tensor_kc<3, kModeF32>(a);
        case 4: return launch_tensor_kc<4, kModeF32>(a);
        case 8: return launch_tensor_kc<8, kModeF32>(a);
        case 9: return launch_tensor_kc<9, kModeF32>(a);
        default: return static_cast<int>(cudaErrorInvalidValue);
      }
    case kModeBF16:
      if (a.nr != 1) return static_cast<int>(cudaErrorInvalidValue);
      switch (nterms) {
        case 1: return launch_tensor_kc<1, kModeBF16>(a);
        case 2: return launch_tensor_kc<2, kModeBF16>(a);
        case 3: return launch_tensor_kc<3, kModeBF16>(a);
        default: return static_cast<int>(cudaErrorInvalidValue);
      }
    case kModePresplit:
      if (nterms != 3 || a.nr != 2 || r_lo == nullptr || rn == nullptr) {
        return static_cast<int>(cudaErrorInvalidValue);
      }
      return launch_tensor_kc<3, kModePresplit>(a);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
