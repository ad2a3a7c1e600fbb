// The seeded top-K engine's kernels: B3 (value-only lane minima and their
// merge), B7 (per-cell integer moments) and the B8/B9 cell compactor.

#include "knn_common.cuh"

namespace {

// ---------------------------------------------------------------------------
// B3 — replaces tpu_knn/kernels/fused.py:_fused_minima_kernel (built by
// _build_minima_candidates): the seeded engine's bound pass. B1's sweep
// without the index fold: per row and lane, the smallest score (DEPTH 1)
// or the two smallest of the multiset (DEPTH 2), optionally only scores
// above the row's lo (NaN never enters: every compare is strict). The
// caller passes the prefix it wants read as n, so a launch reads only
// those columns. Each block writes its partition's 128 lanes to a
// partial array; minima_merge_kernel folds the partitions into the
// contract's (m, DEPTH*128) = [min1 lanes | min2 lanes] (the fold is a
// min, so the merged values do not depend on the partition count).
//
// Bound on the H100: arithmetic, as B1 (2*m*n*k flops; at ds11 with the
// half prefix 2^34 flops, 0.26 ms at the f32 peak). Design: B1's block
// (TM rows x one partition, a thread per lane); the band test reads lo
// from shared memory only for a score that would enter the fold.
// ---------------------------------------------------------------------------
template <int TM, int DEPTH>
__global__ void __launch_bounds__(kLanes)
minima_candidates_kernel(const float* __restrict__ q, const float* __restrict__ r,
                         const float* __restrict__ lo, float* __restrict__ partial, int m, int k,
                         long long ld, int n, int groups_per_part, int row_base) {
  extern __shared__ float4 smem4[];
  float* qT = reinterpret_cast<float*>(smem4);
  __shared__ float s_lo[TM];
  const int part = blockIdx.x;
  const int row0 = row_base + blockIdx.y * TM;
  const int lane = threadIdx.x;
  for (int i = lane; i < TM; i += kLanes) {
    s_lo[i] = lo != nullptr && row0 + i < m ? lo[row0 + i] : neg_inf();
  }
  load_query_tile<TM>(q, qT, m, k, row0);

  float m1[TM], m2[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) m1[i] = m2[i] = pos_inf();

  const long long first = static_cast<long long>(part) * groups_per_part * kLanes + lane;
  for (int g = 0; g < groups_per_part; ++g) {
    const long long col = first + static_cast<long long>(g) * kLanes;
    if (col >= n) break;
    float s[TM];
    column_scores<TM>(qT, r + col, ld, k, s);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      if constexpr (DEPTH == 1) {
        if (s[i] < m1[i] && s[i] > s_lo[i]) m1[i] = s[i];
      } else {
        // tpu_knn's fold (new1 = min(s, m1); the displaced value folds
        // into m2), written as one guarded branch.
        if (s[i] < m2[i] && s[i] > s_lo[i]) {
          if (s[i] < m1[i]) {
            m2[i] = m1[i];
            m1[i] = s[i];
          } else {
            m2[i] = s[i];
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = row0 + i;
    if (row < m) {
      float* o = partial + ((static_cast<long long>(row) * gridDim.x + part) * DEPTH) * kLanes;
      o[lane] = m1[i];
      if constexpr (DEPTH == 2) o[kLanes + lane] = m2[i];
    }
  }
}

// Folds `groups` 128-lane partials of a row ([group][depth][lane]) into
// the row's DEPTH*128 lane minima; one block per row.
template <int DEPTH>
__global__ void __launch_bounds__(kLanes)
minima_merge_kernel(const float* __restrict__ partial, float* __restrict__ out, int groups) {
  const long long row = blockIdx.x;
  const int lane = threadIdx.x;
  const float* p = partial + row * groups * DEPTH * kLanes + lane;
  float m1 = pos_inf(), m2 = pos_inf();
  for (int e = 0; e < groups * DEPTH; ++e) {
    const float s = p[static_cast<long long>(e) * kLanes];
    if (s < m2) {
      if (s < m1) {
        m2 = m1;
        m1 = s;
      } else {
        m2 = s;
      }
    }
  }
  out[row * DEPTH * kLanes + lane] = m1;
  if (DEPTH == 2) out[row * DEPTH * kLanes + kLanes + lane] = m2;
}

// ---------------------------------------------------------------------------
// B7 — replaces tpu_knn/kernels/topk.py:_extract_moment_kernel (built by
// _build_extract_candidates): per (row, cell of `cell` = 64/128/256
// columns), the exact integer moments cnt, sum l, sum l^2 [, sum l^3] of
// the columns l (= col % cell) whose score is <= the row's bound (and >
// its lo, for a band; columns >= n never qualify), packed as tpu_knn
// packs them: A = min(cnt,3) | e1<<2 | p2<<12 masked to 30 bits, bit 30 =
// (cnt > solvable), and p3 in the cubic mode. With rem_part, also the
// per-lane minima of the scores above the bound (the rounds engine's
// next bound source), merged by minima_merge_kernel.
//
// The TPU reduced the 0/1 mask on the matrix unit against a block-
// diagonal weight matrix. Here each warp reduces its 32 columns' (1, l,
// l^2, l^3) in 32-bit integers (__ballot_sync, then __reduce_add_sync
// only when some lane qualifies, which is rare), the warps of a cell meet
// in shared memory, and one thread per (row, cell) packs. Every sum is an
// exact integer below 2^31 for any cell (sum l^3 over 256 lanes <=
// 1.07e9), so the words equal tpu_knn's bit for bit.
//
// Bound on the H100: arithmetic, as B1 (2*m*n*k flops: 0.51 ms at ds11),
// plus a compare and a vote per (row, column). Design: a block of 256
// threads owns TM rows and a partition of 256-column chunks; cells never
// straddle a chunk, and two barriers per chunk hand the warp partials to
// the packing threads (who clear them for the next chunk).
// ---------------------------------------------------------------------------
constexpr int kChunk = 256;  // B7 threads per block = columns per step

template <int TM, bool REM>
__global__ void __launch_bounds__(kChunk)
extract_moments_kernel(const float* __restrict__ q, const float* __restrict__ r,
                       const float* __restrict__ bound, const float* __restrict__ lo,
                       int32_t* __restrict__ out_a, int32_t* __restrict__ out_p3,
                       float* __restrict__ rem_part, int m, int k, long long ld, int n, int nc,
                       int cell, int cubic, int chunks_per_part, int row_base) {
  extern __shared__ float4 smem4[];
  float* qT = reinterpret_cast<float*>(smem4);
  __shared__ float s_b[TM], s_lo[TM];
  __shared__ unsigned s_mom[TM][kChunk / 32][4];
  const int part = blockIdx.x;
  const int row0 = row_base + blockIdx.y * TM;
  const int t = threadIdx.x;
  const int warp = t >> 5;
  const int wl = t & 31;
  for (int i = t; i < TM; i += kChunk) {
    s_b[i] = row0 + i < m ? bound[row0 + i] : neg_inf();
    s_lo[i] = lo != nullptr && row0 + i < m ? lo[row0 + i] : neg_inf();
  }
  for (int e = t; e < TM * (kChunk / 32) * 4; e += kChunk) (&s_mom[0][0][0])[e] = 0u;
  load_query_tile<TM>(q, qT, m, k, row0);

  float rem[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) rem[i] = pos_inf();

  const int cells_per_chunk = kChunk / cell;
  const int warps_per_cell = cell / 32;
  const unsigned solvable = cubic ? 3u : 2u;
  const int chunks = (nc + cells_per_chunk - 1) / cells_per_chunk;
  const int c_end = min(chunks, (part + 1) * chunks_per_part);
  for (int c = part * chunks_per_part; c < c_end; ++c) {
    const long long col = static_cast<long long>(c) * kChunk + t;
    const bool live = col < n;
    const unsigned l = static_cast<unsigned>(col) & static_cast<unsigned>(cell - 1);
    float s[TM];
    if (live) {
      column_scores<TM>(qT, r + col, ld, k, s);
    } else {
#pragma unroll
      for (int i = 0; i < TM; ++i) s[i] = pos_inf();
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const bool qual = live && s[i] <= s_b[i] && s[i] > s_lo[i];
      const unsigned bal = __ballot_sync(0xffffffffu, qual);
      if (bal != 0u) {  // warp-uniform
        const unsigned v = qual ? l : 0u;
        const unsigned e1 = __reduce_add_sync(0xffffffffu, v);
        const unsigned p2 = __reduce_add_sync(0xffffffffu, v * v);
        const unsigned p3 = cubic ? __reduce_add_sync(0xffffffffu, v * v * v) : 0u;
        if (wl == 0) {
          s_mom[i][warp][0] = static_cast<unsigned>(__popc(bal));
          s_mom[i][warp][1] = e1;
          s_mom[i][warp][2] = p2;
          s_mom[i][warp][3] = p3;
        }
      }
      if constexpr (REM) {
        if (live && s[i] < rem[i] && s[i] > s_b[i]) rem[i] = s[i];
      }
    }
    __syncthreads();
    if (t < TM * cells_per_chunk) {
      const int i = t / cells_per_chunk;
      const int cc = t - i * cells_per_chunk;
      unsigned cnt = 0u, e1 = 0u, p2 = 0u, p3 = 0u;
      for (int w = cc * warps_per_cell; w < (cc + 1) * warps_per_cell; ++w) {
        cnt += s_mom[i][w][0];
        e1 += s_mom[i][w][1];
        p2 += s_mom[i][w][2];
        p3 += s_mom[i][w][3];
        s_mom[i][w][0] = s_mom[i][w][1] = s_mom[i][w][2] = s_mom[i][w][3] = 0u;
      }
      const long long cidx = static_cast<long long>(c) * cells_per_chunk + cc;
      const int row = row0 + i;
      if (row < m && cidx < nc) {
        const unsigned packed = (cnt < 3u ? cnt : 3u) | (e1 << 2) | (p2 << 12);
        const unsigned flag = cnt > solvable ? 1u : 0u;
        const long long o = static_cast<long long>(row) * nc + cidx;
        out_a[o] = static_cast<int32_t>((packed & 0x3FFFFFFFu) | (flag << 30));
        if (cubic) out_p3[o] = static_cast<int32_t>(p3);
      }
    }
    __syncthreads();
  }

  if constexpr (REM) {
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int row = row0 + i;
      if (row < m) {
        rem_part[(static_cast<long long>(row) * gridDim.x + part) * kChunk + t] = rem[i];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// B8 and B9 — replace tpu_knn/kernels/topk.py:_cell_compact_kernel and
// _cell_butterfly_kernel (both built by _build_cell_compactor, which picks
// one by part width only because of VMEM): positional compaction of the
// qualifying cells of each (row, part). Fields are (m, nc) int32, field 0
// nonzero exactly at qualifiers; each part (nc / parts cells) writes
// [cell position within the part, f0 (, f1)] of its qualifiers to its
// first `cap` slots in ascending cell order, drops qualifiers past cap and
// zero-fills the slots after the last one. Outputs are (m, parts*cap).
//
// Bound on the H100: device-memory bytes (field 0 read once, the outputs
// written once; 16 MB of A at ds11 K=8, about 5 us). Design: one warp per
// (row, part) walks its cells 128 at a time (four loads in flight per
// lane); __ballot_sync marks the qualifiers, a __popc prefix over the
// lanes below plus a running base gives each its slot. The walk stops once
// cap qualifiers are placed. Independent of cap and of part width, so one
// kernel serves both TPU bodies and the candidate-column compaction.
// ---------------------------------------------------------------------------
constexpr int kCompactWarps = 4;

__global__ void __launch_bounds__(kCompactWarps * 32)
compact_cells_kernel(const int32_t* __restrict__ f0, const int32_t* __restrict__ f1,
                     int32_t* __restrict__ o_pos, int32_t* __restrict__ o0,
                     int32_t* __restrict__ o1, int m, int nc, int parts, int cap) {
  const int wl = threadIdx.x & 31;
  const long long task = static_cast<long long>(blockIdx.x) * kCompactWarps + (threadIdx.x >> 5);
  if (task >= static_cast<long long>(m) * parts) return;  // a whole warp at once
  const long long row = task / parts;
  const int part = static_cast<int>(task - row * parts);
  const int pw = nc / parts;
  const long long in = row * nc + static_cast<long long>(part) * pw;
  const long long out = (row * parts + part) * cap;
  const unsigned below = (1u << wl) - 1u;
  int count = 0;
  for (int c0 = 0; c0 < pw && count < cap; c0 += 4 * 32) {
    int32_t v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int c = c0 + u * 32 + wl;
      v[u] = c < pw ? f0[in + c] : 0;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int c = c0 + u * 32 + wl;
      const unsigned bal = __ballot_sync(0xffffffffu, v[u] != 0);
      const int rank = count + __popc(bal & below);
      if (v[u] != 0 && rank < cap) {
        o_pos[out + rank] = c;
        o0[out + rank] = v[u];
        if (f1 != nullptr) o1[out + rank] = f1[in + c];
      }
      count += __popc(bal);
    }
  }
  for (int s = min(count, cap) + wl; s < cap; s += 32) {
    o_pos[out + s] = 0;
    o0[out + s] = 0;
    if (o1 != nullptr) o1[out + s] = 0;
  }
}

// ---------------------------------------------------------------------------
// Launchers.
// ---------------------------------------------------------------------------

// Opt a kernel into dynamic shared memory beyond what fits beside its
// static shared memory by default.
template <typename Kernel>
int allow_dynamic_smem(Kernel kernel, size_t dynamic, size_t static_bytes) {
  if (dynamic + static_bytes <= kDefaultSmem) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(dynamic)));
}

template <int TM, int DEPTH>
int launch_minima(const float* q, const float* r, const float* lo, float* partial, float* out,
                  int m, int k, long long ld, int n, int parts, int groups_per_part,
                  cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(TM) * k * sizeof(float);
  auto kernel = minima_candidates_kernel<TM, DEPTH>;
  if (const int e = allow_dynamic_smem(kernel, smem, TM * sizeof(float))) return e;
  const int tiles = (m + TM - 1) / TM;
  for (int t0 = 0; t0 < tiles; t0 += kMaxGridY) {
    const int ty = tiles - t0 < kMaxGridY ? tiles - t0 : kMaxGridY;
    kernel<<<dim3(parts, ty), kLanes, smem, stream>>>(q, r, lo, partial, m, k, ld, n,
                                                      groups_per_part, t0 * TM);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  minima_merge_kernel<DEPTH><<<m, kLanes, 0, stream>>>(partial, out, parts);
  return static_cast<int>(cudaGetLastError());
}

template <int TM>
int launch_minima_depth(const float* q, const float* r, const float* lo, float* partial,
                        float* out, int m, int k, long long ld, int n, int parts, int gpp,
                        int depth, cudaStream_t s) {
  if (depth == 1) return launch_minima<TM, 1>(q, r, lo, partial, out, m, k, ld, n, parts, gpp, s);
  return launch_minima<TM, 2>(q, r, lo, partial, out, m, k, ld, n, parts, gpp, s);
}

template <int TM, bool REM>
int launch_extract(const float* q, const float* r, const float* bound, const float* lo,
                   int32_t* out_a, int32_t* out_p3, float* rem_part, float* rem_out, int m,
                   int k, long long ld, int n, int nc, int cell, int cubic, int parts,
                   int chunks_per_part, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(TM) * k * sizeof(float);
  auto kernel = extract_moments_kernel<TM, REM>;
  const size_t static_bytes = TM * (2 * sizeof(float) + (kChunk / 32) * 4 * sizeof(unsigned));
  if (const int e = allow_dynamic_smem(kernel, smem, static_bytes)) return e;
  const int tiles = (m + TM - 1) / TM;
  for (int t0 = 0; t0 < tiles; t0 += kMaxGridY) {
    const int ty = tiles - t0 < kMaxGridY ? tiles - t0 : kMaxGridY;
    kernel<<<dim3(parts, ty), kChunk, smem, stream>>>(q, r, bound, lo, out_a, out_p3, rem_part,
                                                      m, k, ld, n, nc, cell, cubic,
                                                      chunks_per_part, t0 * TM);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (REM) minima_merge_kernel<1><<<m, kLanes, 0, stream>>>(rem_part, rem_out,
                                                            parts * (kChunk / kLanes));
  return static_cast<int>(cudaGetLastError());
}

template <int TM>
int launch_extract_rem(const float* q, const float* r, const float* bound, const float* lo,
                       int32_t* out_a, int32_t* out_p3, float* rem_part, float* rem_out, int m,
                       int k, long long ld, int n, int nc, int cell, int cubic, int parts,
                       int cpp, cudaStream_t s) {
  if (rem_part != nullptr) {
    return launch_extract<TM, true>(q, r, bound, lo, out_a, out_p3, rem_part, rem_out, m, k, ld,
                                    n, nc, cell, cubic, parts, cpp, s);
  }
  return launch_extract<TM, false>(q, r, bound, lo, out_a, out_p3, rem_part, rem_out, m, k, ld,
                                   n, nc, cell, cubic, parts, cpp, s);
}

}  // namespace

extern "C" {

// B3 launch: B1's geometry (tile_m in {1, 8, 32}), depth 1 or 2, lo (m,)
// f32 or null; partial is (m, parts*depth*128) scratch, out (m, depth*128).
int tk_minima_candidates(const float* q, const float* r, const float* lo, float* partial,
                         float* out, int m, int k, long long ld, int n, int parts, int tile_m,
                         int depth, void* stream) {
  if (!valid_geometry(m, k, ld, n, parts) || (depth != 1 && depth != 2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int gpp = groups_per_part(n, parts);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tile_m) {
    case 32: return launch_minima_depth<32>(q, r, lo, partial, out, m, k, ld, n, parts, gpp, depth, s);
    case 8: return launch_minima_depth<8>(q, r, lo, partial, out, m, k, ld, n, parts, gpp, depth, s);
    case 1: return launch_minima_depth<1>(q, r, lo, partial, out, m, k, ld, n, parts, gpp, depth, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// B7 launch: nc cells of `cell` in {64, 128, 256} columns cover the
// operand (ld >= nc*cell >= n); bound (m,) f32, lo (m,) f32 or null;
// out_a (m, nc) int32, out_p3 (m, nc) int32 when cubic; rem_part
// (m, parts*256) scratch and rem_out (m, 128), or both null.
int tk_extract_moments(const float* q, const float* r, const float* bound, const float* lo,
                       int32_t* out_a, int32_t* out_p3, float* rem_part, float* rem_out, int m,
                       int k, long long ld, int n, int nc, int cell, int cubic, int parts,
                       int tile_m, void* stream) {
  const long long width = static_cast<long long>(nc) * cell;
  const int chunks = static_cast<int>((width + kChunk - 1) / kChunk);
  if (m < 1 || k < 1 || n < 1 || n > width || ld < width || parts < 1 || parts > chunks ||
      (cell != 64 && cell != 128 && cell != 256) || (cubic && out_p3 == nullptr) ||
      ((rem_part == nullptr) != (rem_out == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int cpp = (chunks + parts - 1) / parts;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tile_m) {
    case 32:
      return launch_extract_rem<32>(q, r, bound, lo, out_a, out_p3, rem_part, rem_out, m, k, ld,
                                    n, nc, cell, cubic, parts, cpp, s);
    case 8:
      return launch_extract_rem<8>(q, r, bound, lo, out_a, out_p3, rem_part, rem_out, m, k, ld,
                                   n, nc, cell, cubic, parts, cpp, s);
    case 1:
      return launch_extract_rem<1>(q, r, bound, lo, out_a, out_p3, rem_part, rem_out, m, k, ld,
                                   n, nc, cell, cubic, parts, cpp, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The B8/B9 compactor: f0 (and f1, or null) (m, nc) int32 -> o_pos, o0
// (and o1) (m, parts*cap) int32; parts divides nc, 1 <= cap <= nc/parts.
int tk_compact_cells(const int32_t* f0, const int32_t* f1, int32_t* o_pos, int32_t* o0,
                     int32_t* o1, int m, int nc, int parts, int cap, void* stream) {
  if (m < 1 || nc < 1 || parts < 1 || nc % parts != 0 || cap < 1 || cap > nc / parts ||
      ((f1 == nullptr) != (o1 == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long warps = static_cast<long long>(m) * parts;
  const long long blocks = (warps + kCompactWarps - 1) / kCompactWarps;
  compact_cells_kernel<<<static_cast<unsigned>(blocks), kCompactWarps * 32, 0,
                         static_cast<cudaStream_t>(stream)>>>(f0, f1, o_pos, o0, o1, m, nc,
                                                              parts, cap);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
