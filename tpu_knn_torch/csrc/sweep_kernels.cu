// B5: the top-K sweep (per-lane sorted K-lists).

#include "knn_common.cuh"

namespace {

// ---------------------------------------------------------------------------
// B5 — replaces tpu_knn/kernels/topk.py:_sweep_kernel (with _kstate_insert;
// built by _build_sweep_candidates): per lane, the KB lexicographically
// smallest (score, column) pairs of its columns, sorted, from one sweep of
// the operand. KB is a bucket of 4/8/16/32 at or above the caller's K; the
// union of the lists always holds the global top-K (a lane holds at most K
// of them). Only scores below +inf enter (NaN never does); empty slots
// report (+inf, INT32_MAX). Output slot (part*KB + l)*128 + lane of a row
// holds level l of that lane.
//
// Bound on the H100: arithmetic, as B1 (m*n*k FMA; at (k=16, m=8, n=2^20)
// that is 2^27 FMA, 4 us, so the 64 MB operand read, ~0.02 ms, bounds it).
// Design: B1's sweep with a TM x KB state per thread in registers, TM =
// 32/KB rows per block so that the state stays at 64 registers. A
// per-element skip guard (s <= the lane's current KB-th score) runs the
// fully unrolled compare-exchange insertion chain only for elements that
// can enter; after the first few groups almost none can.
// ---------------------------------------------------------------------------
template <int KB>
__device__ __forceinline__ void kstate_insert(float (&ls)[KB], int (&li)[KB], float s, int c) {
  // The displaced element cascades down and the KB+1-th falls out. The
  // index clause matters only for cascaded elements: fresh ones arrive in
  // increasing column order.
#pragma unroll
  for (int l = 0; l < KB; ++l) {
    const bool beats = s < ls[l] || (s == ls[l] && c < li[l]);
    const float os = ls[l];
    const int oi = li[l];
    ls[l] = beats ? s : os;
    li[l] = beats ? c : oi;
    s = beats ? os : s;
    c = beats ? oi : c;
  }
}

template <int TM, int KB>
__global__ void __launch_bounds__(kLanes)
sweep_candidates_kernel(const float* __restrict__ q, const float* __restrict__ r,
                        int32_t* __restrict__ out_i, float* __restrict__ out_s,
                        int m, int k, long long ld, int n, int groups_per_part,
                        int row_base) {
  extern __shared__ float4 smem4[];
  float* qT = reinterpret_cast<float*>(smem4);
  const int part = blockIdx.x;
  const int row0 = row_base + blockIdx.y * TM;
  const int lane = threadIdx.x;
  load_query_tile<TM>(q, qT, m, k, row0);

  float ls[TM][KB];
  int li[TM][KB];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int l = 0; l < KB; ++l) {
      ls[i][l] = pos_inf();
      li[i][l] = kI32Max;
    }
  }

  const long long first = static_cast<long long>(part) * groups_per_part * kLanes + lane;
  for (int g = 0; g < groups_per_part; ++g) {
    const long long col = first + static_cast<long long>(g) * kLanes;
    if (col >= n) break;
    float s[TM];
    column_scores<TM>(qT, r + col, ld, k, s);
    const int c = static_cast<int>(col);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      if (s[i] <= ls[i][KB - 1] && s[i] < pos_inf()) kstate_insert<KB>(ls[i], li[i], s[i], c);
    }
  }

  const long long width = static_cast<long long>(gridDim.x) * KB * kLanes;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = row0 + i;
    if (row < m) {
#pragma unroll
      for (int l = 0; l < KB; ++l) {
        const long long o =
            row * width + (static_cast<long long>(part) * KB + l) * kLanes + lane;
        out_i[o] = li[i][l];
        out_s[o] = ls[i][l];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Launchers.
// ---------------------------------------------------------------------------

template <int TM, int KB>
int launch_sweep(const float* q, const float* r, int32_t* out_i, float* out_s, int m, int k,
                 long long ld, int n, int parts, int groups_per_part, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(TM) * k * sizeof(float);
  if (const int e = allow_smem(sweep_candidates_kernel<TM, KB>, smem)) return e;
  const int tiles = (m + TM - 1) / TM;
  for (int t0 = 0; t0 < tiles; t0 += kMaxGridY) {
    const int ty = tiles - t0 < kMaxGridY ? tiles - t0 : kMaxGridY;
    sweep_candidates_kernel<TM, KB><<<dim3(parts, ty), kLanes, smem, stream>>>(
        q, r, out_i, out_s, m, k, ld, n, groups_per_part, t0 * TM);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

}  // namespace

extern "C" {

// B5 launch: kb in {4, 8, 16, 32} list slots per lane (32/kb rows per
// block); outputs are (m, parts*kb*128).
int tk_sweep_candidates(const float* q, const float* r, int32_t* out_i, float* out_s, int m,
                        int k, long long ld, int n, int parts, int kb, void* stream) {
  if (!valid_geometry(m, k, ld, n, parts)) return static_cast<int>(cudaErrorInvalidValue);
  const int gpp = groups_per_part(n, parts);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kb) {
    case 4: return launch_sweep<8, 4>(q, r, out_i, out_s, m, k, ld, n, parts, gpp, s);
    case 8: return launch_sweep<4, 8>(q, r, out_i, out_s, m, k, ld, n, parts, gpp, s);
    case 16: return launch_sweep<2, 16>(q, r, out_i, out_s, m, k, ld, n, parts, gpp, s);
    case 32: return launch_sweep<1, 32>(q, r, out_i, out_s, m, k, ld, n, parts, gpp, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
