// B11: the projection index's window scan (v11).

#include "knn_common.cuh"

namespace {

// ---------------------------------------------------------------------------
// B11 — replaces tpu_knn/kernels/projection.py:kernel (in
// _build_pallas_window_query): the projection index's window scan. Query
// i's coverage is w_groups 128-column groups of the sorted, augmented SoA
// operand r ((k_pad, ld): k coordinate rows, row k = ‖r‖², padding columns
// PAD_VALUE coordinates and a +inf norm), starting at column
// tiles[i] * 4096. Lane t folds columns start + t + 128 j of its split of
// the coverage into a running max of s' = q·r − ‖r‖²/2 (higher is nearer)
// with a strict `>`, so the earliest column wins a tie and a NaN never
// enters; a lane that folded nothing reports INT32_MAX. Columns at or past
// ld are never read. Arithmetic order: acc = fmaf(q[d], r[d, col], acc)
// for d = 0..k-1, then s' = fmaf(-0.5f, ‖r‖², acc). Output: (m, splits *
// 128) sorted positions (the TPU's 8x row replication was a Mosaic
// workaround and is not carried over).
//
// Bound on the H100: device-memory bytes, m * w_groups * 128 * (k + 1) * 4
// (at (k=3, m=16, n=2^24): 68 MB, about 0.020 ms). Design: a block per
// (split, query); the caller cuts each window into `splits` contiguous
// pieces so that a small batch still fills the card (projection.
// window_splits), and the exact rerank takes all splits * 128 candidates.
// A thread owns V consecutive lanes of a group and reads them with one
// V-wide load a row (V = 4: a float4, where the operand's base and ld are
// 16-byte aligned; V = 1 otherwise), so a group is 128 / V threads and a
// block reads V groups side by side (its "slots": slot s takes the piece's
// groups s, s + V, ...). Each thread keeps kWindowSteps groups in flight:
// the loads of a chunk of kWindowRows rows of all of them are issued
// before any is folded, and the last readable group is worked out before
// the loop, so no load waits on a test. The slots' lane maxima are merged
// at the end (the larger score, the lower column on equal scores: the
// sequential fold's answer).
// ---------------------------------------------------------------------------
constexpr int kTileW = 4096;
constexpr int kWindowRows = 4;
constexpr int kWindowSteps = 2;
// Resident blocks an SM that __launch_bounds__ provides registers for
// (projection.B11_BLOCKS_PER_SM sizes the grid to it).
constexpr int kWindowBlocksPerSm = 4;

__device__ __forceinline__ void load_row(const float* p, float (&v)[4]) {
  const float4 x = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = x.x;
  v[1] = x.y;
  v[2] = x.z;
  v[3] = x.w;
}

__device__ __forceinline__ void load_row(const float* p, float (&v)[1]) { v[0] = __ldg(p); }

template <int V>
__global__ void __launch_bounds__(kLanes, kWindowBlocksPerSm)
window_candidates_kernel(const float* __restrict__ q, const float* __restrict__ r,
                         const int32_t* __restrict__ tiles, int32_t* __restrict__ out_i, int k,
                         long long ld, int w_groups, int groups_per_split) {
  constexpr int kSlots = V;
  constexpr int kGroupThreads = kLanes / V;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  const int split = blockIdx.x;
  const long long row = blockIdx.y;
  const int slot = threadIdx.x / kGroupThreads;
  const int lane0 = (threadIdx.x % kGroupThreads) * V;
  for (int d = threadIdx.x; d < k; d += kLanes) qs[d] = q[row * k + d];
  __syncthreads();

  const long long base = static_cast<long long>(tiles[row]) * kTileW + lane0;
  // The groups this thread reads: its piece, cut where its columns reach
  // ld (V | ld, so its V columns end together).
  const int g0 = split * groups_per_split;
  int g_end = min(w_groups, g0 + groups_per_split);
  g_end = static_cast<int>(min(static_cast<long long>(g_end),
                               base < ld ? (ld - base + kLanes - 1) / kLanes : 0LL));
  float best[V];
  int best_i[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    best[v] = neg_inf();
    best_i[v] = kI32Max;
  }
  for (int g = g0 + slot; g < g_end; g += kSlots * kWindowSteps) {
    float acc[kWindowSteps][V];
    float nrm[kWindowSteps][V];
#pragma unroll
    for (int s = 0; s < kWindowSteps; ++s) {
#pragma unroll
      for (int v = 0; v < V; ++v) acc[s][v] = nrm[s][v] = 0.f;
    }
    const float* rc = r + base + static_cast<long long>(g) * kLanes;
    for (int d0 = 0; d0 <= k; d0 += kWindowRows) {
      float rv[kWindowSteps][kWindowRows][V];
#pragma unroll
      for (int s = 0; s < kWindowSteps; ++s) {
        const bool live = g + s * kSlots < g_end;
#pragma unroll
        for (int j = 0; j < kWindowRows; ++j) {
          if (live && d0 + j <= k) {
            load_row(rc + static_cast<long long>(s) * kSlots * kLanes +
                         static_cast<long long>(d0 + j) * ld,
                     rv[s][j]);
          } else {
#pragma unroll
            for (int v = 0; v < V; ++v) rv[s][j][v] = 0.f;
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kWindowRows; ++j) {
        const int d = d0 + j;
        if (d < k) {
          const float qd = qs[d];
#pragma unroll
          for (int s = 0; s < kWindowSteps; ++s) {
#pragma unroll
            for (int v = 0; v < V; ++v) acc[s][v] = fmaf(qd, rv[s][j][v], acc[s][v]);
          }
        } else if (d == k) {
#pragma unroll
          for (int s = 0; s < kWindowSteps; ++s) {
#pragma unroll
            for (int v = 0; v < V; ++v) nrm[s][v] = rv[s][j][v];
          }
        }
      }
    }
#pragma unroll
    for (int s = 0; s < kWindowSteps; ++s) {
      if (g + s * kSlots >= g_end) break;
      const long long col = base + static_cast<long long>(g + s * kSlots) * kLanes;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float sc = fmaf(-0.5f, nrm[s][v], acc[s][v]);
        if (sc > best[v]) {
          best[v] = sc;
          best_i[v] = static_cast<int>(col) + v;
        }
      }
    }
  }

  int32_t* out = out_i + row * gridDim.x * kLanes + static_cast<long long>(split) * kLanes;
  if constexpr (kSlots == 1) {
    out[lane0] = best_i[0];
  } else {
    __shared__ float merge_s[kSlots][kLanes];
    __shared__ int merge_i[kSlots][kLanes];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      merge_s[slot][lane0 + v] = best[v];
      merge_i[slot][lane0 + v] = best_i[v];
    }
    __syncthreads();
    const int t = threadIdx.x;
    float b = merge_s[0][t];
    int bi = merge_i[0][t];
#pragma unroll
    for (int sl = 1; sl < kSlots; ++sl) {
      const float s = merge_s[sl][t];
      const int i = merge_i[sl][t];
      if (s > b || (s == b && i < bi)) {
        b = s;
        bi = i;
      }
    }
    out[t] = bi;
  }
}

// ---------------------------------------------------------------------------
// Launchers.
// ---------------------------------------------------------------------------

template <int V>
int launch_window(const float* q, const float* r, const int32_t* tiles, int32_t* out_i, int m,
                  int k, long long ld, int w_groups, int splits, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(k) * sizeof(float);
  const size_t static_bytes = V > 1 ? 2 * V * kLanes * sizeof(float) : 0;
  if (const int e = allow_smem(window_candidates_kernel<V>, smem, static_bytes)) return e;
  const int gps = (w_groups + splits - 1) / splits;
  for (int r0 = 0; r0 < m; r0 += kMaxGridY) {
    const int my = m - r0 < kMaxGridY ? m - r0 : kMaxGridY;
    window_candidates_kernel<V><<<dim3(splits, my), kLanes, smem, stream>>>(
        q + static_cast<long long>(r0) * k, r, tiles + r0,
        out_i + static_cast<long long>(r0) * splits * kLanes, k, ld, w_groups, gps);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

}  // namespace

extern "C" {

// B11 (v11): q (m, k), r the (k_pad >= k + 1, ld) augmented operand,
// tiles (m,) int32 window starts in 4096-column tiles, w_groups 128-column
// groups per window, cut into `splits` pieces; out_i (m, splits*128).
// float4 rows where r is 16-byte aligned and ld a multiple of 4, else
// 4-byte rows.
int tk_window_candidates(const float* q, const float* r, const int32_t* tiles, int32_t* out_i,
                         int m, int k, long long ld, int w_groups, int splits, void* stream) {
  if (m < 1 || k < 1 || w_groups < 1 || splits < 1 || splits > w_groups ||
      static_cast<long long>(w_groups) * kLanes > ld) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (reinterpret_cast<uintptr_t>(r) % 16 == 0 && ld % 4 == 0) {
    return launch_window<4>(q, r, tiles, out_i, m, k, ld, w_groups, splits, s);
  }
  return launch_window<1>(q, r, tiles, out_i, m, k, ld, w_groups, splits, s);
}

}  // extern "C"
