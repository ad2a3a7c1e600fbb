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
// enters; a lane that folded nothing reports INT32_MAX. Arithmetic order:
// acc = fmaf(q[d], r[d, col], acc) for d = 0..k-1, then s' = fmaf(-0.5f,
// ‖r‖², acc). Output: (m, splits * 128) sorted positions (the TPU's 8x row
// replication was a Mosaic workaround and is not carried over).
//
// Bound on the H100: device-memory bytes, m * w_groups * 128 * (k + 1) * 4
// (at (k=3, m=16, n=2^24): 68 MB, about 0.020 ms). Design: a block per
// (split, query); the caller cuts each window into `splits` contiguous
// pieces so that a small batch still fills the card, and the exact rerank
// takes all splits * 128 candidates. A column's k + 1 rows are read in
// chunks of kWindowChunk loads issued before they are used (one chunk at
// k = 3), so one kernel serves every k.
// ---------------------------------------------------------------------------
constexpr int kTileW = 4096;
constexpr int kWindowChunk = 4;

__global__ void __launch_bounds__(kLanes)
window_candidates_kernel(const float* __restrict__ q, const float* __restrict__ r,
                         const int32_t* __restrict__ tiles, int32_t* __restrict__ out_i, int k,
                         long long ld, int w_groups, int groups_per_split) {
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  const int split = blockIdx.x;
  const long long row = blockIdx.y;
  const int lane = threadIdx.x;
  for (int d = lane; d < k; d += kLanes) qs[d] = q[row * k + d];
  __syncthreads();

  const long long base = static_cast<long long>(tiles[row]) * kTileW + lane;
  float best = neg_inf();
  int best_i = kI32Max;
  const int g_end = min(w_groups, (split + 1) * groups_per_split);
  for (int g = split * groups_per_split; g < g_end; ++g) {
    const long long col = base + static_cast<long long>(g) * kLanes;
    if (col >= ld) break;
    const float* rc = r + col;
    float acc = 0.f;
    float nrm = 0.f;
    for (int d0 = 0; d0 <= k; d0 += kWindowChunk) {
      float rv[kWindowChunk];
#pragma unroll
      for (int j = 0; j < kWindowChunk; ++j) {
        rv[j] = d0 + j <= k ? __ldg(rc + static_cast<long long>(d0 + j) * ld) : 0.f;
      }
#pragma unroll
      for (int j = 0; j < kWindowChunk; ++j) {
        if (d0 + j < k) acc = fmaf(qs[d0 + j], rv[j], acc);
        else if (d0 + j == k) nrm = rv[j];
      }
    }
    const float s = fmaf(-0.5f, nrm, acc);
    if (s > best) {
      best = s;
      best_i = static_cast<int>(col);
    }
  }
  out_i[row * gridDim.x * kLanes + static_cast<long long>(split) * kLanes + lane] = best_i;
}

// ---------------------------------------------------------------------------
// Launchers.
// ---------------------------------------------------------------------------

int launch_window(const float* q, const float* r, const int32_t* tiles, int32_t* out_i, int m,
                  int k, long long ld, int w_groups, int splits, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(k) * sizeof(float);
  if (const int e = allow_smem(window_candidates_kernel, smem)) return e;
  const int gps = (w_groups + splits - 1) / splits;
  for (int r0 = 0; r0 < m; r0 += kMaxGridY) {
    const int my = m - r0 < kMaxGridY ? m - r0 : kMaxGridY;
    window_candidates_kernel<<<dim3(splits, my), kLanes, smem, stream>>>(
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
int tk_window_candidates(const float* q, const float* r, const int32_t* tiles, int32_t* out_i,
                         int m, int k, long long ld, int w_groups, int splits, void* stream) {
  if (m < 1 || k < 1 || w_groups < 1 || splits < 1 || splits > w_groups ||
      static_cast<long long>(w_groups) * kLanes > ld) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_window(q, r, tiles, out_i, m, k, ld, w_groups, splits,
                       static_cast<cudaStream_t>(stream));
}

}  // extern "C"
