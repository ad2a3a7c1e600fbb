// B2 (small-m lane minima) and B6 (small-m per-lane K-lists): the exact
// diff-form kernels for 1 <= m <= 4.

#include "knn_common.cuh"

namespace {

// ---------------------------------------------------------------------------
// B2 — replaces tpu_knn/kernels/smallm.py:_smallm_kernel (built by
// _build_smallm_candidates): for 1 <= m <= 4 and k <= 32, the exact
// diff-form score, whose error scales with d^2 itself (no norm-trick
// cancellation), so its scores are exact candidates. RT is the operand's
// type: float, or __nv_bfloat16 for a bf16 store (B2-bf16: upcast at the
// read, as tpu_knn's kernel does, smallm.py:94-97; half the bytes).
//
// Bound on the H100: device-memory reads, one pass over k*n*4 bytes (1 GiB
// at k=16, n=2^24, about 0.32 ms at 3.35 TB/s); the arithmetic is a few
// operations per byte. Design: the same lane-per-thread sweep as B1 with
// the queries in shared memory (broadcast reads). Each thread issues all k
// loads of a column before it uses them (KMAX, the next of 8/16/32 above k,
// is a compile-time bound with predicated loads), and the caller picks many
// partitions so that enough loads are in flight to cover device latency.
// ---------------------------------------------------------------------------
template <int M, int KMAX, typename RT>
__global__ void __launch_bounds__(kLanes)
smallm_candidates_kernel(const float* __restrict__ q, const RT* __restrict__ r,
                         int32_t* __restrict__ out_i, float* __restrict__ out_s,
                         int k, long long ld, int n, int groups_per_part) {
  __shared__ float qs[M * KMAX];
  const int part = blockIdx.x;
  const int lane = threadIdx.x;
  load_small_queries<M, KMAX>(q, qs, k);

  float best_s[M];
  int best_i[M];
#pragma unroll
  for (int i = 0; i < M; ++i) {
    best_s[i] = pos_inf();
    best_i[i] = kI32Max;
  }

  const long long first = static_cast<long long>(part) * groups_per_part * kLanes + lane;
  for (int g = 0; g < groups_per_part; ++g) {
    const long long col = first + static_cast<long long>(g) * kLanes;
    if (col >= n) break;
    float rv[KMAX];
    load_column<KMAX>(r + col, ld, k, rv);
    const int c = static_cast<int>(col);
#pragma unroll
    for (int i = 0; i < M; ++i) {
      const float acc = diff_score<KMAX>(rv, qs + i * KMAX);
      if (acc < best_s[i]) {
        best_s[i] = acc;
        best_i[i] = c;
      }
    }
  }

  const long long width = static_cast<long long>(gridDim.x) * kLanes;
#pragma unroll
  for (int i = 0; i < M; ++i) {
    const long long o = i * width + static_cast<long long>(part) * kLanes + lane;
    out_i[o] = best_i[i];
    out_s[o] = best_s[i];
  }
}

// ---------------------------------------------------------------------------
// B6 — replaces tpu_knn/kernels/topk.py:_smallm_topk_kernel (built by
// _build_smallm_topk_candidates): B5's per-lane K-lists over B2's exact
// diff-form scores, for 1 <= m <= 4 and k <= 32, with every list seeded
// at (B, INT32_MAX), where B is the row's bound (the K-th smallest of a B2
// pass's lane minima, a provable upper bound on the row's K-th score). So
// only elements with score <= B enter, and the sentinel entries that stay
// (index INT32_MAX >= n) lose the final selection.
//
// Bound on the H100: device-memory reads, as B2 (1 GiB at k=16, n=2^24,
// about 0.32 ms). Design: B2's sweep (all k loads of a column in flight).
// Insertions are rare, since the bound rejects almost every element, so
// the m x K lists live in shared memory (up to 4 x 32 x 128 x 8 bytes =
// 128 KB), laid out [row][level][lane] so that each thread touches only
// its own lane's column of it, without bank conflicts. Each row's current
// K-th score stays in a register for the skip guard. K is a runtime value.
// ---------------------------------------------------------------------------
__device__ __forceinline__ float kstate_insert_shared(float* ss, int* si, int kk, float s, int c) {
  for (int l = 0; l < kk; ++l) {
    const float os = ss[l * kLanes];
    const int oi = si[l * kLanes];
    if (s < os || (s == os && c < oi)) {
      ss[l * kLanes] = s;
      si[l * kLanes] = c;
      s = os;
      c = oi;
    }
  }
  return ss[(kk - 1) * kLanes];
}

template <int M, int KMAX>
__global__ void __launch_bounds__(kLanes)
smallm_topk_candidates_kernel(const float* __restrict__ q, const float* __restrict__ r,
                              const float* __restrict__ bound,
                              int32_t* __restrict__ out_i, float* __restrict__ out_s,
                              int k, long long ld, int n, int groups_per_part, int kk) {
  __shared__ float qs[M * KMAX];
  extern __shared__ float4 smem4[];
  float* st_s = reinterpret_cast<float*>(smem4);  // [M][kk][128]
  int* st_i = reinterpret_cast<int*>(st_s + M * kk * kLanes);
  const int part = blockIdx.x;
  const int lane = threadIdx.x;

  float worst[M];
#pragma unroll
  for (int i = 0; i < M; ++i) {
    worst[i] = bound[i];
    for (int l = 0; l < kk; ++l) {
      st_s[(i * kk + l) * kLanes + lane] = worst[i];
      st_i[(i * kk + l) * kLanes + lane] = kI32Max;
    }
  }
  load_small_queries<M, KMAX>(q, qs, k);

  const long long first = static_cast<long long>(part) * groups_per_part * kLanes + lane;
  for (int g = 0; g < groups_per_part; ++g) {
    const long long col = first + static_cast<long long>(g) * kLanes;
    if (col >= n) break;
    float rv[KMAX];
    load_column<KMAX>(r + col, ld, k, rv);
    const int c = static_cast<int>(col);
#pragma unroll
    for (int i = 0; i < M; ++i) {
      const float acc = diff_score<KMAX>(rv, qs + i * KMAX);
      if (acc <= worst[i] && acc < pos_inf()) {
        worst[i] = kstate_insert_shared(st_s + i * kk * kLanes + lane,
                                        st_i + i * kk * kLanes + lane, kk, acc, c);
      }
    }
  }

  const long long width = static_cast<long long>(gridDim.x) * kk * kLanes;
  for (int i = 0; i < M; ++i) {
    for (int l = 0; l < kk; ++l) {
      const long long o = i * width + (static_cast<long long>(part) * kk + l) * kLanes + lane;
      out_i[o] = st_i[(i * kk + l) * kLanes + lane];
      out_s[o] = st_s[(i * kk + l) * kLanes + lane];
    }
  }
}

// ---------------------------------------------------------------------------
// Launchers.
// ---------------------------------------------------------------------------

template <int M, typename RT>
int launch_smallm(const float* q, const RT* r, int32_t* out_i, float* out_s, int k,
                  long long ld, int n, int parts, int groups_per_part,
                  cudaStream_t stream) {
  if (k <= 8) {
    smallm_candidates_kernel<M, 8, RT><<<parts, kLanes, 0, stream>>>(
        q, r, out_i, out_s, k, ld, n, groups_per_part);
  } else if (k <= 16) {
    smallm_candidates_kernel<M, 16, RT><<<parts, kLanes, 0, stream>>>(
        q, r, out_i, out_s, k, ld, n, groups_per_part);
  } else {
    smallm_candidates_kernel<M, 32, RT><<<parts, kLanes, 0, stream>>>(
        q, r, out_i, out_s, k, ld, n, groups_per_part);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename RT>
int smallm_entry(const float* q, const RT* r, int32_t* out_i, float* out_s, int m, int k,
                 long long ld, int n, int parts, void* stream) {
  if (!valid_geometry(m, k, ld, n, parts) || k > 32) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int gpp = groups_per_part(n, parts);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (m) {
    case 1: return launch_smallm<1>(q, r, out_i, out_s, k, ld, n, parts, gpp, s);
    case 2: return launch_smallm<2>(q, r, out_i, out_s, k, ld, n, parts, gpp, s);
    case 3: return launch_smallm<3>(q, r, out_i, out_s, k, ld, n, parts, gpp, s);
    case 4: return launch_smallm<4>(q, r, out_i, out_s, k, ld, n, parts, gpp, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int M, int KMAX>
int launch_smallm_topk_k(const float* q, const float* r, const float* bound, int32_t* out_i,
                         float* out_s, int k, long long ld, int n, int parts,
                         int groups_per_part, int kk, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(M) * kk * kLanes * (sizeof(float) + sizeof(int));
  if (const int e = allow_smem(smallm_topk_candidates_kernel<M, KMAX>, smem)) return e;
  smallm_topk_candidates_kernel<M, KMAX><<<parts, kLanes, smem, stream>>>(
      q, r, bound, out_i, out_s, k, ld, n, groups_per_part, kk);
  return static_cast<int>(cudaGetLastError());
}

template <int M>
int launch_smallm_topk(const float* q, const float* r, const float* bound, int32_t* out_i,
                       float* out_s, int k, long long ld, int n, int parts, int groups_per_part,
                       int kk, cudaStream_t s) {
  if (k <= 8) {
    return launch_smallm_topk_k<M, 8>(q, r, bound, out_i, out_s, k, ld, n, parts,
                                      groups_per_part, kk, s);
  }
  if (k <= 16) {
    return launch_smallm_topk_k<M, 16>(q, r, bound, out_i, out_s, k, ld, n, parts,
                                       groups_per_part, kk, s);
  }
  return launch_smallm_topk_k<M, 32>(q, r, bound, out_i, out_s, k, ld, n, parts,
                                     groups_per_part, kk, s);
}

}  // namespace

extern "C" {

// B2 launch: 1 <= m <= 4, 1 <= k <= 32.
int tk_smallm_candidates(const float* q, const float* r, int32_t* out_i, float* out_s,
                         int m, int k, long long ld, int n, int parts, void* stream) {
  return smallm_entry(q, r, out_i, out_s, m, k, ld, n, parts, stream);
}

// B2-bf16 launch: B2 over a bf16 SoA operand (a bf16 store).
int tk_smallm_candidates_bf16(const float* q, const void* r, int32_t* out_i, float* out_s,
                              int m, int k, long long ld, int n, int parts, void* stream) {
  return smallm_entry(q, static_cast<const __nv_bfloat16*>(r), out_i, out_s, m, k, ld, n,
                      parts, stream);
}

// B6 launch: 1 <= m <= 4, 1 <= k <= 32, 1 <= kk <= 32; bound (m,) f32;
// outputs are (m, parts*kk*128).
int tk_smallm_topk_candidates(const float* q, const float* r, const float* bound,
                              int32_t* out_i, float* out_s, int m, int k, long long ld, int n,
                              int parts, int kk, void* stream) {
  if (!valid_geometry(m, k, ld, n, parts) || k > 32 || kk < 1 || kk > 32) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int gpp = groups_per_part(n, parts);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (m) {
    case 1: return launch_smallm_topk<1>(q, r, bound, out_i, out_s, k, ld, n, parts, gpp, kk, s);
    case 2: return launch_smallm_topk<2>(q, r, bound, out_i, out_s, k, ld, n, parts, gpp, kk, s);
    case 3: return launch_smallm_topk<3>(q, r, bound, out_i, out_s, k, ld, n, parts, gpp, kk, s);
    case 4: return launch_smallm_topk<4>(q, r, bound, out_i, out_s, k, ld, n, parts, gpp, kk, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
