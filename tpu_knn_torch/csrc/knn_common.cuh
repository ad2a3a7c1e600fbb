// Shared definitions of tpu_knn_torch's hand-written Hopper (sm_90a)
// kernels. Each *.cu file beside this header holds one family of kernels
// with its launchers and plain C entry points; csrc/build.py compiles the
// files in parallel with nvcc and links them into one library, loaded
// with ctypes.
//
// Every kernel produces the candidate contract of tpu_knn's Pallas kernels:
// the reference columns are cut into P contiguous partitions of whole
// 128-column groups, and lane l of partition p walks columns
// p*G*128 + l, p*G*128 + l + 128, ... (G groups per partition) in
// increasing order. The 1-NN kernels (B1, B2, B4) keep a running
// (min score, index) pair per lane with a strict `<`, so the earliest column
// wins among equal scores and a NaN never enters; a lane that saw no
// column reports (+inf, INT32_MAX). The top-K kernels (B5, B6) keep each
// partition's K lexicographically smallest (score, column) pairs per row,
// sorted (kselect.cuh). P = 1
// is exactly the TPU kernels' (m, 128) contract; P > 1 is v7's rebased
// (m, P*128) contract. Indices are global column numbers. Columns >= n are
// masked (never folded). The seeded top-K engine's kernels follow:
// B3 (value-only lane minima, merged to 128 lanes), B7 (per-cell integer
// moments of the columns under a bound) and the B8/B9 cell compactor.
//
// Operands: q is (m, k) row-major f32; r is the SoA operand, k rows of a
// (k_pad, ld) row-major f32 array (only rows 0..k-1 are read: the zero
// rows k..k_pad-1 are distance-neutral). Outputs are (m, width) int32/f32.
// The kernels allocate nothing and do not synchronise; each entry point
// returns the cudaError_t of its launch.
//
// A Hopper block has no carry into the next block, so where the TPU grid
// swept n in order on one core, here one block owns (row tile, partition)
// and loops over its partition's columns itself; P is chosen by the caller
// so that the grid fills the card's 132 SMs.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kLanes = 128;  // candidate lanes per partition = threads per block
constexpr int kI32Max = 2147483647;
constexpr int kMaxGridY = 65535;
constexpr int kDefaultSmem = 48 * 1024;
// An SM's shared memory (228 KB) and what the system keeps of it for each
// resident block: the budget a kernel's blocks per SM must fit; and what
// one block can address (227 KB, static and dynamic together).
constexpr size_t kSmemPerSm = 233472;
constexpr size_t kSmemPerBlockReserved = 1024;
constexpr size_t kSmemPerBlock = 232448;

__device__ __forceinline__ float pos_inf() { return __int_as_float(0x7f800000); }
__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

// ---------------------------------------------------------------------------
// The score arithmetic of the tiled f32 kernels (B1, B4, B3, B5, B7 and
// B1's variants, tiled.cuh): s = |r|^2 - 2 q.r in plain f32 FMA (tpu_knn's
// "highest" tier). They all score through micro_tile_chunk and
// column_norm_chunk, so a (row, column) pair gets a bit-identical score from
// each of them, whatever tile or partition count a launch picks: |r|^2 and
// each q.r are one fmaf chain over d = 0..k-1 in order, and 2*acc is exact.
// The top-K "passes" engine rests on that (its bound is a score B4 reported
// on an earlier pass), and so does the exact agreement of the sweep (B5) and
// passes engines.
// ---------------------------------------------------------------------------

// A staged operand value as f32: a bf16 operand (a bf16 store's, staged as
// it is stored by the tiled template's bf16 policy) is upcast at the
// shared-memory read, exactly (a bf16 is an f32's high half), so an
// instance over a bf16 operand scores bit for bit as the f32 instance over
// the upcast operand.
__device__ __forceinline__ float staged_f32(float v) { return v; }

__device__ __forceinline__ float staged_f32(__nv_bfloat16 v) {
  return __uint_as_float(static_cast<unsigned>(__bfloat16_as_ushort(v)) << 16);
}

// The arithmetic over a register micro-tile: TM query rows by TN reference
// columns, fed one staged d-chunk at a time. qs is the chunk's
// queries in shared memory at the thread's first row, [d][q_ld] (TM
// consecutive rows per d); rs is the chunk's operand at the thread's first
// column, [d][r_ld] (f32, or bf16 upcast by staged_f32), its TN columns
// col_stride apart. Per coordinate a
// thread loads TM/4 float4 query values and TN operand values and issues
// TM*TN FMAs. acc carries across chunks, so each acc[i][j] is still one
// fmaf chain over d = 0..k-1 in order (rows past k are staged as zeros on
// both sides: fmaf(0, 0, x) == x, as acc is never -0). The caller keeps
// |r|^2 with column_norm_chunk and forms s = norm - 2*acc after the last
// chunk.
template <int TM, int TN, int DK, typename T>
__device__ __forceinline__ void micro_tile_chunk(const float* qs, int q_ld, const T* rs,
                                                 int r_ld, int col_stride,
                                                 float (&acc)[TM][TN]) {
#pragma unroll
  for (int d = 0; d < DK; ++d) {
    float rv[TN];
#pragma unroll
    for (int j = 0; j < TN; ++j) rv[j] = staged_f32(rs[d * r_ld + j * col_stride]);
    float qv[TM];
    if constexpr (TM % 4 == 0) {
#pragma unroll
      for (int i = 0; i < TM; i += 4) {
        const float4 v = *reinterpret_cast<const float4*>(qs + d * q_ld + i);
        qv[i] = v.x;
        qv[i + 1] = v.y;
        qv[i + 2] = v.z;
        qv[i + 3] = v.w;
      }
    } else {
#pragma unroll
      for (int i = 0; i < TM; ++i) qv[i] = qs[d * q_ld + i];
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(qv[i], rv[j], acc[i][j]);
    }
  }
}

// |r|^2 of one staged column over a d-chunk ([d][r_ld] from rc): one fmaf
// chain over d in order, continued across chunks in `norm`.
template <int DK, typename T>
__device__ __forceinline__ float column_norm_chunk(const T* rc, int r_ld, float norm) {
#pragma unroll
  for (int d = 0; d < DK; ++d) {
    const float v = staged_f32(rc[d * r_ld]);
    norm = fmaf(v, v, norm);
  }
  return norm;
}

// One operand value as f32: a bf16 operand (a bf16 store) is upcast at the
// read, exactly (the tensor-core kernel's norm pass).
__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }

__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(__ushort_as_bfloat16(__ldg(reinterpret_cast<const unsigned short*>(p))));
}

// The exact diff-form arithmetic of B2 and B6: sum_d (r[d,col] - q[d])^2,
// one fmaf chain over d in order. B6's bound is the K-th smallest of B2's
// lane minima, so the two kernels must score a column identically (and
// B2-bf16, smallm_kernels.cu, keeps the same chain over its upcast rows).
template <int KMAX>
__device__ __forceinline__ void load_column(const float* __restrict__ rc, long long ld, int k,
                                            float (&rv)[KMAX]) {
  // All k loads of a column are issued before they are used; rows
  // k..KMAX-1 load as 0 against a 0 query coordinate: distance-neutral.
#pragma unroll
  for (int d = 0; d < KMAX; ++d) rv[d] = d < k ? __ldg(rc + d * ld) : 0.f;
}

template <int KMAX>
__device__ __forceinline__ float diff_score(const float (&rv)[KMAX], const float* qi) {
  float acc = 0.f;
#pragma unroll
  for (int d = 0; d < KMAX; ++d) {
    const float diff = rv[d] - qi[d];
    acc = fmaf(diff, diff, acc);
  }
  return acc;
}

template <int M, int KMAX>
__device__ __forceinline__ void load_small_queries(const float* __restrict__ q, float* qs, int k) {
  for (int e = threadIdx.x; e < M * KMAX; e += kLanes) {
    const int i = e / KMAX;
    const int d = e - i * KMAX;
    qs[e] = d < k ? q[i * k + d] : 0.f;
  }
  __syncthreads();
}

// 16-byte asynchronous copies into shared memory (the tensor-core kernel's
// ring, the tiled f32 kernel's cp.async policies): src_bytes < 16
// copies that many bytes and zero-fills the rest (0: no read at all).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}

// The 4-byte form (through L1), for an operand whose rows are not 16-byte
// aligned; src_bytes 0 writes a zero.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Folds `groups` 128-lane partials of a row ([group][depth][lane]) into
// the row's DEPTH*128 lane minima; one block per row (B3's and B7's
// remainder minima, tiled and tensor-core instances alike).
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

// Let `kernel` take `smem` bytes of dynamic shared memory beside
// `static_bytes` of its own: past 48 KB together, only after an opt-in.
template <typename Kernel>
int allow_smem(Kernel kernel, size_t smem, size_t static_bytes = 0) {
  if (smem + static_bytes <= kDefaultSmem) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
}

inline bool valid_geometry(int m, int k, long long ld, int n, int parts) {
  if (m < 1 || k < 1 || n < 1 || parts < 1 || ld < n) return false;
  const long long groups = (static_cast<long long>(n) + kLanes - 1) / kLanes;
  return parts <= groups;
}

inline int groups_per_part(int n, int parts) {
  const long long groups = (static_cast<long long>(n) + kLanes - 1) / kLanes;
  return static_cast<int>((groups + parts - 1) / parts);
}

}  // namespace
