// v10: batched KD-tree traversal, one thread per query.

#include "knn_common.cuh"

namespace {

// ---------------------------------------------------------------------------
// v10 — replaces tpu_knn/kdtree/traversal.py:40 _batched_traverse (a
// vmapped lax.while_loop: XLA in tpu_knn, not Pallas); its source is the
// reference's ask_device / range_ask_kernel (core.cu:1053-1094), one CUDA
// thread per query over the host-built implicit-heap tree (node 1 the root,
// children 2i and 2i + 1; p[node] the point, -1 empty; dim[node] its split
// dimension, clamped at 0; split_val[node] = ref[p[node], dim[node]]).
//
// Each thread keeps its query in registers (k a template parameter, K <= 16)
// and an explicit stack of (node, plane d^2) pairs (kStackCap entries, local
// memory). A pop whose plane d^2 > best is pruned (strict, so equal-distance
// points across the plane are still visited); a visit computes
// d2 = sum_d (q_d - r_d)^2 as __fmul_rn / __fadd_rn over d = 0..K-1 in order
// (no contraction: the host trees' and the plain version's d2 bit for bit),
// updates on d2 < best or d2 == best and a lower index (the lowest index
// wins ties, as v0), then pushes the far child with (q[dim] - split_val)^2
// and the near child with 0, each only when child < cap and p[child] >= 0
// (and the stack has room: a balanced median-split tree never fills it).
// A query makes at most cap + kStackCap pops (tpu_knn's step bound).
//
// Bound on the H100: the larger of the bytes it must read (the tree's
// p, dim, split_val and the (n, k) points once, the queries once, the
// answers written once) over 3.35 TB/s and the visits x 3k flops over the
// f32 peak; the reads are dependent loads through the read-only path
// (__ldg), so a visit costs a few memory latencies and the kernel is
// latency-bound far above that bound. Design: the simplest correct form,
// blocks of one warp (kTraverseBlock) so that a batch of m = 1024 spreads
// over 32 SMs instead of 8; the tree's upper levels stay in L1/L2 for all
// queries.
// ---------------------------------------------------------------------------
constexpr int kStackCap = 36;
constexpr int kTraverseBlock = 32;

template <int K>
__global__ void __launch_bounds__(kTraverseBlock)
kdtree_traverse_kernel(const float* __restrict__ q, const float* __restrict__ ref,
                       const int32_t* __restrict__ p, const int32_t* __restrict__ dim,
                       const float* __restrict__ split_val, int32_t* __restrict__ out_i,
                       float* __restrict__ out_d2, int m, int cap) {
  const int row = blockIdx.x * kTraverseBlock + threadIdx.x;
  if (row >= m) return;
  float qv[K];
#pragma unroll
  for (int d = 0; d < K; ++d) qv[d] = __ldg(q + static_cast<long long>(row) * K + d);
  int stack_n[kStackCap];
  float stack_d[kStackCap];
  stack_n[0] = 1;
  stack_d[0] = 0.f;
  int sp = 1;
  float best = pos_inf();
  int besti = kI32Max;
  const long long max_steps = static_cast<long long>(cap) + kStackCap;
  for (long long step = 0; sp > 0 && step < max_steps; ++step) {
    --sp;
    const int node = stack_n[sp];
    if (stack_d[sp] > best) continue;
    const int pi = __ldg(p + node);
    const float* r = ref + static_cast<long long>(pi) * K;
    float acc = 0.f;
#pragma unroll
    for (int d = 0; d < K; ++d) {
      const float diff = __fsub_rn(qv[d], __ldg(r + d));
      acc = __fadd_rn(acc, __fmul_rn(diff, diff));
    }
    if (acc < best || (acc == best && pi < besti)) {
      best = acc;
      besti = pi;
    }
    const int split_dim = __ldg(dim + node);
    float qd = qv[0];
#pragma unroll
    for (int d = 1; d < K; ++d) qd = d == split_dim ? qv[d] : qd;
    const float delta = __fsub_rn(qd, __ldg(split_val + node));
    const int left = 2 * node;
    const int near_child = delta < 0.f ? left : left + 1;
    const int far_child = delta < 0.f ? left + 1 : left;
    if (sp < kStackCap && far_child < cap && __ldg(p + far_child) >= 0) {
      stack_n[sp] = far_child;
      stack_d[sp] = __fmul_rn(delta, delta);
      ++sp;
    }
    if (sp < kStackCap && near_child < cap && __ldg(p + near_child) >= 0) {
      stack_n[sp] = near_child;
      stack_d[sp] = 0.f;
      ++sp;
    }
  }
  out_i[row] = besti;
  out_d2[row] = best;
}

template <int K>
int launch_traverse(const float* q, const float* ref, const int32_t* p, const int32_t* dim,
                    const float* split_val, int32_t* out_i, float* out_d2, int m, int cap,
                    cudaStream_t stream) {
  const int blocks = (m + kTraverseBlock - 1) / kTraverseBlock;
  kdtree_traverse_kernel<K><<<blocks, kTraverseBlock, 0, stream>>>(q, ref, p, dim, split_val,
                                                                 out_i, out_d2, m, cap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// v10: q (m, k) and ref (n, k) f32 row-major, 1 <= k <= 16; p, dim, split_val
// the (cap = 4n,) tree arrays, dim clamped at 0; out_i (m,) int32, out_d2
// (m,) f32.
int tk_kdtree_traverse(const float* q, const float* ref, const int32_t* p, const int32_t* dim,
                       const float* split_val, int32_t* out_i, float* out_d2, int m, int k,
                       int cap, void* stream) {
  if (m < 1 || cap < 4 || cap > kI32Max / 2) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
#define TK_TRAVERSE_CASE(K) \
  case K:                   \
    return launch_traverse<K>(q, ref, p, dim, split_val, out_i, out_d2, m, cap, s);
    TK_TRAVERSE_CASE(1)
    TK_TRAVERSE_CASE(2)
    TK_TRAVERSE_CASE(3)
    TK_TRAVERSE_CASE(4)
    TK_TRAVERSE_CASE(5)
    TK_TRAVERSE_CASE(6)
    TK_TRAVERSE_CASE(7)
    TK_TRAVERSE_CASE(8)
    TK_TRAVERSE_CASE(9)
    TK_TRAVERSE_CASE(10)
    TK_TRAVERSE_CASE(11)
    TK_TRAVERSE_CASE(12)
    TK_TRAVERSE_CASE(13)
    TK_TRAVERSE_CASE(14)
    TK_TRAVERSE_CASE(15)
    TK_TRAVERSE_CASE(16)
#undef TK_TRAVERSE_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
