// v10: batched KD-tree traversal over node records.

#include "knn_common.cuh"

namespace {

// ---------------------------------------------------------------------------
// v10 — replaces tpu_knn/kdtree/traversal.py:40 _batched_traverse (a
// vmapped lax.while_loop: XLA in tpu_knn, not Pallas); its source is the
// reference's ask_device / range_ask_kernel (core.cu:1053-1094), one CUDA
// thread per query over the host-built implicit-heap tree (node 1 the root,
// children 2i and 2i + 1).
//
// The contract is the reference's: a pop whose plane d^2 > best is pruned
// (strict, so equal-distance points across the plane are still visited); a
// visit computes d2 = sum_d (q_d - r_d)^2 as __fmul_rn / __fadd_rn over d =
// 0..K-1 in order (no contraction: the host trees' and the plain version's
// d2 bit for bit) and keeps the lexicographic minimum of (d2, index) (the
// lowest index wins ties, as v0); it pushes the far child with (q[dim] -
// split_val)^2 and the near child with 0, each where the child exists. No
// point at the final best distance is ever pruned (a plane d^2 never
// exceeds the distance of a point beyond the plane), so the answer does not
// depend on the order of the visits: it is traverse_plain's bit for bit.
//
// Bound on the H100: the larger of the bytes it must read (each distinct
// visited node's record once, the queries once, the answers written once)
// over 3.35 TB/s and the visits x 3k flops over the f32 peak: well below a
// microsecond. The kernel is latency-bound instead: a query's visits form a
// chain of dependent reads (the next node is known only once the last one's
// split is read), and the longest query of a warp sets the warp's time.
// The design shortens each link:
// - one record a node (kd_records: split_val, point index, split dimension
//   with a bit for each child that exists, the point's K coordinates,
//   16 bytes aligned), so a visit is one dependent read of one or two
//   sectors, where the first form read p, then the point, then dim,
//   split_val and both children's p (three round trips, four arrays);
// - the top levels' records (top_levels<K>: 2^10 - 1 nodes at k = 3, 32 KB)
//   staged once a block in shared memory by cp.async;
// - the stack of (node, plane d^2) pairs in shared memory, a warp's
//   stacks side by side, not in local memory;
// - G lanes a query (traversal.traverse_lanes: 1 at k <= 3, a warp above):
//   each step a
//   group pops the top min(G, sp) entries, visits them side by side, folds
//   the visits' (d2, index) into best by shuffles, and pushes lane j's far
//   then near child above the children of lanes j + 1 .. G - 1, so the
//   stack stays sorted by level with at most 2 G entries a level (2 G
//   kStackCap a group; the host's stack_levels check keeps a tree within
//   kStackCap levels, and a push past the stack traps instead of being
//   dropped). A group steps on its own: one lane a query runs each query's
//   chain apart, as the first form's threads did (a first trial that held
//   the warp in step by its votes, and prefetched each visit's children
//   into L1, took 0.112 ms at ds10 against the first form's 0.094). A warp
//   a query prunes less than one lane (it visits the top 32 entries before
//   their siblings' best is known) but cuts the chain of steps up to 32
//   times where the tree prunes little: at k = 16 2.40 ms against one
//   lane's 25.0, at ds10 0.085 against 0.054 (PERF.md §6, PR 22).
// ---------------------------------------------------------------------------
constexpr int kStackCap = 36;           // levels of the deepest tree (traversal.STACK_CAP)
constexpr int kTraverseBlock = 32;      // one warp a block
constexpr int kRecordHead = 4;          // words before a record's coordinates (RECORD_HEAD)
constexpr size_t kTopBytes = 32 * 1024;  // the top levels' records in shared memory

template <int K>
__host__ __device__ constexpr int record_words() {
  return kRecordHead + (K + 3) / 4 * 4;
}

// The levels whose records (nodes 0 .. 2^L - 1, node 0 unused) fit
// kTopBytes: 10 at k <= 4 (32-byte records), 8 at k = 13..16 (80 bytes).
template <int K>
__host__ __device__ constexpr int top_levels() {
  int l = 0;
  while ((static_cast<size_t>(2) << l) * record_words<K>() * 4 <= kTopBytes) ++l;
  return l;
}

template <int K, int G>
__host__ __device__ constexpr size_t traverse_smem() {
  return (static_cast<size_t>(1) << top_levels<K>()) * record_words<K>() * 4 +
         static_cast<size_t>(kTraverseBlock / G) * 2 * G * kStackCap * sizeof(int2);
}

// Word i of a 16-byte piece of a record (i a compile-time constant).
__device__ __forceinline__ int word_of(const int4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

template <int K, int G>
__global__ void __launch_bounds__(kTraverseBlock)
kdtree_traverse_kernel(const float* __restrict__ q, const int4* __restrict__ rec,
                       int32_t* __restrict__ out_i, float* __restrict__ out_d2, int m, int top) {
  static_assert(G == 1 || G == 32, "a query takes one lane or a warp");
  constexpr int RW = record_words<K>() / 4;  // int4s a record
  constexpr int CAP = 2 * G * kStackCap;     // stack entries a group
  extern __shared__ int4 kd_smem[];
  const int staged = min(1 << top_levels<K>(), top + 1);  // records 0 .. staged - 1
  for (int e = threadIdx.x; e < staged * RW; e += kTraverseBlock) {
    cp_async16(kd_smem + e, rec + e, 16);
  }
  cp_async_commit();
  const int lane = threadIdx.x;
  const int sub = lane % G;  // the lane within its query's group
  const int row = blockIdx.x * (kTraverseBlock / G) + lane / G;
  const bool active = row < m;
  float qv[K];
#pragma unroll
  for (int d = 0; d < K; ++d) qv[d] = active ? __ldg(q + static_cast<long long>(row) * K + d) : 0.f;
  int2* const stk = reinterpret_cast<int2*>(kd_smem + (1 << top_levels<K>()) * RW) +
                    (lane / G) * CAP;
  int sp = active ? 1 : 0;
  if (active && sub == 0) stk[0] = make_int2(1, 0);
  // The group's lanes, and those after this one. A group steps on its own:
  // its lanes meet at its shuffles and ballots only, so the lanes of other
  // groups (one lane a query: every lane) run their chains apart, each
  // waiting on its own loads only.
  const unsigned group = (G == 32 ? 0xffffffffu : (1u << G) - 1u) << (lane / G * G);
  const unsigned above = group & ~((2u << lane) - 1u);
  cp_async_wait<0>();
  __syncthreads();
  float best = pos_inf();
  int besti = kI32Max;
  while (sp > 0) {  // the same in every lane of the group
    const int npop = min(G, sp);
    int node = 0;
    bool visit = false;
    if (sub < npop) {
      const int2 e = stk[sp - 1 - sub];
      node = e.x;
      visit = !(__int_as_float(e.y) > best);
    }
    sp -= npop;
    if constexpr (G > 1) __syncwarp(group);  // every pop is read before a push overwrites its slot
    float cd = pos_inf();
    int ci = kI32Max;
    bool far_ok = false, near_ok = false;
    int far_child = 0;
    float plane = 0.f;
    if (visit) {
      int4 v[RW];
      if (node < staged) {
#pragma unroll
        for (int w = 0; w < RW; ++w) v[w] = kd_smem[node * RW + w];
      } else {
#pragma unroll
        for (int w = 0; w < RW; ++w) v[w] = __ldg(rec + static_cast<long long>(node) * RW + w);
      }
      float acc = 0.f;
#pragma unroll
      for (int d = 0; d < K; ++d) {
        const int w = kRecordHead + d;
        const float diff = __fsub_rn(qv[d], __int_as_float(word_of(v[w / 4], w % 4)));
        acc = __fadd_rn(acc, __fmul_rn(diff, diff));
      }
      cd = acc;
      ci = v[0].y;
      const int meta = v[0].z;
      const int split_dim = meta & 0xff;
      float qd = qv[0];
#pragma unroll
      for (int d = 1; d < K; ++d) qd = d == split_dim ? qv[d] : qd;
      const float delta = __fsub_rn(qd, __int_as_float(v[0].x));
      const bool near_left = delta < 0.f;
      const bool has_left = (meta >> 8) & 1, has_right = (meta >> 9) & 1;
      far_child = near_left ? 2 * node + 1 : 2 * node;
      far_ok = near_left ? has_right : has_left;
      near_ok = near_left ? has_left : has_right;
      plane = __fmul_rn(delta, delta);
    }
    // The group's lexicographic minimum of its visits' (d2, index).
#pragma unroll
    for (int o = 1; o < G; o <<= 1) {
      const float od = __shfl_xor_sync(group, cd, o);
      const int oi = __shfl_xor_sync(group, ci, o);
      if (od < cd || (od == cd && oi < ci)) {
        cd = od;
        ci = oi;
      }
    }
    if (cd < best || (cd == best && ci < besti)) {
      best = cd;
      besti = ci;
    }
    // Lane j's far then near child above the children of the group's lanes
    // after it (lane 0 popped the top, the deepest entry).
    int at = sp;
    if constexpr (G > 1) {
      const unsigned fm = __ballot_sync(group, far_ok);
      const unsigned nm = __ballot_sync(group, near_ok);
      at += __popc(fm & above) + __popc(nm & above);
      sp += __popc(fm) + __popc(nm);
    } else {
      sp += far_ok + near_ok;
    }
    if (sp > CAP) __trap();  // a tree deeper than stack_levels allows
    if (far_ok) stk[at++] = make_int2(far_child, __float_as_int(plane));
    if (near_ok) stk[at] = make_int2(far_child ^ 1, 0);
    if constexpr (G > 1) __syncwarp(group);
  }
  if (active && sub == 0) {
    out_i[row] = besti;
    out_d2[row] = best;
  }
}

template <int K, int G>
int launch_traverse(const float* q, const int4* rec, int32_t* out_i, float* out_d2, int m,
                    int top, cudaStream_t stream) {
  constexpr size_t smem = traverse_smem<K, G>();
  static_assert(smem <= kSmemPerBlock, "the top levels and the stacks fit a block");
  auto kernel = kdtree_traverse_kernel<K, G>;
  if (const int err = allow_smem(kernel, smem)) return err;
  const int blocks = (m + kTraverseBlock / G - 1) / (kTraverseBlock / G);
  kernel<<<blocks, kTraverseBlock, smem, stream>>>(q, rec, out_i, out_d2, m, top);
  return static_cast<int>(cudaGetLastError());
}

template <int K>
int launch_traverse_lanes(const float* q, const int4* rec, int32_t* out_i, float* out_d2, int m,
                          int top, int lanes, cudaStream_t stream) {
  switch (lanes) {
    case 1: return launch_traverse<K, 1>(q, rec, out_i, out_d2, m, top, stream);
    case 32: return launch_traverse<K, 32>(q, rec, out_i, out_d2, m, top, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// v10: q (m, k) f32 row-major, 1 <= k <= 16; rec the (top + 1,
// record_words(k)) int32 node records (traversal.kd_records, 16-byte
// aligned), top the last used node, its levels within kStackCap; lanes a
// query 1 or 32; out_i (m,) int32, out_d2 (m,) f32.
int tk_kdtree_traverse(const float* q, const int32_t* rec, int32_t* out_i, float* out_d2, int m,
                       int k, int top, int lanes, void* stream) {
  if (m < 1 || top < 1 || top >= kI32Max / 4 || 32 - __builtin_clz(top) > kStackCap ||
      reinterpret_cast<uintptr_t>(rec) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int4* r = reinterpret_cast<const int4*>(rec);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
#define TK_TRAVERSE_CASE(K) \
  case K:                   \
    return launch_traverse_lanes<K>(q, r, out_i, out_d2, m, top, lanes, s);
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
