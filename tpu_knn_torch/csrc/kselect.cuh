// The K-selection that the top-K kernels B5 (sweep_kernels.cu) and B6
// (smallm_kernels.cu) share: per (row, list), the kk lexicographically
// smallest (score, column) pairs of the list's columns, kept by one warp in
// shared memory.
//
// The list map (topk.list_of in Python): the reference columns are cut
// into P partitions of whole 128-column groups, knn_common.cuh's partition
// map (partition p holds groups [p*G, (p+1)*G), G = groups_per_part(n, P)),
// and each (row, partition) keeps one list. A row's output is (P*kk)
// wide: slot p*kk + l holds level l of partition p's list, levels
// ascending by (score, column), a lower column first among equal scores.
// Only scores below +inf enter (NaN never does); the slots a list does not
// fill keep its seed: (+inf, INT32_MAX) for B5, (B, INT32_MAX) for B6,
// whose bound B admits only scores <= B. The union of a row's lists holds
// its lexicographic top-K, since a list holds at most K of them.
//
// One (row, list)'s state (KSelectState, one warp's): the list, kListSlots
// (score, column) pairs sorted ascending (slots kk.. are kept but not
// reported), and a queue of up to kQueueSlots entries not yet merged. The
// warp offers its 32 lanes' elements together (kselect_offer): an element
// is queued if it lies lexicographically below the list's kk-th entry, at
// a slot given by a ballot and popc, with no atomics. When the queue would
// overflow, and once more at the end (kselect_flush), the warp merges it
// into the list (kselect_merge): a bitonic sort of the queue across the
// lanes, then the bitonic merge of the list with it reversed, keeping the
// kListSlots smallest. The threshold only tightens, so an element turned
// away could never enter; the kept set does not depend on the order in
// which entries were queued, so two launches give the same lists. After
// the first tiles almost nothing passes the threshold (about
// kk*ln(columns/kk) insertions a list in all), so the merges are rare.

#pragma once

#include "knn_common.cuh"

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kListSlots = 32;   // a list's slots: one a lane; kk <= 32 are reported
constexpr int kQueueSlots = 32;  // a queue's: one warp's offer fits an empty queue

// The state of ROWS (row, list)s, each kept by one warp.
template <int ROWS>
struct KSelectState {
  float ls[ROWS][kListSlots];
  int li[ROWS][kListSlots];
  float qs[ROWS][kQueueSlots];
  int qi[ROWS][kQueueSlots];
  int qn[ROWS];
  float bs[ROWS];  // a bound on the list's kk-th entry, in the threshold's
  int bc[ROWS];    // form: only (s, c) lexicographically below it can enter
};

// The list's partition: the list map above.
__host__ __device__ __forceinline__ int list_of(long long col, int groups_per_part) {
  return static_cast<int>(col / kLanes / groups_per_part);
}

__device__ __forceinline__ bool lex_less(float s, int c, float ts, int tc) {
  return s < ts || (s == ts && c < tc);
}

// One compare-exchange of a bitonic network across the warp: the lane and
// lane ^ j swap (score, column) pairs so that the lane keeps the smaller
// (keep_min) or the larger.
__device__ __forceinline__ void exchange(float& s, int& c, int j, bool keep_min) {
  const float os = __shfl_xor_sync(kFullMask, s, j);
  const int oc = __shfl_xor_sync(kFullMask, c, j);
  const bool take = keep_min == lex_less(os, oc, s, c);
  s = take ? os : s;
  c = take ? oc : c;
}

// Sort the warp's 32 pairs ascending, lane order (a bitonic sort).
__device__ __forceinline__ void warp_sort32(float& s, int& c) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int k = 2; k <= 32; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      exchange(s, c, j, ((lane & j) == 0) == ((lane & k) == 0));
    }
  }
}

// Sort a bitonic sequence of 32 pairs ascending (a bitonic merge).
__device__ __forceinline__ void warp_merge32(float& s, int& c) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int j = 16; j > 0; j >>= 1) exchange(s, c, j, (lane & j) == 0);
}

// The 32 smallest of two ascending lists, ascending: lane l's pair (s, c)
// of the first, (os, oc) the second's pair at lane 31 - l.
__device__ __forceinline__ void merge_lists(float& s, int& c, float os, int oc) {
  const bool take = lex_less(os, oc, s, c);
  s = take ? os : s;
  c = take ? oc : c;
  warp_merge32(s, c);
}

// Warp-collective: seed list `row` with (seed, INT32_MAX) in every slot and
// empty its queue.
template <int ROWS>
__device__ __forceinline__ void kselect_init(KSelectState<ROWS>& st, int row, float seed) {
  const int lane = threadIdx.x % 32;
  st.ls[row][lane] = seed;
  st.li[row][lane] = kI32Max;
  if (lane == 0) {
    st.qn[row] = 0;
    st.bs[row] = seed;
    st.bc[row] = kI32Max;
  }
  __syncwarp();
}

// The tighter of (a, ac) and (b, bc) as a threshold, in (ts, tc).
__device__ __forceinline__ void tighter(float a, int ac, float b, int bc, float& ts, int& tc) {
  const bool first = lex_less(a, ac, b, bc);
  ts = first ? a : b;
  tc = first ? ac : bc;
}

// Warp-collective: merge list `row`'s queue into it, empty the queue and
// return its threshold (kselect_threshold) in (ts, tc).
template <int ROWS>
__device__ __forceinline__ void kselect_merge(KSelectState<ROWS>& st, int row, int kk, float& ts,
                                              int& tc) {
  const int lane = threadIdx.x % 32;
  const int queued = st.qn[row];
  float s = lane < queued ? st.qs[row][lane] : pos_inf();
  int c = lane < queued ? st.qi[row][lane] : kI32Max;
  warp_sort32(s, c);
  const float rs = __shfl_sync(kFullMask, s, 31 - lane);
  const int rc = __shfl_sync(kFullMask, c, 31 - lane);
  s = st.ls[row][lane];
  c = st.li[row][lane];
  merge_lists(s, c, rs, rc);
  st.ls[row][lane] = s;
  st.li[row][lane] = c;
  tighter(__shfl_sync(kFullMask, s, kk - 1), __shfl_sync(kFullMask, c, kk - 1), st.bs[row],
          st.bc[row], ts, tc);
  __syncwarp();
  if (lane == 0) st.qn[row] = 0;
  __syncwarp();
}

// Whether (s, c) would enter a list whose kk-th entry is (ts, tc).
__device__ __forceinline__ bool kselect_passes(float s, int c, float ts, int tc) {
  return s < pos_inf() && lex_less(s, c, ts, tc);
}

// Warp-collective: each lane offers its N elements s[j], at columns c0 +
// j * stride, to list `row`, whose threshold the caller holds in (ts, tc)
// (kept up to date here); `live` (warp-uniform) has bit j clear where no
// lane's s[j] passes, and those j are skipped. An element is queued if it
// passes (kselect_passes), j by j, each j's entries at slots given by a
// ballot and popc. Where a j's entries would overflow the queue, the warp
// merges it (a tighter threshold) and goes on from that j: one merge site
// for all N, so the merge's code appears once.
template <int N, int ROWS>
__device__ __forceinline__ void kselect_offer(KSelectState<ROWS>& st, int row, int kk,
                                              const float (&s)[N], int c0, int stride,
                                              float& ts, int& tc, unsigned live = ~0u) {
  const int lane = threadIdx.x % 32;
  for (int start = 0;;) {
    int queued = st.qn[row];
    int stop = N;  // the first j that did not fit
#pragma unroll
    for (int j = 0; j < N; ++j) {
      if (j >= start && stop == N && (live >> j & 1u)) {  // warp-uniform
        const int c = c0 + j * stride;
        const bool take = kselect_passes(s[j], c, ts, tc);
        const unsigned bal = __ballot_sync(kFullMask, take);
        if (queued + __popc(bal) > kQueueSlots) {
          stop = j;
        } else {
          if (take) {
            const int slot = queued + __popc(bal & ((1u << lane) - 1u));
            st.qs[row][slot] = s[j];
            st.qi[row][slot] = c;
          }
          queued += __popc(bal);
        }
      }
    }
    __syncwarp();
    if (lane == 0) st.qn[row] = queued;
    __syncwarp();
    if (stop == N) return;
    kselect_merge(st, row, kk, ts, tc);
    start = stop;
  }
}

// Warp-collective: merge what list `row` still has queued.
template <int ROWS>
__device__ __forceinline__ void kselect_flush(KSelectState<ROWS>& st, int row, int kk) {
  if (st.qn[row] > 0) {  // warp-uniform
    float ts;
    int tc;
    kselect_merge(st, row, kk, ts, tc);
  }
}

// List `row`'s threshold (every lane): the tighter of its kk-th entry and
// its bound.
template <int ROWS>
__device__ __forceinline__ void kselect_threshold(const KSelectState<ROWS>& st, int row, int kk,
                                                  float& ts, int& tc) {
  tighter(st.ls[row][kk - 1], st.li[row][kk - 1], st.bs[row], st.bc[row], ts, tc);
}

// Warp-collective: bound list `row` by the warp's N elements a lane (s[j]
// at column c0 + j * stride): the lanes' minima are 32 distinct elements,
// so their kk-th smallest (bs, bc) has at least kk elements at or below
// it, and no element above it can be among the kk smallest. A list that is
// not full yet (threshold +inf) would otherwise queue every element of its
// first tiles; from its bound (bs, bc + 1), the threshold form of "at or
// below (bs, bc)", it queues about kk of them. Updates (ts, tc).
template <int N, int ROWS>
__device__ __forceinline__ void kselect_bound(KSelectState<ROWS>& st, int row, int kk,
                                              const float (&s)[N], int c0, int stride,
                                              float& ts, int& tc) {
  float ms = pos_inf();
  int mc = kI32Max;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int c = c0 + j * stride;
    const bool take = kselect_passes(s[j], c, ms, mc);
    ms = take ? s[j] : ms;
    mc = take ? c : mc;
  }
  warp_sort32(ms, mc);
  const float bs = __shfl_sync(kFullMask, ms, kk - 1);
  const int bc = __shfl_sync(kFullMask, mc, kk - 1);
  if (bs < pos_inf() && lex_less(bs, bc + 1, ts, tc)) {  // warp-uniform
    ts = bs;
    tc = bc + 1;
    if (threadIdx.x % 32 == 0) {
      st.bs[row] = ts;
      st.bc[row] = tc;
    }
    __syncwarp();
  }
}

// Write the first kk levels of a list, held as lane l's pair (s, c), to
// slots list*kk .. of a row's outputs (lanes < kk write).
__device__ __forceinline__ void kselect_write(float s, int c, int32_t* __restrict__ out_i,
                                              float* __restrict__ out_s, long long row_base,
                                              int list, int kk) {
  const int lane = threadIdx.x % 32;
  if (lane < kk) {
    const long long o = row_base + static_cast<long long>(list) * kk + lane;
    out_i[o] = c;
    out_s[o] = s;
  }
}

}  // namespace
