// kdtree_native — the host KD-trees of tpu_knn_torch (v9 and
// NNIndex(strategy="kdtree")): the port's own copy of the KD-tree parts of
// tpu_knn's native library (tpu_knn/native/src/tpuknn_native.cc), the
// reference's host KD-tree (core.cu:960-1050) and its leaf-bucketed
// serving tree, kdt2. Built on first use by tpu_knn_torch/native/build.py
// (g++ -O3 -march=native -ffp-contract=off -fopenmp) and bound with ctypes.
// -ffp-contract=off keeps every squared distance a separate f32 multiply
// and add over d = 0..k-1, so the host trees' d2 equal the v10 kernel's and
// the plain versions' bit for bit.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <utility>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

// ---------------------------------------------------------------------------
// KD-tree build — implicit-heap array layout (reference core.cu:960-1008):
// node 1 is the root, children of node i are 2i and 2i+1; `p[node]` is the
// reference-point index stored at the node (-1 = empty), `dim[node]` the
// split dimension chosen by maximum variance, median split via
// nth_element. Arrays are sized 4n like the reference (README.md:331).
// ---------------------------------------------------------------------------

struct BuildCtx {
  int k;
  const float* ref;  // (n, k) AoS
  int32_t* p;
  int32_t* dim;
  std::vector<int32_t> order;  // permutation being partitioned
};

static void kd_build_rec(BuildCtx& ctx, int node, int lo, int hi) {
  if (lo >= hi) return;
  // Pick the dimension with maximum variance over a deterministic
  // stride-sample of [lo, hi) (<= ~512 points — same rule and same
  // rationale as kd_build_rec_t below: split choice is a heuristic,
  // query exactness never depends on it).
  int best_dim = 0;
  double best_var = -1.0;
  const int cnt = hi - lo;
  const int step = cnt > 512 ? cnt / 512 : 1;
  for (int d = 0; d < ctx.k; d++) {
    double sum = 0.0, sum2 = 0.0;
    int used = 0;
    for (int i = lo; i < hi; i += step) {
      const double v = ctx.ref[(int64_t)ctx.order[i] * ctx.k + d];
      sum += v;
      sum2 += v * v;
      used++;
    }
    const double var = sum2 / used - (sum / used) * (sum / used);
    if (var > best_var) {
      best_var = var;
      best_dim = d;
    }
  }
  const int mid = (lo + hi) / 2;
  const int k = ctx.k;
  const float* ref = ctx.ref;
  std::nth_element(ctx.order.begin() + lo, ctx.order.begin() + mid,
                   ctx.order.begin() + hi,
                   [ref, k, best_dim](int32_t a, int32_t b) {
                     return ref[(int64_t)a * k + best_dim] <
                            ref[(int64_t)b * k + best_dim];
                   });
  ctx.p[node] = ctx.order[mid];
  ctx.dim[node] = best_dim;
  kd_build_rec(ctx, 2 * node, lo, mid);
  kd_build_rec(ctx, 2 * node + 1, mid + 1, hi);
}

}  // extern "C" (templates below need C++ linkage; reopened after)

// Record-based build for k <= KP: each point is a contiguous
// (coords[KP], idx) record, so both the variance pass and nth_element's
// partition touch sequential memory instead of gathering through a
// permutation (3-4x faster serially than the order-based build above,
// which is kept as the generic fallback for k > 16). Coordinates past k
// are zero-padded; the variance scan runs over the REAL k dims only —
// a padded dim's exact 0.0 variance would otherwise beat a real
// constant dim whose sampled variance rounds negative (catastrophic
// cancellation in sum2/used - mean^2 on duplicate-heavy data), storing
// dim[node] >= k and reading past the k-wide row at query time.
template <int KP>
struct KdRec {
  float c[KP];
  int32_t idx;
};

template <int KP>
static void kd_build_rec_t(KdRec<KP>* recs, int k, int64_t node, int lo,
                           int hi, int32_t* p, int32_t* dim) {
  if (lo >= hi) return;
  const int cnt = hi - lo;
  // Max-variance dim over a deterministic stride-sample (<= ~512 points,
  // the same rule kdt2_pick_dim uses): the full pass made variance the
  // dominant build cost at large nodes, and the SPLIT CHOICE is a pure
  // heuristic — query exactness never depends on it (pruning is by plane
  // distance), matching the behavioral-equivalence contract the
  // adversarial build tests check. Measured: 33 -> ~14 ms at (3, 65536).
  const int step = cnt > 512 ? cnt / 512 : 1;
  double sum[KP] = {0.0}, sum2[KP] = {0.0};
  int used = 0;
  for (int i = lo; i < hi; i += step) {
    for (int d = 0; d < k; d++) {
      const double v = recs[i].c[d];
      sum[d] += v;
      sum2[d] += v * v;
    }
    used++;
  }
  int best_dim = 0;
  double best_var = -1.0;
  for (int d = 0; d < k; d++) {
    const double mean = sum[d] / used;
    const double var = sum2[d] / used - mean * mean;
    if (var > best_var) {
      best_var = var;
      best_dim = d;
    }
  }
  const int mid = (lo + hi) / 2;
  std::nth_element(recs + lo, recs + mid, recs + hi,
                   [best_dim](const KdRec<KP>& a, const KdRec<KP>& b) {
                     return a.c[best_dim] < b.c[best_dim];
                   });
  p[node] = recs[mid].idx;
  dim[node] = best_dim;
  kd_build_rec_t<KP>(recs, k, 2 * node, lo, mid, p, dim);
  kd_build_rec_t<KP>(recs, k, 2 * node + 1, mid + 1, hi, p, dim);
}

template <int KP>
static void kd_build_packed(int k, int n, const float* ref, int32_t* p,
                            int32_t* dim) {
  std::vector<KdRec<KP>> recs(n);
  for (int i = 0; i < n; i++) {
    for (int d = 0; d < KP; d++) {
      recs[i].c[d] = d < k ? ref[(int64_t)i * k + d] : 0.0f;
    }
    recs[i].idx = i;
  }
  kd_build_rec_t<KP>(recs.data(), k, 1, 0, n, p, dim);
}

extern "C" {

// p and dim must have space for 4n int32 entries; initialized to -1 here.
void tk_kdtree_build(int k, int n, const float* ref, int32_t* p,
                     int32_t* dim) {
  const int64_t cap = 4LL * n;
  for (int64_t i = 0; i < cap; i++) {
    p[i] = -1;
    dim[i] = -1;
  }
  if (k <= 4) {
    kd_build_packed<4>(k, n, ref, p, dim);
  } else if (k <= 8) {
    kd_build_packed<8>(k, n, ref, p, dim);
  } else if (k <= 16) {
    kd_build_packed<16>(k, n, ref, p, dim);
  } else {
    BuildCtx ctx;
    ctx.k = k;
    ctx.ref = ref;
    ctx.p = p;
    ctx.dim = dim;
    ctx.order.resize(n);
    for (int i = 0; i < n; i++) ctx.order[i] = i;
    kd_build_rec(ctx, 1, 0, n);
  }
}

// ---------------------------------------------------------------------------
// KD-tree CPU query (reference v9, core.cu:1010-1025): recursive descend +
// backtrack with squared-distance pruning. Returns the nearest reference
// index per query; exact (prune uses strict inequality with the reference's
// 1e-6 slack removed — we prune only when the splitting-plane distance
// strictly exceeds the best, which keeps exactness and lowest-index ties
// handled by the < update and deterministic traversal order).
// ---------------------------------------------------------------------------

struct QueryCtx {
  int k;
  const float* ref;
  const int32_t* p;
  const int32_t* dim;
  int64_t cap;  // 4n
};

static void kd_ask_rec(const QueryCtx& ctx, int node, const float* q,
                       float& best, int32_t& besti) {
  if (node >= ctx.cap || ctx.p[node] < 0) return;
  const int32_t pi = ctx.p[node];
  const float* r = ctx.ref + (int64_t)pi * ctx.k;
  float acc = 0.0f;
  for (int t = 0; t < ctx.k; t++) {
    const float diff = q[t] - r[t];
    acc += diff * diff;
  }
  // Lowest-index tie-break: on equal distance prefer the smaller point
  // index (the serial oracle keeps the first of equals in scan order; for
  // tree traversal order is not scan order, so we make the rule explicit).
  if (acc < best || (acc == best && pi < besti)) {
    best = acc;
    besti = pi;
  }
  const int d = ctx.dim[node];
  const float delta = q[d] - r[d];
  const int near_child = delta < 0 ? 2 * node : 2 * node + 1;
  const int far_child = delta < 0 ? 2 * node + 1 : 2 * node;
  kd_ask_rec(ctx, near_child, q, best, besti);
  if (delta * delta <= best) {
    kd_ask_rec(ctx, far_child, q, best, besti);
  }
}

void tk_kdtree_query(int k, int m, int n, const float* search,
                     const float* ref, const int32_t* p, const int32_t* dim,
                     int32_t* out_idx, float* out_dist) {
  QueryCtx ctx;
  ctx.k = k;
  ctx.ref = ref;
  ctx.p = p;
  ctx.dim = dim;
  ctx.cap = 4LL * n;
#pragma omp parallel for schedule(dynamic, 16)
  for (int i = 0; i < m; i++) {
    float best = std::numeric_limits<float>::infinity();
    int32_t besti = 0;
    kd_ask_rec(ctx, 1, search + (int64_t)i * k, best, besti);
    out_idx[i] = besti;
    if (out_dist) out_dist[i] = best;
  }
}

// Top-K traversal (serving extension — no reference analog): a bounded
// max-heap of (d2, idx) per query, lex-ordered so equal distances keep
// the LOWEST index set (v0's tie rule extended to K). Prune rule matches
// the 1-NN traversal: descend the far child while delta^2 <= the current
// k-th best (or the heap is not yet full).

struct TkTopkEntry {
  float d2;
  int32_t idx;
};

// Strict lex (d2, idx) "a nearer than b"; used as the heap comparator so
// the heap front is the lex-LARGEST (worst) of the kept K.
static bool tk_nearer(const TkTopkEntry& a, const TkTopkEntry& b) {
  return a.d2 < b.d2 || (a.d2 == b.d2 && a.idx < b.idx);
}

static void kd_ask_topk_rec(const QueryCtx& ctx, int64_t node, const float* q,
                            int K, std::vector<TkTopkEntry>& heap) {
  if (node >= ctx.cap || ctx.p[node] < 0) return;
  const int32_t pi = ctx.p[node];
  const float* r = ctx.ref + (int64_t)pi * ctx.k;
  float acc = 0.0f;
  for (int t = 0; t < ctx.k; t++) {
    const float diff = q[t] - r[t];
    acc += diff * diff;
  }
  const TkTopkEntry cur{acc, pi};
  if ((int)heap.size() < K) {
    heap.push_back(cur);
    std::push_heap(heap.begin(), heap.end(), tk_nearer);
  } else if (tk_nearer(cur, heap.front())) {
    std::pop_heap(heap.begin(), heap.end(), tk_nearer);
    heap.back() = cur;
    std::push_heap(heap.begin(), heap.end(), tk_nearer);
  }
  const int d = ctx.dim[node];
  const float delta = q[d] - r[d];
  const int64_t near_child = delta < 0 ? 2 * node : 2 * node + 1;
  const int64_t far_child = delta < 0 ? 2 * node + 1 : 2 * node;
  kd_ask_topk_rec(ctx, near_child, q, K, heap);
  if ((int)heap.size() < K || delta * delta <= heap.front().d2) {
    kd_ask_topk_rec(ctx, far_child, q, K, heap);
  }
}

// out_idx/out_d2 are (m, K) row-major; when n < K the row tail is filled
// with idx -1 / d2 +inf. Rows are sorted ascending by (d2, idx).
void tk_kdtree_query_topk(int k, int m, int n, int K, const float* search,
                          const float* ref, const int32_t* p,
                          const int32_t* dim, int32_t* out_idx,
                          float* out_d2) {
  QueryCtx ctx;
  ctx.k = k;
  ctx.ref = ref;
  ctx.p = p;
  ctx.dim = dim;
  ctx.cap = 4LL * n;
#pragma omp parallel for schedule(dynamic, 16)
  for (int i = 0; i < m; i++) {
    std::vector<TkTopkEntry> heap;
    heap.reserve(K);
    kd_ask_topk_rec(ctx, 1, search + (int64_t)i * k, K, heap);
    std::sort(heap.begin(), heap.end(), tk_nearer);
    int32_t* oi = out_idx + (int64_t)i * K;
    float* od = out_d2 + (int64_t)i * K;
    for (int j = 0; j < K; j++) {
      if (j < (int)heap.size()) {
        oi[j] = heap[j].idx;
        od[j] = heap[j].d2;
      } else {
        oi[j] = -1;
        od[j] = std::numeric_limits<float>::infinity();
      }
    }
  }
}

}  // extern "C" (kdt2 internals below need C++ linkage)

// ---------------------------------------------------------------------------
// kdt2 — the serving-grade KD-tree. The implicit-heap tree above keeps the
// reference's one-point-per-node format (core.cu:960-1008) for the device
// traversal and the checkpoint format; it is a poor host QUERY structure:
// every visited node is a dependent-load chain (p[node] -> dim[node] ->
// ref[p[node]*k]) and every backtrack re-enters one point at a time.
//
// kdt2 buckets points into leaves of ~LEAF_SIZE contiguous records instead:
// inner nodes are a pure implicit heap of (split value, split dim) built by
// exact-median nth_element down to depth ceil(log2(n/LEAF_SIZE)); leaves
// hold the reordered (coords, index) records themselves, so the traversal
// does D cheap branch steps and then SIMD-scans 1-2 cache-resident buckets.
// Build does ~4 fewer nth_element levels than the per-point tree and the
// variance pass samples at most 512 points per node (split QUALITY barely
// moves; every query path stays exact because pruning is by plane distance,
// never by split choice). Queries keep v0's lowest-index tie rule via the
// explicit (d2, idx) lex compare. Exposed to Python as an opaque handle;
// NNIndex(strategy="kdtree") builds one of these for serving and keeps the
// reference-format tree only for checkpoint/device paths.
// ---------------------------------------------------------------------------

namespace {

constexpr int kKdt2Leaf = 16;       // target leaf bucket size
constexpr int kKdt2StackMax = 64;   // >= max inner depth + margin
constexpr int kKdt2TopkMax = 128;   // in-traversal heap capacity

// Records are interleaved (coords[kp], idx-as-float-bits): nth_element
// partitions them IN PLACE (no per-level gather/scatter), and the leaf
// scan reads one contiguous run per bucket. stride = kp + 1 floats.
struct Kdt2 {
  int k = 0;       // logical dims
  int kp = 0;      // padded coord slots per record
  int depth = 0;   // inner levels; leaf count = 1 << depth
  int n = 0;
  std::vector<float> splitv;      // (1<<depth,) heap-indexed, node 1.. used
  std::vector<int32_t> sdim;      // (1<<depth,)
  std::vector<float> recs;        // (n, kp+1) reordered records
  std::vector<int32_t> leaf_off;  // (leaves+1,) record ranges per leaf
};

static inline int32_t kdt2_idx(const float* rec, int kp) {
  int32_t out;
  std::memcpy(&out, rec + kp, sizeof(out));
  return out;
}

// Max-variance dim over a deterministic stride-sample of [lo, hi): at
// most ~512 points contribute, which moves the SPLIT CHOICE only on
// near-tied variances — query exactness never depends on it (pruning is
// by plane distance), and build time stops being variance-dominated.
static int kdt2_pick_dim(const Kdt2& t, int lo, int hi) {
  const int cnt = hi - lo;
  const int step = cnt > 512 ? cnt / 512 : 1;
  const int stride = t.kp + 1;
  int best_dim = 0;
  double best_var = -1.0;
  for (int d = 0; d < t.k; d++) {
    double sum = 0.0, sum2 = 0.0;
    int used = 0;
    for (int i = lo; i < hi; i += step) {
      const double v = t.recs[(int64_t)i * stride + d];
      sum += v;
      sum2 += v * v;
      used++;
    }
    const double mean = sum / used;
    const double var = sum2 / used - mean * mean;
    if (var > best_var) {
      best_var = var;
      best_dim = d;
    }
  }
  return best_dim;
}

// In-place split of records [lo, hi) by coordinate d: left subtree gets
// [lo, mid), right gets [mid, hi). Because leaf ranges are stored
// explicitly (leaf_off), the split does NOT need the exact median: for
// cnt > 64 a single std::partition pass around a sampled-median pivot
// (~1n record moves) replaces nth_element (~3n) — a measured ~25% off the
// whole build. A split leaving <1/4 on either side falls back to the
// exact median, bounding leaf-size skew (max ~6x target under uniform
// data; duplicates degrade gracefully through the same fallback). Equal-
// to-split records may land on either side; correct, because traversal
// descends BOTH sides whenever the plane distance is <= best, and splitv
// is the partition pivot itself (left strictly below it, right at or
// above it).
template <int KP>
static void kdt2_build_rec(Kdt2& t, int node, int lo, int hi, int level) {
  struct Rec {
    float c[KP + 1];  // coords[KP] + idx bits
  };
  static_assert(sizeof(Rec) == (KP + 1) * sizeof(float), "packed");
  const int leaves = 1 << t.depth;
  if (level == t.depth) {
    const int leaf = node - leaves;
    t.leaf_off[leaf] = lo;
    t.leaf_off[leaf + 1] = hi;
    return;
  }
  int mid = (lo + hi) / 2;
  int d = 0;
  float split = 0.0f;
  const int cnt = hi - lo;
  if (cnt > 1) {
    d = kdt2_pick_dim(t, lo, hi);
    Rec* recs = reinterpret_cast<Rec*>(t.recs.data());
    bool exact = true;
    if (cnt > 64) {
      float samp[33];
      int sn = 0;
      const int pstep = cnt / 33 + 1;
      for (int i = lo; i < hi && sn < 33; i += pstep) samp[sn++] = recs[i].c[d];
      std::nth_element(samp, samp + sn / 2, samp + sn);
      const float pivot = samp[sn / 2];
      Rec* pm = std::partition(recs + lo, recs + hi, [d, pivot](const Rec& a) {
        return a.c[d] < pivot;
      });
      mid = (int)(pm - recs);
      if (mid - lo >= cnt / 4 && hi - mid >= cnt / 4) {
        split = pivot;
        exact = false;
      } else {
        mid = (lo + hi) / 2;  // skewed pivot: redo with the exact median
      }
    }
    if (exact) {
      std::nth_element(recs + lo, recs + mid, recs + hi,
                       [d](const Rec& a, const Rec& b) {
                         return a.c[d] < b.c[d];
                       });
      split = recs[mid].c[d];
    }
  } else if (cnt == 1) {
    split = t.recs[(int64_t)lo * (KP + 1) + d];
    mid = lo;  // single record goes right
  }
  t.sdim[node] = d;
  t.splitv[node] = split;
  kdt2_build_rec<KP>(t, 2 * node, lo, mid, level + 1);
  kdt2_build_rec<KP>(t, 2 * node + 1, mid, hi, level + 1);
}

static inline float kdt2_dist(const float* q, const float* r, int k) {
  float acc = 0.0f;
  for (int t = 0; t < k; t++) {
    const float diff = q[t] - r[t];
    acc += diff * diff;
  }
  return acc;
}

static void kdt2_query_row(const Kdt2& t, const float* q, int32_t* out_idx,
                           float* out_d2) {
  const int leaves = 1 << t.depth;
  const int stride = t.kp + 1;
  float best = std::numeric_limits<float>::infinity();
  int32_t besti = 0;
  int32_t stack_node[kKdt2StackMax];
  float stack_d2[kKdt2StackMax];
  int sp = 0;
  int32_t node = 1;
  for (;;) {
    while (node < leaves) {
      const int d = t.sdim[node];
      const float delta = q[d] - t.splitv[node];
      const int32_t left = 2 * node;
      stack_node[sp] = delta < 0 ? left + 1 : left;
      stack_d2[sp] = delta * delta;
      sp++;
      node = delta < 0 ? left : left + 1;
    }
    const int leaf = node - leaves;
    const int end = t.leaf_off[leaf + 1];
    for (int i = t.leaf_off[leaf]; i < end; i++) {
      const float* rec = &t.recs[(int64_t)i * stride];
      const float acc = kdt2_dist(q, rec, t.k);
      const int32_t pi = kdt2_idx(rec, t.kp);
      // v0 tie rule: equal distance keeps the lowest original index.
      if (acc < best || (acc == best && pi < besti)) {
        best = acc;
        besti = pi;
      }
    }
    // Backtrack to the next pending far subtree that can still hold an
    // equal-or-nearer point (plane distance <= best, re-checked against
    // the CURRENT best so late prunes skip whole subtrees).
    do {
      if (sp == 0) {
        *out_idx = besti;
        if (out_d2) *out_d2 = best;
        return;
      }
      sp--;
    } while (stack_d2[sp] > best);
    node = stack_node[sp];
  }
}

static void kdt2_query_topk_row(const Kdt2& t, const float* q, int K,
                                int32_t* out_idx, float* out_d2) {
  const int leaves = 1 << t.depth;
  const int stride = t.kp + 1;
  TkTopkEntry heap[kKdt2TopkMax];
  int hs = 0;
  int32_t stack_node[kKdt2StackMax];
  float stack_d2[kKdt2StackMax];
  int sp = 0;
  int32_t node = 1;
  for (;;) {
    while (node < leaves) {
      const int d = t.sdim[node];
      const float delta = q[d] - t.splitv[node];
      const int32_t left = 2 * node;
      stack_node[sp] = delta < 0 ? left + 1 : left;
      stack_d2[sp] = delta * delta;
      sp++;
      node = delta < 0 ? left : left + 1;
    }
    const int leaf = node - leaves;
    const int end = t.leaf_off[leaf + 1];
    for (int i = t.leaf_off[leaf]; i < end; i++) {
      const float* rec = &t.recs[(int64_t)i * stride];
      const TkTopkEntry cur{kdt2_dist(q, rec, t.k), kdt2_idx(rec, t.kp)};
      if (hs < K) {
        heap[hs++] = cur;
        std::push_heap(heap, heap + hs, tk_nearer);
      } else if (tk_nearer(cur, heap[0])) {
        std::pop_heap(heap, heap + K, tk_nearer);
        heap[K - 1] = cur;
        std::push_heap(heap, heap + K, tk_nearer);
      }
    }
    do {
      if (sp == 0) {
        std::sort(heap, heap + hs, tk_nearer);
        for (int j = 0; j < K; j++) {
          if (j < hs) {
            out_idx[j] = heap[j].idx;
            out_d2[j] = heap[j].d2;
          } else {
            out_idx[j] = -1;
            out_d2[j] = std::numeric_limits<float>::infinity();
          }
        }
        return;
      }
      sp--;
    } while (hs >= K && stack_d2[sp] > heap[0].d2);
    node = stack_node[sp];
  }
}

}  // namespace

extern "C" {

// Build a kdt2 over an (n, k) AoS reference set; returns an opaque handle
// (tk_kdt2_free to release), or nullptr when k > 16 (callers fall back to
// the reference-format tree). n must be >= 1.
void* tk_kdt2_build(int k, int n, const float* ref) {
  if (k > 16 || n < 1) return nullptr;
  auto* t = new Kdt2();
  t->k = k;
  t->kp = k <= 4 ? 4 : (k <= 8 ? 8 : 16);
  t->n = n;
  int depth = 0;
  while ((n >> depth) > kKdt2Leaf && depth + 1 < kKdt2StackMax - 1) depth++;
  t->depth = depth;
  const int leaves = 1 << depth;
  const int stride = t->kp + 1;
  t->splitv.assign(leaves, 0.0f);
  t->sdim.assign(leaves, 0);
  t->recs.assign((size_t)n * stride, 0.0f);
  t->leaf_off.assign(leaves + 1, 0);
  for (int i = 0; i < n; i++) {
    std::memcpy(&t->recs[(int64_t)i * stride], ref + (int64_t)i * k,
                (size_t)k * sizeof(float));
    std::memcpy(&t->recs[(int64_t)i * stride + t->kp], &i, sizeof(int32_t));
  }
  if (t->kp == 4) {
    kdt2_build_rec<4>(*t, 1, 0, n, 0);
  } else if (t->kp == 8) {
    kdt2_build_rec<8>(*t, 1, 0, n, 0);
  } else {
    kdt2_build_rec<16>(*t, 1, 0, n, 0);
  }
  return t;
}

void tk_kdt2_free(void* handle) { delete (Kdt2*)handle; }

int tk_kdt2_depth(void* handle) { return ((Kdt2*)handle)->depth; }

void tk_kdt2_query(void* handle, int m, const float* search,
                   int32_t* out_idx, float* out_d2) {
  const Kdt2& t = *(const Kdt2*)handle;
#pragma omp parallel for schedule(dynamic, 16)
  for (int i = 0; i < m; i++) {
    kdt2_query_row(t, search + (int64_t)i * t.k, out_idx + i,
                   out_d2 ? out_d2 + i : nullptr);
  }
}

// Rows ascending by (d2, idx); -1/+inf tail when n < K. K <= 128.
void tk_kdt2_query_topk(void* handle, int m, int K, const float* search,
                        int32_t* out_idx, float* out_d2) {
  const Kdt2& t = *(const Kdt2*)handle;
#pragma omp parallel for schedule(dynamic, 16)
  for (int i = 0; i < m; i++) {
    kdt2_query_topk_row(t, search + (int64_t)i * t.k, K,
                        out_idx + (int64_t)i * K, out_d2 + (int64_t)i * K);
  }
}

}  // extern "C"
