"""NNIndex — the build-once / query-many serving API (counterpart of tpu_knn/engine/index.py).

    index = NNIndex(ref, strategy="fused")       # pay layout/build once
    idx, d2 = index.query(search)                # hot path

The port serves three f32, immutable strategies:

- "fused": the reference set is placed once on the device in two layouts,
  the (n, k) AoS copy that the exact rerank gathers rows from and the
  (k_pad, n_pad) SoA operand the candidate kernels stream (tpu_knn's
  layout, so an index's state carries across verbatim: `from_state`).
  Queries route per batch as in tpu_knn: m <= 4 to the small-m kernel B2
  (or the AoS scan), small n to the dense path, everything else to B1 +
  the exact refinement. Exact top-K (`query(neighbors=)`) and
  `query_radius` run the engines of kernels/topk.py over the same operands.
- "projection": the sorted window index of kernels/projection.py (v11:
  B11, the per-query certificate and B1's fallback scan).
- "auto": "fused" plus, where v11's niche applies (k <= 8) and a
  build-time probe of the certificate clears CERT_RATE_MIN, the
  projection index; each batch routes to it where projection_wins (small
  m, large n) and to the fused path otherwise (`last_strategy` says
  which), and served batches' realized certification demotes the route.
  Top-K goes through the fused engines.

The kdtree and sharded strategies, the bf16/int8 stores, the cosine/ip
metrics, mutable indexes and save/load raise NotImplementedError naming
their ROADMAP item.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from tpu_knn_torch.kernels.fused import (
    DEFAULT_PRECISION, _check_precision_certified, _check_precision_ported,
    _refine, default_parts, fused_candidates, prep_soa, select_cutoff,
)
from tpu_knn_torch.kernels.tuning import LANE, MAX_TILE_N, pick_tiles
from tpu_knn_torch.utils.platform import as_f32
from tpu_knn_torch.utils.shapes import round_up


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to tpu_knn_torch yet: ROADMAP item {item}")


@functools.lru_cache(maxsize=None)
def _build_smallm_prepared(m: int, n: int, k: int):
    """Small-batch prepared pipeline: B2 against the same SoA operand as
    the fused path, then the exact refinement (diff-form scores: always
    certified). At k < 8 and m == 1, and above the kernel's k range, the
    AoS scan over the index's resident ref array serves instead, as in
    tpu_knn. Returns run(search, r_ops, ref_aos) -> (idx, d2)."""
    from tpu_knn_torch.kernels.smallm import (
        AOS_SCAN_MAX_KPAD_WASTE_K, SMALLM_MAX_K, _aos_scan, default_parts,
        smallm_candidates,
    )

    if (k < AOS_SCAN_MAX_KPAD_WASTE_K and m == 1) or k > SMALLM_MAX_K:
        def run_aos(search, r_ops, ref_aos):
            return _aos_scan(search, ref_aos)

        return run_aos
    parts = default_parts(n)
    cutoff = select_cutoff("exact", k)

    def run(search, r_ops, ref_aos):
        cand = smallm_candidates(search, r_ops[0], n, parts)
        return _refine(search, ref_aos, cand, n, cutoff=cutoff)

    return run


@functools.lru_cache(maxsize=None)
def _build_prepared_query(m: int, n: int, k: int,
                          precision: str = DEFAULT_PRECISION):
    """Query pipeline against a prepared (k_pad, n_pad) SoA operand — the
    same candidate kernel as v4, with no per-call transpose. Returns
    run(search, r_ops, ref_aos) -> (idx, d2)."""
    parts = default_parts(m, k, n)
    cutoff = select_cutoff(precision, k)

    def run(search, r_ops, ref_aos):
        cand = fused_candidates(search, r_ops[0], n, parts)
        # The exact refinement gathers rows from the AoS copy.
        return _refine(search, ref_aos, cand, n, cutoff=cutoff)

    return run


def _tile_for_width(n: int, width: int) -> int:
    """The widest 128-multiple tile <= MAX_TILE_N that pads n to exactly
    ``width`` (tpu_knn's rule for an operand padded for another tiling,
    smallm.py:179-189)."""
    t = (min(MAX_TILE_N, width) // LANE) * LANE
    while t >= LANE:
        if width % t == 0 and round_up(n, t) == width:
            return t
        t -= LANE
    raise ValueError(f"operand width {width} is not n={n} padded to a "
                     f"multiple of {LANE}")


class NNIndex:
    #: Serving pads each batch up to the next bucket (tpu_knn's policy), so
    #: a varying-m stream reuses a handful of launch geometries.
    bucket_m: bool = True

    def __init__(self, ref, strategy: str = "fused", mesh=None,
                 precision: str | None = None, mutable: bool = False,
                 capacity: int | None = None, store: str = "float32",
                 metric: str = "l2", device="cuda"):
        if metric not in ("l2", "cosine", "ip"):
            raise ValueError(
                f"metric must be 'l2', 'cosine', or 'ip', got {metric!r}")
        if store not in ("float32", "bf16", "int8"):
            raise ValueError(f"store must be 'float32', 'bf16', or "
                             f"'int8', got {store!r}")
        if strategy not in ("fused", "auto", "projection", "kdtree", "sharded"):
            raise ValueError(f"unknown strategy {strategy!r}")
        if strategy == "kdtree":
            raise _not_ported("strategy='kdtree'", "A.8")
        if strategy == "sharded" or mesh is not None:
            raise _not_ported("strategy='sharded' / mesh=", "A.9")
        if store != "float32":
            raise _not_ported(f"store={store!r}", "A.6")
        if metric != "l2":
            raise _not_ported(f"metric={metric!r}", "A.6")
        if mutable or capacity is not None:
            raise _not_ported("mutable=True / capacity=", "A.6")
        if precision is not None:
            # Serving never accepts a selection-approximate tier.
            _check_precision_certified(precision)
            _check_precision_ported(precision)
        ref_t = as_f32(ref, device)
        n, k = ref_t.shape
        if strategy == "projection":
            from tpu_knn_torch.kernels.projection import build_projection_index

            self._init_projection(ref_t, build_projection_index(ref_t))
            return
        # tile_n is fixed at build time for a large-batch query: it sets the
        # operand's n padding (tpu_knn's choice, so state carries across).
        _, tile_n = pick_tiles(k, 1024, n, wide=False)
        self._init_fused(ref_t, prep_soa(ref_t, round_up(n, tile_n)), tile_n)
        if strategy == "auto":
            self._init_auto()

    def _init_common(self, ref_t: torch.Tensor, strategy: str):
        self.strategy = strategy
        self.store = "float32"
        self.metric = "l2"
        self.mutable = False
        self.precision = DEFAULT_PRECISION
        self.n, self.k = ref_t.shape
        self.device = ref_t.device
        self.ref_dev = ref_t     # AoS copy for exact refinement

    def _init_fused(self, ref_t: torch.Tensor, r_op: torch.Tensor, tile_n: int):
        self._init_common(ref_t, "fused")
        self.tile_n = tile_n
        self.r_ops = (r_op,)     # SoA operand of the candidate kernels

    def _init_projection(self, ref_t: torch.Tensor, proj_index):
        """strategy="projection": the sorted index of kernels/projection.py
        (build_projection_index's seven tensors)."""
        self._init_common(ref_t, "projection")
        self.proj_index = tuple(proj_index)

    def _init_auto(self):
        """strategy="auto": the fused index plus, where v11's niche applies
        (k <= 8, n >= 128), the projection index, kept only if a probe of
        the certificate's hit rate clears CERT_RATE_MIN. Served batches
        feed the realized rate back (_note_projection_batch)."""
        self.strategy = "auto"
        self.proj_index = None
        self.cert_rate = 0.0
        self.last_strategy = None
        self._proj_ok_batches = 0    # certified batches in the current window
        self._proj_batches = 0
        self.realized_cert_rate = None
        self.proj_demoted = False
        if self.k <= 8 and self.n >= 128:
            self._probe_projection()

    #: Certification hit rate the build-time probe must clear for "auto"
    #: to serve through the projection index (tpu_knn's).
    CERT_RATE_MIN = 0.9

    #: Realized rate of fully certified batches below which "auto" demotes
    #: the projection route, evaluated every PROJ_FEEDBACK_PERIOD served
    #: projection batches over that window (tpu_knn's feedback): one
    #: uncertified row sends the whole batch through the fallback scan, so
    #: below half the window pass is waste.
    PROJ_REALIZED_MIN = 0.5
    PROJ_FEEDBACK_PERIOD = 32

    def _note_projection_batch(self, certified: bool):
        """Count the served batch's outcome (all rows certified, as the
        pipeline already read it on the host); every PROJ_FEEDBACK_PERIOD
        batches, that window's realized rate, and demotion below
        PROJ_REALIZED_MIN."""
        self._proj_ok_batches += bool(certified)
        self._proj_batches += 1
        if self._proj_batches % self.PROJ_FEEDBACK_PERIOD == 0:
            realized = self._proj_ok_batches / self.PROJ_FEEDBACK_PERIOD
            self._proj_ok_batches = 0   # the next window starts afresh
            self.realized_cert_rate = realized
            if realized < self.PROJ_REALIZED_MIN:
                self.proj_index = None
                self.proj_demoted = True

    def _probe_projection(self):
        """Build the projection index and estimate its certificate's hit
        rate on synthetic in-distribution queries: midpoints of
        projection-adjacent points (local geometry without the d = 0
        self-matches that would certify trivially). Below CERT_RATE_MIN the
        index is dropped and every batch serves fused."""
        from tpu_knn_torch.kernels.projection import (
            _build_kernel_window_query, auto_window, build_projection_index,
        )

        proj_index = build_projection_index(self.ref_dev)
        ref_sorted = proj_index[0]
        n_probe = min(64, self.n // 2)
        step = max(1, (self.n - 1) // n_probe)
        pos = torch.arange(n_probe, device=self.device) * step
        probes = (ref_sorted[pos] + ref_sorted[pos + 1]) * 0.5
        run = _build_kernel_window_query(n_probe, self.n, self.k,
                                         auto_window(self.k, self.n))
        _, _, ok = run(probes, *proj_index)
        self.cert_rate = int(ok.sum()) / n_probe
        if self.cert_rate >= self.CERT_RATE_MIN:
            self.proj_index = proj_index

    @classmethod
    def from_state(cls, state, device="cuda") -> "NNIndex":
        """Build from a tpu_knn index's state, given as NumPy, taken
        verbatim after a check:

        - fused: ``{"ref": np.asarray(ix.ref_dev), "r_op":
          np.asarray(ix.r_ops[0])}``; ``r_op`` must be the zero-padded
          (k_pad, n_pad) transpose of ``ref`` (tpu_knn's prep_soa layout);
        - projection: ``{"ref": ..., "proj_index": tuple(np.asarray(a) for
          a in ix.proj_index)}``; ``order`` must be a permutation and the
          rest build_projection_index's layout of ``ref[order]``."""
        if "proj_index" in state:
            return cls._from_projection_state(state, device)
        ref = np.ascontiguousarray(state["ref"], np.float32)
        r_op = np.ascontiguousarray(state["r_op"], np.float32)
        if ref.ndim != 2 or r_op.ndim != 2:
            raise ValueError("state['ref'] must be (n, k), state['r_op'] (k_pad, n_pad)")
        n, k = ref.shape
        if r_op.shape[0] != round_up(k, 8) or r_op.shape[1] < n:
            raise ValueError(f"r_op shape {r_op.shape} is not the SoA operand "
                             f"of a ({n}, {k}) reference set")
        want = np.zeros_like(r_op)
        want[:k, :n] = ref.T
        if not np.array_equal(r_op, want):
            raise ValueError("r_op is not the zero-padded transpose of ref")
        tile_n = _tile_for_width(n, r_op.shape[1])
        index = cls.__new__(cls)
        index._init_fused(as_f32(ref, device), as_f32(r_op, device), tile_n)
        return index

    @classmethod
    def _from_projection_state(cls, state, device) -> "NNIndex":
        from tpu_knn_torch.kernels.projection import PAD_VALUE, TILE_W

        ref = np.ascontiguousarray(state["ref"], np.float32)
        if len(state["proj_index"]) != 7:
            raise ValueError("proj_index must hold build_projection_index's 7 arrays")
        ref_sorted, order, axis, proj, rnorm, inv_order, r_aug = (
            np.asarray(a) for a in state["proj_index"])
        n, k = ref.shape
        if order.shape != (n,) or not np.array_equal(np.sort(order), np.arange(n)):
            raise ValueError("order is not a permutation of the points")
        axis = int(axis)
        want = ref[order]
        k_pad, n_pad = round_up(k + 1, 8), round_up(n, TILE_W) + TILE_W
        if not (np.array_equal(ref_sorted, want) and 0 <= axis < k
                and np.array_equal(proj, want[:, axis])
                and np.array_equal(inv_order[order], np.arange(n))
                and bool(np.all(proj[1:] >= proj[:-1]))):
            raise ValueError("proj_index is not the projection index of ref")
        # ‖r‖² may differ from ours in the last bits (f32 summation order).
        norm = (want.astype(np.float64) ** 2).sum(axis=1)
        if r_aug.shape != (k_pad, n_pad) or not np.allclose(rnorm, norm, rtol=1e-6):
            raise ValueError(f"r_aug {r_aug.shape} or rnorm is not the augmented "
                             "operand of ref[order]")
        aug = np.zeros((k_pad, n_pad), np.float32)
        aug[:k, :n] = want.T
        aug[k, :n] = rnorm
        aug[:k, n:] = PAD_VALUE
        aug[k, n:] = np.inf
        if not np.array_equal(r_aug, aug):
            raise ValueError("r_aug is not the augmented, padded transpose of ref[order]")
        index = cls.__new__(cls)
        tensors = [as_f32(a, device) for a in (ref_sorted, proj, rnorm, r_aug)]
        ints = [torch.as_tensor(np.array(a, np.int32), device=tensors[0].device)
                for a in (order, axis, inv_order)]
        index._init_projection(as_f32(ref, device), (
            tensors[0], ints[0], ints[1], tensors[1], tensors[2], ints[2], tensors[3]))
        return index

    @staticmethod
    def _m_bucket(m: int) -> int:
        # Small batches keep their own {1, 2, 4} buckets: the small-m
        # kernel's cost is linear in the padded m.
        if m <= 4:
            return 1 << max(0, m - 1).bit_length()
        return max(8, 1 << (m - 1).bit_length())

    def _as_queries(self, search) -> torch.Tensor:
        search = as_f32(search, self.device)
        if search.device != self.device:
            raise ValueError(f"queries on {search.device}, index on {self.device}")
        if search.dim() != 2 or search.shape[1] != self.k:
            raise ValueError(f"queries must be (m, {self.k}), got "
                             f"{tuple(search.shape)}")
        return search

    def query(self, search, neighbors: int | None = None):
        """search (m, k) -> (idx (m,) int32, d2 (m,) f32) tensors on the
        index's device. NumPy queries are placed there; a tensor must
        already be there.

        neighbors=K (exact top-K) returns (idx (m, K), d2 (m, K)) —
        including K=1 — each row ascending by exact (d2, index)
        (kernels/topk.py)."""
        search = self._as_queries(search)
        if neighbors is not None:
            return self._query_topk(search, neighbors)
        m = search.shape[0]
        mb = self._m_bucket(m) if self.bucket_m else m
        if mb != m:
            # Edge padding: duplicate real queries so padded rows behave
            # like in-distribution work.
            search = torch.cat([search, search[-1:].expand(mb - m, self.k)])
        idx, d2 = self._query_padded(search, m)
        return idx[:m], d2[:m]

    def pipeline(self, m: int):
        """Return (run, ops) for the prepared fused query pipeline at batch
        size ``m`` (strategies "fused" and "auto"): ``run(search, *ops) ->
        (idx, d2)`` with ``ops`` the device-resident prepared operands. The
        projection strategy has no single pipeline and raises."""
        from tpu_knn_torch.kernels.smallm import (
            aos_scan_applicable, smallm_applicable,
        )

        if self.strategy not in ("fused", "auto"):
            raise ValueError(f"pipeline() requires the fused/auto strategy, "
                             f"not {self.strategy!r}")
        if smallm_applicable(m, self.k, self.n) or aos_scan_applicable(m, self.k, self.n):
            return (_build_smallm_prepared(m, self.n, self.k),
                    (self.r_ops, self.ref_dev))
        run = _build_prepared_query(m, self.n, self.k, self.precision)
        return run, (self.r_ops, self.ref_dev)

    def _query_padded(self, search, m_true: int):
        from tpu_knn_torch.kernels.dense import _dense, dense_applicable
        from tpu_knn_torch.kernels.smallm import (
            aos_scan_applicable, smallm_applicable,
        )

        m = search.shape[0]
        n = self.n
        if self.strategy == "projection":
            from tpu_knn_torch.kernels.projection import projection_knn

            return projection_knn(search, self.ref_dev, prebuilt=self.proj_index)
        if self.strategy == "auto":
            from tpu_knn_torch.kernels.projection import (
                _build_projection_pipeline, auto_window, projection_wins,
            )

            # The cost model sees the true batch size (padding is not work
            # the user asked for).
            if self.proj_index is not None and projection_wins(self.k, m_true, n):
                self.last_strategy = "projection"
                run = _build_projection_pipeline(m, n, self.k, auto_window(self.k, n))
                idx, d2, certified = run(search, self.ref_dev, *self.proj_index,
                                         r_op=self.r_ops[0])
                self._note_projection_batch(certified)
                return idx, d2
            self.last_strategy = "fused"
        if smallm_applicable(m, self.k, n) or aos_scan_applicable(m, self.k, n):
            # The small-m kernel serves tiny batches off the very same SoA
            # operand (still the "fused" strategy — a kernel choice).
            run = _build_smallm_prepared(m, n, self.k)
            return run(search, self.r_ops, self.ref_dev)
        if dense_applicable(m, self.k, n):
            # Small reference sets skip the streaming pipeline.
            return _dense(search, self.ref_dev)
        run = _build_prepared_query(m, n, self.k, self.precision)
        return run(search, self.r_ops, self.ref_dev)

    # ---- top-K and radius queries ------------------------------------

    def query_radius(self, search, radius: float, max_results: int | None = None):
        """Exact fixed-radius neighbors (static output shape — see
        kernels/topk.py:within_radius). Returns (idx (m, cap), d2 (m, cap),
        count (m,)): rows ascending by exact (d2, index), padded -1/+inf.

        max_results=<int>: single shot with that cap (count < max_results
        certifies completeness; a cap beyond n is clamped and the output
        padded back). max_results=None: escalate the cap (doubling) until
        no row truncates, returning each query's true in-radius set;
        raises past the engine ceiling (PASSES_MAX_NEIGHBORS)."""
        from tpu_knn_torch.kernels.topk import _radius_query

        search = self._as_queries(search)
        return _radius_query(lambda eff: self._query_topk(search, eff),
                             self.n, radius, max_results)

    def _query_topk(self, search, neighbors: int):
        from tpu_knn_torch.kernels.topk import (
            MAX_NEIGHBORS, _build_aos_topk, _build_topk,
        )

        if self.strategy not in ("fused", "auto"):
            raise ValueError(
                "neighbors>1 requires the fused/auto/sharded strategy "
                "(prepared SoA operand) or the native kdtree backend; "
                f"this index uses {self.strategy!r}")
        search, m, mb = self._topk_prep_batch(search, neighbors)
        if mb == 1 and neighbors <= MAX_NEIGHBORS:
            # m=1 top-K: the zero-prep AoS cell engine over the resident
            # ref (tpu_knn's measured choice); m >= 2 keeps the prepared
            # one-scan engines.
            idx, d2 = _build_aos_topk(mb, self.n, self.k, neighbors)(
                search, self.ref_dev)
            return idx[:m], d2[:m]
        run = _build_topk(mb, self.n, self.k, neighbors, self.r_ops[0].shape[1])
        idx, d2 = run(search, self.r_ops, self.ref_dev)
        return idx[:m], d2[:m]

    def _topk_prep_batch(self, search, neighbors: int):
        """Shared top-K entry: validate the K cap and bucket+edge-pad m.
        Returns (search (mb, k) f32, m, mb)."""
        from tpu_knn_torch.kernels.topk import PASSES_MAX_NEIGHBORS

        cap = min(self.n, PASSES_MAX_NEIGHBORS)
        if not (1 <= neighbors <= cap):
            raise ValueError(
                f"neighbors must be in [1, min(n_live, "
                f"{PASSES_MAX_NEIGHBORS})] = [1, {cap}], got {neighbors}")
        m = search.shape[0]
        mb = self._m_bucket(m) if self.bucket_m else m
        if mb != m:
            search = torch.cat([search, search[-1:].expand(mb - m, self.k)])
        return search, m, mb

    # ---- serving surface not ported yet ----------------------------

    def filtered_view(self, keep):
        raise _not_ported("filtered_view", "A.6")

    def save(self, path):
        raise _not_ported("save", "A.6")

    @classmethod
    def load(cls, path, *args, **kwargs):
        raise _not_ported("load", "A.6")
