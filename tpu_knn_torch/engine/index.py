"""NNIndex — the build-once / query-many serving API (counterpart of tpu_knn/engine/index.py).

    index = NNIndex(ref, strategy="fused")       # pay layout/build once
    idx, d2 = index.query(search)                # hot path

The port serves four strategies:

- "fused": the reference set is placed once on the device in two layouts,
  the (n, k) AoS copy that the exact rerank gathers rows from and the
  candidate kernels' operands (tpu_knn's layout, so an index's state
  carries across verbatim: `from_state`): the (k_pad, n_pad) SoA operand,
  or for precision="bf16x3_presplit" B12's (hi, lo, ‖r‖²). The score
  tier is tpu_knn's (`precision=None`: auto_precision(k, max(n,
  capacity)), "qsplit2" in place of "bf16x3" for a quantized store), and
  the operand's n padding follows it (pick_tiles' wide= for "packed").
  Queries route per batch as in tpu_knn: m <= 4 to the small-m kernel B2
  (or the AoS scan), small n to the dense path, everything else to the
  tier's candidate kernel + the exact refinement. Three stores, as in
  tpu_knn: "float32"; "bf16" (the points quantized once, both layouts in
  bf16, every kernel upcasting at the read: exact over the stored
  points); "int8" (only the (n, k) int8 grid of p = z + s·g is resident,
  queries run in grid space on q' = (q − z)/s, batches over a per-call
  bf16 SoA operand, reported d2 rescaled by s²). Exact top-K
  (`query(neighbors=)`) and `query_radius` run the engines of
  kernels/topk.py over every store: m = 1 the AoS engine straight off the
  stored points (the int8 grid), m >= 2 the prepared engines over the
  store's own operand (a bf16 store's bf16 operand, launching the
  kernels' bf16 instances; for int8 the per-call bf16 grid operand).
  metric="cosine" / "ip" reduce to exact L2 by a build-time transform of
  the points (unit vectors; ip's augmented column) and a query-time one
  of the queries; answers carry the metric's own score. mutable=True
  keeps `capacity` slots, empty and removed ones PAD_VALUE in both
  layouts (every kernel scores them +inf), with add / remove / compact
  and growth past capacity; ids are slot numbers. `filtered_view(keep)`
  shares the AoS copy and holds one SoA operand whose excluded columns
  are PAD_VALUE; it reports original ids and stays off the routes that
  scan the unmasked AoS copy.
- "projection": the sorted window index of kernels/projection.py (v11:
  B11, the per-query certificate and B1's fallback scan).
- "auto": "fused" plus, where v11's niche applies (k <= 8) and a
  build-time probe of the certificate clears CERT_RATE_MIN, the
  projection index; each batch routes to it where projection_wins (small
  m, large n) and to the fused path otherwise (`last_strategy` says
  which), and served batches' realized certification demotes the route.
  Top-K goes through the fused engines.
- "kdtree": the host KD-trees of tpu_knn_torch/native, as in tpu_knn:
  the leaf-bucketed kdt2 serves k <= 16, the reference-format tree
  (`tree`, built lazily) above; 1-NN, top-K and radius run on the host
  and return tensors on the index's device.

- "sharded": the points sharded over a mesh of devices
  (distributed/sharded.py, v8's machinery) once, at build: each shard's
  AoS rows and SoA operand (int8: its grid rows only) live on the devices
  that scan it, PAD_VALUE past n (a mutable index's empty and removed
  slots too), and every query runs the per-shard pipelines and the
  reduction, answering on the mesh's first device. The f32, bf16 and int8
  stores, cosine/ip, top-K, radius, mutable indexes (ids are global slot
  numbers, kept across growth), filtered views (masked copies of both
  operands) and save / load with the mesh's shape, as in tpu_knn.

precision="bf16x3_presplit" (B12) serves the f32 points, a bf16 store
(hi = the stored values, lo = 0, ‖r‖² in f32), the int8 grid (the same
split of the per-call grid operand) and "auto". `save` / `load` write and
read tpu_knn's .npz files.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from tpu_knn_torch.kernels.fused import (
    PORTED_PRECISIONS, _check_precision_certified, _refine, auto_precision, prep_soa,
    select_cutoff,
)
from tpu_knn_torch.kernels.tiers import presplit_ops, refine_candidates, tier_parts
from tpu_knn_torch.kernels.tuning import LANE, MAX_TILE_N, pick_tiles
from tpu_knn_torch.utils.platform import as_f32, check_device
from tpu_knn_torch.utils.shapes import cdiv, round_up


@functools.lru_cache(maxsize=None)
def _build_smallm_prepared(m: int, n: int, k: int, aos_ok: bool = True):
    """Small-batch prepared pipeline: B2 (B2-bf16 over a bf16 store's
    operand) against the same SoA operand as the fused path, then the
    exact refinement (diff-form scores: always certified). At k < 8 and
    m == 1, and above the kernel's k range, the AoS scan over the index's
    resident ref array serves instead, as in tpu_knn (PAD slots score +inf
    there too). ``aos_ok=False`` (a filtered view, whose shared AoS copy is
    not masked) keeps B2 over the masked operand at every m, and raises
    above B2's k range. Returns run(search, r_ops, ref_aos) -> (idx, d2)."""
    from tpu_knn_torch.kernels.smallm import (
        AOS_SCAN_MAX_KPAD_WASTE_K, SMALLM_MAX_K, _aos_scan, operand_parts,
        smallm_candidates,
    )

    if k > SMALLM_MAX_K and not aos_ok:
        raise ValueError(f"smallm prepared route needs k <= {SMALLM_MAX_K} or an "
                         f"AoS-maskable index, got k={k} with aos_ok=False")
    if (k < AOS_SCAN_MAX_KPAD_WASTE_K and m == 1 and aos_ok) or k > SMALLM_MAX_K:
        def run_aos(search, r_ops, ref_aos):
            return _aos_scan(search, ref_aos)

        return run_aos
    cutoff = select_cutoff("exact", k)

    def run(search, r_ops, ref_aos):
        cand = smallm_candidates(search, r_ops[0], n, operand_parts(r_ops[0], n))
        return _refine(search, ref_aos, cand, n, cutoff=cutoff)

    return run


@functools.lru_cache(maxsize=None)
def _build_prepared_query(m: int, n: int, k: int, precision: str,
                          cutoff_scale: float = 1.0):
    """Query pipeline against the prepared operands — the same candidate
    kernel as v4 for the tier (kernels/tiers.py refine_candidates), with no
    per-call transpose. ``cutoff_scale`` rescales the certified top-T
    cutoff for a caller whose coordinates are a scaled embedding of the
    user's (store="int8" runs in grid space, where score magnitudes and
    resolvable gaps both scale by 1/s²). Returns run(search, r_ops,
    ref_aos) -> (idx, d2)."""
    parts = tier_parts(precision, m, k, n)
    cutoff = select_cutoff(precision, k) * cutoff_scale

    def run(search, r_ops, ref_aos):
        cand = refine_candidates(search, r_ops, n, parts, precision)
        # The exact refinement gathers rows from the AoS copy.
        return _refine(search, ref_aos, cand, n, cutoff=cutoff)

    return run


#: The coordinate of an empty or removed slot of a mutable index and of a
#: column a filtered view excludes (tpu_knn's, distributed/sharded.py): its
#: squared distance to any in-contract query, and its norm-form score,
#: overflow f32 to +inf in every kernel, so such a column is never
#: reported and needs no mask. A bf16 operand holds it as 1.0038e30,
#: whose square overflows as well.
PAD_VALUE = 1e30


def _pad_like(t: torch.Tensor) -> torch.Tensor:
    """PAD_VALUE as a 0-d tensor of t's dtype and device (rounded once,
    as jnp rounds it into a bf16 array)."""
    return torch.tensor(PAD_VALUE, dtype=t.dtype, device=t.device)


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


def _resolve_precision(precision, k: int, n: int, store: str) -> str:
    """tpu_knn's NNIndex tier rule (index.py:270-288): auto_precision (n:
    the larger of the points and a mutable index's capacity), with
    "qsplit2" for "bf16x3" over a quantized (bf16-exact) store; an explicit
    tier must be certified (serving has no allow_approximate)."""
    if precision is None:
        precision = auto_precision(k, n)
        if store in ("bf16", "int8") and precision == "bf16x3":
            precision = "qsplit2"
        return precision
    _check_precision_certified(precision)
    return precision


def _np_bf16_bits(a, what: str) -> np.ndarray:
    """A NumPy bfloat16 array (ml_dtypes, as tpu_knn hands them over) as its
    16-bit patterns, with no ml_dtypes import."""
    a = np.ascontiguousarray(a)
    if a.dtype.name != "bfloat16" or a.dtype.itemsize != 2:
        raise ValueError(f"{what} must be a bfloat16 array, got {a.dtype}")
    return a.view(np.int16)


def _bf16_tensor(bits: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(check_device(device))


def _host(t: torch.Tensor) -> np.ndarray:
    """A stored tensor as NumPy for a file: bf16 as its uint16 bits
    (tpu_knn's `host()`: np.savez has no bfloat16)."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).cpu().numpy().view(np.uint16)
    return t.cpu().numpy()


def _state_tensors(state, device):
    """(ref, r_op) of a fused state as tensors on ``device``: float32, or a
    bf16 store's bfloat16 taken bit for bit, and the store's name."""
    if np.asarray(state["ref"]).dtype.name == "bfloat16":
        ref = _np_bf16_bits(state["ref"], "state['ref']")
        r_op = _np_bf16_bits(state["r_op"], "state['r_op'] of a bf16 store")
        return _bf16_tensor(ref, device), _bf16_tensor(r_op, device), "bf16"
    return (as_f32(np.ascontiguousarray(state["ref"], np.float32), device),
            as_f32(np.ascontiguousarray(state["r_op"], np.float32), device), "float32")


def _expected_soa(ref: torch.Tensor, width: int, pad_cols=None) -> torch.Tensor:
    """The SoA operand of ref at ``width`` columns in ref's dtype: its
    zero-padded (round_up(k, 8), width) transpose, with every row of the
    columns where ``pad_cols`` (width,) is True set to PAD_VALUE."""
    n, k = ref.shape
    r_op = torch.zeros((round_up(k, 8), width), dtype=ref.dtype, device=ref.device)
    r_op[:k, :n] = ref.T
    if pad_cols is not None:
        r_op[:, torch.as_tensor(pad_cols, device=ref.device)] = _pad_like(r_op)
    return r_op


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal shapes, dtypes and bit patterns (PAD and NaN alike)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    view = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
    return torch.equal(a.contiguous().view(view), b.contiguous().view(view))


class NNIndex:
    #: Serving pads each batch up to the next bucket (tpu_knn's policy), so
    #: a varying-m stream reuses a handful of launch geometries.
    bucket_m: bool = True

    def __init__(self, ref, strategy: str = "fused", mesh=None,
                 precision: str | None = None, mutable: bool = False,
                 capacity: int | None = None, store: str = "float32",
                 metric: str = "l2", device="cuda", *, _pretransformed: bool = False):
        """store: "float32", "bf16" or "int8" (the module docstring).

        metric="cosine" / "ip" (strategy "fused", store "float32"):
        similarity search through the exact-L2 machinery by a build-time
        transform, as in tpu_knn. "cosine" normalizes the points once (a
        zero vector raises) and each batch of queries; answers carry the
        cosine similarity, and query_radius takes a minimum similarity.
        "ip" gives each point the column sqrt(max‖r‖² − ‖r‖²), which
        makes d2 monotone in q·r; answers carry the exact f32 q·r of the
        winners, and query_radius raises.

        mutable=True (strategy "fused"): `capacity` slots (at least 2n and
        1024, a multiple of the operand's tile); add / remove / compact,
        and growth past capacity by doubling.

        ``_pretransformed`` (load's): a metric index's points arrive
        already transformed (unit vectors; ip's augmented column) and are
        taken as they are."""
        if metric not in ("l2", "cosine", "ip"):
            raise ValueError(
                f"metric must be 'l2', 'cosine', or 'ip', got {metric!r}")
        if metric != "l2" and strategy not in ("fused", "sharded"):
            raise ValueError(
                "metric='cosine'/'ip' requires strategy='fused' or 'sharded' (the spatial "
                f"indexes assume raw-coordinate geometry); got {strategy!r}")
        if metric != "l2" and store != "float32":
            raise ValueError("metric='cosine'/'ip' requires store='float32' (tpu_knn's "
                             "rule: quantizing after the metric transform breaks the "
                             "monotone reduction to L2)")
        if store not in ("float32", "bf16", "int8"):
            raise ValueError(f"store must be 'float32', 'bf16', or "
                             f"'int8', got {store!r}")
        if strategy not in ("fused", "auto", "projection", "kdtree", "sharded"):
            raise ValueError(f"unknown strategy {strategy!r}")
        if store != "float32" and strategy not in ("fused", "sharded"):
            raise ValueError(f"store={store!r} requires strategy='fused' or 'sharded' "
                             f"(the spatial indexes bake f32 structures into their "
                             f"build); got {strategy!r}")
        if store == "int8" and mutable:
            raise ValueError("store='int8' is immutable (the quantization grid is fixed "
                             "by the build-time value range) — use store='bf16' for a "
                             "mutable quantized index")
        if mutable and strategy not in ("fused", "sharded"):
            raise ValueError(
                "mutable=True requires strategy='fused' or 'sharded' (slot-addressed "
                f"prepared operands); {strategy!r} bakes point order into its build — "
                "rebuild instead")
        if mesh is not None and strategy != "sharded":
            raise ValueError("mesh= requires strategy='sharded' (the other strategies live "
                             "on one device)")
        self.metric = metric
        if strategy == "sharded":
            self._init_sharded(ref, mesh, precision, mutable, capacity, store, _pretransformed)
            return
        if strategy == "kdtree":
            self._init_kdtree(ref, precision, device)
            return
        ref_t = (self._transform_ref(ref, device) if metric != "l2" and not _pretransformed
                 else as_f32(ref, device))
        n, k = ref_t.shape
        self.k_user = k - (1 if metric == "ip" else 0)
        precision = _resolve_precision(precision, k, max(n, capacity or 0), store)
        if strategy == "projection":
            from tpu_knn_torch.kernels.projection import build_projection_index

            self._init_projection(ref_t, build_projection_index(ref_t), precision)
            return
        if precision == "bf16x3_presplit" and mutable:
            raise ValueError("precision='bf16x3_presplit' keeps B12's pre-split operands, "
                             "which a mutable index's in-place updates do not keep; use "
                             "an immutable index or another tier")
        # tile_n is fixed at build time for a large-batch query: it sets the
        # operand's n padding, wide for the packed tier (tpu_knn's rule,
        # index.py:290-296, so state carries across).
        _, tile_n = pick_tiles(k, 1024, n, wide=precision == "packed")
        if store == "int8":
            self._init_int8(ref_t, tile_n, precision)
            return
        # A bf16 store quantizes once, through f32, and both layouts hold
        # the quantized values (tpu_knn's index.py:300-323).
        ref_s = ref_t.to(torch.bfloat16) if store == "bf16" else ref_t
        if mutable:
            self._init_fused(ref_s, None, tile_n, precision, store)
            self._init_mutable(ref_s, capacity)
            return
        n_pad = round_up(n, tile_n)
        # B12's operands split the stored values: over a bf16 store hi is
        # the value itself and lo 0 (tpu_knn's prep_soa over its bf16
        # array), with ‖r‖² in f32 where tpu_knn rounds it to bf16.
        r_ops = (presplit_ops(ref_s, n_pad) if precision == "bf16x3_presplit"
                 else (prep_soa(ref_s, n_pad),))
        self._init_fused(ref_s, r_ops, tile_n, precision, store)
        if strategy == "auto":
            self._init_auto()

    def _init_common(self, ref_dev: torch.Tensor, strategy: str, precision: str,
                     store: str = "float32"):
        self.strategy = strategy
        self.store = store
        self.metric = getattr(self, "metric", "l2")
        self.mutable = False
        self.precision = precision
        self.n, self.k = ref_dev.shape
        self.k_user = getattr(self, "k_user", self.k)
        self.device = ref_dev.device
        self.ref_dev = ref_dev   # AoS copy for exact refinement (the int8 grid)

    def _init_fused(self, ref_dev: torch.Tensor, r_ops, tile_n: int,
                    precision: str, store: str = "float32"):
        self._init_common(ref_dev, "fused", precision, store)
        self.tile_n = tile_n
        # The candidate kernels' operands; None for the int8 store, which
        # holds the grid only (its batches build a bf16 operand per call).
        self.r_ops = None if r_ops is None else tuple(r_ops)

    def _init_projection(self, ref_t: torch.Tensor, proj_index, precision: str):
        """strategy="projection": the sorted index of kernels/projection.py
        (build_projection_index's seven tensors)."""
        self._init_common(ref_t, "projection", precision)
        self.proj_index = tuple(proj_index)

    # ---- the kdtree strategy (host trees) -------------------------------
    #
    # As in tpu_knn (index.py:343-359, 1089-1131): the points stay on the
    # host; the native kdt2 tree serves k <= KDT2_MAX_K, the
    # reference-format implicit-heap tree (built lazily) the rest. Answers
    # are tensors on the index's device (tpu_knn returns NumPy).

    def _init_kdtree(self, ref, precision, device, tree=None):
        from tpu_knn_torch import native

        if isinstance(ref, torch.Tensor):
            device, ref = ref.device, ref.detach().cpu().numpy()
        self.device = check_device(device)
        self.ref = np.ascontiguousarray(ref, np.float32)
        self.strategy, self.store, self.metric, self.mutable = "kdtree", "float32", "l2", False
        self.n, self.k = self.ref.shape
        self.k_user = self.k
        self.precision = _resolve_precision(precision, self.k, self.n, "float32")
        self._tree = tree
        # load() passes the saved tree and leaves kdt2 to the first query.
        self._kdt2 = (native.Kdt2Index(self.ref)
                      if tree is None and self.k <= native.KDT2_MAX_K else None)

    @property
    def tree(self):
        """The reference-format implicit-heap KDTree (kdtree strategy),
        built on first use: save() and the k > 16 queries need it."""
        if self.strategy != "kdtree":
            raise AttributeError("tree: kdtree-strategy indexes only")
        if self._tree is None:
            from tpu_knn_torch.kdtree.build import build_kdtree

            self._tree = build_kdtree(self.ref)
        return self._tree

    @property
    def dev_tree(self):
        """tpu_knn's device-traversal handle, None while the native tree
        serves, which in the port is always (it has no NumPy fallback to
        serve instead); v10 is the device traversal (kdtree/versions.py)."""
        if self.strategy != "kdtree":
            raise AttributeError("dev_tree: kdtree-strategy indexes only")
        return None

    def _serving_tree(self):
        """The kdt2 serving tree, rebuilt from the points at the first query
        after a load(); None above its k cap."""
        from tpu_knn_torch import native

        if self._kdt2 is None and self.k <= native.KDT2_MAX_K:
            self._kdt2 = native.Kdt2Index(self.ref)
        return self._kdt2

    def _kdtree_queries(self, search) -> np.ndarray:
        if isinstance(search, torch.Tensor):
            search = search.detach().cpu().numpy()
        search = np.ascontiguousarray(search, np.float32)
        if search.ndim != 2 or search.shape[1] != self.k:
            raise ValueError(f"queries must be (m, {self.k}), got {search.shape}")
        return search

    def _kdtree_answers(self, idx: np.ndarray, d2: np.ndarray):
        return (torch.from_numpy(idx).to(self.device), torch.from_numpy(d2).to(self.device))

    def _kdtree_query(self, search: np.ndarray):
        from tpu_knn_torch import native

        kdt2 = self._serving_tree()
        if kdt2 is not None:
            return self._kdtree_answers(*kdt2.query(search))
        return self._kdtree_answers(*native.kdtree_query(search, self.ref, self.tree.p,
                                                         self.tree.dim))

    def _kdtree_topk(self, search: np.ndarray, neighbors: int):
        """Host top-K: kdt2 (bounded heap) at K <= KDT2_TOPK_MAX, the
        reference-format tree above; rows ascending by (d2, index)."""
        from tpu_knn_torch import native

        if not 1 <= neighbors <= self.n:
            raise ValueError(f"neighbors must be in [1, {self.n}], got {neighbors}")
        kdt2 = self._serving_tree() if neighbors <= native.KDT2_TOPK_MAX else None
        if kdt2 is not None:
            return self._kdtree_answers(*kdt2.query_topk(search, neighbors))
        return self._kdtree_answers(*native.kdtree_query_topk(
            search, self.ref, self.tree.p, self.tree.dim, neighbors))

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

    # ---- metric transforms (cosine / inner product) --------------------
    #
    # Both metrics run the exact-L2 machinery over transformed points
    # (tpu_knn's index.py:396-472): argmin L2 over unit vectors is argmax
    # cosine (d2 = 2 − 2·cos), and with ip's augmented column every point
    # has the norm max‖r‖², so d2 = ‖q‖² + max‖r‖² − 2·q·r.

    def _transform_ref(self, ref, device, place: bool = True):
        """Build-time transform of the points (tpu_knn's `_transform_ref`):
        NumPy input in NumPy f32 arithmetic, as tpu_knn's host build does
        it, so both packages store the same bits; a tensor in torch on its
        device. Sets `_ip_m2` for "ip". ``place=False`` leaves a NumPy
        result on the host (the sharded build places it shard by shard)."""
        xp = torch if isinstance(ref, torch.Tensor) else np
        if xp is np:
            ref = np.ascontiguousarray(ref, np.float32)
        else:
            ref = as_f32(ref, device)
        n2 = (ref * ref).sum(1)
        if self.metric == "cosine":
            if float(n2.min()) == 0.0:
                raise ValueError(
                    "metric='cosine': reference contains a zero vector "
                    "(no direction); remove it or use metric='l2'")
            out = ref / xp.sqrt(n2)[:, None]
        else:  # ip: augment with sqrt(max_norm2 − ‖r‖²) so norms equalize
            m2 = float(n2.max())
            self._ip_m2 = m2
            if xp is np:
                aug = np.sqrt(np.maximum(np.asarray(m2, np.float32) - n2, 0))
                out = np.concatenate([ref, aug[:, None]], axis=1)
            else:
                aug = torch.sqrt(torch.clamp(torch.tensor(m2, device=ref.device) - n2, min=0))
                out = torch.cat([ref, aug[:, None]], dim=1)
        if not place and xp is np:
            return np.ascontiguousarray(out, np.float32)
        return as_f32(out, device)

    def _transform_q(self, search) -> torch.Tensor:
        """Query-time counterpart of _transform_ref (tpu_knn's
        `_transform_q`): checks the user's dimensionality (k_user; "ip"
        stores k_user + 1 columns), rejects a zero cosine query that
        arrives as NumPy (a tensor would need a device read), and returns
        the transformed (m, k) f32 batch on the index's device."""
        if np.shape(search)[-1] != self.k_user:
            raise ValueError(f"queries must have k={self.k_user} dims, "
                             f"got {np.shape(search)[-1]}")
        if isinstance(search, np.ndarray) and self.metric == "cosine":
            if not (search.astype(np.float32) ** 2).sum(1).all():
                raise ValueError("metric='cosine': zero query vector")
        search = as_f32(search, self.device)
        if search.device != self.device or search.dim() != 2:
            raise ValueError(f"queries must be (m, {self.k_user}) on {self.device}, got "
                             f"{tuple(search.shape)} on {search.device}")
        if self.metric == "cosine":
            return search / torch.sqrt((search * search).sum(dim=1, keepdim=True))
        return torch.nn.functional.pad(search, (0, 1))   # ip: q gains a 0 column

    def _metric_scores(self, search_t, idx, d2):
        """The engine's exact L2 answers in the metric's own score (tpu_knn's
        `_metric_scores`): cosine sim = 1 − d2/2; ip the exact f32 q·r of
        the reported points, recomputed (the d2-derived form loses low bits
        to cancellation). idx (m,) or (m, K); slots with idx < 0 (radius
        padding) score −inf."""
        if self.metric == "l2":
            return idx, d2
        if self.metric == "cosine":
            return idx, torch.where(torch.isfinite(d2), 1.0 - d2 * 0.5, -torch.inf)
        valid = idx >= 0
        safe = torch.where(valid, idx, 0)
        if self.strategy == "sharded":
            pts = self.r_sharded.rows(safe).to(torch.float32)
        else:
            pts = self.ref_dev[safe.reshape(-1).long()]
            pts = pts.reshape(*idx.shape, self.ref_dev.shape[1])
        q = search_t[:, None, :] if idx.dim() == 2 else search_t
        ip = (pts * q).sum(dim=-1)   # the augmented column meets q's 0
        return idx, torch.where(valid, ip, -torch.inf)

    def _user_queries(self, search) -> torch.Tensor:
        """A batch in the space the engines search: the metric's transform,
        the int8 grid's, or the queries as they are (checked)."""
        if self.metric != "l2":
            return self._transform_q(search)
        search = self._as_queries(search)
        return self._i8_q(search) if self.store == "int8" else search

    # ---- mutable indexes ----------------------------------------------
    #
    # A mutable index keeps `capacity` slots in both layouts; empty and
    # removed slots hold PAD_VALUE (all k_pad rows of the SoA operand), so
    # every kernel scores them +inf and the engines run unchanged over
    # n_eff = capacity columns (tpu_knn's index.py:775-973). Updates are in
    # place on the device; ids are slot numbers and never move until
    # compact().

    @property
    def _n_eff(self) -> int:
        """The n every engine runs over: the points of a static index, the
        slot capacity of a mutable one."""
        return self.capacity if self.mutable else self.n

    @property
    def n_live(self) -> int:
        """Queryable points: n; a mutable index's adds less removes; a
        filtered view's kept points."""
        if self.mutable:
            return self._live_count
        view_live = getattr(self, "_view_live", None)
        return self.n if view_live is None else view_live

    def _init_mutable(self, ref_dev: torch.Tensor, capacity: int | None):
        """Slots 0..n-1 hold ref_dev (the stored dtype), the rest of
        round_up(max(capacity, 2n, 1024), tile_n) slots PAD_VALUE."""
        n = ref_dev.shape[0]
        self.n = n
        self.mutable = True
        self.capacity = round_up(max(capacity or 0, 2 * n, 1024), self.tile_n)
        fill = torch.full((self.capacity - n, self.k), PAD_VALUE, dtype=ref_dev.dtype,
                          device=ref_dev.device)
        self.ref_dev = torch.cat([ref_dev, fill])
        self.r_ops = (_expected_soa(self.ref_dev, self.capacity,
                                    torch.arange(self.capacity) >= n),)
        self._n_slots = n                     # the next free slot
        self._live = np.zeros(self.capacity, bool)
        self._live[:n] = True
        self._live_count = n   # n_live, kept by add / remove

    def _require_mutable(self):
        if not self.mutable:
            raise ValueError(
                "this index is immutable; build with NNIndex(..., "
                "mutable=True) for add/remove/compact")

    def add(self, points) -> np.ndarray:
        """Append points; returns their stable ids ((p,) int32, the ids
        later queries report). In-place on the device; past capacity the
        slots grow by doubling. A metric index transforms the points
        (cosine: a zero vector raises; ip: a squared norm above the
        build's maximum raises)."""
        self._require_mutable()
        if self.metric != "l2":
            points = self._transform_added(points)
        points = as_f32(points, self.device)
        if points.dim() != 2 or points.shape[1] != self.k:
            raise ValueError(f"points must be (p, {self.k}), got {tuple(points.shape)}")
        p = points.shape[0]
        if p == 0:
            return np.empty(0, np.int32)
        if self._n_slots + p > self.capacity:
            self._grow(self._n_slots + p)
        pos = self._n_slots
        if self.strategy == "sharded":
            self._add_sharded(points, pos)   # a bf16 store quantizes adds
        else:
            pts = points.to(self.ref_dev.dtype)   # a bf16 store quantizes adds
            self.ref_dev[pos:pos + p] = pts
            r_op = self.r_ops[0]
            r_op[:, pos:pos + p] = 0
            r_op[:self.k, pos:pos + p] = pts.T
        ids = np.arange(pos, pos + p, dtype=np.int32)
        self._n_slots += p
        self._live[ids] = True
        self._live_count += p
        return ids

    def _transform_added(self, points):
        """A metric index's transform of added points, as `_transform_ref`
        does it: NumPy input in tpu_knn's NumPy f32 arithmetic, a tensor in
        torch on its device (cosine: a zero vector raises; ip: a squared
        norm above the build's maximum raises)."""
        xp = torch if isinstance(points, torch.Tensor) else np
        points = (as_f32(points, self.device) if xp is torch
                  else np.ascontiguousarray(points, np.float32))
        if points.ndim != 2 or points.shape[1] != self.k_user:
            raise ValueError(f"points must be (p, {self.k_user}), "
                             f"got {tuple(points.shape)}")
        n2 = (points ** 2).sum(1)
        if self.metric == "cosine":
            if not bool(n2.all()):
                raise ValueError("metric='cosine': zero vector added")
            return points / xp.sqrt(n2)[:, None]
        top = float(n2.max()) if points.shape[0] else 0.0
        if top > self._ip_m2:
            raise ValueError(
                "metric='ip': added point's squared norm "
                f"{top:.6g} exceeds the build-time "
                f"maximum {self._ip_m2:.6g} the augmentation was "
                "sized for — rebuild the index with the larger "
                "set")
        if xp is torch:
            aug = torch.sqrt(torch.clamp(torch.tensor(self._ip_m2, device=points.device) - n2,
                                         min=0))
            return torch.cat([points, aug[:, None]], dim=1)
        aug = np.sqrt(np.maximum(np.float32(self._ip_m2) - n2.astype(np.float32), 0))
        return np.concatenate([points, aug.astype(np.float32)[:, None]], axis=1)

    def remove(self, ids) -> None:
        """Remove points by id: their slots become PAD_VALUE (never reported
        again); the capacity comes back only with compact()."""
        self._require_mutable()
        ids = np.atleast_1d(np.asarray(ids, np.int64))
        if ids.size == 0:
            return
        if ids.min() < 0 or ids.max() >= self._n_slots:
            raise ValueError(f"ids out of range [0, {self._n_slots})")
        if not self._live[ids].all():
            dead = ids[~self._live[ids]]
            raise ValueError(f"ids already removed: {dead.tolist()[:8]}")
        if self.strategy == "sharded":
            self._remove_sharded(ids)
        else:
            at = torch.as_tensor(ids, device=self.device)
            self.ref_dev[at] = _pad_like(self.ref_dev)
            self.r_ops[0][:, at] = _pad_like(self.r_ops[0])
        self._live[ids] = False
        self._live_count -= np.unique(ids).size

    def _grow(self, need: int):
        """Capacity to round_up(max(2·capacity, need), tile_n), the new
        slots PAD_VALUE; slot ids stay. A sharded index lays its slots out
        anew over max(2·capacity, need) (its n_local changes)."""
        if self.strategy == "sharded":
            live = self._live[: self._n_slots].copy()
            slots = self.r_sharded.gather()[: self._n_slots]
            self._init_mutable_sharded(slots, max(2 * self.capacity, need), slots.dtype)
            self._live[: self._n_slots] = live
            self._live_count = int(live.sum())
            return
        new_cap = round_up(max(2 * self.capacity, need), self.tile_n)
        pad_n = new_cap - self.capacity
        self.ref_dev = torch.cat([self.ref_dev, torch.full(
            (pad_n, self.k), PAD_VALUE, dtype=self.ref_dev.dtype, device=self.device)])
        self.r_ops = (torch.nn.functional.pad(self.r_ops[0], (0, pad_n), value=PAD_VALUE),)
        live = np.zeros(new_cap, bool)
        live[: self.capacity] = self._live
        self._live = live
        self.capacity = new_cap

    def compact(self) -> np.ndarray:
        """Drop removed slots and shrink the capacity. Point ids change;
        returns the (old slots,) int32 map from old id to new id (-1 for a
        removed point)."""
        self._require_mutable()
        live_ids = np.nonzero(self._live[: self._n_slots])[0]
        mapping = np.full(self._n_slots, -1, np.int32)
        mapping[live_ids] = np.arange(live_ids.size, dtype=np.int32)
        if self.strategy == "sharded":
            self.n = int(live_ids.size)
            slots = self.r_sharded.gather()[torch.as_tensor(live_ids, device=self.device)]
            self._init_mutable_sharded(slots, None, slots.dtype)
            return mapping
        self._init_mutable(self.ref_dev[torch.as_tensor(live_ids, device=self.device)], None)
        return mapping

    # ---- filtered views ---------------------------------------------------

    def filtered_view(self, keep) -> "NNIndex":
        """An exact filtered-search view: a queryable index of the points
        where ``keep`` ((n,) bool) is True (tpu_knn's index.py:974-1039).
        It shares this index's AoS copy and holds one masked SoA operand
        (excluded columns PAD_VALUE, scored +inf by every kernel), so
        queries, top-K and radius run the prepared engines and report
        original ids. The shared AoS copy is not masked, so the view stays
        off the routes that scan it (the AoS scan, the dense path, the
        m = 1 AoS top-K engine). Read-only."""
        if self.store == "int8":
            raise ValueError(
                "filtered_view requires a resident SoA operand to mask; "
                "store='int8' keeps only the grid array — use "
                "store='bf16' for filtered quantized serving")
        if self.mutable:
            raise ValueError(
                "filtered_view on a mutable index is ambiguous under "
                "later add/remove; use remove() or build a view from a "
                "compacted snapshot")
        if self.strategy != "sharded" and (self.strategy not in ("fused", "auto")
                                           or len(self.r_ops) != 1):
            raise ValueError(
                "filtered_view requires the fused/auto/sharded strategy "
                f"with a plain SoA operand; this index uses {self.strategy!r}")
        keep = np.asarray(keep, bool)
        if keep.shape != (self.n,):
            raise ValueError(
                f"keep must be a ({self.n},) boolean mask, "
                f"got shape {keep.shape}")
        live = int(keep.sum())
        if live < 1:
            raise ValueError("filtered_view would keep no points")
        if self.strategy == "sharded":
            return self._filtered_view_sharded(keep, live)
        r_op = self.r_ops[0]
        col_keep = np.zeros(r_op.shape[1], bool)
        col_keep[: self.n] = keep
        masked = torch.where(torch.as_tensor(col_keep, device=self.device)[None, :], r_op,
                             _pad_like(r_op))
        return self._as_view(self.ref_dev, masked, live)

    def _as_view(self, ref_dev, r_op, live: int) -> "NNIndex":
        view = NNIndex.__new__(NNIndex)
        view.metric, view.k_user = self.metric, self.k_user
        if self.metric == "ip":
            view._ip_m2 = self._ip_m2
        view._init_fused(ref_dev, (r_op,), self.tile_n, self.precision, self.store)
        view._view_live = live
        view._aos_selfmasked = False
        return view

    # ---- the sharded strategy -------------------------------------------
    #
    # As in tpu_knn (index.py:361-390, 503-640, 1041-1087): the points are
    # laid out over the mesh's reference axes once, [dcn-major, sp-minor]
    # along n, n_local rows a shard (distributed/sharded.py's layouts), and
    # every query runs that module's per-shard pipelines over them. The f32
    # and bf16 stores keep two operands a shard, its rows (the exact
    # refinement gathers from them) and their SoA transpose, PAD_VALUE past
    # n; the int8 store keeps only the grid rows (zeros past n, excluded by
    # position). A mutable index lays its capacity slots out the same way:
    # global slot g is padded row g (shard g // n_local), so ids stay what
    # they are across growth. Answers come back on the mesh's first device.

    def _init_sharded(self, ref, mesh, precision, mutable: bool, capacity, store: str,
                      pretransformed: bool):
        from tpu_knn_torch.distributed.sharded import _check_tier, default_mesh

        self.mesh = mesh if mesh is not None else default_mesh()
        self.device = self.mesh.home
        self.strategy, self.store, self.mutable = "sharded", store, False
        self.ref_dev = self.r_ops = None
        # The points stay where they are (a NumPy array on the host) until
        # each shard's rows move to its devices.
        ref = (ref.to(torch.float32) if isinstance(ref, torch.Tensor)
               else np.ascontiguousarray(ref, np.float32))
        if self.metric != "l2" and not pretransformed:
            ref = self._transform_ref(ref, self.device, place=False)
        self.n, self.k = ref.shape
        self.k_user = self.k - (1 if self.metric == "ip" else 0)
        self.precision = _resolve_precision(precision, self.k, max(self.n, capacity or 0),
                                            store)
        _check_tier(self.precision)
        if store == "int8":
            self._init_int8_sharded(ref)
            return
        dtype = torch.bfloat16 if store == "bf16" else torch.float32
        if mutable:
            self._init_mutable_sharded(ref, capacity, dtype)
            return
        from tpu_knn_torch.distributed.sharded import sharded_layout

        self.tile_n, self._n_local, _ = sharded_layout(self.n, self.k, self.mesh)
        self._place_sharded_operands(ref, dtype)

    def _place_sharded_operands(self, rows, dtype) -> None:
        """Both prepared operands of every shard from ``rows`` (the points or
        the slots, host or device): the (n_local, k) rows in ``dtype`` (a
        bf16 store quantizes here, once), PAD_VALUE past the rows given, and
        their SoA transpose."""
        from tpu_knn_torch.distributed.sharded import place_rows, place_soa

        self.r_sharded = place_rows(self.mesh, rows, self._n_local, dtype)
        self.r_ops_sharded = place_soa(self.r_sharded)

    def _init_int8_sharded(self, ref):
        """store="int8" + strategy="sharded": one global embed (zero, scale)
        from the points' exact f32 min/max (host arithmetic for NumPy, as
        tpu_knn's host build; torch for a tensor, as the fused int8 build),
        and each shard's (n_local, k) int8 grid rows its only resident
        state."""
        from tpu_knn_torch.distributed.sharded import int8_sharded_layout, place_rows

        if isinstance(ref, torch.Tensor):
            self._set_i8_embed(ref.min(dim=0).values.double().cpu().numpy(),
                               ref.max(dim=0).values.double().cpu().numpy())
            z = self._i8_zero_dev.to(ref.device)
            g = torch.clamp(torch.round((ref - z) * self._i8_inv_s_dev.to(ref.device)),
                            -127.0, 127.0).to(torch.int8)
        else:
            self._set_i8_embed(ref.min(axis=0).astype(np.float64),
                               ref.max(axis=0).astype(np.float64))
            g = np.clip(np.round((ref - self._i8_zero) * self._i8_inv_s),
                        -127.0, 127.0).astype(np.int8)
        self._n_local, _ = int8_sharded_layout(self.n, self.mesh)
        self.tile_n = pick_tiles(self.k, 1024, self.n, wide=self.precision == "packed")[1]
        self.r_sharded = place_rows(self.mesh, g, self._n_local, torch.int8, fill=0)
        self.r_ops_sharded = None

    def _init_mutable_sharded(self, slots, capacity: int | None, dtype):
        """Mutable + sharded: ``slots`` the occupied slot rows (removed ones
        already PAD_VALUE), laid out over max(capacity, 2 · slots, 1024)
        slots at the sharded layout, the rest PAD_VALUE; all given slots
        live. Growth and compact lay the slots out anew this way (n_local
        changes; a slot's id is its position in ``slots``)."""
        from tpu_knn_torch.distributed.sharded import sharded_layout

        n_slots = slots.shape[0]
        cap_t = max(capacity or 0, 2 * n_slots, 1024)
        self.tile_n, self._n_local, self.capacity = sharded_layout(cap_t, self.k, self.mesh)
        self.mutable = True
        self._place_sharded_operands(slots, dtype)
        self._n_slots = n_slots
        self._live = np.zeros(self.capacity, bool)
        self._live[:n_slots] = True
        self._live_count = n_slots

    def _shard_spans(self, lo: int, hi: int):
        """(shard, first local row, global rows [a, b)) for each shard that
        global rows [lo, hi) touch."""
        w = self._n_local
        return [(s, a - s * w, a, min(hi, (s + 1) * w))
                for s in range(lo // w, cdiv(hi, w)) for a in (max(lo, s * w),)]

    def _add_sharded(self, pts: torch.Tensor, pos: int) -> None:
        """Write (p, k) points into slots [pos, pos + p) of every copy of
        both operands, in place."""
        p = pts.shape[0]
        for s, a, g0, g1 in self._shard_spans(pos, pos + p):
            for t in self.r_sharded.copies_of(s):
                t[a:a + g1 - g0] = pts[g0 - pos:g1 - pos].to(t.device, t.dtype)
            for t in self.r_ops_sharded.copies_of(s):
                blk = pts[g0 - pos:g1 - pos].to(t.device, t.dtype)
                t[:, a:a + g1 - g0] = 0
                t[:self.k, a:a + g1 - g0] = blk.T

    def _remove_sharded(self, ids: np.ndarray) -> None:
        """PAD_VALUE into the removed slots of every copy of both operands."""
        owner = ids // self._n_local
        for s in np.unique(owner):
            local = ids[owner == s] - s * self._n_local
            for t in self.r_sharded.copies_of(int(s)):
                t[torch.as_tensor(local, device=t.device)] = _pad_like(t)
            for t in self.r_ops_sharded.copies_of(int(s)):
                t[:, torch.as_tensor(local, device=t.device)] = _pad_like(t)

    def _filtered_view_sharded(self, keep: np.ndarray, live: int) -> "NNIndex":
        """filtered_view over the mesh (tpu_knn's index.py:1041-1087): one
        masked copy of each shard's two operands, the excluded rows and
        columns PAD_VALUE, so the view runs the unmodified shard pipelines
        and reports original ids."""
        from tpu_knn_torch.distributed.mesh import ShardedArray

        view = NNIndex.__new__(NNIndex)
        for attr in ("strategy", "store", "metric", "k_user", "precision", "n", "k", "device",
                     "mesh", "tile_n", "_n_local"):
            setattr(view, attr, getattr(self, attr))
        if self.metric == "ip":
            view._ip_m2 = self._ip_m2
        view.mutable, view.ref_dev, view.r_ops = False, None, None
        w = self._n_local
        maskp = np.zeros(self.r_sharded.shape[0], bool)
        maskp[: self.n] = keep
        aos, soa = [], []
        for s in range(self.r_sharded.num_shards):
            r, r_op = self.r_sharded.block(s), self.r_ops_sharded.block(s)
            mk = torch.as_tensor(maskp[s * w:(s + 1) * w], device=r.device)
            aos.append(torch.where(mk[:, None], r, _pad_like(r)))
            soa.append(torch.where(mk[None, :], r_op, _pad_like(r_op)))
        view.r_sharded = ShardedArray(self.mesh, aos, axis=0)
        view.r_ops_sharded = ShardedArray(self.mesh, soa, axis=1)
        view._view_live = live
        return view

    def _sharded_query(self, search: torch.Tensor):
        """1-NN of a bucketed batch over the shards (grid units for int8)."""
        from tpu_knn_torch.distributed.sharded import _build_sharded, _build_sharded_int8

        m = search.shape[0]
        if self.store == "int8":
            return _build_sharded_int8(m, self.n, self.k, self._n_local, self.mesh,
                                       cutoff_scale=1.0 / self._i8_s2)(search, self.r_sharded)
        run = _build_sharded(m, self._n_eff, self.k, self.mesh, tile_n=self.tile_n,
                             prepadded=True, precision=self.precision)
        return run(search, (self.r_sharded, self.r_ops_sharded))

    def _sharded_topk(self, search: torch.Tensor, neighbors: int):
        """Top-K of a batch over the shards (grid space for int8, user-unit
        d2 out)."""
        from tpu_knn_torch.distributed.sharded import (
            _build_sharded_int8_topk, _build_sharded_topk,
        )

        search, m, mb = self._topk_prep_batch(search, neighbors)
        if self.store == "int8":
            idx, d2 = _build_sharded_int8_topk(mb, self.n, self.k, neighbors, self._n_local,
                                               self.mesh)(search, self.r_sharded)
            return idx[:m], d2[:m] * self._i8_s2
        run = _build_sharded_topk(mb, self._n_eff, self.k, neighbors, self.mesh,
                                  n_local=self._n_local, prepadded=True,
                                  precision=self.precision)
        idx, d2 = run(search, self.r_sharded, self.r_ops_sharded)
        return idx[:m], d2[:m]

    def _sharded_pipeline(self, m: int):
        """pipeline() of the sharded strategy: run(search, ops) over ops =
        ((rows, SoA),) for f32/bf16, (grid,) for int8 with the grid
        transform and the d2 rescale inside run."""
        from tpu_knn_torch.distributed.sharded import _build_sharded, _build_sharded_int8

        if self.store == "int8":
            run0 = _build_sharded_int8(m, self.n, self.k, self._n_local, self.mesh,
                                       cutoff_scale=1.0 / self._i8_s2)

            def run_i8(search, grid):
                idx, d2 = run0(self._i8_q(as_f32(search, self.device)), grid)
                return idx, d2 * self._i8_s2

            return run_i8, (self.r_sharded,)
        run = _build_sharded(m, self._n_eff, self.k, self.mesh, tile_n=self.tile_n,
                             prepadded=True, precision=self.precision)
        return run, ((self.r_sharded, self.r_ops_sharded),)

    @staticmethod
    def _rebind_mesh(names, sizes, device="cuda"):
        """A saved mesh's shape over this process's devices: on the CUDA
        cards where enough are visible (one each), else default_mesh(); on
        the CPU, logical shards of that shape (results do not depend on the
        placement)."""
        from tpu_knn_torch.distributed.mesh import Mesh
        from tpu_knn_torch.distributed.sharded import _grid, default_mesh

        sizes = tuple(int(x) for x in sizes)
        need = int(np.prod(sizes))
        device = torch.device(device)
        devs = ([torch.device("cuda", i) for i in range(torch.cuda.device_count())]
                if device.type == "cuda" else [device] * need)
        if len(devs) < need:
            return default_mesh()
        return Mesh(_grid(devs, sizes), tuple(str(a) for a in names))

    # ---- the int8 grid store ------------------------------------------
    #
    # store="int8" keeps only the (n, k) int8 grid of the affine embed
    # p = z + s·g (per-dim zero z, one global step s), and runs every query
    # exactly in grid space on q' = (q − z)/s: ‖q − p‖² = s²·‖q' − g‖², so
    # the engines need no dequantization (grid integers are exact in f32 and
    # bf16 at every read) and reported d2 rescale by s² (tpu_knn's
    # index.py:455-501).

    def _set_i8_embed(self, lo: np.ndarray, hi: np.ndarray):
        """The embed's constants from f64 per-dim (lo, hi), tpu_knn's
        `_set_i8_embed` verbatim: zero offsets, the global inverse step and
        the d2 rescale derived from the stored inverse step."""
        z = (lo + hi) / 2.0
        half = float(np.max(hi - z)) if len(z) else 0.0
        s = half / 127.0 if half > 0.0 else 1.0
        self._set_i8_constants(np.asarray(z, np.float32), np.float32(1.0 / s))

    def _set_i8_constants(self, zero: np.ndarray, inv_s) -> None:
        self._i8_zero = np.asarray(zero, np.float32)       # (k,) host copy
        self._i8_inv_s = np.float32(inv_s)
        self._i8_s2 = float(np.float32(1.0 / (np.float64(self._i8_inv_s) ** 2)))
        self._i8_zero_dev = torch.as_tensor(self._i8_zero, device=self.device)
        self._i8_inv_s_dev = torch.tensor(self._i8_inv_s, device=self.device)

    def _init_int8(self, ref_t: torch.Tensor, tile_n: int, precision: str):
        self.device = ref_t.device
        self._set_i8_embed(ref_t.min(dim=0).values.double().cpu().numpy(),
                           ref_t.max(dim=0).values.double().cpu().numpy())
        g = torch.clamp(torch.round((ref_t - self._i8_zero_dev) * self._i8_inv_s_dev),
                        -127.0, 127.0).to(torch.int8)
        self._init_fused(g, None, tile_n, precision, "int8")

    @classmethod
    def from_int8_grid(cls, grid, zero, scale, precision: str | None = None,
                       mesh=None, strategy: str = "fused", device="cuda") -> "NNIndex":
        """An int8 index built straight from pre-quantized grid state (the
        capacity path): ``grid`` (n, k) int8, ``zero`` (k,) per-dim offsets,
        ``scale`` the positive global step; the stored points are
        zero + scale·grid. Queries behave as NNIndex(..., store="int8")'s.
        A tensor grid stays on its device; NumPy goes to ``device``."""
        if mesh is not None and strategy != "sharded":
            raise ValueError("mesh= requires strategy='sharded' (a fused grid index "
                             "lives on one device) — it would otherwise be silently "
                             "ignored")
        dtype = grid.dtype if isinstance(grid, torch.Tensor) else np.asarray(grid).dtype
        if dtype not in (torch.int8, np.int8) or len(grid.shape) != 2:
            raise ValueError(f"grid must be an (n, k) int8 array, got {dtype} "
                             f"{tuple(grid.shape)}")
        zero = np.ascontiguousarray(zero, np.float32)
        if zero.shape != (grid.shape[1],):
            raise ValueError(f"zero must be ({grid.shape[1]},) f32, got {zero.shape}")
        if not float(scale) > 0.0:
            raise ValueError(f"scale must be positive, got {scale}")
        return cls._from_int8_grid(grid, zero, np.float32(1.0 / np.float64(scale)),
                                   precision, strategy, device, mesh)

    @classmethod
    def _from_int8_grid(cls, grid, zero, inv_s, precision: str | None,
                        strategy: str = "fused", device="cuda", mesh=None) -> "NNIndex":
        """The index over the given grid and embed constants (re-quantizing
        is neither possible nor wanted: the grid is the index); ``None``
        takes tpu_knn's tier for a quantized store. strategy="sharded"
        places the grid's rows shard by shard over ``mesh`` (default_mesh()
        by default): a grid never has to fit one device whole."""
        if strategy not in ("fused", "sharded"):
            raise ValueError(f"int8 grids serve the fused or sharded strategy, "
                             f"got {strategy!r}")
        n, k = grid.shape
        if precision is None:
            precision = _resolve_precision(None, k, n, "int8")
        elif precision not in PORTED_PRECISIONS:
            raise ValueError(f"unknown precision={precision!r}")
        if strategy == "sharded":
            return cls._from_int8_grid_sharded(grid, zero, inv_s, precision, mesh)
        if not isinstance(grid, torch.Tensor):
            grid = torch.from_numpy(np.array(grid, np.int8))
            grid = grid.to(check_device(device))
        check_device(grid.device)
        ix = cls.__new__(cls)
        ix.device = grid.device
        ix._set_i8_constants(zero, inv_s)
        _, tile_n = pick_tiles(k, 1024, n, wide=precision == "packed")
        ix._init_fused(grid.contiguous(), None, tile_n, precision, "int8")
        return ix

    @classmethod
    def _from_int8_grid_sharded(cls, grid, zero, inv_s, precision: str, mesh) -> "NNIndex":
        from tpu_knn_torch.distributed.sharded import (
            _check_tier, default_mesh, int8_sharded_layout, place_rows,
        )

        _check_tier(precision)
        ix = cls.__new__(cls)
        ix.mesh = mesh if mesh is not None else default_mesh()
        ix.device = ix.mesh.home
        ix.strategy, ix.store, ix.metric, ix.mutable = "sharded", "int8", "l2", False
        ix.n, ix.k = grid.shape
        ix.k_user, ix.precision = ix.k, precision
        ix.ref_dev = ix.r_ops = ix.r_ops_sharded = None
        ix._set_i8_constants(zero, inv_s)
        ix.tile_n = pick_tiles(ix.k, 1024, ix.n, wide=precision == "packed")[1]
        ix._n_local, _ = int8_sharded_layout(ix.n, ix.mesh)
        ix.r_sharded = place_rows(ix.mesh, grid, ix._n_local, torch.int8, fill=0)
        return ix

    def _i8_q(self, search: torch.Tensor) -> torch.Tensor:
        """User-space queries -> grid space (one f32 rounding per
        coordinate, the embed's definition)."""
        return (search - self._i8_zero_dev) * self._i8_inv_s_dev

    def _i8_soa(self):
        """The per-call bf16 SoA operand of the batch engines: grid values
        are exact in bf16, so the batch route computes the grid-space
        geometry the AoS scan does. Built per call and released after (the
        int8 mode holds the grid only; steady batch serving is what
        store='bf16' is for)."""
        return (prep_soa(self.ref_dev.to(torch.bfloat16), round_up(self.n, self.tile_n)),)

    def _i8_ops(self):
        """The per-call operands of the 1-NN batch tier (tpu_knn's
        `_i8_ops` over ``precision``): the bf16 SoA operand, or for
        "bf16x3_presplit" B12's split of it (hi the grid values, lo 0,
        ‖g‖² in f32)."""
        if self.precision == "bf16x3_presplit":
            return presplit_ops(self.ref_dev, round_up(self.n, self.tile_n))
        return self._i8_soa()

    def _i8_query(self, search: torch.Tensor):
        """Grid-space 1-NN of an (already transformed, bucketed) batch, in
        grid units: m <= 4 the diff-form AoS scan straight off the int8
        grid, small n the dense path, batches the tier's kernel over the
        per-call bf16 operand with the certificate rescaled to grid units
        (tpu_knn's index.py:1679-1715)."""
        from tpu_knn_torch.kernels.dense import _dense, dense_applicable
        from tpu_knn_torch.kernels.smallm import SMALLM_MAX_M, _aos_scan

        m = search.shape[0]
        if dense_applicable(m, self.k, self.n):
            return _dense(search, self.ref_dev)
        if m <= SMALLM_MAX_M:
            return _aos_scan(search, self.ref_dev)
        run = _build_prepared_query(m, self.n, self.k, self.precision,
                                    cutoff_scale=1.0 / self._i8_s2)
        return run(search, self._i8_ops(), self.ref_dev)

    def _i8_run(self, search, grid):
        """pipeline()'s run for the int8 mode: the grid transform, the route
        _query_padded takes for the batch and the d2 rescale in one call,
        over ops = (grid,), so a timed run includes the per-call bf16
        operand."""
        if grid is not self.ref_dev:
            raise ValueError("run() serves this index's own grid")
        idx, d2 = self._i8_query(self._i8_q(as_f32(search, self.device)))
        return idx, d2 * self._i8_s2

    # ---- state from a tpu_knn index ------------------------------------

    @classmethod
    def from_state(cls, state, device="cuda", mesh=None) -> "NNIndex":
        """Build from a tpu_knn index's state, given as NumPy, taken
        verbatim after a check (an optional ``"precision"`` key carries the
        index's tier; else tpu_knn's default for the store):

        - fused: ``{"ref": np.asarray(ix.ref_dev), "r_op":
          np.asarray(ix.r_ops[0])}``; ``r_op`` must be the zero-padded
          (k_pad, n_pad) transpose of ``ref`` (tpu_knn's prep_soa layout).
          A bf16 store hands both over as bfloat16 (taken bit for bit
          through a 16-bit integer view);
        - presplit (precision="bf16x3_presplit"): ``{"ref": ..., "r_ops":
          tuple(np.asarray(a) for a in ix.r_ops)}``, the (hi, lo) bf16 split
          of the zero-padded (round_up(k, 16), n_pad) transpose and its
          (1, n_pad) f32 ‖r‖² row;
        - int8: ``{"grid": np.asarray(ix.ref_dev), "zero": ix._i8_zero,
          "inv_s": ix._i8_inv_s}``;
        - projection: ``{"ref": ..., "proj_index": tuple(np.asarray(a) for
          a in ix.proj_index)}``; ``order`` must be a permutation and the
          rest build_projection_index's layout of ``ref[order]``;
        - mutable (f32 or bf16): the fused keys over the slots, ``ref``
          (capacity, k) and ``r_op`` (k_pad, capacity) with every empty
          or removed slot PAD_VALUE (all k_pad rows of the operand), plus
          ``"capacity"``, ``"_n_slots"``, ``"_live"`` ((capacity,) bool)
          and optionally ``"tile_n"`` and ``"n"`` (ix.tile_n, ix.n);
        - filtered view (f32 or bf16): ``{"ref": the parent's AoS copy,
          "r_op": the view's masked operand, "_view_live": ...}``, the
          excluded columns PAD_VALUE in every row;
        - a metric index adds ``"metric"``, optionally ``"k_user"``, and
          for "ip" ``"_ip_m2"`` to its fused, presplit, mutable or view
          state (of the transformed points);
        - sharded, given the port's ``mesh`` of the same shape as the
          index's: ``{"ref": np.asarray(ix.r_sharded), "r_op":
          np.asarray(ix.r_ops_sharded), "n": ix.n}`` (the padded layout,
          PAD_VALUE rows past n; bf16 as for fused), the mutable keys
          ``"_n_slots"`` and ``"_live"`` for a mutable index (its capacity
          is the padded length), or for int8 ``{"grid":
          np.asarray(ix.r_sharded), "zero": ..., "inv_s": ..., "n": ix.n}``;
          each checked against the layout this mesh gives, metric keys as
          above."""
        if mesh is not None:
            index = cls._from_sharded_state(state, mesh)
        else:
            index = cls._from_store_state(state, device)
        metric = state.get("metric", "l2")
        if metric not in ("l2", "cosine", "ip"):
            raise ValueError(f"state['metric'] must be 'l2', 'cosine' or 'ip', got {metric!r}")
        if metric != "l2":
            if index.store != "float32" or index.strategy not in ("fused", "sharded"):
                raise ValueError("a cosine/ip state must be a fused or sharded float32 "
                                 "index's")
            index.metric = metric
            index.k_user = int(state.get("k_user", index.k - (metric == "ip")))
            if index.k_user != index.k - (metric == "ip"):
                raise ValueError(f"k_user={index.k_user} does not fit {index.k} stored "
                                 f"columns under metric={metric!r}")
            if metric == "ip":
                index._ip_m2 = float(state["_ip_m2"])
        return index

    @classmethod
    def _from_sharded_state(cls, state, mesh) -> "NNIndex":
        """A tpu_knn sharded index's state over the port's ``mesh``: the
        padded layout checked against this mesh's (sharded_layout,
        int8_sharded_layout, or for a mutable index n_local = capacity /
        shards), then placed shard by shard."""
        from tpu_knn_torch.distributed.sharded import (
            _num_shards, int8_sharded_layout, sharded_layout,
        )

        n = int(state["n"])
        shards = _num_shards(mesh)
        if "grid" in state:
            grid = np.asarray(state["grid"])
            if grid.dtype != np.int8 or grid.ndim != 2:
                raise ValueError(f"state['grid'] must be an (n_pad, k) int8 array, got "
                                 f"{grid.dtype} {grid.shape}")
            if grid.shape[0] != int8_sharded_layout(n, mesh)[1] or grid[n:].any():
                raise ValueError(f"grid of {grid.shape[0]} rows is not the int8 layout of "
                                 f"n={n} over {shards} shards (zeros past n)")
            return cls._from_int8_grid(grid[:n], np.asarray(state["zero"], np.float32),
                                       np.float32(state["inv_s"]), state.get("precision"),
                                       strategy="sharded", mesh=mesh)
        ref, r_op, store = _state_tensors(state, "cpu")
        n_pad, k = ref.shape
        if "_live" in state:
            n_slots, live = int(state["_n_slots"]), np.asarray(state["_live"], bool)
            n_local = n_pad // shards
            ok = (n_pad % shards == 0 and n_local % LANE == 0 and live.shape == (n_pad,)
                  and 0 <= n_slots <= n_pad and not live[n_slots:].any())
        else:
            n_local = sharded_layout(n, k, mesh)[1]
            ok = n_pad == n_local * shards
            live = None
        pad = ref[:, 0] == _pad_like(ref)
        if not ok or not bool(pad[n if live is None else n_slots:].all()):
            raise ValueError(f"ref of {n_pad} rows is not the sharded layout of this mesh "
                             f"(PAD_VALUE past the points)")
        # tpu_knn zero-pads the rows past k, but writes PAD_VALUE into every
        # row of a removed slot's column; the port lays PAD columns out its
        # own way (place_soa).
        tail = r_op[k:].clone() if r_op.shape == (round_up(k, 8), n_pad) else None
        if tail is not None:
            tail[:, pad & (tail == _pad_like(tail)).all(dim=0)] = 0
        if tail is None or bool(tail.any()) or not _bits_equal(r_op[:k], ref.T):
            raise ValueError("r_op is not the zero-padded transpose of ref")
        precision = state.get("precision")
        if precision == _resolve_precision(None, k, n_pad if live is not None else n, store):
            precision = None   # the store's own tier, which an explicit tier may not name
        index = cls.__new__(cls)
        index.metric = state.get("metric", "l2")
        if live is None:
            index._init_sharded(ref[:n], mesh, precision, False, None, store, True)
            return index
        index._init_sharded(ref[:n_slots], mesh, precision, True, n_pad, store, True)
        # The state's own layout: its capacity, every slot as it is.
        index._n_local, index.capacity = n_local, n_pad
        index.tile_n = _tile_for_width(n_local, n_local)
        index._place_sharded_operands(ref, ref.dtype)
        index.n, index._n_slots, index._live = n, n_slots, live.copy()
        index._live_count = int(live.sum())
        return index

    @classmethod
    def _from_store_state(cls, state, device) -> "NNIndex":
        if "proj_index" in state:
            return cls._from_projection_state(state, device)
        if "grid" in state:
            return cls._from_int8_state(state, device)
        if "r_ops" in state:
            return cls._from_presplit_state(state, device)
        return cls._from_soa_state(state, device)

    @classmethod
    def _from_soa_state(cls, state, device) -> "NNIndex":
        """A fused (f32 or bf16) state: immutable, mutable ("capacity") or a
        filtered view ("_view_live"), each checked against the layout
        tpu_knn keeps and taken bit for bit."""
        ref, r_op, store = _state_tensors(state, device)
        if ref.dim() != 2 or r_op.dim() != 2:
            raise ValueError("state['ref'] must be (n, k), state['r_op'] (k_pad, n_pad)")
        n, k = ref.shape
        width = r_op.shape[1]
        if r_op.shape[0] != round_up(k, 8) or width < n:
            raise ValueError(f"r_op shape {tuple(r_op.shape)} is not the SoA operand of a "
                             f"({n}, {k}) reference set")
        index = cls.__new__(cls)
        if "capacity" in state:
            cap, n_slots = int(state["capacity"]), int(state["_n_slots"])
            live = np.asarray(state["_live"], bool)
            if (n != cap or width != cap or live.shape != (cap,)
                    or not 0 <= n_slots <= cap or live[n_slots:].any()):
                raise ValueError(f"a mutable state holds capacity ({cap}) slots in ref and "
                                 f"r_op and no live slot past _n_slots ({n_slots})")
            dead = torch.as_tensor(~live, device=ref.device)
            if not (_bits_equal(r_op, _expected_soa(ref, cap, ~live))
                    and bool((ref[dead] == _pad_like(ref)).all())):
                raise ValueError("ref and r_op are not a mutable index's slots: the live "
                                 "slots' zero-padded transpose, PAD_VALUE in every other slot")
            n0 = int(state.get("n", n_slots))
            precision = _resolve_precision(state.get("precision"), k, max(n0, cap), store)
            tile_n = int(state.get("tile_n",
                                   pick_tiles(k, 1024, n0, wide=precision == "packed")[1]))
            if cap % tile_n:
                raise ValueError(f"capacity {cap} is not a multiple of tile_n={tile_n}")
            index._init_fused(ref, (r_op,), tile_n, precision, store)
            index.n, index.mutable, index.capacity = n0, True, cap
            index._n_slots, index._live = n_slots, live.copy()
            index._live_count = int(live.sum())
            return index
        excluded = None
        if "_view_live" in state:
            excluded = (r_op == _pad_like(r_op)).all(dim=0).cpu().numpy()
            excluded[n:] = True
            kept = int((~excluded[:n]).sum())
            if kept != int(state["_view_live"]) or kept < 1:
                raise ValueError(f"_view_live={state['_view_live']} but r_op keeps {kept} "
                                 "columns")
        if not _bits_equal(r_op, _expected_soa(ref, width, excluded)):
            raise ValueError("r_op is not the zero-padded transpose of ref"
                             + ("" if excluded is None else
                                " with the excluded columns PAD_VALUE"))
        index._init_fused(ref, (r_op,), _tile_for_width(n, width),
                          _resolve_precision(state.get("precision"), k, n, store), store)
        if excluded is not None:
            index._view_live = kept
            index._aos_selfmasked = False
        return index

    @classmethod
    def _from_presplit_state(cls, state, device) -> "NNIndex":
        ref = np.ascontiguousarray(state["ref"], np.float32)
        if ref.ndim != 2 or len(state["r_ops"]) != 3:
            raise ValueError("a presplit state is ref (n, k) and r_ops (hi, lo, rn)")
        hi = _np_bf16_bits(state["r_ops"][0], "hi")
        lo = _np_bf16_bits(state["r_ops"][1], "lo")
        rn = np.ascontiguousarray(state["r_ops"][2], np.float32)
        n, k = ref.shape
        width = hi.shape[1] if hi.ndim == 2 else -1
        if (hi.shape != (round_up(k, 16), width) or lo.shape != hi.shape
                or rn.shape != (1, width) or width < n):
            raise ValueError(f"r_ops shapes {hi.shape}, {lo.shape}, {rn.shape} are not "
                             f"B12's operands of a ({n}, {k}) reference set")
        want_hi, want_lo, _ = presplit_ops(torch.from_numpy(ref.copy()), width)
        norm = np.zeros(width)
        norm[:n] = (ref.astype(np.float64) ** 2).sum(axis=1)
        if not (np.array_equal(hi, want_hi.view(torch.int16).numpy())
                and np.array_equal(lo, want_lo.view(torch.int16).numpy())):
            raise ValueError("r_ops' (hi, lo) are not the bf16 split of ref's padded "
                             "transpose")
        # ‖r‖² may differ from ours in the last bits (f32 summation order).
        if not np.allclose(rn[0], norm, rtol=1e-6, atol=0.0):
            raise ValueError("r_ops' norm row is not ‖r‖² of ref")
        index = cls.__new__(cls)
        index._init_fused(as_f32(ref, device), (_bf16_tensor(hi, device),
                                                _bf16_tensor(lo, device),
                                                as_f32(rn, device)),
                          _tile_for_width(n, width), "bf16x3_presplit")
        return index

    @classmethod
    def _from_int8_state(cls, state, device) -> "NNIndex":
        grid = np.asarray(state["grid"])
        zero = np.ascontiguousarray(state["zero"], np.float32)
        inv_s = np.float32(state["inv_s"])
        if grid.dtype != np.int8 or grid.ndim != 2:
            raise ValueError(f"state['grid'] must be an (n, k) int8 array, got "
                             f"{grid.dtype} {grid.shape}")
        if zero.shape != (grid.shape[1],) or not np.all(np.isfinite(zero)):
            raise ValueError(f"state['zero'] must be ({grid.shape[1]},) finite f32")
        if not (np.isfinite(inv_s) and inv_s > 0):
            raise ValueError(f"state['inv_s'] must be a positive finite f32, got {inv_s}")
        return cls._from_int8_grid(grid, zero, inv_s, state.get("precision"), device=device)

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
            tensors[0], ints[0], ints[1], tensors[1], tensors[2], ints[2], tensors[3]),
            _resolve_precision(state.get("precision"), k, n, "float32"))
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
        (kernels/topk.py). A metric index returns the metric's score in
        the second slot (cosine similarity, or the exact f32 q·r;
        descending)."""
        if self.mutable and self.n_live < 1:
            raise ValueError("index has no live points")
        if self.strategy == "kdtree":
            search = self._kdtree_queries(search)
            return (self._kdtree_query(search) if neighbors is None
                    else self._kdtree_topk(search, neighbors))
        search = self._user_queries(search)
        if neighbors is not None:
            idx, d2 = self._query_topk(search, neighbors)
            return self._metric_scores(search, idx, d2)
        m = search.shape[0]
        mb = self._m_bucket(m) if self.bucket_m else m
        if mb != m:
            # Edge padding: duplicate real queries so padded rows behave
            # like in-distribution work.
            search = torch.cat([search, search[-1:].expand(mb - m, self.k)])
        idx, d2 = self._query_padded(search, m)
        idx, d2 = idx[:m], d2[:m]
        if self.store == "int8":
            d2 = d2 * self._i8_s2   # back to user units (monotone)
        return self._metric_scores(search[:m], idx, d2)

    def pipeline(self, m: int):
        """Return (run, ops) for the prepared fused query pipeline at batch
        size ``m`` (strategies "fused" and "auto"): ``run(search, *ops) ->
        (idx, d2)`` with ``ops`` the device-resident prepared operands
        (for store="int8" the grid, with the grid transform and the d2
        rescale inside run). Queries are in the space the engines search
        (a metric index's transformed queries). The projection strategy
        has no single pipeline and raises."""
        from tpu_knn_torch.kernels.smallm import (
            aos_scan_applicable, smallm_applicable,
        )

        if self.strategy == "sharded":
            return self._sharded_pipeline(m)
        if self.strategy not in ("fused", "auto"):
            raise ValueError(f"pipeline() requires the fused/auto/sharded strategy, "
                             f"not {self.strategy!r}")
        if self.store == "int8":
            return self._i8_run, (self.ref_dev,)
        n = self._n_eff
        aos_ok = getattr(self, "_aos_selfmasked", True)
        if (smallm_applicable(m, self.k, n)
                or (aos_ok and aos_scan_applicable(m, self.k, n))) and len(self.r_ops) == 1:
            return (_build_smallm_prepared(m, n, self.k, aos_ok=aos_ok),
                    (self.r_ops, self.ref_dev))
        run = _build_prepared_query(m, n, self.k, self.precision)
        return run, (self.r_ops, self.ref_dev)

    def _query_padded(self, search, m_true: int):
        from tpu_knn_torch.kernels.dense import _dense, dense_applicable
        from tpu_knn_torch.kernels.smallm import (
            aos_scan_applicable, smallm_applicable,
        )

        m = search.shape[0]
        n = self._n_eff
        if self.strategy == "sharded":
            return self._sharded_query(search)
        if self.store == "int8":
            return self._i8_query(search)
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
                # The fallback scan reuses a plain operand; a presplit
                # index's fallback prepares its own.
                idx, d2, certified = run(search, self.ref_dev, *self.proj_index,
                                         r_op=self.r_ops[0] if len(self.r_ops) == 1 else None)
                self._note_projection_batch(certified)
                return idx, d2
            self.last_strategy = "fused"
        aos_ok = getattr(self, "_aos_selfmasked", True)
        if (smallm_applicable(m, self.k, n)
                or (aos_ok and aos_scan_applicable(m, self.k, n))) and len(self.r_ops) == 1:
            # The small-m kernel serves tiny batches off the very same SoA
            # operand (still the "fused" strategy — a kernel choice). A
            # presplit index keeps B12 at every m (tpu_knn's
            # len(r_ops) == 1 condition, index.py:1740-1742); a filtered
            # view keeps its masked operand (aos_ok False).
            run = _build_smallm_prepared(m, n, self.k, aos_ok=aos_ok)
            return run(search, self.r_ops, self.ref_dev)
        if dense_applicable(m, self.k, n) and aos_ok:
            # Small reference sets skip the streaming pipeline (PAD slots
            # score +inf there too); a view's shared AoS copy is unmasked.
            return _dense(search, self.ref_dev)
        run = _build_prepared_query(m, n, self.k, self.precision)
        return run(search, self.r_ops, self.ref_dev)

    # ---- top-K and radius queries ------------------------------------

    def query_radius(self, search, radius: float, max_results: int | None = None):
        """Exact fixed-radius neighbors (static output shape — see
        kernels/topk.py:within_radius). Returns (idx (m, cap), d2 (m, cap),
        count (m,)): rows ascending by exact (d2, index), padded -1/+inf.

        max_results=<int>: single shot with that cap (count < max_results
        certifies completeness; a cap beyond n_live is clamped and the
        output padded back). max_results=None: escalate the cap (doubling)
        until no row truncates, returning each query's true in-radius set;
        raises past the engine ceiling (PASSES_MAX_NEIGHBORS).

        metric="cosine": ``radius`` is a minimum similarity in [-1, 1] (the
        L2 threshold over unit vectors is sqrt(2 − 2·s_min)); rows come back
        (idx, similarity, count), similarity descending, padded -1/-inf.
        metric="ip" has no radius analog and raises."""
        from tpu_knn_torch.kernels.topk import _radius_query

        if self.metric == "ip":
            raise ValueError(
                "metric='ip' has no radius-query analog (the inner "
                "product is not a distance); use query(neighbors=K)")
        if self.metric == "cosine":
            if not -1.0 <= radius <= 1.0:
                raise ValueError(
                    "metric='cosine': radius is a minimum similarity in "
                    f"[-1, 1], got {radius}")
            search = self._transform_q(search)
            idx, d2, cnt = _radius_query(
                lambda eff: self._query_topk(search, eff), self.n_live,
                float(np.sqrt(max(2.0 - 2.0 * radius, 0.0))), max_results)
            _, sim = self._metric_scores(search, idx, d2)
            return idx, sim, cnt
        # int8: grid space here; _query_topk reports user-unit d2, so the
        # radius compares in the user's units.
        search = (self._kdtree_queries(search) if self.strategy == "kdtree"
                  else self._user_queries(search))
        return _radius_query(lambda eff: self._query_topk(search, eff),
                             self.n_live, radius, max_results)

    def _query_topk(self, search, neighbors: int):
        """Top-K of a batch in the engines' space (grid space for int8),
        d2 in user units."""
        from tpu_knn_torch.kernels.topk import (
            MAX_NEIGHBORS, _build_aos_topk, _build_topk,
        )

        if self.strategy == "kdtree":
            return self._kdtree_topk(search, neighbors)
        if self.strategy == "sharded":
            return self._sharded_topk(search, neighbors)
        if self.store == "int8":
            return self._i8_query_topk(search, neighbors)
        if self.strategy not in ("fused", "auto") or len(self.r_ops) != 1:
            raise ValueError(
                "neighbors>1 requires the fused/auto/sharded strategy "
                "(prepared SoA operand) or the native kdtree backend; "
                f"this index uses {self.strategy!r}")
        search, m, mb = self._topk_prep_batch(search, neighbors)
        if (mb == 1 and neighbors <= MAX_NEIGHBORS
                and getattr(self, "_aos_selfmasked", True)):
            # m=1 top-K: the zero-prep AoS cell engine over the resident
            # ref (tpu_knn's measured choice; PAD slots score +inf); m >= 2
            # keeps the prepared one-scan engines, over the store's own
            # operand (bf16 for a bf16 store: the kernels' bf16 instances).
            idx, d2 = _build_aos_topk(mb, self._n_eff, self.k, neighbors)(
                search, self.ref_dev)
            return idx[:m], d2[:m]
        # The engines' kernels at the index's tier, as tpu_knn passes it.
        run = _build_topk(mb, self._n_eff, self.k, neighbors, self.r_ops[0].shape[1],
                          precision=self.precision)
        idx, d2 = run(search, self.r_ops, self.ref_dev)
        return idx[:m], d2[:m]

    def _topk_prep_batch(self, search, neighbors: int):
        """Shared top-K entry: validate the K cap (n_live: a mutable index's
        live points, a view's kept ones) and bucket+edge-pad m. Returns
        (search (mb, k) f32, m, mb)."""
        from tpu_knn_torch.kernels.topk import PASSES_MAX_NEIGHBORS

        cap = min(self.n_live, PASSES_MAX_NEIGHBORS)
        if not (1 <= neighbors <= cap):
            raise ValueError(
                f"neighbors must be in [1, min(n_live, "
                f"{PASSES_MAX_NEIGHBORS})] = [1, {cap}], got {neighbors}")
        m = search.shape[0]
        mb = self._m_bucket(m) if self.bucket_m else m
        if mb != m:
            search = torch.cat([search, search[-1:].expand(mb - m, self.k)])
        return search, m, mb

    def _i8_query_topk(self, search, neighbors: int):
        """int8 top-K of a grid-space batch, d2 in user units (tpu_knn's
        `_i8_query_topk`): m = 1 the AoS engine straight off the int8 grid,
        m >= 2 the prepared engines over the per-call bf16 grid operand
        (grid integers are exact in bf16, so every route reports the same
        grid-space geometry)."""
        from tpu_knn_torch.kernels.topk import (
            MAX_NEIGHBORS, _build_aos_topk, _build_topk,
        )

        search, m, mb = self._topk_prep_batch(search, neighbors)
        if mb == 1 and neighbors <= MAX_NEIGHBORS:
            idx, d2 = _build_aos_topk(mb, self.n, self.k, neighbors)(search, self.ref_dev)
        else:
            # The top-K engines take the plain operand whatever the 1-NN
            # tier (tpu_knn handed them B12's three and failed at m >= 2),
            # at the index's tier, or at "highest" beside the presplit tier,
            # which has no top-K instance.
            ops = self._i8_soa()
            tier = "highest" if self.precision == "bf16x3_presplit" else self.precision
            run = _build_topk(mb, self.n, self.k, neighbors, ops[0].shape[1], precision=tier)
            idx, d2 = run(search, ops, self.ref_dev)
        return idx[:m], d2[:m] * self._i8_s2

    # ---- checkpoint / resume ------------------------------------------
    #
    # tpu_knn's .npz files, key for key (index.py:1134-1284): always
    # strategy, precision, mutable, store and metric (ip_m2 for "ip");
    # ref, the stored points (a bf16 store's as their uint16 bits, a metric
    # index's transformed, a mutable index's first _n_slots slots with
    # live); the int8 grid with i8_zero and i8_inv_s; the kdtree with p,
    # dim and split_val. load() rebuilds the operands from the points, so a
    # file crosses between the two packages either way.

    def save(self, path) -> None:
        """Write the index to ``path`` (NumPy adds .npz). A filtered view
        raises: it is ephemeral."""
        if getattr(self, "_view_live", None) is not None:
            raise ValueError("filtered views are ephemeral; save the "
                             "parent index and the mask")
        meta = dict(strategy=self.strategy, precision=self.precision, mutable=self.mutable,
                    store=self.store, metric=self.metric)
        if self.metric == "ip":
            meta["ip_m2"] = self._ip_m2
        if self.strategy == "kdtree":
            np.savez_compressed(path, ref=self.ref, p=self.tree.p, dim=self.tree.dim,
                                split_val=self.tree.split_val, **meta)
            return
        src = self.ref_dev
        if self.strategy == "sharded":
            # The mesh's shape (load rebinds it); the payload gathered once,
            # its padding rows left out.
            meta["mesh_axes"] = np.asarray(self.mesh.axis_names)
            meta["mesh_sizes"] = np.asarray([self.mesh.shape[a] for a in self.mesh.axis_names],
                                            np.int64)
            src = self.r_sharded.gather()
        if self.store == "int8":
            np.savez_compressed(path, ref=_host(src[: self.n]), i8_zero=self._i8_zero,
                                i8_inv_s=self._i8_inv_s, **meta)
            return
        if self.mutable:
            np.savez_compressed(path, ref=_host(src[: self._n_slots]),
                                live=self._live[: self._n_slots], **meta)
            return
        np.savez_compressed(path, ref=_host(src[: self.n]), **meta)

    @classmethod
    def load(cls, path, mesh=None, device="cuda") -> "NNIndex":
        """Restore a saved index (the port's or tpu_knn's file) on
        ``device``: the operands are rebuilt from the saved points (a
        projection index re-sorted, "auto" probed again), a metric index's
        points taken as transformed, a mutable index's ids and removed
        slots kept, a kdtree's saved arrays taken without a rebuild (kdt2
        is rebuilt at the first query). A bf16 or int8 index whose tier is
        "qsplit2" loads (tpu_knn's load raises on it). A sharded index
        loads over ``mesh``, by default the saved mesh's shape rebound to
        this process's devices (_rebind_mesh: ``device``'s cards, or
        logical shards on the CPU); ``mesh`` is ignored for the other
        strategies, as in tpu_knn."""
        with np.load(path) as z:
            strategy, precision = str(z["strategy"]), str(z["precision"])
            mutable = bool(z["mutable"])
            store = str(z["store"]) if "store" in z else "float32"
            metric = str(z["metric"]) if "metric" in z else "l2"
            if strategy != "sharded":
                mesh = None
            elif mesh is None:
                mesh = cls._rebind_mesh(z["mesh_axes"], z["mesh_sizes"], device)
            ref = z["ref"]
            if store == "int8":
                return cls._from_int8_grid(ref, np.asarray(z["i8_zero"], np.float32),
                                           np.float32(z["i8_inv_s"]), precision,
                                           strategy=strategy, device=device, mesh=mesh)
            if strategy == "kdtree":
                from tpu_knn_torch.kdtree.build import KDTree

                ix = cls.__new__(cls)
                ref = np.ascontiguousarray(ref, np.float32)
                ix._init_kdtree(ref, precision, device, tree=KDTree(
                    ref=ref, p=z["p"], dim=z["dim"], split_val=z["split_val"]))
                return ix
            if store == "bf16":
                ref = _bf16_tensor(np.ascontiguousarray(ref).view(np.int16),
                                   "cpu" if mesh is not None else device)
            live = np.asarray(z["live"], bool) if mutable else None
            ip_m2 = float(z["ip_m2"]) if metric == "ip" else None
        n, k = ref.shape
        if store == "bf16" and precision == _resolve_precision(None, k, n, store):
            # tpu_knn's own tier for the store ("qsplit2" above k = 32),
            # which the constructor refuses as an explicit precision.
            precision = None
        ix = cls(ref, strategy=strategy, mesh=mesh, precision=precision, mutable=mutable,
                 store=store, metric=metric, device=device, _pretransformed=metric != "l2")
        if mutable:
            # The saved slots hold PAD_VALUE where removed; their ids stay.
            ix.remove(np.flatnonzero(~live))
        if metric == "ip":
            ix._ip_m2 = ip_m2
        return ix
