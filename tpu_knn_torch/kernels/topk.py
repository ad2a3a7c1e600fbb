"""Exact top-K nearest neighbors (counterpart of tpu_knn/kernels/topk.py).

Rows come back ascending by exact (squared distance, index): v0's tie rule
(core.cu:50-54) extended to K results. The port has three of tpu_knn's
engines:

- "sweep" (auto in the serving regime, m*K <= SWEEP_AUTO_BUDGET and
  K <= SWEEP_MAX_NEIGHBORS): one K-deep sorted list of (score, index) per
  (row, partition) from one reference read, then `_finalize_topk`. For
  m > 4 (or k > 32) that read is B5 (`sweep_candidates`, replacing
  `_sweep_kernel`). For m <= 4 and k <= 32 it is the bound-seeded
  two-pass form: B2 (kernels/smallm.py) gives per-lane minima, the K-th
  smallest of them bounds the row's K-th score, and B6
  (`smallm_topk_candidates`, replacing `_smallm_topk_kernel`) keeps only
  elements at or under that bound. Both kernels select with one shared
  block-wide K-selection (csrc/kselect.cuh; `list_of` is its list map).
- "passes": K lexicographically banded 1-NN sweeps, each one launch of B4
  (kernels/fused.py `banded_candidates`) and a `_lex_min`, with no host
  sync between them. B4 and B5 score with one shared function on the
  card, so the two engines agree exactly.
- "aos": the zero-prep per-call engine for m <= 4 over the caller's (n, k)
  array, torch ops (plain XLA in tpu_knn).
- "seeded" (auto in the batch regime, m*K > 256 or K > 32): the bound
  pass B3, the moment extraction B7, the cell compactor (B8/B9) and an
  exact rerank, with the passes engine as its certified fallback
  (kernels/seeded.py).

Score tiers, as tpu_knn resolves them: `topk_knn` (and `within_radius*`,
`knn_graph` through it) runs at `auto_precision(k, n)` ("packed" at k <=
32, "bf16x3" at embedding width), an `NNIndex` at its `precision`; each
engine hands that tier to every kernel it launches (`_build_topk`,
`_build_topk_percall`, the seeded engines and their passes fallback).
"highest" runs the tiled f32 kernels (B5, B4, B3, B7 on the CUDA cores);
every other term-list tier their tensor-core instances (kernels/tiers.py,
csrc/tensor_mainloop.cuh), which score a (row, column) pair exactly as B1's
tiers do, so at each tier the sweep and passes engines still agree bit for
bit and the seeded engine's bound and qualifiers come from one arithmetic.
B6 (the small-m sweep) and the aos engine score in the exact diff form, at
no tier, as tpu_knn's do. Over a bf16 store's operand every engine launches
the kernels' bf16 instances ("highest": B5, B6, B4, B3 and B7 upcast at
the read, bit for bit the f32 instances over the upcast operand; the
tensor-core instances read the operand as stored), so no top-K path makes
an f32 copy of the store.
"""

from __future__ import annotations

import functools

import torch

from tpu_knn_torch.kernels.fused import (
    _I32_MAX, DEFAULT_PRECISION, SOA_DTYPES, _candidate_outputs, _check_bound,
    _check_candidate_operands, auto_precision, banded_candidates, banded_parts, count_launch,
    prep_soa, scores, tiled_entry, transposed_queries,
)
from tpu_knn_torch.kernels.smallm import (
    SMALLM_MAX_K, SMALLM_MAX_M, bf16_parts, check_smallm_shape, diff_scores,
    operand_parts, smallm_applicable, smallm_candidates,
)
from tpu_knn_torch.kernels.tuning import LANE, pick_parts, pick_tiles, sweep_geometry
from tpu_knn_torch.utils.platform import as_f32_pair, launch_stream
from tpu_knn_torch.utils.shapes import cdiv, round_up

# ---- constants and policy (tpu_knn's, verbatim) -----------------------

#: Largest K served by the default ("auto"/"sweep"-eligible) contract.
MAX_NEIGHBORS = 128

#: Absolute ceiling, served by the K-pass banded engine only.
PASSES_MAX_NEIGHBORS = 512

#: Largest K the single-sweep engine serves.
SWEEP_MAX_NEIGHBORS = 32

#: Largest K the seeded engine serves.
SEEDED_MAX_NEIGHBORS = PASSES_MAX_NEIGHBORS

#: Auto-routing boundary between the sweep and the seeded engine (m*K).
SWEEP_AUTO_BUDGET = 256


def _auto_method(m: int, kk: int) -> str:
    if kk <= SWEEP_MAX_NEIGHBORS and m * kk <= SWEEP_AUTO_BUDGET:
        return "sweep"
    if kk <= SEEDED_MAX_NEIGHBORS:
        return "seeded"
    return "passes"


def _percall_width(m: int, n: int, k: int, kk: int, method: str) -> int:
    """Operand width of a per-call top-K. The seeded engine's cells are a
    function of it, so its operand (which its passes fallback shares) is
    padded to the tile tpu_knn pads to; the sweep and passes engines
    mask columns >= n, so theirs is padded to the lane."""
    resolved = _auto_method(m, kk) if method == "auto" else method
    return round_up(n, pick_tiles(k, m, n)[1] if resolved == "seeded" else LANE)


# ---- launch geometry of B5 and B6 --------------------------------------

#: Resident B6 blocks of 128 threads an SM (csrc smallm_kernels.cu
#: kSmallmTopkBlocksPerSm, its __launch_bounds__): its state is a few KB,
#: so the partition count is set by the loads in flight, as B2's is; at
#: k > 16 its 32 loads a thread in flight need more registers
#: (kSmallmTopkWideBlocksPerSm).
B6_BLOCKS_PER_SM = 8
B6_WIDE_BLOCKS_PER_SM = 6


def sweep_parts(m: int, k: int, n: int, precision: str = DEFAULT_PRECISION) -> int:
    """B5's partition count, one list per (row, partition): the tiled
    kernel's (tuning.sweep_geometry) for "highest", its tensor-core
    instance's (tiers.tensor_topk_parts) at any other tier."""
    if precision != "highest":
        from tpu_knn_torch.kernels.tiers import tensor_topk_parts

        return tensor_topk_parts("B5", m, n)
    return sweep_geometry(m, k, n).parts


def smallm_topk_parts(n: int, k: int) -> int:
    """B6's partition count at (k, n): one wave of the blocks an SM holds
    (B6 is bound by device reads, as B2 is), one list per (row,
    partition)."""
    return pick_parts(1, n, B6_BLOCKS_PER_SM if k <= 16 else B6_WIDE_BLOCKS_PER_SM)


def smallm_topk_operand_parts(r_op: torch.Tensor, n: int, k: int) -> int:
    """P for the B6 instance that serves r_op: B6-bf16's over a bf16
    operand (B2-bf16's blocks, smallm.bf16_parts), B6's otherwise."""
    return bf16_parts(n) if r_op.dtype == torch.bfloat16 else smallm_topk_parts(n, k)


def list_of(col, n: int, parts: int):
    """The list that holds column `col` in B5's and B6's output (csrc
    kselect.cuh list_of): its partition, P partitions of whole 128-column
    groups (G = ceil(ceil(n/128)/P) each). Row slot list*K + l holds level
    l of the list."""
    return col // LANE // cdiv(cdiv(n, LANE), parts)


# ---- lexicographic order ------------------------------------------------
#
# torch has no multi-key sort (jax.lax.sort(num_keys=2)); one int64 key per
# element carries the order: the f32 bits mapped to a signed integer that
# is monotone in the value (NaN last, as in lax.sort), shifted above the
# index. The keys of two entries are equal only if both score and index are.


def _f32_order(x: torch.Tensor) -> torch.Tensor:
    b = x.contiguous().view(torch.int32)
    b = torch.where(b < 0, b ^ 0x7FFFFFFF, b)
    b = torch.where(torch.isnan(x), 0x7FC00000, b)
    return b.to(torch.int64)


def _lex_key(score: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """int64 keys ordered as (score, idx) lexicographically."""
    return (_f32_order(score) << 32) | (idx.to(torch.int64) + 2**31)


def _lex_sort(score, idx):
    """Sort each row (last dim) by (score, idx). Returns (score, idx)."""
    order = torch.sort(_lex_key(score, idx), dim=-1).indices
    return score.gather(-1, order), idx.gather(-1, order)


def _lex_smallest(score, idx, kk: int):
    """The kk lexicographically smallest (score, idx) entries of each row,
    in order (a selection over unique keys, so no tie is left to chance).
    Returns (score, idx)."""
    pos = torch.topk(_lex_key(score, idx), kk, dim=-1, largest=False).indices
    return score.gather(-1, pos), idx.gather(-1, pos)


def _lex_min(idx, score):
    """Per-row lexicographic (score, index) minimum of the candidate set.
    Exact duplicates carry bit-identical scores, so the lowest index among
    tied minima is returned (v0's tie rule at the candidate level)."""
    v = score.min(dim=-1, keepdim=True).values
    tie = torch.where(score == v, idx, _I32_MAX)
    return tie.min(dim=-1).values, v.squeeze(-1)


def _gather_d2(search, ref_aos, sel, n: int):
    """Exact f32 diff-form d2 of the selected rows (+inf where sel >= n)
    and their indices (-1 there)."""
    valid = sel < n
    safe = torch.where(valid, sel, 0).long()
    pts = ref_aos[safe.reshape(-1)].reshape(*sel.shape, ref_aos.shape[1])
    diff = search.reshape(search.shape[0], *([1] * (sel.dim() - 1)),
                          search.shape[1]) - pts
    d2 = torch.where(valid, (diff * diff).sum(dim=-1), torch.inf)
    return torch.where(valid, sel, -1), d2


def _finalize_topk(search, ref_aos, ci, cs, kk: int, n: int):
    """Candidate lists -> exact top-K rows.

    Selection: the kk lex-smallest (kernel score, index) per query (the
    union of the per-partition K-lists always contains the global lex
    top-K: any list holds at most K of them). Reporting: exact f32 diff-form
    distances for the selected rows, sorted by (d2, index)."""
    _, sel = _lex_smallest(cs, ci, kk)
    idx, d2 = _gather_d2(search, ref_aos, sel, n)
    d2, idx = _lex_sort(d2, idx)
    return idx, d2


# ---- B5 and B6 wrappers --------------------------------------------------


def _partition_lists(s: torch.Tensor, parts: int, kk: int, seed=None):
    """Plain per-partition K-lists of an (m, n) score matrix, the kernels'
    contract (list_of): for each row and partition the kk lexicographically
    smallest (score, column) pairs below +inf (NaN never enters), sorted;
    the slots a list does not fill hold (+inf, I32_MAX), or (seed[row],
    I32_MAX) where seed (m,) is given. Output slot p*kk + l of a row."""
    m, n = s.shape
    gpp = cdiv(cdiv(n, LANE), parts)
    width = parts * gpp * LANE
    s = torch.where(s < torch.inf, s, torch.inf)           # NaN -> +inf
    s = torch.nn.functional.pad(s, (0, width - n), value=torch.inf)
    s = s.view(m, parts, gpp * LANE)
    col = torch.arange(width, dtype=torch.int32, device=s.device).view(1, parts, -1)
    col = col.expand(m, parts, gpp * LANE)
    if gpp * LANE < kk:
        s = torch.nn.functional.pad(s, (0, kk - gpp * LANE), value=torch.inf)
        col = torch.nn.functional.pad(col, (0, kk - gpp * LANE), value=_I32_MAX)
    # Columns rise along dim 2, so a stable sort by score is the lex order.
    v, order = torch.sort(s, dim=2, stable=True)
    v = v[:, :, :kk]
    i = torch.gather(col, 2, order[:, :, :kk])
    i = torch.where(v < torch.inf, i, _I32_MAX)
    if seed is not None:
        v = torch.where(i == _I32_MAX, seed[:, None, None], v)
    return i.reshape(m, parts * kk), v.reshape(m, parts * kk)


def sweep_candidates_plain(q, r_op, n: int, parts: int, kk: int,
                           precision: str = DEFAULT_PRECISION):
    """B5's plain torch version: fused.scores at the tier (B4's plain
    version's), then _partition_lists."""
    return _partition_lists(scores(q, r_op, n, precision), parts, kk)


def sweep_candidates(q: torch.Tensor, r_op: torch.Tensor, n: int, parts: int,
                     kk: int, precision: str = DEFAULT_PRECISION):
    """(m, k) queries x (k_pad, n_pad) SoA operand -> (idx, score), each
    (m, parts*kk): per (row, partition) (list_of), the kk lexicographically
    smallest (score, column) pairs of the partition's columns below n,
    sorted, empty slots (+inf, I32_MAX). The score is B1's and B4's at the
    same tier (bit-identical on the card). ``precision``: "highest" runs
    the tiled f32 kernel (its bf16 instance over a bf16 operand), any other
    term-list tier B5's tensor-core instance (kernels/tiers.py; P from
    sweep_parts at the tier). CPU tensors take the plain version; CUDA
    tensors launch the kernel or raise."""
    _check_candidate_operands(q, r_op, n, parts, r_dtypes=SOA_DTYPES)
    if not 1 <= kk <= SWEEP_MAX_NEIGHBORS:
        raise ValueError(f"sweep engine serves K in [1, {SWEEP_MAX_NEIGHBORS}], got {kk}")
    m, k = q.shape
    from tpu_knn_torch.kernels import tiers

    tiers.check_topk_tier(precision)
    if q.device.type == "cpu":
        return sweep_candidates_plain(q, r_op, n, parts, kk, precision)
    if precision != "highest":
        return tiers.sweep_tier_launch(q, r_op, n, parts, kk, precision)
    from tpu_knn_torch.csrc.build import check, load

    lib = load()
    q_t = transposed_queries(q)
    idx, score = _candidate_outputs(m, parts * kk, q.device)
    with torch.cuda.device(q.device):
        err = tiled_entry(lib, "sweep_candidates", r_op)(
            q_t.data_ptr(), r_op.data_ptr(), idx.data_ptr(), score.data_ptr(),
            m, q_t.shape[1], k, r_op.stride(0), n, parts, kk, sweep_geometry(m, k, n).tm,
            launch_stream(q.device))
    check(lib, err, "B5 sweep_candidates")
    count_launch(sweep_candidates, r_op)
    return idx, score


#: Kernel launches of B5 and of its bf16 instance (CUDA tensors only; the
#: plain version is not counted).
sweep_candidates.launches = 0
sweep_candidates.bf16_launches = 0


def smallm_topk_candidates_plain(q, r_op, n: int, parts: int, kk: int, bound):
    """B6's plain torch version: smallm.diff_scores, only the elements
    with score <= the row's bound, _partition_lists seeded (bound,
    I32_MAX)."""
    s = diff_scores(q, r_op, n)
    s = torch.where(s <= bound[:, None], s, torch.inf)
    return _partition_lists(s, parts, kk, seed=bound)


def smallm_topk_candidates(q: torch.Tensor, r_op: torch.Tensor, n: int,
                           parts: int, kk: int, bound: torch.Tensor):
    """(m <= 4, k <= 32) queries x SoA operand, bound (m,) f32 -> (idx,
    score), each (m, parts*kk): per (row, partition) (list_of), the kk
    lexicographically smallest (exact diff-form score, column) pairs with
    score <= bound[row], sorted, the rest of each list the seed
    (bound[row], I32_MAX). CPU tensors take the plain version; CUDA
    tensors launch B6 (B6-bf16 over a bf16 operand) or raise."""
    _check_candidate_operands(q, r_op, n, parts, r_dtypes=SOA_DTYPES)
    m, k = q.shape
    check_smallm_shape(m, k)
    if not 1 <= kk <= SWEEP_MAX_NEIGHBORS:
        raise ValueError(f"sweep engine serves K in [1, {SWEEP_MAX_NEIGHBORS}]")
    _check_bound(bound, m, torch.float32, q.device, "bound")
    if q.device.type == "cpu":
        return smallm_topk_candidates_plain(q, r_op, n, parts, kk, bound)
    from tpu_knn_torch.csrc.build import check, load

    lib = load()
    idx, score = _candidate_outputs(m, parts * kk, q.device)
    with torch.cuda.device(q.device):
        err = tiled_entry(lib, "smallm_topk_candidates", r_op)(
            q.data_ptr(), r_op.data_ptr(), bound.data_ptr(), idx.data_ptr(),
            score.data_ptr(), m, k, r_op.stride(0), n, parts, kk,
            launch_stream(q.device))
    check(lib, err, "B6 smallm_topk_candidates")
    count_launch(smallm_topk_candidates, r_op)
    return idx, score


#: Kernel launches of B6 and of B6-bf16 (CUDA tensors only; the plain
#: version is not counted).
smallm_topk_candidates.launches = 0
smallm_topk_candidates.bf16_launches = 0


# ---- engines ------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _build_topk(m: int, n: int, k: int, kk: int, n_ops: int, method: str = "auto",
                precision: str = DEFAULT_PRECISION):
    """Top-K pipeline against a prepared (k_pad, n_ops) SoA operand plus
    the AoS array for exact distances, its kernels at the score tier
    ``precision`` (tpu_knn's `_build_topk` argument; the small-m sweep's
    B2 and B6 score in the diff form at every tier). The seeded engine's
    cells are a function of the operand width n_ops, as in tpu_knn. Returns
    run(search, r_ops, ref_aos) -> (idx (m, kk) int32, d2 (m, kk) f32)."""
    if n_ops < n or n_ops % LANE != 0:
        raise ValueError(f"operand width {n_ops} incompatible with n={n}")
    from tpu_knn_torch.kernels.tiers import check_topk_tier

    check_topk_tier(precision)
    if method == "auto":
        method = _auto_method(m, kk)
    if method == "sweep":
        if not 1 <= kk <= SWEEP_MAX_NEIGHBORS:
            raise ValueError(
                f"sweep engine serves K in [1, {SWEEP_MAX_NEIGHBORS}]")
        if smallm_applicable(m, k, n):
            # Tiny batches: two diff-form scans. The K-th smallest of B2's
            # lane minima is a provable upper bound B on the row's K-th
            # score (K distinct elements <= B exist), which seeds B6. Over
            # a bf16 operand both are the bf16 instances, at their P.
            def run_smallm(search, r_ops, ref_aos):
                r_op = r_ops[0]
                _, cs1 = smallm_candidates(search, r_op, n, operand_parts(r_op, n))
                bound = torch.topk(cs1, kk, dim=-1, largest=False).values[:, -1]
                ci, cs = smallm_topk_candidates(search, r_op, n,
                                                smallm_topk_operand_parts(r_op, n, k), kk,
                                                bound.contiguous())
                return _finalize_topk(search, ref_aos, ci, cs, kk, n)

            return run_smallm
        parts = sweep_parts(m, k, n, precision)

        def run_sweep(search, r_ops, ref_aos):
            ci, cs = sweep_candidates(search, r_ops[0], n, parts, kk, precision)
            return _finalize_topk(search, ref_aos, ci, cs, kk, n)

        return run_sweep
    if method == "seeded":
        from tpu_knn_torch.kernels.seeded import _build_seeded

        return _build_seeded(m, n, k, kk, n_ops, precision)
    if method != "passes":
        raise ValueError(f"unknown top-K method {method!r}")
    parts = banded_parts(precision, m, k, n)

    def run_passes(search, r_ops, ref_aos):
        b_s = torch.full((m,), -torch.inf, dtype=torch.float32, device=search.device)
        b_i = torch.full((m,), -1, dtype=torch.int32, device=search.device)
        q_t = transposed_queries(search) if search.is_cuda and precision == "highest" else None
        picks = []
        for _ in range(kk):    # K banded passes, no host sync between them
            ci, cs = banded_candidates(search, r_ops[0], n, parts, b_s, b_i, q_t, precision)
            b_i, b_s = _lex_min(ci, cs)
            picks.append(b_i)
        # Pass order is the kernel-score order; the output contract is
        # exact (d2, index) ascending. The d2 are computed as
        # _finalize_topk computes them, so the engines agree bit for bit.
        idx, d2 = _gather_d2(search, ref_aos, torch.stack(picks, dim=1), n)
        d2, idx = _lex_sort(d2, idx)
        return idx, d2

    return run_passes


#: Cell width of the aos engine's bound and compaction.
AOS_CELL = 4096


@functools.lru_cache(maxsize=None)
def _build_aos_topk(m: int, n: int, k: int, kk: int, masked: bool = False):
    """Zero-prep per-call top-K for m <= 4 over the caller's (n, k) array
    (tpu_knn's `_build_aos_topk`, torch ops): per query row, the diff-form
    score vector; the K-th smallest of the per-cell minima (cells of 4096
    scores) bounds the K-th score; cells holding any score <= the bound are
    compacted (at most K + 16 of them) and their scores sorted by exact
    (d2, index). More qualifying cells than that (only dense near-duplicate
    clusters) take the certified fallback, an exact lexicographic top-K of
    the whole row, which breaks ties toward the lower index. Where tpu_knn
    chose with lax.cond, the port reads one flag on the host per call.

    masked=True (tpu_knn's) adds a ``live`` argument to run: rows at index
    >= live score +inf, for an operand whose padding rows cannot hold +inf
    (an int8 grid shard's). A row selected anyway (live < K) comes back
    with d2 = +inf (index -1 from the cells, its own from the fallback):
    callers treat +inf rows as dead."""
    C = AOS_CELL
    n_pad = round_up(n, C)
    ncell = n_pad // C
    cap_c = int(min(ncell, kk + 16))

    def cell_stage(sp, cell_iota, lane_iota):
        spc = sp.view(ncell, C)
        cmin = spc.min(dim=1).values
        bound = torch.sort(cmin).values[min(kk, ncell) - 1]
        qual = (spc <= bound).any(dim=1)
        key = torch.where(qual, cell_iota, ncell)
        cellids = torch.sort(key).values[:cap_c]
        live = cellids < ncell
        safe = torch.where(live, cellids, 0)
        rows = torch.where(live[:, None], spc[safe.long()], torch.inf)
        gidx = (safe[:, None] * C + lane_iota).reshape(-1)
        flat_d = rows.reshape(-1)
        flat_i = torch.where((flat_d != torch.inf) & (gidx < n), gidx, _I32_MAX)
        ds, isrt = _lex_sort(flat_d, flat_i)
        return (torch.where(isrt[:kk] != _I32_MAX, isrt[:kk], -1), ds[:kk],
                qual.sum())

    def run(search, ref, live: int | None = None):
        if masked != (live is not None):
            raise ValueError("a masked engine takes live=, an unmasked one does not")
        dev = ref.device
        cell_iota = torch.arange(ncell, dtype=torch.int32, device=dev)
        lane_iota = torch.arange(C, dtype=torch.int32, device=dev)
        rows_i, rows_d, nqual, sps = [], [], [], []
        for r in range(m):
            s = ((ref - search[r]) ** 2).sum(dim=-1)
            if masked:
                s[live:] = torch.inf
            sp = torch.nn.functional.pad(s, (0, n_pad - n), value=torch.inf)
            ri, rd, nq = cell_stage(sp, cell_iota, lane_iota)
            rows_i.append(ri)
            rows_d.append(rd)
            nqual.append(nq)
            sps.append(sp)
        idx, d2 = torch.stack(rows_i), torch.stack(rows_d)
        over = torch.stack(nqual) > cap_c
        if bool(over.any()):     # the certificate: one host read per call
            sp = torch.stack(sps)
            col = torch.arange(n_pad, dtype=torch.int32, device=dev)
            fd, fi = _lex_smallest(sp, col.expand(m, n_pad), kk)
            idx = torch.where(over[:, None], fi, idx)
            d2 = torch.where(over[:, None], fd, d2)
        return idx, d2

    return run


@functools.lru_cache(maxsize=None)
def _build_topk_percall(m: int, n: int, k: int, kk: int, method: str = "auto",
                        precision: str = DEFAULT_PRECISION):
    if method == "aos" or (
            method == "auto" and kk <= MAX_NEIGHBORS
            and (m <= 2 or (m <= SMALLM_MAX_M
                            and (k < 8 or k > SMALLM_MAX_K)))):
        if not (1 <= m <= SMALLM_MAX_M):
            raise ValueError(
                f"aos top-K serves 1 <= m <= {SMALLM_MAX_M}, got {m}")
        if kk > MAX_NEIGHBORS:
            raise ValueError(
                f"aos top-K serves K <= {MAX_NEIGHBORS}, got {kk}")
        return _build_aos_topk(m, n, k, kk)
    n_ops = _percall_width(m, n, k, kk, method)
    run = _build_topk(m, n, k, kk, n_ops, method, precision)

    def go(search, ref):
        return run(search, (prep_soa(ref, n_ops),), ref)

    return go


def topk_knn(search, ref, neighbors: int, method: str = "auto", device="cuda"):
    """Exact K-nearest-neighbors: (m, k) queries against (n, k) refs.

    Returns (idx (m, K) int32, d2 (m, K) f32) tensors on the inputs'
    device, each row ascending by exact (squared distance, index).
    Requires neighbors <= n. The engines' kernels score at
    auto_precision(k, n), tpu_knn's tier. `method` selects the engine:
    "aos" (zero-prep scan, m <= 4 and K <= 128 — the per-call default in
    that regime),
    "sweep" (one reference read, K <= SWEEP_MAX_NEIGHBORS), "passes" (K
    banded reads, K <= PASSES_MAX_NEIGHBORS), "seeded" (the extraction
    engine — single-round to K = 64, score-band rounds at ~2 reads per 64
    results beyond, to K <= PASSES_MAX_NEIGHBORS), or "auto" (tpu_knn's
    routing; the passes engine remains every tier's certified fallback
    and the radius-escalation workhorse).
    """
    search, ref = as_f32_pair(search, ref, device)
    m, k = search.shape
    n = ref.shape[0]
    if not (1 <= neighbors <= min(n, PASSES_MAX_NEIGHBORS)):
        raise ValueError(
            f"neighbors must be in [1, min(n, {PASSES_MAX_NEIGHBORS})] = "
            f"[1, {min(n, PASSES_MAX_NEIGHBORS)}], got {neighbors}")
    if method == "sweep" and neighbors > SWEEP_MAX_NEIGHBORS:
        raise ValueError(
            f"sweep engine serves K <= {SWEEP_MAX_NEIGHBORS}, got {neighbors}")
    if (method not in ("passes", "seeded", "auto")
            and neighbors > MAX_NEIGHBORS):
        raise ValueError(
            f"K > {MAX_NEIGHBORS} requires method='seeded' or 'passes', "
            f"got {method!r} with K={neighbors}")
    return _build_topk_percall(m, n, k, neighbors, method,
                               auto_precision(k, n))(search, ref)


# ---- fixed-radius queries ----------------------------------------------


def _radius_query(topk_fn, n_live: int, radius: float,
                  max_results, start_cap: int = 32):
    """Shared fixed-radius machinery (tpu_knn's). ``topk_fn(eff_cap) ->
    (idx (m, eff_cap), d2)`` supplies the exact top-K engine (per call or
    prepared index). ``max_results`` int = single shot with that cap
    (clamped to ``n_live``, padded back); None = escalate (doubling) until
    every row's true in-radius set is returned; the loop's one host read
    per step is the largest count. Returns (idx, d2, count); raises past
    min(n_live, PASSES_MAX_NEIGHBORS)."""
    if not float(radius) >= 0.0:   # also rejects NaN
        raise ValueError(f"radius must be non-negative, got {radius}")
    limit = min(n_live, PASSES_MAX_NEIGHBORS)
    r2 = float(radius) ** 2

    def one_shot(cap):
        eff = min(cap, n_live)
        if eff > limit:
            raise ValueError(
                f"max_results={cap} exceeds the radius-query engine "
                f"ceiling min(n, {PASSES_MAX_NEIGHBORS}); shrink the cap "
                "or partition the reference set")
        idx, d2 = topk_fn(eff)
        inside = d2 <= r2
        idx = torch.where(inside, idx, -1)
        d2 = torch.where(inside, d2, torch.inf)
        if eff < cap:   # cap clamped to n_live: pad back to the requested width
            idx = torch.nn.functional.pad(idx, (0, cap - eff), value=-1)
            d2 = torch.nn.functional.pad(d2, (0, cap - eff), value=torch.inf)
        return idx, d2, inside.sum(dim=-1).to(torch.int32)

    if max_results is not None:
        if max_results < 1:
            raise ValueError(
                f"max_results must be >= 1, got {max_results}")
        return one_shot(max_results)
    cap = min(max(1, start_cap), limit)
    while True:
        idx, d2, count = one_shot(cap)
        if cap >= n_live:   # every point examined: complete
            return idx, d2, count
        if (int(count.max()) if count.numel() else 0) < cap:
            return idx, d2, count
        if cap >= limit:
            raise ValueError(
                f"radius {radius} captures >= {limit} neighbors for "
                f"some query — beyond the engine ceiling min(n, "
                f"{PASSES_MAX_NEIGHBORS}); shrink the radius or "
                "partition the reference set")
        cap = min(cap * 2, limit)


def within_radius(search, ref, radius: float, max_results: int,
                  method: str = "auto", device="cuda"):
    """Exact fixed-radius neighbors, capped at ``max_results`` per query.

    Returns (idx (m, max_results) int32, d2 (m, max_results) f32,
    count (m,) int32): per query, the up-to-``max_results`` nearest points
    with exact squared distance <= radius**2, rows ascending by exact
    (d2, index) and padded with idx -1 / d2 +inf; ``count`` is the number
    of returned neighbors (a full row means the cap may have truncated;
    ``within_radius_complete`` escalates the cap until no row does)."""
    search, ref = as_f32_pair(search, ref, device)
    return _radius_query(
        lambda eff: topk_knn(search, ref, eff, method),
        ref.shape[0], radius, max_results)


def within_radius_complete(search, ref, radius: float, *,
                           start_cap: int = 32, method: str = "auto",
                           device="cuda"):
    """Fixed-radius neighbors with no truncation: escalates the result
    cap (doubling) until every row reports fewer neighbors than the cap.
    Returns (idx (m, cap), d2 (m, cap), count (m,)) with ``count`` each
    query's true in-radius count. Raises if the radius captures more than
    min(n, PASSES_MAX_NEIGHBORS) points for some query."""
    search, ref = as_f32_pair(search, ref, device)
    return _radius_query(
        lambda eff: topk_knn(search, ref, eff, method),
        ref.shape[0], radius, None, start_cap=start_cap)
