"""v4 — the fused streaming 1-NN pipeline (counterpart of tpu_knn/kernels/fused.py).

The candidate stage is B1, a hand-written CUDA kernel (csrc/fused_kernels.cu,
replacing tpu_knn's Pallas `_fused_kernel`; register-tiled scores over a
cp.async-staged operand, its launch geometry from
tuning.tiled_geometry): per query row it folds the
score s = ‖r‖² − 2·q·r of every reference column into per-lane running
(min score, index) pairs, so the m×n score matrix never reaches device
memory, and emits (m, P·128) candidates. The exact selection (`_refine`:
top-T pre-selection under a certified score-magnitude cutoff, then an
exact diff-form rerank with the lowest-index tie rule) is plain torch, as
it was plain XLA in tpu_knn. B4 (`banded_candidates`, replacing
`_fused_banded_kernel`) is B1 with a per-row lexicographic bound, one
pass of the top-K passes engine (kernels/topk.py); B3
(`minima_candidates`, replacing `_fused_minima_kernel`) is B1 with a
value-only lane fold, the seeded engine's bound pass (kernels/seeded.py).
Two ladder rungs are B1's kernel under the tiled template's other operand
policies, with bit-identical scores: v3 (`aos_candidates`) reads the
caller's (n, k) array, its copies transposing each chunk on the way in,
instead of the SoA relayout, and v6 (`const_query_candidates`) keeps each
block's query rows resident in shared memory for the whole sweep. B1, B4
and B3 also take a bf16 store's operand (r_op bf16): their bf16 instances,
the tiled template's BF16 policy, which stages the operand as stored and
upcasts each value at the read, so their outputs are the f32 instances'
bit for bit over the upcast operand (no per-call f32 copy of the store);
a wrapper counts those launches in its `.bf16_launches`.

Precision: B1, B4 and B3 here compute in plain f32 FMA on the CUDA cores,
the "highest" tier. tpu_knn's bf16-split tiers (packed, bf16x3, bf16x4,
qsplit2, default/bf16_raw) and B12 (bf16x3 over pre-split operands) run on
the tensor cores (kernels/tiers.py, csrc/tensor_mainloop.cuh): B1's in
csrc/tensor_kernels.cu, B4's and B3's (`precision=` of banded_candidates
and minima_candidates) in csrc/tensor_banded_kernels.cu and
tensor_minima_kernels.cu, v3's and v6's (`precision=` of aos_candidates
and const_query_candidates) in csrc/tensor_ladder_kernels.cu. `fused_knn`
(v4, and v3 with soa=False) and `const_query_knn` (v6) resolve
`precision=None` through `auto_precision`, as tpu_knn does; the tier
policy (`auto_precision`, `_packed_terms`, `select_cutoff`) is carried
across unchanged so that routing cannot drift from tpu_knn's.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from tpu_knn_torch.engine.registry import register_version
from tpu_knn_torch.kernels.tuning import LANE, resident_geometry, tiled_geometry
from tpu_knn_torch.utils.platform import as_f32_pair, check_device, launch_stream
from tpu_knn_torch.utils.shapes import cdiv, round_up

#: The candidate kernels' default tier: tpu_knn's "highest" (B1's f32
#: arithmetic on the CUDA cores).
DEFAULT_PRECISION = "highest"

#: The tiers tpu_knn's fused path computes (`_qr_dot`'s branches and the
#: presplit builder); every other name raises ValueError.
PORTED_PRECISIONS = frozenset({"packed", "bf16x3", "bf16x3_presplit", "bf16x4", "qsplit2",
                               "highest", "default", "bf16_raw"})

_I32_MAX = 2**31 - 1


def _packed_terms(k_pad: int):
    """Choose the packed-contraction term list for k_pad contraction rows
    (tpu_knn's policy, verbatim). Returns (n_splits, term_pairs)."""
    if 9 * k_pad <= 128:
        # full 3x3: near-exact (~2^-26 relative)
        return 3, [(i, j) for i in range(3) for j in range(3)]
    if 8 * k_pad <= 128:
        # 3-split, drop lo·lo (~2^-34 relative — still effectively exact)
        return 3, [(i, j) for i in range(3) for j in range(3)
                   if not (i == 2 and j == 2)]
    if 4 * k_pad <= 128:
        # 2x2: bf16x4 quality (~2^-17 representation error)
        return 2, [(i, j) for i in range(2) for j in range(2)]
    return 0, []  # does not fit — caller falls back to multi-pass


def auto_precision(k: int, n: int) -> str:
    """tpu_knn's precision tier for the score matmul, verbatim (the ±1e-3
    gate tightens as n grows and k falls; see tpu_knn.kernels.fused)."""
    log2n = math.log2(max(n, 2))
    if 4 * round_up(k, 8) <= 128:
        return "packed"
    if log2n > 7 * k:
        return "highest"
    if log2n > 5 * k:
        return "bf16x4"
    return "bf16x3"


#: Candidate lanes kept for the exact rerank when the safety certificate
#: holds (see _refine_guarded).
REFINE_TOP_T = 8

#: Score-magnitude cutoff for the top-T pre-selection at the packed
#: 3-split tier (relative score error ~2^-26); other tiers scale it by
#: their error ratio (select_cutoff), so the certified absolute error
#: budget (4096 * 2^-26 = 6e-5) is tier-independent.
SELECT_SCORE_CUTOFF = 4096.0

#: Conservative relative score error per precision tier. "exact" is the
#: diff-form path (smallm), whose error scales with d^2 itself.
_TIER_EPS = {
    "packed3": 2.0 ** -26, "packed2": 2.0 ** -17,
    "bf16x3": 2.0 ** -17, "bf16x3_presplit": 2.0 ** -17,
    "bf16x4": 2.0 ** -17, "highest": 2.0 ** -24, "default": 2.0 ** -8,
    "qsplit2": 2.0 ** -17,
}


def select_cutoff(precision: str, k: int) -> float:
    """Score-magnitude bound under which _refine_guarded's top-T cut is
    certified safe for the given score arithmetic (tpu_knn's rule)."""
    if precision == "exact":
        return float(np.inf)
    if precision == "packed":
        n_splits, _ = _packed_terms(round_up(k, 8))
        precision = "packed3" if n_splits == 3 else (
            "packed2" if n_splits == 2 else "bf16x3")
    eps = _TIER_EPS.get(precision, 2.0 ** -8)
    return SELECT_SCORE_CUTOFF * min(1.0, (2.0 ** -26) / eps)


#: Precision tiers whose selection can miss the true neighbor outright:
#: tpu_knn's bf16_raw, and "default" too in this port (tpu_knn certifies
#: it): its one bf16 pass reads an error of the whole of its 2^-8 gate, and
#: fused_knn at ds11 answered one query of 5 x 1024 outside the ±1e-3
#: contract on an H100 (tier_numerics.py default).
UNCERTIFIED_PRECISIONS = frozenset({"bf16_raw", "default"})


def _check_precision_certified(precision, allow_approximate: bool = False):
    """tpu_knn's certification check (fused.py:932-947), with an unknown
    tier name rejected (tpu_knn computed it as "default")."""
    if precision is not None and precision not in PORTED_PRECISIONS:
        raise ValueError(f"unknown precision={precision!r}; the tiers are "
                         f"{sorted(PORTED_PRECISIONS)}")
    if precision in UNCERTIFIED_PRECISIONS and not allow_approximate:
        raise ValueError(
            f"precision={precision!r} is selection-approximate (can drop "
            "the true neighbor before exact refinement; bf16_raw measured "
            "1/1024 gate errors at k=768 — docs/SERVING.md). Pass "
            "allow_approximate=True to accept results outside the ±1e-3 "
            "contract.")
    if precision == "qsplit2":
        raise ValueError(
            "precision='qsplit2' is the quantized-store tier (requires a "
            "bf16-exact operand); NNIndex(store='bf16'/'int8') selects "
            "it automatically — it cannot serve per-call f32 references")


# ---- operands -------------------------------------------------------

#: The SoA operand types of the tiled kernels (B1, B4, B3, B5, B7): f32, and
#: a bf16 store's bf16 (their bf16 instances, upcast at the read).
SOA_DTYPES = (torch.float32, torch.bfloat16)


def tiled_entry(lib, name: str, r_op: torch.Tensor):
    """The C entry point of a tiled kernel for r_op's type: tk_<name>, or
    its bf16 instance tk_<name>_bf16 (the same arguments)."""
    return getattr(lib, f"tk_{name}_bf16" if r_op.dtype == torch.bfloat16 else f"tk_{name}")


def count_launch(wrapper, r_op: torch.Tensor) -> None:
    """Count one kernel launch of ``wrapper``: in `.bf16_launches` for its
    bf16 instance, else in `.launches`."""
    if r_op.dtype == torch.bfloat16:
        wrapper.bf16_launches += 1
    else:
        wrapper.launches += 1



def prep_soa(ref: torch.Tensor, n_pad: int) -> torch.Tensor:
    """(n, k) points -> the zero-padded (k_pad, n_pad) SoA operand in their
    dtype (f32, or bf16 for a bf16 store), k_pad = round_up(k, 8)
    (tpu_knn's prep_soa layout, so operands carry across verbatim)."""
    n, k = ref.shape
    r_op = torch.zeros((round_up(k, 8), n_pad), dtype=ref.dtype, device=ref.device)
    r_op[:k, :n] = ref.T
    return r_op


def _check_candidate_operands(q, r_op, n: int, parts: int, aos: bool = False,
                              r_dtypes=(torch.float32,)) -> None:
    """Validate a candidate launch: q (m, k) f32 against the SoA operand
    (>= k rows, >= n columns, one of ``r_dtypes``), or with ``aos`` the
    row-major (n, k) points."""
    if q.dtype != torch.float32 or r_op.dtype not in r_dtypes:
        raise TypeError(f"candidate kernels take float32 queries and a "
                        f"{'/'.join(map(str, r_dtypes))} operand")
    if q.dim() != 2 or r_op.dim() != 2:
        raise ValueError("queries must be (m, k) and the operand (k_pad, n_pad)")
    if not (q.is_contiguous() and r_op.is_contiguous()):
        raise ValueError("candidate kernels take contiguous operands")
    if q.device != r_op.device:
        raise ValueError(f"queries on {q.device}, operand on {r_op.device}")
    m, k = q.shape
    rows, cols = r_op.shape[::-1] if aos else r_op.shape
    if m < 1 or not 1 <= k <= rows or (aos and k != rows):
        raise ValueError(f"queries {tuple(q.shape)} do not fit operand "
                         f"{tuple(r_op.shape)}")
    if not 1 <= n <= min(cols, _I32_MAX - LANE):
        raise ValueError(f"n={n} outside the operand's {cols} columns")
    if not 1 <= parts <= cdiv(n, LANE):
        raise ValueError(f"parts={parts} must be in [1, {cdiv(n, LANE)}]")
    check_device(q.device)


def _lane_fold(s: torch.Tensor, parts: int):
    """Plain per-lane fold of an (m, n) score matrix into (m, parts*128)
    candidates — the kernels' contract: partition p holds column groups
    [p*G, (p+1)*G) of 128 (G = ceil(ceil(n/128)/parts)), lane l folds
    columns ≡ l (mod 128) with a strict `<`, i.e. the minimum score and,
    among equal minima, the lowest column; NaN never enters; a lane whose
    scores are all +inf (or that has no column) reports (+inf, I32_MAX)."""
    m, n = s.shape
    gpp = cdiv(cdiv(n, LANE), parts)
    width = parts * gpp * LANE
    s = torch.where(torch.isnan(s), torch.inf, s)
    s = torch.nn.functional.pad(s, (0, width - n), value=torch.inf)
    s = s.view(m, parts, gpp, LANE)
    v = s.min(dim=2).values                                  # (m, P, 128)
    col = torch.arange(width, dtype=torch.int32, device=s.device)
    col = col.view(1, parts, gpp, LANE)
    tie = torch.where(s == v[:, :, None], col, _I32_MAX)
    idx = tie.min(dim=2).values
    idx = torch.where(v < torch.inf, idx, _I32_MAX)
    return idx.reshape(m, parts * LANE), v.reshape(m, parts * LANE)


def norm_scores(q, r_op, n: int):
    """The plain versions' f32 score s = ‖r‖² − 2·(q @ r) over the first n
    columns (m, n). B1, B4 and B5's plain versions share it, as the three
    kernels share one score function, so the top-K engines' plain runs
    compare scores bit for bit as the kernels do. A bf16 operand is upcast
    at the read (exact), as the kernels' bf16 instances upcast it."""
    k = q.shape[1]
    r = r_op[:k, :n].float()
    return (r * r).sum(dim=0) - 2.0 * (q @ r)


def scores(q, r_op, n: int, precision: str = DEFAULT_PRECISION):
    """The plain versions' score at a tier: norm_scores for "highest",
    else tiers.tier_scores (the term list's arithmetic). The top-K kernels'
    plain versions take it, so that at each tier B4's and B5's compare bit
    for bit, as their kernels do."""
    if precision == "highest":
        return norm_scores(q, r_op, n)
    from tpu_knn_torch.kernels.tiers import tier_scores

    return tier_scores(q, r_op, n, precision)


def fused_candidates_plain(q, r_op, n: int, parts: int):
    """B1's plain torch version: norm_scores, then the per-lane fold
    (_lane_fold)."""
    return _lane_fold(norm_scores(q, r_op, n), parts)


def transposed_queries(q: torch.Tensor) -> torch.Tensor:
    """(m, k) queries -> the (k, round_up(m, 4)) transposed copy, rows
    m.. zero, that the tiled f32 kernels (B1, B4, B3, B7) stage in 16-byte
    copies."""
    m, k = q.shape
    q_t = q.new_zeros((k, round_up(m, 4)))
    q_t[:, :m] = q.T
    return q_t


def checked_queries_t(q: torch.Tensor, q_t):
    """q_t as a tiled kernel (B1, B4, B3, B7) takes it: transposed_queries(q)
    where q_t is None, else q_t itself if it has that copy's form, or
    ValueError. A caller that launches several of them on the same
    queries makes the copy once and passes it."""
    m, k = q.shape
    if q_t is None:
        return transposed_queries(q)
    if (q_t.dtype != torch.float32 or q_t.shape != (k, round_up(m, 4))
            or not q_t.is_contiguous() or q_t.device != q.device):
        raise ValueError(f"q_t must be transposed_queries(q): a contiguous ({k}, "
                         f"{round_up(m, 4)}) float32 tensor on {q.device}, got "
                         f"{tuple(q_t.shape)} {q_t.dtype} on {q_t.device}")
    return q_t


def _candidate_outputs(m: int, width: int, device):
    return (torch.empty((m, width), dtype=torch.int32, device=device),
            torch.empty((m, width), dtype=torch.float32, device=device))


def fused_candidates(q: torch.Tensor, r_op: torch.Tensor, n: int, parts: int):
    """(m, k) queries x (k_pad, n_pad) SoA operand -> (idx (m, parts*128)
    int32, score (m, parts*128) f32): B1's candidate contract over the
    first n columns (see csrc/fused_kernels.cu). A bf16 operand (a bf16
    store's) takes B1's bf16 instance. CPU tensors take the plain version;
    CUDA tensors launch the kernel or raise."""
    _check_candidate_operands(q, r_op, n, parts, r_dtypes=SOA_DTYPES)
    if q.device.type == "cpu":
        return fused_candidates_plain(q, r_op, n, parts)
    from tpu_knn_torch.csrc.build import check, load

    lib = load()
    m, k = q.shape
    q_t = transposed_queries(q)
    idx, score = _candidate_outputs(m, parts * LANE, q.device)
    with torch.cuda.device(q.device):
        err = tiled_entry(lib, "fused_candidates", r_op)(
            q_t.data_ptr(), r_op.data_ptr(), idx.data_ptr(), score.data_ptr(),
            m, q_t.shape[1], k, r_op.stride(0), n, parts, tiled_geometry(m, k, n).tm,
            launch_stream(q.device))
    check(lib, err, "B1 fused_candidates")
    count_launch(fused_candidates, r_op)
    return idx, score


#: Kernel launches of B1 and of its bf16 instance (CUDA tensors only; the
#: plain version is not counted).
fused_candidates.launches = 0
fused_candidates.bf16_launches = 0


def _check_bound(bound, m: int, dtype, device, what: str) -> None:
    if (bound.dtype != dtype or bound.shape != (m,) or not bound.is_contiguous()
            or bound.device != device):
        raise ValueError(f"{what} must be a contiguous ({m},) {dtype} tensor "
                         f"on {device}, got {tuple(bound.shape)} {bound.dtype} "
                         f"on {bound.device}")


def banded_candidates_plain(q, r_op, n: int, parts: int, bound_s, bound_i,
                            precision: str = DEFAULT_PRECISION):
    """B4's plain torch version at a tier: scores (norm_scores for
    "highest", tier_scores otherwise) with every element whose (score,
    column) is lexicographically <= the row's bound (bound_s[i],
    bound_i[i]) masked to +inf, then the per-lane fold."""
    s = scores(q, r_op, n, precision)
    col = torch.arange(n, dtype=torch.int32, device=s.device)
    bs, bi = bound_s[:, None], bound_i[:, None]
    eligible = (s > bs) | ((s == bs) & (col > bi))
    return _lane_fold(torch.where(eligible, s, torch.inf), parts)


def banded_candidates(q: torch.Tensor, r_op: torch.Tensor, n: int, parts: int,
                      bound_s: torch.Tensor, bound_i: torch.Tensor, q_t=None,
                      precision: str = DEFAULT_PRECISION):
    """B1's candidate contract restricted to the elements that lie
    lexicographically above each row's bound: (score, col) folds only if
    score > bound_s[i], or score == bound_s[i] and col > bound_i[i].
    bound_s (m,) f32 and bound_i (m,) int32. One call is one pass of the
    top-K passes engine (kernels/topk.py), which makes q's transposed copy
    once (`transposed_queries(q)`, passed as q_t) for all its "highest"
    passes; the scores are bit-identical to B1's (and B5's) at the same
    tier on the card. ``precision`` is the score tier: "highest" runs the
    tiled f32 kernel (its bf16 instance over a bf16 operand), any other
    term-list tier B4's tensor-core instance (kernels/tiers.py; q_t unused;
    P as tiers.tensor_topk_parts gives it). CPU tensors take the plain
    version; CUDA tensors launch the kernel or raise."""
    _check_candidate_operands(q, r_op, n, parts, r_dtypes=SOA_DTYPES)
    m, k = q.shape
    _check_bound(bound_s, m, torch.float32, q.device, "bound_s")
    _check_bound(bound_i, m, torch.int32, q.device, "bound_i")
    from tpu_knn_torch.kernels import tiers

    tiers.check_topk_tier(precision)
    if q.device.type == "cpu":
        return banded_candidates_plain(q, r_op, n, parts, bound_s, bound_i, precision)
    if precision != "highest":
        return tiers.banded_tier_launch(q, r_op, n, parts, bound_s, bound_i, precision)
    from tpu_knn_torch.csrc.build import check, load

    lib = load()
    q_t = checked_queries_t(q, q_t)
    idx, score = _candidate_outputs(m, parts * LANE, q.device)
    with torch.cuda.device(q.device):
        err = tiled_entry(lib, "banded_candidates", r_op)(
            q_t.data_ptr(), r_op.data_ptr(), bound_s.data_ptr(), bound_i.data_ptr(),
            idx.data_ptr(), score.data_ptr(), m, q_t.shape[1], k, r_op.stride(0), n, parts,
            tiled_geometry(m, k, n).tm, launch_stream(q.device))
    check(lib, err, "B4 banded_candidates")
    count_launch(banded_candidates, r_op)
    return idx, score


#: Kernel launches of B4 and of its bf16 instance (CUDA tensors only; the
#: plain version is not counted).
banded_candidates.launches = 0
banded_candidates.bf16_launches = 0


def tiled_parts(m: int, k: int, n: int) -> int:
    """B1, B4 and v3's partition count (tuning.tiled_geometry): their
    callers' default P."""
    return tiled_geometry(m, k, n).parts


def banded_parts(precision: str, m: int, k: int, n: int) -> int:
    """B4's partition count at a tier: the tiled kernel's (tiled_parts) for
    "highest", its tensor-core instance's otherwise."""
    if precision == "highest":
        return tiled_parts(m, k, n)
    from tpu_knn_torch.kernels.tiers import tensor_topk_parts

    return tensor_topk_parts("B4", m, n)


# ---- B3: value-only per-lane minima (the seeded engines' bound pass) ----

#: The plain versions of B3 and B7 score the operand in chunks of this
#: many columns, at the same boundaries, so that a column gets the same
#: f32 score from both (and a (m, n) score matrix is never held at once).
SCORE_CHUNK = 1 << 16


def score_chunks(q, r_op, n: int, precision: str = DEFAULT_PRECISION):
    """(first column, (m, width) scores) over [0, n) in SCORE_CHUNK
    pieces: norm_scores' arithmetic, chunk by chunk (a bf16 operand upcast
    a chunk at a time); at a term-list tier tiers.tier_score_chunks'."""
    if precision != "highest":
        from tpu_knn_torch.kernels.tiers import tier_score_chunks

        yield from tier_score_chunks(q, r_op, n, precision)
        return
    k = q.shape[1]
    for c0 in range(0, n, SCORE_CHUNK):
        r = r_op[:k, c0:min(n, c0 + SCORE_CHUNK)].float()
        yield c0, (r * r).sum(dim=0) - 2.0 * (q @ r)


def _lane_groups(s: torch.Tensor) -> torch.Tensor:
    """(m, w) -> (m, ceil(w/128), 128), +inf in the ragged tail."""
    m, w = s.shape
    s = torch.nn.functional.pad(s, (0, round_up(w, LANE) - w), value=torch.inf)
    return s.view(m, -1, LANE)


def minima_candidates_plain(q, r_op, n: int, depth: int = 1, lo=None,
                            n_limit: int | None = None, precision: str = DEFAULT_PRECISION):
    """B3's plain torch version: score_chunks at the tier over the first
    min(n, n_limit) columns, only s > lo[row] where lo is given, NaN
    never entering; per lane (column mod 128) the smallest score, and
    for depth 2 also the second smallest (of the multiset), as
    [min1 lanes | min2 lanes]; +inf where a lane has too few scores."""
    n_eff = n if n_limit is None else min(n, n_limit)
    m = q.shape[0]
    best = torch.full((m, depth, LANE), torch.inf, dtype=torch.float32,
                      device=q.device)
    for c0, s in score_chunks(q, r_op, n, precision):
        if c0 >= n_eff:
            break
        col = c0 + torch.arange(s.shape[1], device=s.device)
        keep = (col < n_eff) & ~torch.isnan(s)
        if lo is not None:
            keep = keep & (s > lo[:, None])
        g = _lane_groups(torch.where(keep, s, torch.inf))
        if depth == 1:
            best = torch.minimum(best, g.min(dim=1, keepdim=True).values)
        else:
            both = torch.cat([best, g], dim=1)
            best = torch.topk(both, 2, dim=1, largest=False).values
    return best.reshape(m, depth * LANE)


def minima_candidates(q: torch.Tensor, r_op: torch.Tensor, n: int,
                      depth: int = 1, lo: torch.Tensor | None = None,
                      n_limit: int | None = None, q_t: torch.Tensor | None = None,
                      precision: str = DEFAULT_PRECISION):
    """(m, k) queries x (k_pad, >= n) SoA operand -> (m, 128*depth) f32:
    the value-only per-lane minima of the tier's scores over the first
    min(n, n_limit) columns (see minima_candidates_plain), optionally
    only the scores above lo (m,) f32. The scores are bit-identical to
    B1's and B7's at the same tier on the card, which the seeded engine's
    bound relies on. q_t: q's transposed copy (checked_queries_t), made
    once by the seeded engine for its "highest" B3 and B7 launches.
    ``precision``: "highest" runs the tiled f32 kernel (its bf16 instance
    over a bf16 operand), any other term-list tier B3's tensor-core
    instance (kernels/tiers.py). CPU tensors take the plain version; CUDA
    tensors launch the kernel or raise."""
    if depth not in (1, 2):
        raise ValueError(f"depth must be 1 or 2, got {depth}")
    n_eff = n if n_limit is None else min(n, n_limit)
    if n_eff < 1:
        raise ValueError(f"n_limit={n_limit} leaves no column")
    _check_candidate_operands(q, r_op, n, 1, r_dtypes=SOA_DTYPES)
    m, k = q.shape
    if lo is not None:
        _check_bound(lo, m, torch.float32, q.device, "lo")
    from tpu_knn_torch.kernels import tiers

    tiers.check_topk_tier(precision)
    if precision != "highest" and depth == 2 and lo is not None:
        raise ValueError("at a term-list tier B3 takes lo at depth 1 only (tpu_knn's banded "
                         "bound pass is depth 1)")
    if q.device.type == "cpu":
        return minima_candidates_plain(q, r_op, n, depth, lo, n_limit, precision)
    if precision != "highest":
        return tiers.minima_tier_launch(q, r_op, n_eff, depth, lo, precision)
    from tpu_knn_torch.csrc.build import check, load

    lib = load()
    q_t = checked_queries_t(q, q_t)
    g = tiled_geometry(m, k, n_eff)      # B1's grid
    partial = torch.empty((m, g.parts * depth * LANE), dtype=torch.float32,
                          device=q.device)
    out = torch.empty((m, depth * LANE), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = tiled_entry(lib, "minima_candidates", r_op)(
            q_t.data_ptr(), r_op.data_ptr(), lo.data_ptr() if lo is not None else None,
            partial.data_ptr(), out.data_ptr(), m, q_t.shape[1], k, r_op.stride(0), n_eff,
            g.parts, g.tm, depth, launch_stream(q.device))
    check(lib, err, "B3 minima_candidates")
    count_launch(minima_candidates, r_op)
    return out


#: Kernel launches of B3 and of its bf16 instance (CUDA tensors only; the
#: plain version is not counted).
minima_candidates.launches = 0
minima_candidates.bf16_launches = 0


# ---- the B1 variants of the ladder: AoS (v3) and resident queries (v6) ----


def aos_candidates_plain(q, ref, n: int, parts: int, precision: str = DEFAULT_PRECISION):
    """The AoS variant's plain version: at "highest" B1's plain version over
    the same points (norm_scores reads the first k rows of any (>= k, >= n)
    array); at a tier tiers.aos_tier_candidates_plain (the AoS term list)."""
    if precision != "highest":
        from tpu_knn_torch.kernels.tiers import aos_tier_candidates_plain

        return aos_tier_candidates_plain(q, ref, n, parts, precision)
    return fused_candidates_plain(q, ref[:n].T, n, parts)


def aos_candidates(q: torch.Tensor, ref: torch.Tensor, n: int, parts: int,
                   precision: str = DEFAULT_PRECISION):
    """(m, k) queries x the caller's row-major (n, k) points -> B1's (idx,
    score) candidates (m, parts*128), with no per-call SoA relayout (v3).
    "highest": B1's tiled kernel at B1's TM (tuning.tiled_geometry), its
    ring's copies reading each chunk's columns from the (n, k) array and
    landing them transposed (csrc/tiled.cuh); the queries from their
    transposed copy, as B1's; its scores bit-identical to B1's on the card.
    Any other term-list tier: v3's tensor-core instance (tiers.aos_tier_launch,
    the AoS term list; P from fused.ladder_parts), whose scores are B1's
    tier's bit for bit where the term lists agree. Any k. CPU tensors take
    the plain version; CUDA tensors launch the kernel or raise."""
    _check_candidate_operands(q, ref, n, parts, aos=True)
    m, k = q.shape
    if precision != "highest":
        from tpu_knn_torch.kernels import tiers

        tiers.ladder_terms(precision, k, aos=True)
    if q.device.type == "cpu":
        return aos_candidates_plain(q, ref, n, parts, precision)
    if precision != "highest":
        return tiers.aos_tier_launch(q, ref, n, parts, precision)
    from tpu_knn_torch.csrc.build import check, load

    lib = load()
    q_t = transposed_queries(q)
    idx, score = _candidate_outputs(m, parts * LANE, q.device)
    with torch.cuda.device(q.device):
        err = lib.tk_aos_candidates(
            q_t.data_ptr(), ref.data_ptr(), idx.data_ptr(), score.data_ptr(), m, q_t.shape[1],
            k, n, parts, tiled_geometry(m, k, n).tm,
            launch_stream(q.device))
    check(lib, err, "B1 (AoS variant) aos_candidates")
    aos_candidates.launches += 1
    return idx, score


#: Kernel launches of B1's AoS variant at "highest" (CUDA tensors only;
#: its tier instances count in tiers.TIER_LAUNCHES).
aos_candidates.launches = 0

#: The reference v6's guard on its query set, k*m <= 16384 floats (the
#: 64 KB of __constant__ memory it used, core.cu:603-607): what the v6 rung
#: of the ladder means, kept though the port holds the rows in shared
#: memory.
CONST_QUERY_FLOATS = 16384


def const_query_fits(m: int, k: int) -> bool:
    """The reference v6's guard: k*m <= CONST_QUERY_FLOATS."""
    return k * m <= CONST_QUERY_FLOATS


def const_query_candidates(q: torch.Tensor, r_op: torch.Tensor, n: int, parts: int,
                           precision: str = DEFAULT_PRECISION):
    """B1's candidate contract with each block's query rows resident in
    shared memory for the whole sweep (v6). "highest": B1's tiled kernel
    whose ring carries only the operand (csrc/tiled.cuh), at the TM of
    tuning.resident_geometry, the rows copied once per block from the
    transposed queries; scores bit-identical to B1's. Any other term-list
    tier: B1's tier instance with the q parts resident (tiers.resident_tier_launch:
    B1's own launch where a 64-row block's parts fit, else the live rows'
    parts, one block an SM; P from tiers.resident_tier_parts); scores B1's
    tier's bit for bit. The query set must pass the reference's guard
    (const_query_fits). CPU tensors take B1's plain version at the tier;
    CUDA tensors launch the kernel or raise."""
    _check_candidate_operands(q, r_op, n, parts)
    m, k = q.shape
    if not const_query_fits(m, k):
        raise ValueError(f"(m={m}, k={k}) queries exceed v6's {CONST_QUERY_FLOATS}-float "
                         "query set (the reference's guard)")
    if precision != "highest":
        from tpu_knn_torch.kernels import tiers

        tiers.ladder_terms(precision, k)
        if q.device.type == "cpu":
            return tiers.tensor_candidates_plain(q, r_op, n, parts, precision)
        return tiers.resident_tier_launch(q, r_op, n, parts, precision)
    if q.device.type == "cpu":
        return fused_candidates_plain(q, r_op, n, parts)
    from tpu_knn_torch.csrc.build import check, load

    lib = load()
    q_t = transposed_queries(q)
    idx, score = _candidate_outputs(m, parts * LANE, q.device)
    with torch.cuda.device(q.device):
        err = lib.tk_const_query_candidates(
            q_t.data_ptr(), r_op.data_ptr(), idx.data_ptr(), score.data_ptr(), m,
            q_t.shape[1], k, r_op.stride(0), n, parts, resident_geometry(m, k, n).tm,
            launch_stream(q.device))
    check(lib, err, "B1 (resident-query variant) const_query_candidates")
    const_query_candidates.launches += 1
    return idx, score


#: Kernel launches of B1's resident-query variant at "highest" (CUDA
#: tensors only; its tier instances count in tiers.TIER_LAUNCHES).
const_query_candidates.launches = 0


def ladder_parts(rung: str, precision: str, m: int, k: int, n: int) -> int:
    """The default partition count of a ladder rung ("v3", "v5", "v6") at a
    tier: at "highest" its tiled kernel's (v3, v5: B1's tiled_parts; v6:
    tuning.resident_geometry's), else its tensor-core instance's (v3, v5:
    tiers.ladder_tier_parts, their own blocks; v6: tiers.resident_tier_parts)."""
    from tpu_knn_torch.kernels import tiers

    if precision == "highest":
        return resident_geometry(m, k, n).parts if rung == "v6" else tiled_parts(m, k, n)
    if rung == "v6":
        return tiers.resident_tier_parts(precision, m, k, n)
    return tiers.ladder_tier_parts(m, n)


# ---- exact selection ------------------------------------------------


def _exact_rerank(search, src, cand, n_valid, tie_src=None):
    """Exact diff-form selection over a candidate set.

    search: (m, k) queries; src: (N, k) points gathered by `cand` (m, C)
    indices; entries >= n_valid are masked out. Ties on the exact squared
    distance break to the smallest reported index — `cand` itself, or
    `tie_src[cand]` where `tie_src` maps src positions to external ids
    (the projection index's sorted position -> original index) — v0's
    lowest-index semantics (core.cu:50-54). Returns (idx (m,) int32
    reported ids, d2 (m,) f32).
    """
    valid = cand < n_valid
    safe = torch.where(valid, cand, 0)
    pts = src[safe.reshape(-1).long()].reshape(*cand.shape, src.shape[1])
    diff = search[:, None, :] - pts
    d2 = (diff * diff).sum(dim=-1)                   # (m, C) f32 exact-form
    d2 = torch.where(valid, d2, torch.inf)
    t = safe if tie_src is None else tie_src[safe.long()]
    v = d2.min(dim=-1, keepdim=True).values
    tie = torch.where((d2 == v) & valid, t, _I32_MAX)
    idx = tie.min(dim=-1).values.to(torch.int32)     # lowest index among ties
    return idx, v.squeeze(-1)


def _refine_guarded(search, ref, idx, score, n, t: int = REFINE_TOP_T,
                    cutoff: float = SELECT_SCORE_CUTOFF):
    """Top-T pre-selection with a magnitude-certified fast path: keep the
    t lexicographically-(score, index)-smallest candidate lanes per row,
    unless any finite score magnitude exceeds ``cutoff`` — then rerank
    every lane exactly. The certificate costs one host sync (a scalar
    read) where tpu_knn used lax.cond."""
    score = torch.where(torch.isnan(score), torch.inf, score)
    s = score
    picks = []
    for _ in range(t):
        v = s.min(dim=-1, keepdim=True).values
        tie = torch.where(s == v, idx, _I32_MAX)
        pick = tie.min(dim=-1).values
        picks.append(pick)
        s = torch.where(idx == pick[:, None], torch.inf, s)
    sel = torch.stack(picks, dim=-1)
    if not math.isfinite(cutoff):   # exact-score tier: always certified
        return _exact_rerank(search, ref, sel, n)
    finite_mag = torch.where(torch.isfinite(score), score.abs(), 0.0)
    if bool(finite_mag.max() > cutoff):
        return _exact_rerank(search, ref, idx, n)
    return _exact_rerank(search, ref, sel, n)


def _refine(search, ref, cand, n, cutoff: float = SELECT_SCORE_CUTOFF):
    """Exact selection over per-lane candidates (see _exact_rerank).

    `cand` is either (idx, score) — the candidate kernels' contract,
    enabling the certified top-T pre-selection (_refine_guarded) — or a
    bare index tensor (B10, which emits indices only), which reranks every
    lane. ``cutoff`` is the tier-scaled certification bound
    (select_cutoff)."""
    if isinstance(cand, (tuple, list)):
        idx, score = cand
        if idx.shape[-1] > REFINE_TOP_T:
            return _refine_guarded(search, ref, idx, score, n, cutoff=cutoff)
        cand = idx
    return _exact_rerank(search, ref, cand, n)


# ---- per-call entry -------------------------------------------------


def fused_knn(search, ref, *, soa: bool = True, parts: int | None = None,
              precision: str | None = None, allow_approximate: bool = False,
              device="cuda"):
    """Exact 1-NN of (m, k) queries against (n, k) points.

    Returns (indices (m,) int32, exact squared distances (m,) f32) as
    tensors on the inputs' device (see utils/platform.py for the device
    rule). Routing as in tpu_knn: m <= 4 takes the diff-form AoS scan,
    small n the dense path, everything else the candidate kernel of the
    score tier + _refine. ``precision=None`` resolves through
    auto_precision(k, n) ("packed" at k <= 32): the tensor-core tiers of
    kernels/tiers.py, "highest" on B1. An explicit ``parts`` (the kernel's
    n-partition count) or ``precision`` signals measurement intent and
    keeps the candidate path. Selection-approximate tiers (bf16_raw) need
    ``allow_approximate=True``. ``soa=False`` is v3: B1's AoS variant over
    the caller's array (no per-call relayout) at the tier resolved as
    above ("packed" at tpu_knn's unpadded AoS width, `_packed_terms(k)`;
    "bf16x3_presplit" is bf16x3's terms over the array, as tpu_knn's
    `_qr_dot` runs it there), never routed elsewhere, as in tpu_knn.
    """
    _check_precision_certified(precision, allow_approximate)
    search, ref = as_f32_pair(search, ref, device)
    m, k = search.shape
    n = ref.shape[0]
    if not soa:
        if precision is None:
            precision = auto_precision(k, n)
        cand = aos_candidates(search, ref, n, parts or ladder_parts("v3", precision, m, k, n),
                              precision)
        return _refine(search, ref, cand, n, cutoff=select_cutoff(precision, k))
    if parts is None and precision is None:
        from tpu_knn_torch.kernels.smallm import (
            aos_scan_applicable, smallm_applicable, smallm_knn,
        )

        if smallm_applicable(m, k, n) or aos_scan_applicable(m, k, n):
            return smallm_knn(search, ref)
        from tpu_knn_torch.kernels.dense import dense_applicable, dense_knn

        if dense_applicable(m, k, n):
            return dense_knn(search, ref)
    from tpu_knn_torch.kernels.tiers import presplit_ops, refine_candidates, tier_parts

    if precision is None:
        precision = auto_precision(k, n)
    if parts is None:
        parts = tier_parts(precision, m, k, n)
    n_pad = round_up(n, LANE)
    r_ops = (presplit_ops(ref, n_pad) if precision == "bf16x3_presplit"
             else (prep_soa(ref, n_pad),))
    cand = refine_candidates(search, r_ops, n, parts, precision)
    return _refine(search, ref, cand, n, cutoff=select_cutoff(precision, k))


def _to_host(idx) -> np.ndarray:
    return idx.cpu().numpy().astype(np.int32)


def const_query_knn(search, ref, *, precision: str | None = None, device="cuda"):
    """v6: exact 1-NN with each block's query rows resident in shared
    memory for the sweep (const_query_candidates, P from ladder_parts),
    then _refine. ``precision=None`` resolves through auto_precision(k, n),
    as tpu_knn's v6 (fused_knn with tile_m covering m) does, and the tier
    is certified as fused_knn's ("bf16x3_presplit" runs bf16x3's terms
    over the f32 operand). The query set must pass the reference's guard
    (const_query_fits); v6's guard delegates the rest to v4. Returns
    (indices (m,) int32, exact d2 (m,) f32)."""
    _check_precision_certified(precision)
    search, ref = as_f32_pair(search, ref, device)
    m, k = search.shape
    n = ref.shape[0]
    if precision is None:
        precision = auto_precision(k, n)
    cand = const_query_candidates(search, prep_soa(ref, round_up(n, LANE)), n,
                                  ladder_parts("v6", precision, m, k, n), precision)
    return _refine(search, ref, cand, n, cutoff=select_cutoff(precision, k))


def v3_callback(k, m, n, search, ref):
    idx, _ = fused_knn(search, ref, soa=False)
    return _to_host(idx)


def v4_callback(k, m, n, search, ref):
    idx, _ = fused_knn(search, ref)
    return _to_host(idx)


def _v6_guard(k, m, n):
    """v6 runs where the query set passes the reference's own guard (k*m
    <= 16384, const_query_fits); tpu_knn's guard was its 4 MB VMEM query
    block (fused.py:1038-1077, ROADMAP C)."""
    return const_query_fits(m, k)


def v6_callback(k, m, n, search, ref):
    idx, _ = const_query_knn(search, ref)
    return _to_host(idx)


# v3 has no guard: its kernel takes every shape (tpu_knn's guard was a fact
# about the TPU's tiled HBM pages, fused.py:1013-1025, ROADMAP C); the
# fallback is tpu_knn's, kept for the registry's parity.
register_version(
    "v3",
    v3_callback,
    "B1's AoS variant: B1's tiled kernel over the caller's (n, k) array, "
    "each chunk transposed by its copies into shared memory, CUDA (reference "
    "v3, core.cu:231-312)",
    fallback="v4",
)
register_version(
    "v4",
    v4_callback,
    "fused streaming kernel B1 over the SoA (k, n) operand, CUDA "
    "(reference v4, core.cu:313-423)",
)
register_version(
    "v6",
    v6_callback,
    "B1 with each block's query rows resident in shared memory for the "
    "sweep, CUDA (reference v6 constant-memory broadcast, core.cu:530-643)",
    guard=_v6_guard,
    fallback="v4",
)
