"""The batch-regime "seeded" top-K engine (counterpart of the seeded parts
of tpu_knn/kernels/topk.py).

Auto-selected at m*K > SWEEP_AUTO_BUDGET or K > SWEEP_MAX_NEIGHBORS. Per
call (or per 1024-row chunk of a larger batch):

1. B3 (`fused.minima_candidates`) folds each row's per-lane score minima
   in one read; the K-th smallest of them, inflated by 2^-20
   (`_inflate_bound`), bounds the row's K-th score (at least K distinct
   elements score at or below it).
2. B7 (`extract_moments`) scores the operand again and emits, per (row,
   cell of 64/128/256 columns), exact integer moments of the set of
   columns scoring <= the bound, packed as tpu_knn packs them.
3. The compactor (`compact_cells`, B8 and B9 in one kernel) gathers each
   row's qualifying cells; `_solve_cells` recovers their column ids from
   the moments (quadratic, or cubic with Newton's identities); the exact
   diff-form (d2, index) rerank selects the K.
4. A certificate (no cell past the solver, every root exact, every row's
   cells within the compaction cap, >= K candidates) decides whether the
   answer stands; otherwise a wider compaction, and then the passes
   engine (K launches of B4), answers. One overflowing cell per row is
   expanded into the rerank whole.

K > 64 (or 64 < K <= 128 with few cells) runs score-band rounds
(`_build_seeded_rounds`). Where tpu_knn chose a tier with lax.cond, the
port reads the certificate on the host, once per decision; `TIERS`
counts which tier answered each call (or chunk).

The constants and the cell policy are tpu_knn's, verbatim: they decide
which cells exist and so which candidates are compacted. The engines take
their caller's score tier (tpu_knn's `precision`) and hand it to B3, B7
and the passes fallback: "highest" runs the tiled f32 kernels, which
choose their own blocks (B3 by tuning.tiled_geometry, B7 by
tuning.moments_geometry; the engine makes the queries' transposed copy
that they stage once per call or chunk), any other term-list tier their
tensor-core instances (kernels/tiers.py). B3 and B7 score a column bit for
bit alike at each tier, which the bound and its 2^-20 inflation rely on.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from tpu_knn_torch.kernels.fused import (
    _I32_MAX, DEFAULT_PRECISION, SOA_DTYPES, _check_bound, _check_candidate_operands,
    _lane_groups, auto_precision, checked_queries_t, count_launch, minima_candidates,
    score_chunks, tiled_entry, transposed_queries,
)
from tpu_knn_torch.kernels.tuning import (
    LANE, OPERAND_TILE_BUDGET, moments_geometry, pick_tiles,
)
from tpu_knn_torch.utils.platform import launch_stream
from tpu_knn_torch.utils.shapes import cdiv, round_up

# ---- constants and policy (tpu_knn's, verbatim) -----------------------

#: Largest K one extraction round serves; K > 64 runs score-band rounds.
SEEDED_ROUND_K = 64

#: Extraction tile widths per mode. On the card they are not launch
#: geometry: through _extract_tile_n and _extract_mode they fix the cell
#: width, and so which candidates are compacted.
EXTRACT_TILE_N_CUBIC = 2048
EXTRACT_TILE_N_HEX = 2048
EXTRACT_TILE_N_QUAD = 8192
EXTRACT_TILE_N_OCT = 4096

#: Batches beyond 2x this many rows split into sub-batches of this size,
#: each an independent pipeline with its own certificate.
SEEDED_CHUNK_ROWS = 1024

#: Moment fields per cell: 4 (cnt, sum l, sum l^2 in two base-256 digits;
#: cells of <= 2 qualifiers solve exactly) or 8 (adds sum l^3; <= 3).
_EXTRACT_FIELDS = 4
_EXTRACT_FIELDS_CUBIC = 8

#: Candidate columns are dense-compacted to this width before the exact
#: rerank wherever the recovery width exceeds it.
RERANK_COMPACT_CAP = 224


def _solvable_for(n_fields: int) -> int:
    """Qualifiers per cell the root recovery solves exactly for a field
    mode: the one source for the overflow flag and the solver."""
    return 2 if n_fields == _EXTRACT_FIELDS else 3


def _extract_mode(tile_n: int, kk: int) -> tuple[int, int]:
    """(cell lane width, field count) of the extraction: tpu_knn's
    policy, verbatim (cells narrow as K grows, so that a cell rarely
    holds more qualifiers than its moments can solve)."""
    if kk > 64:
        return 64, _EXTRACT_FIELDS_CUBIC
    if kk > 32:
        return 128, _EXTRACT_FIELDS_CUBIC
    if kk <= 16 and tile_n <= 2048 and tile_n % 64 == 0:
        return 64, _EXTRACT_FIELDS
    if tile_n % 256 == 0:
        return 256, (_EXTRACT_FIELDS if kk <= 16 else _EXTRACT_FIELDS_CUBIC)
    return 128, (_EXTRACT_FIELDS if kk <= 16 else _EXTRACT_FIELDS_CUBIC)


def _extract_tile_n(n_ops: int, max_tile_n: int, k: int) -> int:
    """Widest 128 * 2^p tile <= max_tile_n dividing the operand width,
    clamped by the operand tile budget at wide k (tpu_knn's rule)."""
    max_tile_n = min(max_tile_n, OPERAND_TILE_BUDGET // round_up(k, 8))
    t = 128
    while t * 2 <= min(max_tile_n, n_ops) and n_ops % (t * 2) == 0:
        t *= 2
    return t


def _moment_weights(tile_n: int, cell: int,
                    n_fields: int = _EXTRACT_FIELDS) -> np.ndarray:
    """tpu_knn's block-diagonal (tile_n, n_fields * tile_n // cell)
    weight matrix (f32 here; every entry is an integer <= 255): input
    lane r, in-cell id l = r % cell, carries the field weights (1, l,
    l^2 >> 8, l^2 & 255[, l^3 >> 16, (l^3 >> 8) & 255, l^3 & 255, 0]) at
    columns field * (tile_n // cell) + r // cell. A 0/1 mask times it
    gives every cell's moments as base-256 digit sums."""
    l = np.arange(tile_n, dtype=np.int64)
    c = l // cell
    li = l % cell
    cols = [np.ones_like(li), li, (li * li) >> 8, (li * li) & 255]
    if n_fields == _EXTRACT_FIELDS_CUBIC:
        cols += [(li ** 3) >> 16, ((li ** 3) >> 8) & 255, (li ** 3) & 255,
                 np.zeros_like(li)]
    elif n_fields != _EXTRACT_FIELDS:
        raise ValueError(f"unsupported field count {n_fields}")
    fields = np.stack(cols, axis=1).astype(np.float32)
    cpt = tile_n // cell
    w = np.zeros((tile_n, n_fields * cpt), np.float32)
    for f in range(n_fields):
        w[l, f * cpt + c] = fields[:, f]
    return w


#: Which tier answered each seeded call (or 1024-row chunk): "fast" (the
#: first compaction certified), "escalated" (a wider compaction did),
#: "fallback" (the passes engine), "expanded" (the answer included one
#: overflowing cell per row, expanded whole; counted beside its tier),
#: "round_escalated" (rounds engine: rounds that took the wider
#: compaction). Nothing resets it but the caller.
TIERS = {"fast": 0, "escalated": 0, "expanded": 0, "fallback": 0,
         "round_escalated": 0}


# ---- B7: per-cell exact moments of the qualifying columns ----------------


def _pack_moments(cnt, e1, p2, solvable: int):
    """tpu_knn's packed payload A = min(cnt, 3) | e1 << 2 | p2 << 12,
    masked to 30 bits, with bit 30 = (cnt > solvable); int64 in, int32
    out (the mask keeps exactly the bits int32 arithmetic would)."""
    packed = torch.clamp(cnt, max=3) | (e1 << 2) | (p2 << 12)
    flag = (cnt > solvable).to(torch.int64)
    return ((packed & 0x3FFFFFFF) | (flag << 30)).to(torch.int32)


#: Columns per weight tile of B7's plain version (a multiple of every
#: cell width, dividing fused.SCORE_CHUNK).
PLAIN_MOMENT_TILE = 1024


def extract_moments_plain(q, r_op, n: int, bound, cell: int, n_fields: int,
                          lo=None, emit_rem: bool = False, precision: str = DEFAULT_PRECISION):
    """B7's plain torch version. A column qualifies for its row if it is
    below n, its score (fused.score_chunks at the tier, B3's plain
    version's) is <= bound[row] and, where
    lo is given, > lo[row]. Per row and cell of `cell` columns (cell c
    holds columns [c*cell, (c+1)*cell), l = column % cell): cnt, e1 =
    sum l, p2 = sum l^2 and p3 = sum l^3 of its qualifiers, as tpu_knn
    computes them: the 0/1 mask times _moment_weights in f32 gives exact
    base-256 digit sums (each below 2^24), combined in integers. Returns
    (A (m, nc) int32[, p3 (m, nc) int32][, rem (m, 128) f32]), nc =
    r_op.shape[1] // cell: A packed by _pack_moments, p3 in the cubic
    mode, rem the per-lane minima of the scores > bound (emit_rem)."""
    m = q.shape[0]
    nc = r_op.shape[1] // cell
    solvable = _solvable_for(n_fields)
    dev = q.device
    t = PLAIN_MOMENT_TILE
    cpt = t // cell
    w = torch.from_numpy(_moment_weights(t, cell, n_fields)).to(dev)
    digits = torch.zeros((n_fields, m, nc), dtype=torch.int64, device=dev)
    rem = torch.full((m, 1, LANE), torch.inf, dtype=torch.float32, device=dev)
    for c0, s in score_chunks(q, r_op, n, precision):
        qual = s <= bound[:, None]
        if lo is not None:
            qual = qual & (s > lo[:, None])
        width = s.shape[1]
        qual = torch.nn.functional.pad(qual, (0, round_up(width, t) - width))
        mo = qual.view(m, -1, t).to(torch.float32) @ w          # (m, tiles, nf*cpt)
        mo = mo.view(m, -1, n_fields, cpt).permute(2, 0, 1, 3).reshape(n_fields, m, -1)
        first = c0 // cell
        take = min(mo.shape[2], nc - first)
        digits[:, :, first:first + take] = mo[:, :, :take].round().to(torch.int64)
        if emit_rem:
            above = torch.where(s > bound[:, None], s, torch.inf)
            rem = torch.minimum(rem, _lane_groups(above).min(dim=1, keepdim=True).values)
    p2 = 256 * digits[2] + digits[3]
    outs = (_pack_moments(digits[0], digits[1], p2, solvable),)
    if n_fields == _EXTRACT_FIELDS_CUBIC:
        outs += ((65536 * digits[4] + 256 * digits[5] + digits[6]).to(torch.int32),)
    if emit_rem:
        outs += (rem.reshape(m, LANE),)
    return outs


def extract_moments(q: torch.Tensor, r_op: torch.Tensor, n: int,
                    bound: torch.Tensor, cell: int, n_fields: int,
                    lo: torch.Tensor | None = None, emit_rem: bool = False,
                    q_t: torch.Tensor | None = None, precision: str = DEFAULT_PRECISION):
    """(m, k) queries x (k_pad, n_ops) SoA operand, bound (m,) f32[, lo
    (m,) f32] -> (A[, p3][, rem]) as in extract_moments_plain, packed
    bit for bit as tpu_knn's extraction kernel packs them. The scores
    are B1's and B3's at the same tier (bit-identical on the card). q_t:
    q's transposed copy (fused.checked_queries_t), made once per call by
    the engine for its "highest" launches. ``precision``: "highest" runs
    the tiled f32 kernel (its bf16 instance over a bf16 operand), any other
    term-list tier B7's tensor-core instance (kernels/tiers.py). CPU
    tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    _check_candidate_operands(q, r_op, n, 1, r_dtypes=SOA_DTYPES)
    m, k = q.shape
    n_ops = r_op.shape[1]
    if cell not in (64, 128, 256) or n_ops % cell:
        raise ValueError(f"cell={cell} must be 64/128/256 and divide the "
                         f"operand width {n_ops}")
    if n_fields not in (_EXTRACT_FIELDS, _EXTRACT_FIELDS_CUBIC):
        raise ValueError(f"unsupported field count {n_fields}")
    if emit_rem and lo is None:
        raise ValueError("emit_rem requires a band (lo)")
    _check_bound(bound, m, torch.float32, q.device, "bound")
    if lo is not None:
        _check_bound(lo, m, torch.float32, q.device, "lo")
    from tpu_knn_torch.kernels import tiers

    tiers.check_topk_tier(precision)
    if q.device.type == "cpu":
        return extract_moments_plain(q, r_op, n, bound, cell, n_fields, lo, emit_rem, precision)
    cubic = n_fields == _EXTRACT_FIELDS_CUBIC
    if precision != "highest":
        a, p3, rem = tiers.moments_tier_launch(q, r_op, n, bound, cell, cubic, lo, emit_rem,
                                               precision)
        return (a,) + ((p3,) if cubic else ()) + ((rem,) if emit_rem else ())
    from tpu_knn_torch.csrc.build import check, load

    lib = load()
    q_t = checked_queries_t(q, q_t)
    nc = n_ops // cell
    g = moments_geometry(m, k, n_ops)
    dev = q.device
    a = torch.empty((m, nc), dtype=torch.int32, device=dev)
    p3 = torch.empty((m, nc), dtype=torch.int32, device=dev) if cubic else None
    rem_part = rem = None
    if emit_rem:
        rem_part = torch.empty((m, g.parts * LANE), dtype=torch.float32, device=dev)
        rem = torch.empty((m, LANE), dtype=torch.float32, device=dev)

    def ptr(t):
        return t.data_ptr() if t is not None else None

    with torch.cuda.device(dev):
        err = tiled_entry(lib, "extract_moments", r_op)(
            q_t.data_ptr(), r_op.data_ptr(), bound.data_ptr(), ptr(lo), a.data_ptr(),
            ptr(p3), ptr(rem_part), ptr(rem), m, q_t.shape[1], k, r_op.stride(0), n, nc,
            cell, int(cubic), g.parts, g.tm, launch_stream(dev))
    check(lib, err, "B7 extract_moments")
    count_launch(extract_moments, r_op)
    return (a,) + ((p3,) if cubic else ()) + ((rem,) if emit_rem else ())


#: Kernel launches of B7 and of its bf16 instance (CUDA tensors only; the
#: plain version is not counted).
extract_moments.launches = 0
extract_moments.bf16_launches = 0


# ---- B8/B9: positional compaction of qualifying cells --------------------


def _check_fields(fields, parts: int, cap: int):
    if len(fields) not in (1, 2):
        raise ValueError(f"the compactor takes 1 or 2 fields, got {len(fields)}")
    f0 = fields[0]
    for f in fields:
        if (f.dtype != torch.int32 or f.dim() != 2 or f.shape != f0.shape
                or not f.is_contiguous() or f.device != f0.device):
            raise ValueError("fields must be contiguous (m, nc) int32 tensors "
                             "of one shape on one device")
    m, nc = f0.shape
    if parts < 1 or nc % parts:
        raise ValueError(f"nc={nc} not divisible by parts={parts}")
    if not 1 <= cap <= nc // parts:
        raise ValueError(f"cap={cap} outside [1, {nc // parts}]")


def compact_cells_plain(fields, parts: int, cap: int):
    """The compactor's plain torch version: each row's cells split into
    `parts` equal parts; in each part, the cells whose field 0 is nonzero
    go, in ascending cell order, to the part's first `cap` slots as
    [cell position within the part, *fields]; qualifiers past cap are
    dropped; unused slots are 0. Returns len(fields) + 1 arrays
    (m, parts*cap) int32."""
    f0 = fields[0]
    m, nc = f0.shape
    pw = nc // parts
    qual = (f0 != 0).view(m, parts, pw)
    rank = torch.cumsum(qual.to(torch.int32), dim=2) - 1
    slot = torch.where(qual & (rank < cap), rank, cap).long()
    pos = torch.arange(pw, dtype=torch.int32, device=f0.device).expand(m, parts, pw)
    outs = []
    for f in (pos, *(x.view(m, parts, pw) for x in fields)):
        o = torch.zeros((m, parts, cap + 1), dtype=torch.int32, device=f0.device)
        o.scatter_(2, slot, f)           # slot `cap` collects the dropped
        outs.append(o[:, :, :cap].reshape(m, parts * cap))
    return tuple(outs)


def compact_cells(fields, parts: int, cap: int):
    """nf (1 or 2) fields (m, nc) int32, field 0 nonzero exactly at the
    qualifying cells -> nf + 1 arrays (m, parts*cap) int32: tpu_knn's
    cell compactor contract (see compact_cells_plain), at any part width
    (one CUDA kernel stands for both of tpu_knn's Pallas bodies). CPU
    tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    _check_fields(fields, parts, cap)
    f0 = fields[0]
    if f0.device.type == "cpu":
        return compact_cells_plain(fields, parts, cap)
    from tpu_knn_torch.csrc.build import check, load
    from tpu_knn_torch.utils.platform import check_device

    check_device(f0.device)
    lib = load()
    m, nc = f0.shape
    outs = tuple(torch.empty((m, parts * cap), dtype=torch.int32, device=f0.device)
                 for _ in range(len(fields) + 1))
    with torch.cuda.device(f0.device):
        err = lib.tk_compact_cells(
            f0.data_ptr(), fields[1].data_ptr() if len(fields) > 1 else None,
            outs[0].data_ptr(), outs[1].data_ptr(),
            outs[2].data_ptr() if len(fields) > 1 else None, m, nc, parts, cap,
            launch_stream(f0.device))
    check(lib, err, "B8/B9 compact_cells")
    compact_cells.launches += 1
    return outs


#: Kernel launches of the compactor (CUDA tensors only).
compact_cells.launches = 0


# ---- exact lane recovery ---------------------------------------------------


def _floordiv(a, b):
    return torch.div(a, b, rounding_mode="floor")


def _newton_max_root(e1, e2, e3, iters: int = 24):
    """Largest integer root of x^3 - e1 x^2 + e2 x - e3 (the <= 3 lane
    ids of a cell, padded with zeros), by integer Newton from 255 down,
    in int32 as tpu_knn computes it. Returns (r3, exact): exact
    certifies p(r3) == 0, so moments that describe no <= 3 integer lanes
    can never yield a silently wrong root."""
    x = torch.full_like(e1, 255)
    for _ in range(iters):
        px = ((x - e1) * x + e2) * x - e3
        dpx = (3 * x - 2 * e1) * x + e2
        step = torch.where(dpx > 0,
                           torch.clamp(_floordiv(px, torch.clamp(dpx, min=1)), min=1), 1)
        x = torch.where(px > 0, x - step, x)
    px = ((x - e1) * x + e2) * x - e3
    return x, px == 0


def _quad_lanes(p1, sq):
    """The two lanes with sum p1 and square sum sq: (p1 -+ d) / 2 with
    d^2 = 2 sq - p1^2. The f32 sqrt is only a seed: rounded half to even,
    certified by d*d == disc in int32, halved in integers."""
    disc = torch.clamp(2 * sq - p1 * p1, min=0)
    d = torch.round(torch.sqrt(disc.to(torch.float32))).to(torch.int32)
    return _floordiv(p1 - d, 2), _floordiv(p1 + d, 2), d * d == disc


def _solve_cells(cellc, valid, c_cnt, e1, p2, p3, *, cell: int, n: int,
                 solvable: int):
    """Compacted cells' power sums -> candidate global columns
    (m, solvable * slots) with sentinel n in empty slots, and the
    recovery certificate (a 0-d bool tensor)."""
    base = cellc * cell
    if solvable == 2:
        l1, l2, q_ok = _quad_lanes(e1, p2)
        rec_ok = (q_ok | ~valid).all()
        col2 = torch.where(valid & (c_cnt >= 1), base + l2, n)
        col1 = torch.where(valid & (c_cnt >= 2), base + l1, n)
        return torch.cat([col2, col1], dim=1), rec_ok
    # Newton's identities give the elementary symmetric functions
    # exactly; the largest root comes from integer Newton, and deflation
    # leaves a quadratic.
    e2 = _floordiv(e1 * e1 - p2, 2)
    e3 = _floordiv(e1 * e1 * e1 - 3 * e1 * p2 + 2 * p3, 6)
    r3, exact = _newton_max_root(e1, e2, e3)
    l1, l2, q_ok = _quad_lanes(e1 - r3, p2 - r3 * r3)
    rec_ok = ((exact & q_ok) | ~valid).all()
    col_a = torch.where(valid & (c_cnt >= 1), base + r3, n)
    col_b = torch.where(valid & (c_cnt >= 2), base + l2, n)
    col_c = torch.where(valid & (c_cnt >= 3), base + l1, n)
    return torch.cat([col_a, col_b, col_c], dim=1), rec_ok


def _compact_and_solve(m: int, nc: int, parts: int, cap: int, fields, *,
                       cell: int, n: int, solvable: int):
    """Compact the packed moment fields (the compactor kernel) and
    recover candidate columns. Returns (cols (m, solvable*parts*cap_e),
    recovery certificate)."""
    pw = nc // parts
    cap_e = min(cap, pw)
    outs = compact_cells(fields, parts, cap_e)
    lanepos, ac = outs[0], outs[1]
    valid = ac != 0
    off = torch.arange(parts, dtype=torch.int32, device=ac.device).repeat_interleave(cap_e)
    cellc = torch.where(valid, lanepos + off * pw, 0)
    c_cnt = ac & 3
    e1 = (ac >> 2) & 1023
    p2 = (ac >> 12) & 0x3FFFF
    p3 = outs[2] if solvable == 3 else None
    return _solve_cells(cellc, valid, c_cnt, e1, p2, p3, cell=cell, n=n,
                        solvable=solvable)


def _compact_cols(cols, n: int, cap: int = RERANK_COMPACT_CAP, parts: int = 1):
    """Dense-compact each row's valid candidate columns (< n) into
    parts * cap slots, order kept, n beyond; the compactor kernel again,
    with the columns riding as col + 1. Returns (cols, ok: every part's
    candidates fit)."""
    m, w = cols.shape
    if parts > 1 and (w % parts or (w // parts) % 128):
        parts = 1
    cap = min(cap, w // parts)
    _pos, vals = compact_cells((torch.where(cols < n, cols + 1, 0).contiguous(),),
                               parts, cap)
    valid = cols < n
    ok = (valid.view(m, parts, w // parts).sum(dim=2) <= cap).all()
    return torch.where(vals != 0, vals - 1, n), ok


def _exact_rerank(search, ref_aos, cols, kk: int, n: int):
    """Gather the candidate rows, compute exact diff-form d2 and keep the
    kk lexicographically smallest (d2, index): ((m, kk) idx, -1 in empty
    slots, (m, kk) d2)."""
    from tpu_knn_torch.kernels.topk import _gather_d2, _lex_smallest

    if cols.shape[1] < kk:
        cols = torch.nn.functional.pad(cols, (0, kk - cols.shape[1]), value=n)
    idx, d2 = _gather_d2(search, ref_aos, cols, n)
    d2, idx = _lex_smallest(d2, torch.where(idx >= 0, idx, _I32_MAX), kk)
    return torch.where(idx < n, idx, -1), d2


def _inflate_bound(bound, lo=None):
    """Safety inflation of a seeded score bound (tpu_knn's constants): a
    looser bound only admits extra qualifiers. 9.54e-7 ~ 2^-20 relative
    covers the score reduction error, +1e-35 keeps a zero bound strictly
    inflating, NaN becomes +inf (which floods the counts and trips the
    certificate); lo keeps the rounds engine's band monotone."""
    bound = bound + bound.abs() * 9.54e-7 + 1e-35
    bound = torch.where(torch.isnan(bound), torch.inf, bound)
    if lo is not None:
        bound = torch.maximum(bound, lo)
    return bound


def _kth_smallest(x, kk: int):
    return torch.sort(x, dim=-1).values[:, kk - 1].contiguous()


def _host_flags(*flags) -> list[bool]:
    """One device-to-host read for a tier decision (tpu_knn's lax.cond)."""
    return [bool(v) for v in torch.stack([f.reshape(()) for f in flags]).tolist()]


def _part_fits(qual, parts: int, cap: int):
    m, nc = qual.shape
    return (qual.view(m, parts, nc // parts).sum(dim=2) <= cap).all()


def _narrow_parts(nc: int, parts: int) -> int:
    while nc % parts != 0 or (parts > 1 and nc // parts % 128):
        parts //= 2
    return parts


def _bound_prefix(k: int, m: int, n: int, kk: int, n_ops: int, precision: str | None = None):
    """tpu_knn's prefix bound read: for K <= 16 over n_ops >= 2^16 the
    bound pass reads only the first half (K <= 8) or 3/4 of the operand,
    rounded down to the bound pass's tile. The tile is the one tpu_knn
    chooses at the engine's score tier (wide where it is "packed";
    precision None: auto_precision(k, n), the per-call tier), so both
    packages read the same prefix. Returns the prefix width or None."""
    if not (kk <= 16 and n_ops >= (1 << 16)):
        return None
    if precision is None:
        precision = auto_precision(k, n)
    _, tile = pick_tiles(k, m, n, wide=precision == "packed")
    tile = min(tile, n_ops)
    while n_ops % tile != 0:
        tile -= 128
    num, den = (1, 2) if kk <= 8 else (3, 4)
    part = (n_ops * num // den) // tile * tile
    if part >= tile and min(n, part) >= 1024:
        return part
    return None


def seeded_geometry(m: int, n: int, k: int, kk: int, n_ops: int,
                    precision: str | None = None) -> dict:
    """The single-round engine's geometry (tpu_knn's ladder): cell and
    field mode, bound pass depth and prefix (at the score tier, see
    _bound_prefix), the compaction caps and part splits of the fast and
    escalation tiers."""
    max_tile_n = (EXTRACT_TILE_N_QUAD if kk <= 16 else
                  EXTRACT_TILE_N_OCT if kk <= 32 else
                  EXTRACT_TILE_N_CUBIC if kk <= 64 else EXTRACT_TILE_N_HEX)
    cell, n_fields = _extract_mode(_extract_tile_n(n_ops, max_tile_n, k), kk)
    p1_limit = _bound_prefix(k, m, n, kk, n_ops, precision)
    nc = n_ops // cell
    cap_full = min(nc, ((4 if kk <= 8 else 3) * kk + 16) if p1_limit
                   else (2 * kk + 16), 256)
    cap_fast = cap_full if p1_limit else min(cap_full, 96 if kk > 64 else 48)
    nparts = _narrow_parts(nc, 8 if kk > 64 else 4 if kk > 32 else 1)
    escalates = not (cap_full == cap_fast and nparts == 1)
    esc_parts = 2 if kk > 64 and nc % 2 == 0 and (nc // 2) % 128 == 0 else 1
    esc_cap = min(cap_full, 192) if esc_parts > 1 else cap_full
    return {"cell": cell, "n_fields": n_fields, "solvable": _solvable_for(n_fields),
            "depth": 2 if kk > 64 else 1, "p1_limit": p1_limit, "nc": nc,
            "cap_fast": cap_fast, "nparts": nparts, "escalates": escalates,
            "esc_cap": esc_cap, "esc_parts": esc_parts}


def rounds_geometry(n_ops: int, k: int, kk: int) -> dict:
    """The rounds engine's geometry: the K = 64 cubic cells, a 4-way fast
    compaction at cap 48, a one-part escalation at 2*64 + 16."""
    cell, n_fields = _extract_mode(_extract_tile_n(n_ops, EXTRACT_TILE_N_CUBIC, k),
                                   SEEDED_ROUND_K)
    nc = n_ops // cell
    solvable = _solvable_for(n_fields)
    cap_full = min(nc, 2 * SEEDED_ROUND_K + 16)
    nparts = _narrow_parts(nc, 4)
    cap_fast = min(48, nc // nparts)
    return {"cell": cell, "n_fields": n_fields, "solvable": solvable, "nc": nc,
            "cap_full": cap_full, "nparts": nparts, "cap_fast": cap_fast,
            "width": min(solvable * max(nparts * cap_fast, cap_full),
                         RERANK_COMPACT_CAP),
            "rounds": cdiv(kk, SEEDED_ROUND_K)}


def uses_rounds(kk: int, n_ops: int) -> bool:
    """K > 64 runs score-band rounds unless one band suffices: K <= 128
    over at least 8K cells of 64 columns (a depth-2 bound pass then
    bounds the K-th score)."""
    single_band = kk <= 2 * SEEDED_ROUND_K and n_ops // 64 >= 8 * kk
    return kk > SEEDED_ROUND_K and not single_band


# ---- the engines -----------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _build_seeded(m: int, n: int, k: int, kk: int, n_ops: int,
                  precision: str = DEFAULT_PRECISION):
    """The seeded top-K pipeline against a (k_pad, n_ops) SoA operand
    plus the AoS array for exact distances, B3, B7 and the passes fallback
    at the score tier ``precision``. Returns run(search, r_ops, ref_aos)
    -> (idx (m, kk) int32, d2 (m, kk) f32)."""
    from tpu_knn_torch.kernels.topk import SEEDED_MAX_NEIGHBORS, _build_topk

    if not 1 <= kk <= SEEDED_MAX_NEIGHBORS:
        raise ValueError(f"seeded engine serves K in [1, {SEEDED_MAX_NEIGHBORS}]")
    if m > 2 * SEEDED_CHUNK_ROWS:
        # 1024-row sub-batches, each a full pipeline with its own
        # certificate and host reads; the ragged tail is edge-padded.
        c = SEEDED_CHUNK_ROWS
        m_pad = round_up(m, c)
        inner = _build_seeded(c, n, k, kk, n_ops, precision)

        def run_chunked(search, r_ops, ref_aos):
            q = search
            if m_pad != m:
                q = torch.cat([q, q[-1:].expand(m_pad - m, q.shape[1])])
            outs = [inner(q[s:s + c], r_ops, ref_aos) for s in range(0, m_pad, c)]
            return (torch.cat([o[0] for o in outs])[:m],
                    torch.cat([o[1] for o in outs])[:m])

        return run_chunked
    if uses_rounds(kk, n_ops):
        return _build_seeded_rounds(m, n, k, kk, n_ops, precision)
    g = seeded_geometry(m, n, k, kk, n_ops, precision)
    cell, solvable, nc = g["cell"], g["solvable"], g["nc"]
    fallback_run = _build_topk(m, n, k, kk, n_ops, "passes", precision)

    def run(search, r_ops, ref_aos):
        r_op = r_ops[0]
        q_t = _engine_queries_t(search, precision)
        cs1 = minima_candidates(search, r_op, n, depth=g["depth"],
                                n_limit=g["p1_limit"], q_t=q_t, precision=precision)
        # At least kk distinct elements score <= the kk-th lane minimum.
        bound = _inflate_bound(_kth_smallest(cs1, kk))
        moms = extract_moments(search, r_op, n, bound, cell, g["n_fields"], q_t=q_t,
                               precision=precision)
        # Overflow cells (more qualifiers than the solver takes, bit 30)
        # leave the solver's fields and, one per row, join the rerank
        # whole; they credit solvable + 1 candidates to the count.
        ov = (moms[0] >> 30) & 1
        ov_rows = ov.sum(dim=1)
        a_pack = torch.where(ov != 0, 0, moms[0])
        fields = (a_pack,) if solvable == 2 else (
            a_pack, torch.where(ov != 0, 0, moms[1]))
        counted = (torch.clamp(a_pack & 3, max=solvable).sum(dim=1)
                   + ov_rows * (solvable + 1))
        qual = a_pack != 0
        has_ov = ov_rows[:, None] > 0
        ov_cols = torch.where(
            has_ov, torch.argmax(ov, dim=1).to(torch.int32)[:, None] * cell
            + torch.arange(cell, dtype=torch.int32, device=ov.device), n)
        cert_common = (ov_rows <= 1).all() & (counted >= kk).all()

        def recover(cap_i, parts_i):
            cols, rec_ok = _compact_and_solve(
                search.shape[0], nc, parts_i, cap_i, fields, cell=cell, n=n,
                solvable=solvable)
            if cols.shape[1] > 256:
                # Wide recovery carries slack: dense-compact before the
                # rerank (K > 64 needs 2 parts x 256).
                cols, okc = (_compact_cols(cols, n, 256, parts=2) if kk > 64
                             else _compact_cols(cols, n))
                rec_ok = rec_ok & okc
            return cols, rec_ok

        def rerank(cols, expanded):
            if expanded:
                TIERS["expanded"] += 1
                cols = torch.cat([cols, ov_cols], dim=1)
            return _exact_rerank(search, ref_aos, cols, kk, n)

        # Host reads per call: one (fast tier), two (escalated), or one
        # or two before the fallback.
        cols, rec_ok = recover(g["cap_fast"], g["nparts"])
        fits = _part_fits(qual, g["nparts"], min(g["cap_fast"], nc // g["nparts"]))
        any_ov, cert_fast = _host_flags(has_ov.any(), cert_common & rec_ok & fits)
        if cert_fast:
            TIERS["fast"] += 1
            return rerank(cols, any_ov)
        if g["escalates"]:
            esc_parts, esc_cap = g["esc_parts"], g["esc_cap"]
            cols, rec_ok = recover(esc_cap, esc_parts)
            fits = _part_fits(qual, esc_parts, min(esc_cap, nc // esc_parts))
            (cert_full,) = _host_flags(cert_common & rec_ok & fits)
            if cert_full:
                TIERS["escalated"] += 1
                return rerank(cols, any_ov)
        TIERS["fallback"] += 1
        return fallback_run(search, r_ops, ref_aos)

    return run


def _engine_queries_t(search, precision: str):
    """The transposed queries the "highest" B3 and B7 stage, made once per
    call or chunk (None on the CPU and at a term-list tier, whose kernels
    take the split query parts instead)."""
    return transposed_queries(search) if search.is_cuda and precision == "highest" else None


@functools.lru_cache(maxsize=None)
def _build_seeded_rounds(m: int, n: int, k: int, kk: int, n_ops: int,
                         precision: str = DEFAULT_PRECISION):
    """Multi-round seeded engine: round r owns the half-open score band
    (B_{r-1}, B_r]. Round 1's bound source is a B3 pass; each round's
    extraction (banded B7) also folds the per-lane minima of the scores
    above its bound, the next round's bound source. The bands partition
    the reference by the kernel's own scores, so once the rounds'
    recovered counts reach K every element scoring <= B_R is a
    candidate, and one exact rerank over all rounds' columns selects the
    K. Host reads per call: one per round (its compaction tier) and one
    for the certificate."""
    from tpu_knn_torch.kernels.topk import _build_topk

    g = rounds_geometry(n_ops, k, kk)
    cell, solvable, nc, width = g["cell"], g["solvable"], g["nc"], g["width"]
    fallback_run = _build_topk(m, n, k, kk, n_ops, "passes", precision)

    def tier(fields, cap_i, parts_i):
        cols, rec_ok = _compact_and_solve(m, nc, parts_i, cap_i, fields,
                                          cell=cell, n=n, solvable=solvable)
        if cols.shape[1] > width:
            cols, okc = _compact_cols(cols, n, width)
            rec_ok = rec_ok & okc
        return torch.nn.functional.pad(cols, (0, width - cols.shape[1]), value=n), rec_ok

    def run(search, r_ops, ref_aos):
        r_op = r_ops[0]
        lo = torch.full((m,), -torch.inf, dtype=torch.float32, device=search.device)
        q_t = _engine_queries_t(search, precision)
        cs1 = minima_candidates(search, r_op, n, q_t=q_t, precision=precision)
        cols_all, certs = [], []
        counted = torch.zeros((m,), dtype=torch.int64, device=search.device)
        remaining, escalated = kk, False
        for _ in range(g["rounds"]):
            needed = min(SEEDED_ROUND_K, remaining)
            bound = _inflate_bound(_kth_smallest(cs1, needed), lo)
            a_pack, p3, cs1 = extract_moments(search, r_op, n, bound, cell,
                                              g["n_fields"], lo=lo, emit_rem=True, q_t=q_t,
                                              precision=precision)
            qual = a_pack != 0
            counted += torch.clamp(a_pack & 3, max=solvable).sum(dim=1)
            (fast_fits,) = _host_flags(_part_fits(qual, g["nparts"], g["cap_fast"]))
            if fast_fits:
                cols, ok = tier((a_pack, p3), g["cap_fast"], g["nparts"])
            else:
                TIERS["round_escalated"] += 1
                escalated = True
                cols, ok = tier((a_pack, p3), g["cap_full"], 1)
                ok = ok & (qual.sum(dim=1) <= g["cap_full"]).all()
            cols_all.append(cols)
            certs.append(ok & (a_pack.max() < (1 << 30)))
            lo = bound
            remaining -= needed
        (cert,) = _host_flags(torch.stack(certs).all() & (counted >= kk).all())
        if cert:
            TIERS["escalated" if escalated else "fast"] += 1
            return _exact_rerank(search, ref_aos, torch.cat(cols_all, dim=1), kk, n)
        TIERS["fallback"] += 1
        return fallback_run(search, r_ops, ref_aos)

    return run
