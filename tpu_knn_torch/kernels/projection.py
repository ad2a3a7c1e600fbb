"""v11 — the projection-sorted window index (counterpart of tpu_knn/kernels/projection.py).

Build: sort the reference points by their coordinate on the maximum-
variance axis (`build_projection_index`). Query: `searchsorted` places
each query's projection in the sorted order, a window of consecutive
points around it is scanned, 128 lane candidates are reranked with exact
diff-form distances (ties to the lowest ORIGINAL index: `_exact_rerank`'s
`tie_src`), and the answer is certified per query when the nearest
projections just outside the window are strictly farther than the best
in-window distance (d²(q, r) >= (q[d] − r[d])² on any axis d). Uncertified
queries take B1's full scan, merged per query, so exactness never depends
on the data, only speed does.

Two engines, as in tpu_knn:

- "kernel" (default): B11 (`window_candidates`, csrc/window_kernels.cu,
  replacing the Pallas window kernel), a per-query sweep of the window's
  tiles of the augmented SoA operand `r_aug` ([coords | ‖r‖² | 0] rows,
  padding columns PAD_VALUE with a +inf norm so they score −inf), then the
  rerank and the certificate (`_build_kernel_window_query`).
  `_build_projection_pipeline` adds the fallback: where tpu_knn used
  `lax.cond`, the port reads `ok.all()` on the host once per call and
  runs B1 and `_refine` only when it is false; `TALLY` counts the reads
  and the fallback batches.
- "scan": tpu_knn's grouped contiguous-slice engine as torch ops
  (`_build_window_query`), kept as a cross-check.

Products run in true f32 (tpu_knn's Precision.HIGHEST).
"""

from __future__ import annotations

import functools

import torch

from tpu_knn_torch.engine.registry import register_version
from tpu_knn_torch.kernels.fused import (
    _I32_MAX, DEFAULT_PRECISION, _exact_rerank, _lane_fold, _refine, _to_host,
    fused_candidates, fused_knn, prep_soa, select_cutoff, tiled_parts,
)
from tpu_knn_torch.kernels.tuning import H100_SMS, LANE
from tpu_knn_torch.utils.platform import (
    as_f32, as_f32_pair, check_device, full_f32_matmul, launch_stream,
)
from tpu_knn_torch.utils.shapes import cdiv, round_up

#: Padding fill whose scores overflow to −inf (never wins).
PAD_VALUE = 1e30

DEFAULT_WINDOW = 4096

#: Window tile: window starts are aligned down to it, and the augmented
#: operand carries one tile of slack past round_up(n, TILE_W).
TILE_W = 4096

#: Queries per group in the grouped-window scan engine.
DEFAULT_GROUP = 8

#: B11 is bound by device-memory reads; its windows are cut into splits
#: until the launch has this many blocks per SM (window_splits).
B11_BLOCKS_PER_SM = 4

#: Host reads of the kernel pipeline's certificate ("host_reads") and the
#: batches that took the fallback scan ("fallback_batches"), both engines.
#: Nothing resets it but the caller.
TALLY = {"host_reads": 0, "fallback_batches": 0}


def auto_window(k: int, n: int) -> int:
    """Window size for a high certification rate on uniform-ish data
    (tpu_knn's rule, verbatim): the window's projection half-width must
    exceed d_NN ~ n^(-1/k), i.e. w >~ 2·n^(1-1/k); 4x for slack,
    128-aligned."""
    w = int(4.0 * n ** (1.0 - 1.0 / max(k, 1)))
    w = max(DEFAULT_WINDOW, min(n, w))
    return max(128, (w // 128) * 128)


def window_tiles(n: int, window: int) -> int:
    """TILE_W tiles one window covers (one extra for the aligned-down start)."""
    return cdiv(min(window, n), TILE_W) + 1


def _axis_column(x: torch.Tensor, axis: torch.Tensor) -> torch.Tensor:
    """x[:, axis] for a 0-dim device tensor axis, without a host read."""
    return x.gather(1, axis.long().view(1, 1).expand(x.shape[0], 1)).squeeze(1)


def build_projection_index(ref, axis: int | None = None, device="cuda"):
    """Returns (ref_sorted (n,k), order (n,) int32, axis (0-dim int32),
    proj (n,) f32 sorted projections, rnorm (n,) f32 sorted ‖r‖²,
    inv_order (n,) int32 with inv_order[original] = sorted position,
    r_aug (k_pad, n_pad) f32 — B11's augmented SoA operand, k_pad =
    round_up(k + 1, 8), n_pad = round_up(n, TILE_W) + TILE_W), all on the
    points' device. axis: a fixed split axis, or None for the maximum
    (population) variance one, the first on ties, as jnp.argmax."""
    ref = as_f32(ref, device)
    n, k = ref.shape
    if axis is None:
        d = torch.var(ref, dim=0, correction=0).argmax()
    else:
        d = torch.tensor(axis, device=ref.device)
    d = d.to(torch.int32)
    proj = _axis_column(ref, d)
    order = torch.argsort(proj, stable=True).to(torch.int32)
    ref_sorted = ref[order.long()]
    rnorm = (ref_sorted * ref_sorted).sum(dim=1)
    inv_order = torch.empty(n, dtype=torch.int32, device=ref.device)
    inv_order[order.long()] = torch.arange(n, dtype=torch.int32, device=ref.device)
    # [coords | ‖r‖² | zero rows] transposed to SoA; padding columns score
    # s' = q·r − inf/2 = −inf and can never win.
    k_pad = round_up(k + 1, 8)
    n_pad = round_up(n, TILE_W) + TILE_W
    r_aug = torch.zeros((k_pad, n_pad), dtype=torch.float32, device=ref.device)
    r_aug[:k, :n] = ref_sorted.T
    r_aug[k, :n] = rnorm
    r_aug[:k, n:] = PAD_VALUE
    r_aug[k, n:] = torch.inf
    return ref_sorted, order, d, proj[order.long()], rnorm, inv_order, r_aug


# ---- B11: the window kernel ---------------------------------------------


def window_splits(m: int, w_tiles: int) -> int:
    """Pieces each window is cut into, so that the (splits, m) grid has
    B11_BLOCKS_PER_SM blocks per SM; at most one 128-column group each."""
    return max(1, min(w_tiles * TILE_W // LANE, cdiv(B11_BLOCKS_PER_SM * H100_SMS, m)))


def _check_window_operands(q, r_aug, tiles, w_tiles: int, splits: int) -> None:
    if q.dtype != torch.float32 or r_aug.dtype != torch.float32 or tiles.dtype != torch.int32:
        raise TypeError("window_candidates takes f32 queries and operand, int32 tiles")
    if q.dim() != 2 or r_aug.dim() != 2 or tiles.dim() != 1:
        raise ValueError("queries (m, k), operand (k_pad, n_pad), tiles (m,)")
    if not (q.is_contiguous() and r_aug.is_contiguous() and tiles.is_contiguous()):
        raise ValueError("window_candidates takes contiguous operands")
    if not q.device == r_aug.device == tiles.device:
        raise ValueError("queries, operand and tiles must be on one device")
    m, k = q.shape
    groups = w_tiles * TILE_W // LANE
    if m < 1 or tiles.shape[0] != m or k + 1 > r_aug.shape[0]:
        raise ValueError(f"queries {tuple(q.shape)}, tiles {tuple(tiles.shape)} do not "
                         f"fit operand {tuple(r_aug.shape)}")
    if w_tiles < 1 or w_tiles * TILE_W > r_aug.shape[1] or not 1 <= splits <= groups:
        raise ValueError(f"w_tiles={w_tiles}, splits={splits} do not fit operand "
                         f"{tuple(r_aug.shape)}")
    check_device(q.device)


def window_candidates_plain(q, r_aug, tiles, w_tiles: int, splits: int):
    """B11's plain version: the window scores s' = q·r − ‖r‖²/2, summed
    over d = 0..k−1 in order and then the norm term (the kernel's order;
    the kernel fuses each step into one fmaf), folded per lane into a
    running max (the earliest column on ties; NaN never enters), as
    (m, splits*128) sorted positions, INT32_MAX for an empty lane."""
    m, k = q.shape
    cols = tiles.long()[:, None] * TILE_W + torch.arange(w_tiles * TILE_W, device=q.device)
    rc = r_aug[:k + 1][:, cols]                              # (k + 1, m, W)
    s = torch.zeros(cols.shape, dtype=torch.float32, device=q.device)
    for d in range(k):
        s = s + q[:, d, None] * rc[d]
    idx, _ = _lane_fold(-(s + (-0.5) * rc[k]), splits)
    base = tiles[:, None] * TILE_W
    return torch.where(idx < _I32_MAX, idx + base, _I32_MAX)


def window_candidates(q: torch.Tensor, r_aug: torch.Tensor, tiles: torch.Tensor,
                      w_tiles: int, splits: int):
    """(m, k) queries x the projection index's augmented operand ->
    (m, splits*128) int32 candidate sorted positions: per query the lane
    maxima of s' over the w_tiles*TILE_W columns from tiles[i]*TILE_W,
    the window cut into ``splits`` contiguous pieces (csrc B11). CPU
    tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    _check_window_operands(q, r_aug, tiles, w_tiles, splits)
    m, k = q.shape
    if q.device.type == "cpu":
        return window_candidates_plain(q, r_aug, tiles, w_tiles, splits)
    from tpu_knn_torch.csrc.build import check, load

    lib = load()
    idx = torch.empty((m, splits * LANE), dtype=torch.int32, device=q.device)
    with torch.cuda.device(q.device):
        err = lib.tk_window_candidates(
            q.data_ptr(), r_aug.data_ptr(), tiles.data_ptr(), idx.data_ptr(), m, k,
            r_aug.stride(0), w_tiles * TILE_W // LANE, splits,
            launch_stream(q.device))
    check(lib, err, "B11 window_candidates")
    window_candidates.launches += 1
    return idx


#: Kernel launches of B11 (CUDA tensors only; the plain version is not counted).
window_candidates.launches = 0


# ---- query engines ------------------------------------------------------


def _certify(q_proj, d_best, proj, lo, hi, n: int):
    """The per-query bound against the points just outside the sorted
    range [lo, hi): both must be strictly farther in projection than the
    best in-range distance."""
    lp = torch.where(lo >= 1, proj[(lo - 1).clamp(min=0)], -torch.inf)
    rp = torch.where(hi < n, proj[hi.clamp(max=n - 1)], torch.inf)
    dl = q_proj - lp
    dr = rp - q_proj
    return (dl * dl > d_best) & (dr * dr > d_best)


@functools.lru_cache(maxsize=None)
def _build_window_query(m: int, n: int, k: int, window: int, group: int = DEFAULT_GROUP):
    """The grouped contiguous-slice scan engine (tpu_knn's, as torch ops):
    queries sorted by projection, groups of ``group`` consecutive ones, one
    contiguous slice of the sorted points per group covering every
    member's window; norm-trick scores select 128 lane candidates per
    query, reranked exactly. Queries whose window does not fit their
    group's slice fail the bound and take the fallback. Returns
    run(search, *index) -> (idx, d2, ok)."""
    g = min(group, m)
    num_groups = cdiv(m, g)
    m_pad = num_groups * g
    w = min(window, n)
    spread = 0 if g == 1 else min(n, 4 * (n * g) // max(m, 1) + 256)
    L = max(LANE, (min(n, w + spread) // LANE) * LANE)

    def run(search, ref_sorted, order, axis, proj, rnorm, inv_order, r_aug=None):
        dev = search.device
        q_proj = _axis_column(search, axis)
        pos = torch.searchsorted(proj, q_proj)
        q_order = torch.argsort(q_proj, stable=True)
        q_sorted, pos_sorted, qp_sorted = search[q_order], pos[q_order], q_proj[q_order]
        if m_pad != m:
            # Edge padding: zero padding would drag the last group's slice
            # anchor to position 0 and fail its bound.
            q_sorted = torch.cat([q_sorted, q_sorted[-1:].expand(m_pad - m, k)])
            pos_sorted = torch.cat([pos_sorted, pos_sorted[-1:].expand(m_pad - m)])
            qp_sorted = torch.cat([qp_sorted, qp_sorted[-1:].expand(m_pad - m)])
        qg = q_sorted.view(num_groups, g, k)
        start = (pos_sorted.view(num_groups, g).min(dim=1).values - w // 2).clamp(0, n - L)
        cols = start[:, None] + torch.arange(L, device=dev)             # (G, L)
        win, rn_win = ref_sorted[cols], rnorm[cols]
        with full_f32_matmul():
            qw = torch.bmm(qg, win.transpose(1, 2))                     # (G, g, L)
        qn2 = (qg * qg).sum(dim=2, keepdim=True)
        s = qn2 + rn_win[:, None, :] - 2.0 * qw                         # approx
        # 128 lane candidates per query by approximate score, reranked
        # exactly (near d = 0 the norm trick can mis-rank).
        slot = s.view(num_groups, g, L // LANE, LANE).argmin(dim=2)
        lane = torch.arange(LANE, device=dev)
        cand = start[:, None, None] + slot * LANE + lane                # sorted positions
        idx, d_best = _exact_rerank(qg.reshape(m_pad, k), ref_sorted,
                                    cand.reshape(m_pad, LANE).to(torch.int32), n,
                                    tie_src=order)
        ok = _certify(qp_sorted, d_best, proj, start.repeat_interleave(g),
                      (start + L).repeat_interleave(g), n)
        inv = torch.empty(m, dtype=torch.long, device=dev)
        inv[q_order] = torch.arange(m, device=dev)
        idx_out, ok_out = idx[:m][inv], ok[:m][inv]
        # The winners' distances in exact diff form (the norm-trick values
        # select but carry cancellation error near d = 0).
        diff = search - ref_sorted[inv_order[idx_out.long()].long()]
        return idx_out, (diff * diff).sum(dim=1), ok_out

    return run


@functools.lru_cache(maxsize=None)
def _build_kernel_window_query(m: int, n: int, k: int, window: int):
    """The per-query window scan through B11 (tpu_knn's
    `_build_pallas_window_query`): window starts from searchsorted and clip
    as torch ops on the card (no host read), B11's lane candidates in
    sorted space, the exact rerank reporting and tying on the ORIGINAL
    index, and the bound against the points just outside the tile-aligned
    coverage. Returns run(search, *index) -> (idx, d2, ok)."""
    w = min(window, n)
    w_tiles = window_tiles(n, window)
    splits = window_splits(m, w_tiles)

    def run(search, ref_sorted, order, axis, proj, rnorm, inv_order, r_aug):
        q_proj = _axis_column(search, axis)
        pos = torch.searchsorted(proj, q_proj)
        start = (pos - w // 2).clamp(0, max(n - w, 0))
        tiles = (start // TILE_W).to(torch.int32)                   # aligned down
        cand = window_candidates(search, r_aug, tiles, w_tiles, splits)
        idx, d_best = _exact_rerank(search, ref_sorted, cand, n, tie_src=order)
        lo = tiles.long() * TILE_W
        ok = _certify(q_proj, d_best, proj, lo, lo + w_tiles * TILE_W, n)
        return idx, d_best, ok

    return run


@functools.lru_cache(maxsize=None)
def _build_projection_pipeline(m: int, n: int, k: int, window: int):
    """The window scan, its certificate and the merged fallback. Where
    tpu_knn ran the fallback under `lax.cond`, this reads `ok.all()` once
    per call (TALLY["host_reads"]) and runs B1 + `_refine` for the batch
    only when some query failed (TALLY["fallback_batches"]), merged per
    query. Returns run(search, ref, *index, r_op=None) -> (idx, d2,
    certified), certified the host bool read (every query certified); r_op
    is a prepared SoA operand of ref for the fallback (NNIndex's), built
    per call otherwise."""
    win_run = _build_kernel_window_query(m, n, k, window)
    parts = tiled_parts(m, k, n)
    cutoff = select_cutoff(DEFAULT_PRECISION, k)

    def run(search, ref, *index, r_op=None):
        idx, d2, ok = win_run(search, *index)
        TALLY["host_reads"] += 1
        if bool(ok.all()):
            return idx, d2, True
        TALLY["fallback_batches"] += 1
        if r_op is None:
            r_op = prep_soa(ref, round_up(n, LANE))
        f_idx, f_d2 = _refine(search, ref, fused_candidates(search, r_op, n, parts), n,
                              cutoff=cutoff)
        return torch.where(ok, idx, f_idx), torch.where(ok, d2, f_d2), False

    return run


def projection_work(k: int, n: int, m: int) -> int:
    """Reference rows the window path touches for an m-query batch (the
    kernel's tile-aligned coverage) — the dispatch cost model."""
    return m * window_tiles(n, auto_window(k, n)) * TILE_W


def projection_wins(k: int, m: int, n: int) -> bool:
    """True where the window path should beat the fused full scan by a
    safe margin (tpu_knn's rule, verbatim): k small, the batch small, and
    the covered rows well under one full scan."""
    return (k <= 4 and m <= 64 and n >= (1 << 20)
            and 2 * projection_work(k, n, m) <= n)


def projection_knn(search, ref, *, window: int | None = None, group: int | None = None,
                   prebuilt=None, engine: str = "kernel", device="cuda"):
    """Exact 1-NN via the projection index. Returns (idx (m,) int32, d2
    (m,) f32) on the inputs' device. ``prebuilt`` is a
    build_projection_index output to reuse (NNIndex); built per call
    otherwise. ``engine``: "kernel" (B11) or "scan" (torch ops)."""
    if engine not in ("kernel", "scan"):
        raise ValueError(f"engine must be 'kernel' or 'scan', got {engine!r}")
    search, ref = as_f32_pair(search, ref, device)
    m, k = search.shape
    n = ref.shape[0]
    if n < LANE:
        return fused_knn(search, ref)
    if window is None:
        window = auto_window(k, n)
    if group is None:
        # Small batches: one slice per query; large sorted batches share
        # slices across neighbours.
        group = 1 if m <= 64 else DEFAULT_GROUP
    index = prebuilt if prebuilt is not None else build_projection_index(ref)
    if engine == "kernel":
        idx, d2, _ = _build_projection_pipeline(m, n, k, window)(search, ref, *index)
        return idx, d2
    idx, d2, ok = _build_window_query(m, n, k, window, group)(search, *index)
    TALLY["host_reads"] += 1
    if bool(ok.all()):
        return idx, d2
    TALLY["fallback_batches"] += 1
    f_idx, f_d2 = fused_knn(search, ref)
    return torch.where(ok, idx, f_idx), torch.where(ok, d2, f_d2)


def v11_callback(k, m, n, search, ref):
    idx, _ = projection_knn(search, ref)
    return _to_host(idx)


register_version(
    "v11",
    v11_callback,
    "projection-sorted window index: B11's window scan with a per-query "
    "exactness bound and B1 full-scan fallback, CUDA (tpu_knn's v11, beyond "
    "the reference ladder)",
    # The 1-D projection bound stops paying as k grows (tpu_knn measured
    # 0/1024 uniform queries certified at k=16, n=2^20).
    guard=lambda k, m, n: k <= 8 and n >= 128,
    fallback="v4",
)
