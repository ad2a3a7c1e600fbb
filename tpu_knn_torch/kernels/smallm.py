"""Small-batch (m <= 4) diff-form 1-NN (counterpart of tpu_knn/kernels/smallm.py).

Two engines, split as in tpu_knn:

- PREPARED (NNIndex, operand built once, k >= 8 or m >= 2): B2, a
  hand-written CUDA kernel (csrc/smallm_kernels.cu, replacing tpu_knn's
  Pallas `_smallm_kernel`) that streams the same SoA (k_pad, n_pad)
  operand as B1 and folds exact diff-form scores Σ(r − q)² into per-lane
  candidates; `_refine` picks the winner (always certified: the scores
  are exact). A bf16 store's operand takes B2-bf16, a kernel of its own
  (16-byte loads of 8 bf16, upcast at the read) with B2's candidates bit
  for bit, at its own partition count (`bf16_parts`).
- PER-CALL (caller hands an (n, k) array): the diff-form AoS scan over
  the caller's array, plain torch ops (plain XLA in tpu_knn). It takes a
  bf16 store's points or an int8 grid as they are stored: f32 − bf16 and
  f32 − int8 promote to f32 exactly, as jnp's do. An explicit ``tile_n``
  keeps tpu_knn's measurement pipeline instead: the SoA operand padded to
  a multiple of tile_n, B2 at its own partition count, the exact refine.
"""

from __future__ import annotations

import torch

from tpu_knn_torch.kernels.fused import (
    _check_candidate_operands, _I32_MAX, _lane_fold, _refine, prep_soa, select_cutoff,
)
from tpu_knn_torch.kernels.tuning import LANE, pick_parts
from tpu_knn_torch.utils.platform import as_f32_pair, launch_stream
from tpu_knn_torch.utils.shapes import round_up

#: Largest batch the kernel serves.
SMALLM_MAX_M = 4

#: Largest k (matches the packed dot's fit: 4 * round_up(k, 8) <= 128).
SMALLM_MAX_K = 32

#: tpu_knn's reference-tile budget in f32 elements (k_pad * tile_n).
OPERAND_BUDGET = 1 << 19

#: k below which the AoS scan also serves the prepared m == 1 path: the
#: SoA operand pads k to a multiple of 8 (tpu_knn's measured rule; B2
#: reads only the k real rows, so on the card the rule is a later
#: measurement's to revisit).
AOS_SCAN_MAX_KPAD_WASTE_K = 8

#: B2 is bound by device-memory reads; more blocks per SM keep more loads
#: in flight (tuning.pick_parts).
B2_BLOCKS_PER_SM = 4

#: B2-bf16's blocks of 256 threads per SM: the residency its
#: __launch_bounds__ provides registers for (csrc smallm_kernels.cu
#: kSmallmBf16BlocksPerSm), the same threads an SM as B2's grid with half
#: its partitions, so the refine after it ranks half the candidates.
B2_BF16_BLOCKS_PER_SM = 2


def pick_tile_n(k: int, n: int) -> int:
    """tpu_knn's tile for the Pallas small-m kernel, verbatim (kept for the
    policy table; the CUDA kernel takes its geometry from default_parts)."""
    k_pad = round_up(k, 8)
    tile_n = min(1 << 16, OPERAND_BUDGET // k_pad)
    tile_n = min(tile_n, round_up(n, 128))
    return max(128, (tile_n // 128) * 128)


def smallm_applicable(m: int, k: int, n: int) -> bool:
    """Dispatch predicate: small batch, any n, k within the packed range."""
    return 1 <= m <= SMALLM_MAX_M and 1 <= k <= SMALLM_MAX_K and n >= 1


def aos_scan_applicable(m: int, k: int, n: int) -> bool:
    """Dispatch predicate for small batches above the kernel's k range."""
    return 1 <= m <= SMALLM_MAX_M and k > SMALLM_MAX_K and n >= 1


def default_parts(n: int) -> int:
    """B2 partition count (one row tile: the whole batch)."""
    return pick_parts(1, n, B2_BLOCKS_PER_SM)


def bf16_parts(n: int) -> int:
    """B2-bf16's partition count: one wave of B2_BF16_BLOCKS_PER_SM blocks
    an SM, never more than n's 128-column groups (264 at n >= 2^15 + 2^10
    against B2's 528)."""
    return pick_parts(1, n, B2_BF16_BLOCKS_PER_SM)


#: B2-bf16's load widths in bf16 values a thread reads a row (csrc
#: smallm_kernels.cu bf16_vec): the widest whose bytes divide the operand's
#: base address and whose count divides its row stride; at most
#: BF16_NARROW_WIDTH for m > BF16_WIDE_MAX_M (bf16_vec_cap: m rows x 8
#: lanes of state do not fit the registers of B2_BF16_BLOCKS_PER_SM blocks).
BF16_LOAD_WIDTHS = (8, 4, 2, 1)
BF16_WIDE_MAX_M = 2
BF16_NARROW_WIDTH = 4


def bf16_load_width(r_op: torch.Tensor, m: int) -> int:
    """The load width B2-bf16's launcher picks for r_op at m rows (a
    mirror of csrc's bf16_vec and bf16_vec_cap, for tests and logs)."""
    width = next(v for v in BF16_LOAD_WIDTHS
                 if r_op.data_ptr() % (2 * v) == 0 and r_op.stride(0) % v == 0)
    return width if m <= BF16_WIDE_MAX_M else min(width, BF16_NARROW_WIDTH)


def operand_parts(r_op: torch.Tensor, n: int) -> int:
    """P for the kernel that serves r_op: B2-bf16's for a bf16 operand,
    B2's otherwise."""
    return bf16_parts(n) if r_op.dtype == torch.bfloat16 else default_parts(n)


def diff_scores(q, r_op, n: int):
    """The plain versions' exact diff-form scores Σ_d (r[d,col] − q[d])²
    over the first n columns (m, n), one query row at a time. B2 and B6's
    plain versions share it, as the two kernels share one score function."""
    m, k = q.shape
    r = r_op[:k, :n].float()   # a bf16 operand upcasts exactly
    return torch.stack([((r - q[i, :, None]) ** 2).sum(dim=0) for i in range(m)])


def smallm_candidates_plain(q, r_op, n: int, parts: int):
    """B2's plain torch version: diff_scores, then the per-lane fold
    (fused._lane_fold)."""
    return _lane_fold(diff_scores(q, r_op, n), parts)


def check_smallm_shape(m: int, k: int) -> None:
    if not (1 <= m <= SMALLM_MAX_M and 1 <= k <= SMALLM_MAX_K):
        raise ValueError(f"smallm kernel serves 1 <= m <= {SMALLM_MAX_M} and "
                         f"1 <= k <= {SMALLM_MAX_K}, got m={m}, k={k}")


def smallm_candidates(q: torch.Tensor, r_op: torch.Tensor, n: int, parts: int):
    """(m <= 4, k <= 32) queries x (k_pad, n_pad) SoA operand, f32 or (a
    bf16 store's) bf16 -> (idx (m, parts*128) int32, exact score
    (m, parts*128) f32): B2's candidate contract over the first n columns.
    CPU tensors take the plain version; CUDA tensors launch the kernel (B2,
    or B2-bf16 for a bf16 operand) or raise."""
    _check_candidate_operands(q, r_op, n, parts, r_dtypes=(torch.float32, torch.bfloat16))
    m, k = q.shape
    check_smallm_shape(m, k)
    if q.device.type == "cpu":
        return smallm_candidates_plain(q, r_op, n, parts)
    from tpu_knn_torch.csrc.build import check, load

    lib = load()
    bf16 = r_op.dtype == torch.bfloat16
    idx = torch.empty((m, parts * LANE), dtype=torch.int32, device=q.device)
    score = torch.empty((m, parts * LANE), dtype=torch.float32, device=q.device)
    entry = lib.tk_smallm_candidates_bf16 if bf16 else lib.tk_smallm_candidates
    with torch.cuda.device(q.device):
        err = entry(q.data_ptr(), r_op.data_ptr(), idx.data_ptr(), score.data_ptr(),
                    m, k, r_op.stride(0), n, parts,
                    launch_stream(q.device))
    check(lib, err, "B2-bf16 smallm_candidates" if bf16 else "B2 smallm_candidates")
    if bf16:
        from tpu_knn_torch.kernels.tiers import TIER_LAUNCHES

        TIER_LAUNCHES["B2-bf16"] += 1
    else:
        smallm_candidates.launches += 1
    return idx, score


#: Kernel launches of B2 (CUDA tensors only; the plain version is not
#: counted). B2-bf16 counts in tiers.TIER_LAUNCHES["B2-bf16"].
smallm_candidates.launches = 0


def _aos_scan(search, ref, live: int | None = None):
    """Zero-prep small-m scan (tpu_knn's `_build_aos_scan`): exact f32
    diff-form distances over the caller's (n, k) array, one query row at
    a time, with v0's tie rule made explicit (the lowest index among the
    rows at the minimum). +inf rows self-exclude. ``live`` (tpu_knn's
    masked=True) excludes the rows at index >= live by position, for an
    operand whose padding rows cannot hold +inf (an int8 grid shard's):
    only the first ``live`` rows are read (at least one).
    Returns (idx (m,) int32, d2 (m,) f32)."""
    if live is not None:
        if not 1 <= live <= ref.shape[0]:
            raise ValueError(f"live={live} outside [1, {ref.shape[0]}]")
        ref = ref[:live]
    n = ref.shape[0]
    s = torch.stack([((ref - q) ** 2).sum(dim=1) for q in search])  # (m, n)
    v = s.min(dim=1, keepdim=True).values
    col = torch.arange(n, dtype=torch.int32, device=ref.device)
    idx = torch.where(s == v, col, _I32_MAX).min(dim=1).values
    return idx, v.squeeze(1)


def smallm_knn(search, ref, *, tile_n: int | None = None, device="cuda"):
    """Small-batch exact 1-NN: (m <= 4) queries against (n, k) points.

    Returns (indices (m,) int32, exact squared distances (m,) f32); same
    contract and tie semantics as fused_knn. The default is the AoS scan;
    an explicit ``tile_n`` keeps tpu_knn's per-call B2 pipeline
    (measurement intent, `_build_smallm`): the SoA operand padded to
    round_up(n, tile_n), B2 at default_parts(n), the exact refine (its
    scores are exact: select_cutoff("exact", k)). That pipeline serves
    1 <= m <= 4 and 1 <= k <= 32, tile_n a positive multiple of 128, and
    raises ValueError otherwise, where tpu_knn's does.
    """
    search, ref = as_f32_pair(search, ref, device)
    m, k = search.shape
    n = ref.shape[0]
    if tile_n is None:
        if not (1 <= m <= SMALLM_MAX_M):
            raise ValueError(f"smallm serves 1 <= m <= {SMALLM_MAX_M}, got {m}")
        return _aos_scan(search, ref)
    check_smallm_shape(m, k)
    if tile_n % LANE != 0 or tile_n <= 0:
        raise ValueError(f"tile_n must be a positive multiple of 128, got {tile_n}")
    r_op = prep_soa(ref, round_up(n, tile_n))
    cand = smallm_candidates(search, r_op, n, default_parts(n))
    return _refine(search, ref, cand, n, cutoff=select_cutoff("exact", k))
