"""The bf16-split score tiers of the fused 1-NN path on the tensor cores
(counterpart of tpu_knn/kernels/fused.py's `_split_bf16`, `_split_bf16_3`,
`_qr_dot`, `_qr_dot_packed`, `_score_tile`'s bf16 upcast and
`_score_tile_presplit`, and of the presplit prep of
`_build_fused_candidates`).

A tier computes q·r as a **term list**: a list of (q part, r part)
products of bf16 parts, each product exact in f32 and the terms summed in
f32. The parts are those of the 3-way split x ≈ hi + mid + lo (index 0, 1,
2); the 2-way split's lo is the 3-way split's mid, so one indexing serves
every tier:

- "packed": `_packed_terms(round_up(k, 8))` — 9 terms at k_pad = 8 and 8
  (lo·lo dropped) at k_pad = 16 (packed3), the 2x2 at k_pad 24 and 32
  (packed2), and bf16x3 above;
- "bf16x3" and "bf16x3_presplit": hi·hi, hi·lo, lo·hi; "bf16x4" adds lo·lo;
- "qsplit2": q_hi·r, q_lo·r over a bf16-exact operand (quantized stores);
- "default" and "bf16_raw": one bf16 pass (the TPU's DEFAULT precision).

"highest" is not a term list: it is B1's f32 FMA on the CUDA cores
(kernels/fused.py).

Two kernels serve the tiers (csrc/tensor_kernels.cu), both with B1's
candidate contract (csrc/knn_common.cuh): `tensor_candidates` (B1's
tiers) runs a tier's terms as one bf16 GEMM on the tensor cores
(`mma.sync.m16n8k16`, fragments from `ldmatrix`) over an f32 or bf16 SoA
operand streamed through shared memory, splitting each staged f32 chunk
of r once into bf16 part planes (q is split once per call by the
wrapper; ‖r‖² once per call by a norm pass before the kernel), and folds
s = ‖r‖² − 2·q·r per lane; `presplit_candidates` (B12) is the same kernel
reading pre-split (hi, lo) bf16 rows and an f32 ‖r‖² row. Their plain versions (`tier_scores`,
`presplit_scores` and the per-lane fold) compute every term as an f32
matmul of the upcast parts, as tpu_knn's dot_general with an f32 result
does. On a bf16 operand the lower r parts are exactly zero, so the kernel
drops those terms (adding a ±0 product leaves an f32 sum unchanged) and
reads the operand as it is stored. The 1-NN ladder's rungs (v3, v5, v6)
have tier instances of their own on the same mainloop
(csrc/tensor_ladder_kernels.cu; the ladder section below), and v3's
"packed" takes tpu_knn's unpadded AoS term list (`term_list(..., aos=True)`).
"""

from __future__ import annotations

import collections
import math

import torch

from tpu_knn_torch.kernels.fused import (
    _I32_MAX, _TIER_EPS, _candidate_outputs, _check_candidate_operands, _lane_fold, _packed_terms,
    fused_candidates, norm_scores,
)
from tpu_knn_torch.kernels.tuning import (
    LANE, MOMENT_CHUNK, SMEM_PER_BLOCK, SMEM_PER_BLOCK_RESERVED, SMEM_PER_SM,
    _wave_parts, kselect_state_bytes,
)
from tpu_knn_torch.utils.platform import full_f32_matmul, launch_stream
from tpu_knn_torch.utils.shapes import cdiv, round_up

# The tensor-core kernel's geometry (csrc/tensor_mainloop.cuh). A block of
# 4 * rows threads (16 warps at 128 rows, 8 at 64) owns its epilogue's
# rows of queries (TENSOR_TILE_M for B1's tiers, B12, B4, B3, B5 and B7;
# B5_SERVE_ROWS for B5 at m <= B5_SERVE_ROWS; TENSOR_LADDER_TILE_M and
# LADDER_SERVE_ROWS for the 1-NN ladder's v3 and B10 instances,
# TENSOR_LIVE_TILE_M for v6's live-row one) and one slice of LANE //
# TENSOR_SLICES lanes of
# a partition, and walks the
# partition's 128-column groups TENSOR_TILE_GROUPS at a time (a column
# tile); TENSOR_BLOCKS_PER_SM blocks run on an SM at once (its
# __launch_bounds__), and their shared memory (tensor_smem) is checked
# against that when the kernel is compiled.

#: Query rows per block of B1's tiers, B12, B4, B3, B5 and B7 (their
#: epilogues' kRows: four warps of 32 rows, each beside three more for the
#: slice's other lanes), so each staged r chunk serves 128 rows.
TENSOR_TILE_M = 128
#: Query rows per block of the 1-NN ladder's v3 and B10 instances above m =
#: LADDER_SERVE_ROWS (csrc kLadderRows): B1's block, one an SM.
TENSOR_LADDER_TILE_M = 128
#: Their rows per block at m <= LADDER_SERVE_ROWS: four warps, all on live
#: rows, two blocks an SM (csrc kLadderServeRows).
LADDER_SERVE_ROWS = 32
#: Query rows per block of v6's live-row instance above m =
#: LADDER_SERVE_ROWS (LADDER_SERVE_ROWS at or below), and the rows whose
#: resident q parts TENSOR_Q_RESIDENT_BYTES holds (csrc kTBM).
TENSOR_LIVE_TILE_M = 64
#: Query rows per block of B5 at m <= B5_SERVE_ROWS (the serving shapes):
#: four warps, all on live rows (csrc kServeRows).
B5_SERVE_ROWS = 32
#: Blocks per (row tile, partition): lane slices of 32 (csrc kTSlices).
TENSOR_SLICES = 4
#: 128-column groups per column tile (csrc kTGroups).
TENSOR_TILE_GROUPS = 4
#: Blocks of TENSOR_TILE_M rows resident per SM (csrc CandidatesEpi's
#: kBlocksPerSm): one block of 16 warps, the SM's 64K registers at 128 a
#: thread.
TENSOR_BLOCKS_PER_SM = 1

_HH_HL_LH = ((0, 0), (0, 1), (1, 0))

#: Operand modes of the tensor-core kernel (csrc OperandMode).
_MODE_F32, _MODE_BF16, _MODE_PRESPLIT = 0, 1, 2

#: Kernel launches of the kernels this module's tiers run, CUDA tensors
#: only (the plain versions are not counted), one count per row of the
#: kernel table: tensor_candidates by resolved tier ("packed3", "packed2",
#: "bf16x3", "bf16x4", "qsplit2", "default", "bf16_raw"), B12 as
#: "bf16x3_presplit", B2 over a bf16 store's operand
#: (smallm.smallm_candidates) as "B2-bf16", and the top-K kernels' tier
#: instances as "<kernel> <resolved tier>" ("B4 packed3", "B5 bf16x3", ...;
#: "<kernel>-bf16 <tier>" over a bf16 operand, see topk_tier_row), and the
#: 1-NN ladder's as "B1 v3 <tier>", "B10 <tier>", "B1 v6 <tier>"
#: (ladder_tier_row).
TIER_LAUNCHES: collections.Counter = collections.Counter()


# ---- the arithmetic -------------------------------------------------


def split_bf16_3(x: torch.Tensor):
    """f32 -> (hi, mid, lo) bf16 with x ≈ hi + mid + lo, each part rounded
    to nearest even (tpu_knn's `_split_bf16_3`; torch's `.to(bfloat16)`
    rounds as JAX's astype does). The 2-way split (hi, lo) of
    `_split_bf16` is (hi, mid): x − hi is exact in f32, so both round the
    same value."""
    hi = x.to(torch.bfloat16)
    r1 = x - hi.float()
    mid = r1.to(torch.bfloat16)
    lo = (r1 - mid.float()).to(torch.bfloat16)
    return hi, mid, lo


def _packed_width(k: int, aos: bool) -> int:
    """The contraction width "packed" picks its terms at: round_up(k, 8)
    for an SoA block, k itself for tpu_knn's AoS block (v3), which it does
    not pad (fused.py:402-405), so at k = 9..14 v3 runs all 9 terms."""
    return k if aos else round_up(k, 8)


def resolved_tier(precision: str, k: int, aos: bool = False) -> str:
    """The `_TIER_EPS` key of the arithmetic a tier runs at width k:
    "packed" resolves by its term list (packed3, packed2, or bf16x3 where
    the contraction is too wide to pack), as select_cutoff does; ``aos``:
    over tpu_knn's unpadded AoS block (v3)."""
    if precision == "packed":
        n_splits, _ = _packed_terms(_packed_width(k, aos))
        return {3: "packed3", 2: "packed2"}.get(n_splits, "bf16x3")
    return precision


def term_list(precision: str, k: int, aos: bool = False) -> tuple[tuple[int, int], ...]:
    """(q part, r part) pairs of a tier at width k, in tpu_knn's order
    (`_qr_dot`): indices into the 3-way split (0 hi, 1 mid = the 2-way
    split's lo, 2 lo). ``aos``: "packed" over tpu_knn's unpadded AoS block
    (`_packed_terms(k)`, v3)."""
    if precision in ("default", "bf16_raw"):
        return ((0, 0),)
    if precision == "qsplit2":
        return ((0, 0), (1, 0))
    if precision == "packed":
        n_splits, pairs = _packed_terms(_packed_width(k, aos))
        if n_splits:
            return tuple(pairs)
        precision = "bf16x3"
    if precision in ("bf16x3", "bf16x3_presplit"):
        return _HH_HL_LH
    if precision == "bf16x4":
        return _HH_HL_LH + ((1, 1),)
    raise ValueError(f"precision={precision!r} is not a term-list tier")


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """An f32 product of upcast bf16 parts (exact products, f32 sum)."""
    with full_f32_matmul():
        return a.float() @ b.float()


def tier_qr(q: torch.Tensor, r: torch.Tensor, precision: str, aos: bool = False) -> torch.Tensor:
    """q (m, k) f32 · r (k, w) f32 by the tier's terms, structured as
    tpu_knn's `_qr_dot`: one dot over the concatenated parts for "packed",
    hh + (hl + lh) (+ ll) for the bf16x3/x4 ladder, q_hi·r + q_lo·r for
    qsplit2. ``aos``: term_list's."""
    k = q.shape[1]
    qp, rp = split_bf16_3(q), split_bf16_3(r)
    terms = term_list(precision, k, aos)
    if precision in ("default", "bf16_raw"):
        return _dot(qp[0], rp[0])
    if precision == "qsplit2":
        return _dot(qp[0], rp[0]) + _dot(qp[1], rp[0])
    if precision == "packed" and _packed_terms(_packed_width(k, aos))[0]:
        return _dot(torch.cat([qp[i] for i, _ in terms], dim=1),
                    torch.cat([rp[j] for _, j in terms], dim=0))
    qr = _dot(qp[0], rp[0]) + (_dot(qp[0], rp[1]) + _dot(qp[1], rp[0]))
    if precision == "bf16x4":
        qr = qr + _dot(qp[1], rp[1])
    return qr


def tier_scores(q: torch.Tensor, r_op: torch.Tensor, n: int, precision: str,
                aos: bool = False) -> torch.Tensor:
    """The plain score s = ‖r‖² − 2·(q·r) of a term-list tier over the
    first n columns of an f32 or bf16 SoA operand, (m, n) f32. A bf16
    operand is upcast first (exact), as `_score_tile` does. ``aos``: at
    term_list's AoS terms."""
    k = q.shape[1]
    r = r_op[:k, :n].float()
    return (r * r).sum(dim=0) - 2.0 * tier_qr(q, r, precision, aos)


def presplit_ops(ref: torch.Tensor, n_pad: int):
    """(n, k) f32 -> B12's operands (tpu_knn's presplit `prep_soa`): the
    zero-padded (round_up(k, 16), n_pad) transpose split into bf16 (hi, lo)
    and its f32 column norms ‖r‖² as a (1, n_pad) row."""
    n, k = ref.shape
    r = torch.zeros((round_up(k, 16), n_pad), dtype=torch.float32, device=ref.device)
    r[:k, :n] = ref.T
    hi = r.to(torch.bfloat16)
    lo = (r - hi.float()).to(torch.bfloat16)
    return hi, lo, (r * r).sum(dim=0, keepdim=True)


def presplit_scores(q, hi, lo, rn, n: int) -> torch.Tensor:
    """B12's plain score (tpu_knn's `_score_tile_presplit`): q split once,
    hh + (hl + lh) over the stored (hi, lo) rows, minus from the stored
    ‖r‖² row; (m, n) f32."""
    k = q.shape[1]
    qh, ql, _ = split_bf16_3(q)
    h, lw = hi[:k, :n], lo[:k, :n]
    qr = _dot(qh, h) + (_dot(qh, lw) + _dot(ql, h))
    return rn[0, :n] - 2.0 * qr


# ---- the kernels ------------------------------------------------------


def tensor_parts(m: int, n: int) -> int:
    """Partition count of a tensor-core launch. Each partition takes
    ceil(m / TENSOR_TILE_M) row tiles x TENSOR_SLICES blocks, and the card
    runs TENSOR_BLOCKS_PER_SM * 132 of them at once, all with the same
    work: ceil(ceil(G / P) / TENSOR_TILE_GROUPS) column tiles of their
    partition's share of the G 128-column groups. So a launch takes
    ceil(blocks / that) waves of one block's work, and P minimises waves x
    tiles per block, within tuning.TILED_COST_SLACK of its minimum the
    smallest P (fewer candidates for the caller to merge): at m = 1024, n
    = 2^20, P = 4 is one wave of 128 blocks, 512 tiles each, 3% above the
    same work spread evenly over the 132 slots."""
    return _wave_parts(cdiv(m, TENSOR_TILE_M) * TENSOR_SLICES, cdiv(n, LANE), TENSOR_TILE_GROUPS,
                       TENSOR_BLOCKS_PER_SM)


#: The instances the kernel is built for: (operand mode, T) -> the term
#: list each one runs (term_list's, less the terms a bf16 operand drops;
#: csrc instance_terms). The C entry refuses any other list.
TENSOR_INSTANCES = {
    (0, 1): ((0, 0),), (0, 2): ((0, 0), (1, 0)), (0, 3): _HH_HL_LH,
    (0, 4): _HH_HL_LH + ((1, 1),),
    (0, 8): tuple((i, j) for i in range(3) for j in range(3))[:8],
    (0, 9): tuple((i, j) for i in range(3) for j in range(3)),
    (1, 1): ((0, 0),), (1, 2): ((0, 0), (1, 0)), (1, 3): ((0, 0), (1, 0), (2, 0)),
    (2, 3): _HH_HL_LH,
}

#: The instances a packed tier's list runs as (packed_tier: its r bits
#: carry PACKED_SUM and the kernel sums its terms in the tensor core):
#: packed3's 9 or 8 terms over f32 and their 3 over bf16, packed2's 4 over
#: f32 (bf16x4's list, summed as bf16x4 without the flag) and 2 over bf16.
TENSOR_PACKED_INSTANCES = {(0, 4), (0, 8), (0, 9), (1, 2), (1, 3)}

#: The resident q parts' limit of a 64-row block (csrc kQResidentBytes;
#: q_resident_limit: twice that for a 128-row block, so whether a width's
#: parts are resident does not depend on the block's rows; the SM's budget,
#: SMEM_PER_SM less SMEM_PER_BLOCK_RESERVED a block, is tuning's).
TENSOR_Q_RESIDENT_BYTES = 30 * 1024
_TENSOR_MAX_STAGES = 4


def tensor_fold_bytes(rows: int = TENSOR_TILE_M) -> int:
    """A block's fold slots, 8 (score, index) pairs a thread of its 4 *
    rows (csrc fold_slot_bytes)."""
    return 8 * 4 * rows * 8


def tensor_q_resident_limit(rows: int = TENSOR_TILE_M) -> int:
    """The resident q parts' limit of a block of ``rows`` (csrc
    q_resident_limit)."""
    return TENSOR_Q_RESIDENT_BYTES * rows // TENSOR_LIVE_TILE_M

#: The tensor-core mainloop's epilogues (csrc tensor_mainloop.cuh): kernel
#: -> (its state's shared-memory bytes, EPI::kStateBytes; its blocks per
#: SM, EPI::kBlocksPerSm; whether a block owns a whole partition of
#: contiguous columns, EPI::kContig, else one lane slice of it; its block's
#: rows, EPI::kRows). B1 keeps the fold slots; B4 adds its rows' bounds, B3
#: their lo (its one-chunk instances keep their state in registers and
#: leave the slots unused); B5 keeps its rows' K-lists (kselect.cuh), an
#: admission score a row and, for each of two tiles, B5_ROW_SLOTS (score,
#: slot) entries, their count and a 128-bit mask a row, and a 128-bit row
#: summary ("B5-serve": its B5_SERVE_ROWS-row blocks, two an SM); B7 its
#: rows' bound and lo, two 128-bit qualifier masks (two tiles) and four
#: sums a row, and "B7-band" (the rounds engine's instance: a band, the
#: remainder minima) also a remainder tile of 128 rows 136 floats apart.
_B7_STATE = 2 * 4 * TENSOR_TILE_M + 3 * 4 * 4 * TENSOR_TILE_M

#: A B5 row's kept entries of a tile in shared memory (csrc kRowSlots).
B5_ROW_SLOTS = 8


def _b5_state(rows: int) -> int:
    return kselect_state_bytes(rows) + 4 * rows + 2 * rows * (8 * B5_ROW_SLOTS + 4 + 16) + 2 * 16


TENSOR_EPILOGUES = {
    "B1": (tensor_fold_bytes(), TENSOR_BLOCKS_PER_SM, False, TENSOR_TILE_M),
    "B4": (tensor_fold_bytes() + 2 * 4 * TENSOR_TILE_M, TENSOR_BLOCKS_PER_SM, False,
           TENSOR_TILE_M),
    "B3": (tensor_fold_bytes() + 4 * TENSOR_TILE_M, TENSOR_BLOCKS_PER_SM, False, TENSOR_TILE_M),
    "B5": (_b5_state(TENSOR_TILE_M), TENSOR_BLOCKS_PER_SM, True, TENSOR_TILE_M),
    "B5-serve": (_b5_state(B5_SERVE_ROWS), 2, True, B5_SERVE_ROWS),
    "B7": (_B7_STATE, TENSOR_BLOCKS_PER_SM, True, TENSOR_TILE_M),
    "B7-band": (_B7_STATE + 4 * TENSOR_TILE_M * 136, TENSOR_BLOCKS_PER_SM, True, TENSOR_TILE_M),
}

#: The 1-NN ladder's epilogue (csrc LadderEpi: B1's fold) at each block
#: height, in TENSOR_EPILOGUES' form: v3's and B10's 128-row blocks, one an
#: SM ("ladder"), and 32-row ones, two an SM, at m <= LADDER_SERVE_ROWS
#: ("ladder-serve", ladder_epilogue); v6's live-row blocks (csrc
#: LiveEpi<BM, BPS>, tensor_live_epilogue): 64 rows, one an SM
#: ("ladder-live"), or at m <= LADDER_SERVE_ROWS, where the live rows'
#: parts fit a 32-row block's q_resident_limit, 32 rows two an SM
#: ("ladder-live-pair").
LADDER_EPILOGUES = {
    "ladder": (tensor_fold_bytes(TENSOR_LADDER_TILE_M), 1, False, TENSOR_LADDER_TILE_M),
    "ladder-serve": (tensor_fold_bytes(LADDER_SERVE_ROWS), 2, False, LADDER_SERVE_ROWS),
    "ladder-live": (tensor_fold_bytes(TENSOR_LIVE_TILE_M), 1, False, TENSOR_LIVE_TILE_M),
    "ladder-live-pair": (tensor_fold_bytes(LADDER_SERVE_ROWS), 2, False, LADDER_SERVE_ROWS),
}


def tensor_chunk(k16: int, terms=(), packed: bool = False) -> int:
    """KC, the d-rows of one ring stage: 32 where k16 allows, else 16; 16
    for a 4-term list that is not packed (bf16x4's: at 32 its registers
    spilled), but on v6's live rows (called without ``terms``)."""
    if len(terms) == 4 and not packed:
        return 16
    return 32 if k16 % 32 == 0 else 16


def _tensor_plan(mode: int, terms, kc: int, rows: int = TENSOR_TILE_M):
    """(q parts, r planes, r bytes of a stage, q chunk bytes, f32 part
    planes' bytes) of an instance whose blocks own ``rows`` query rows
    (csrc q_parts ... planes_bytes)."""
    nq = 1 + max(i for i, _ in terms)
    nr = (1 + max(j for _, j in terms)) if mode == _MODE_F32 else 2 if mode == _MODE_PRESPLIT else 1
    cols = TENSOR_TILE_GROUPS * LANE // TENSOR_SLICES
    r_stage = (kc * cols * 4 if mode == _MODE_F32
               else (1 + (mode == _MODE_PRESPLIT)) * kc * (cols + 8) * 2) + 4 * cols
    q_chunk = nq * rows * (kc + 8) * 2
    planes = nr * kc * (cols + 8) * 2 if mode == _MODE_F32 else 0
    return nq, nr, r_stage, q_chunk, planes


def _epilogue(epilogue: str):
    return LADDER_EPILOGUES.get(epilogue) or TENSOR_EPILOGUES[epilogue]


def tensor_rows(epilogue: str = "B1") -> int:
    """The query rows of an epilogue's block (csrc EPI::kRows); a key of
    TENSOR_EPILOGUES or LADDER_EPILOGUES."""
    return _epilogue(epilogue)[3]


def tensor_blocks_per_sm(epilogue: str) -> int:
    """An instance's blocks an SM (csrc EPI::blocks_per_sm): its
    epilogue's at every term list and chunk."""
    return _epilogue(epilogue)[1]


def _fixed_bytes(mode: int, epilogue: str = "B1", sets: int = 1) -> int:
    """The epilogue's state and, in f32 mode, a copy of a tile's ‖r‖² row
    for each of ``sets`` sets of part planes (csrc fixed_bytes)."""
    return _epilogue(epilogue)[0] + (sets * 4 * LANE if mode == _MODE_F32 else 0)


def _live_q_budget(epilogue: str) -> int:
    """The live rows' q parts a live-row plan holds (csrc
    LiveEpi::kLiveQBytes): TENSOR_Q_LIVE_BYTES one block an SM, a block's
    q_resident_limit two."""
    if tensor_blocks_per_sm(epilogue) == 1:
        return TENSOR_Q_LIVE_BYTES
    return tensor_q_resident_limit(tensor_rows(epilogue))


def _deepest_ring(mode: int, terms, kc: int, epilogue: str, sets: int) -> int:
    """The deepest ring, up to 4 stages, at which the instance's blocks per
    SM fit an SM at any k16 beside ``sets`` sets of part planes (csrc
    deepest_ring; a live-row epilogue's q bytes its budget, q_budget)."""
    rows = tensor_rows(epilogue)
    _, _, r_stage, q_chunk, planes = _tensor_plan(mode, terms, kc, rows)
    per_sm = tensor_blocks_per_sm(epilogue)
    live = epilogue.startswith("ladder-live")

    def fits(stages):
        most = (_fixed_bytes(mode, epilogue, sets) + stages * r_stage + sets * planes
                + (_live_q_budget(epilogue) if live
                   else max(stages * q_chunk, tensor_q_resident_limit(rows))))
        return (per_sm * (most + SMEM_PER_BLOCK_RESERVED) <= SMEM_PER_SM
                and most <= SMEM_PER_BLOCK)

    return next((s for s in (_TENSOR_MAX_STAGES, 3) if fits(s)), 2)


def tensor_plane_sets(mode: int, terms, kc: int, epilogue: str = "B1") -> int:
    """The part planes' sets (csrc plane_sets): two for an f32 instance
    that runs one block an SM and fits with both beside a ring of at least
    3 stages (the split of chunk s + 1 then runs beside step s's mmas),
    else one."""
    if (mode == _MODE_F32 and tensor_blocks_per_sm(epilogue) == 1
            and _deepest_ring(mode, terms, kc, epilogue, 2) >= 3):
        return 2
    return 1


def tensor_stages(mode: int, terms, kc: int, epilogue: str = "B1") -> int:
    """The ring's depth (csrc ring_stages): the deepest, up to 4, at which
    the instance's blocks per SM (tensor_blocks_per_sm) fit an SM at any
    k16 beside its part planes (tensor_plane_sets)."""
    return _deepest_ring(mode, terms, kc, epilogue,
                         tensor_plane_sets(mode, terms, kc, epilogue))


def tensor_smem(mode: int, terms, kc: int, k16: int, epilogue: str = "B1") -> int:
    """Dynamic shared memory of one block (csrc tensor_smem): the
    epilogue's state, the ring's stages (the r chunk, the column tile's
    ‖r‖² row, and the q chunk where the q parts are not resident), the f32
    mode's part planes (tensor_plane_sets of them), and the resident q
    parts. ``epilogue``: a key of
    TENSOR_EPILOGUES or LADDER_EPILOGUES (v3's and B10's instances:
    ladder_epilogue)."""
    rows = tensor_rows(epilogue)
    _, _, r_stage, q_chunk, planes = _tensor_plan(mode, terms, kc, rows)
    q_res = k16 // kc * q_chunk   # resident q parts: the ring's chunks, one after another
    resident = q_res <= tensor_q_resident_limit(rows)
    stages = tensor_stages(mode, terms, kc, epilogue)
    sets = tensor_plane_sets(mode, terms, kc, epilogue)
    return (_fixed_bytes(mode, epilogue, sets) + stages * (r_stage + (0 if resident else q_chunk))
            + sets * planes + (q_res if resident else 0))


#: The flag in a packed term list's r bits: the terms are one packed dot,
#: summed in the tensor core (csrc kPackedSum).
PACKED_SUM = 1 << 30


def _pack_terms(terms, packed: bool = False) -> tuple[int, int]:
    q_bits = sum(i << (2 * t) for t, (i, _) in enumerate(terms))
    r_bits = sum(j << (2 * t) for t, (_, j) in enumerate(terms))
    return q_bits, r_bits | (PACKED_SUM if packed else 0)


def packed_tier(precision: str, k: int, aos: bool = False) -> bool:
    """Whether a tier at width k is one of "packed"'s term lists (packed3,
    packed2): tpu_knn's one dot over the concatenated parts, whose terms
    the kernels sum in the tensor core (csrc tile_terms)."""
    return resolved_tier(precision, k, aos) in ("packed3", "packed2")


def _prepare(q, operand, n: int, terms, what: str, packed: bool = False):
    """What every tensor-core launch takes: the library, the q parts the
    terms use, split here once per call from the zero-padded queries ((nq,
    m, k16) bf16, torch's round-to-nearest-even casts, tpu_knn's split bit
    for bit), scratch for the operand's ‖r‖² row (the C entry's norm pass
    writes it) and the packed term list. The staged rows are copied 16
    bytes at a time, so the operand's rows must start on 16-byte
    boundaries."""
    if operand.data_ptr() % 16 or (operand.stride(0) * operand.element_size()) % 16:
        raise ValueError(f"{what}: the operand's rows must be 16-byte aligned (row stride "
                         f"{operand.stride(0)} elements)")
    return _prepare_q(q, n, terms, packed)


def _prepare_q(q, n: int, terms, packed: bool = False):
    """_prepare's library, q parts, ‖r‖² scratch and packed term list, for
    an operand of any alignment (v3's (n, k) array); ``packed``: the
    terms are a packed tier's (packed_tier)."""
    from tpu_knn_torch.csrc.build import load

    lib = load()
    k = q.shape[1]
    q_pad = torch.nn.functional.pad(q, (0, round_up(k, 16) - k))
    nq = 1 + max(i for i, _ in terms)
    qp = torch.stack(split_bf16_3(q_pad)[:nq]).contiguous()
    norms = torch.empty(n, dtype=torch.float32, device=q.device)
    return lib, qp, norms, _pack_terms(terms, packed)


def _launch(q, operand, ptrs, mode: int, n: int, parts: int, terms, what: str,
            packed: bool = False):
    """Launch B1's tiers or B12 over ``operand`` (its first array; ``ptrs``
    = (r, r_lo, rn) pointers; rn None: the C entry first writes the
    operand's ‖r‖² row into scratch allocated here; see _prepare)."""
    from tpu_knn_torch.csrc.build import check

    lib, qp, norms, (q_bits, r_bits) = _prepare(q, operand, n if ptrs[2] is None else 0,
                                                terms, what, packed)
    m, k = q.shape
    idx, score = _candidate_outputs(m, parts * LANE, q.device)
    if ptrs[2] is None:
        ptrs = (*ptrs[:2], norms.data_ptr())
    with torch.cuda.device(q.device):
        err = lib.tk_tensor_candidates(
            qp.data_ptr(), *ptrs, idx.data_ptr(), score.data_ptr(), m, k, operand.stride(0), n,
            parts, mode, len(terms), q_bits, r_bits,
            launch_stream(q.device))
    check(lib, err, what)
    return idx, score


def _operand_instance(r_op: torch.Tensor, precision: str, k: int):
    """(operand mode, term list) of the tensor-core instance that runs a
    term-list tier over r_op: over a bf16 operand the lower parts are
    exactly zero, so their terms add ±0 and are dropped."""
    terms = term_list(precision, k)
    if r_op.dtype == torch.bfloat16:
        return _MODE_BF16, tuple(t for t in terms if t[1] == 0)
    return _MODE_F32, terms


def tensor_candidates_plain(q, r_op, n: int, parts: int, precision: str):
    """B1's tiers, plain: tier_scores, then the per-lane fold."""
    return _lane_fold(tier_scores(q, r_op, n, precision), parts)


def tensor_candidates(q: torch.Tensor, r_op: torch.Tensor, n: int, parts: int,
                      precision: str):
    """(m, k) f32 queries x (k_pad, n_pad) f32 or bf16 SoA operand -> B1's
    (idx, score) candidates (m, parts*128) under a term-list tier. CPU
    tensors take the plain version; CUDA tensors launch the tensor-core
    kernel or raise."""
    _check_candidate_operands(q, r_op, n, parts, r_dtypes=(torch.float32, torch.bfloat16))
    term_list(precision, q.shape[1])
    if q.device.type == "cpu":
        return tensor_candidates_plain(q, r_op, n, parts, precision)
    mode, terms = _operand_instance(r_op, precision, q.shape[1])
    out = _launch(q, r_op, (r_op.data_ptr(), None, None), mode, n, parts, terms,
                  f"B1 ({precision}) tensor_candidates", packed_tier(precision, q.shape[1]))
    TIER_LAUNCHES[resolved_tier(precision, q.shape[1])] += 1
    return out


def _check_presplit(q, hi, lo, rn, n: int) -> None:
    k16 = round_up(q.shape[1], 16)
    if hi.dtype != torch.bfloat16 or lo.dtype != torch.bfloat16 or rn.dtype != torch.float32:
        raise TypeError("presplit operands are (hi, lo) bfloat16 and an f32 norm row")
    if (hi.shape != lo.shape or hi.shape[0] != k16 or rn.shape != (1, hi.shape[1])
            or not (hi.is_contiguous() and lo.is_contiguous() and rn.is_contiguous())
            or not hi.device == lo.device == rn.device):
        raise ValueError(f"presplit operands {tuple(hi.shape)}, {tuple(lo.shape)}, "
                         f"{tuple(rn.shape)} are not contiguous ({k16}, n_pad) x 2 + "
                         "(1, n_pad) on one device")


def presplit_candidates_plain(q, hi, lo, rn, n: int, parts: int):
    """B12's plain version: presplit_scores, then the per-lane fold."""
    return _lane_fold(presplit_scores(q, hi, lo, rn, n), parts)


def presplit_candidates(q: torch.Tensor, hi: torch.Tensor, lo: torch.Tensor,
                        rn: torch.Tensor, n: int, parts: int):
    """(m, k) f32 queries x B12's operands (presplit_ops) -> B1's (idx,
    score) candidates under bf16x3 over the stored parts. CPU tensors take
    the plain version; CUDA tensors launch the kernel or raise."""
    _check_candidate_operands(q, hi, n, parts, r_dtypes=(torch.bfloat16,))
    _check_presplit(q, hi, lo, rn, n)
    if q.device.type == "cpu":
        return presplit_candidates_plain(q, hi, lo, rn, n, parts)
    out = _launch(q, hi, (hi.data_ptr(), lo.data_ptr(), rn.data_ptr()), _MODE_PRESPLIT, n,
                  parts, _HH_HL_LH, "B12 presplit_candidates")
    TIER_LAUNCHES["bf16x3_presplit"] += 1
    return out


# ---- the top-K kernels at a tier ------------------------------------------
#
# B4, B3, B5 and B7 at a term-list tier: the tensor-core mainloop with each
# kernel's epilogue (csrc tensor_banded_kernels.cu, tensor_minima_kernels.cu,
# tensor_sweep_kernels.cu, tensor_moments_kernels.cu). The wrappers
# (fused.banded_candidates, fused.minima_candidates, topk.sweep_candidates,
# seeded.extract_moments) validate, take the plain versions on the CPU and
# send every tier other than "highest" here on the card. One mainloop
# scores a (row, column) pair identically in all of them and in B1's tiers,
# so B4 and B5 agree bit for bit, as do B3 and B7. Their plain versions fold
# tier_scores in place of fused.norm_scores (fused.scores).

#: The top-K kernels that have tier instances.
TOPK_TIER_KERNELS = ("B4", "B3", "B5", "B7")


def check_topk_tier(precision: str) -> None:
    """A top-K kernel's tier: "highest" (its tiled f32 kernel) or a
    term-list tier. "bf16x3_presplit" takes no top-K instance (tpu_knn's
    presplit index raises for neighbors > 1)."""
    if precision == "highest":
        return
    if precision == "bf16x3_presplit":
        raise ValueError("the top-K kernels have no bf16x3_presplit instance (tpu_knn's "
                         "presplit index serves 1-NN only)")
    term_list(precision, 1)


def topk_tier_row(kernel: str, r_op: torch.Tensor, precision: str, k: int) -> str:
    """The TIER_LAUNCHES key of a top-K kernel's tier instance: "<kernel>
    <resolved tier>", "<kernel>-bf16 <resolved tier>" over a bf16 operand."""
    bf16 = "-bf16" if r_op.dtype == torch.bfloat16 else ""
    return f"{kernel}{bf16} {resolved_tier(precision, k)}"


def sweep_tier_epilogue(m: int) -> str:
    """The TENSOR_EPILOGUES key of B5's tier instance at m rows (csrc
    tk_tensor_sweep): "B5-serve" at m <= B5_SERVE_ROWS, else "B5"."""
    return "B5-serve" if m <= B5_SERVE_ROWS else "B5"


def tensor_topk_parts(kernel: str, m: int, n: int) -> int:
    """The partition count of a top-K kernel's tier instance. B4 and B3
    take B1's tier geometry (tensor_parts: lane slices, one 128-row block
    an SM). B5 and B7 give a block a whole partition, at their epilogues'
    rows and blocks an SM (TENSOR_EPILOGUES; B5's by m, sweep_tier_epilogue;
    "B7-band": B7 with a band or the remainder minima): B5's partitions are
    its lists, of whole 128-column groups; B7's hold whole
    MOMENT_CHUNK-column chunks of the n columns given here (the operand's
    width). Each P is tuning._wave_parts' choice for its blocks."""
    if kernel in ("B4", "B3"):
        return tensor_parts(m, n)
    if kernel not in ("B5", "B5-serve", "B7", "B7-band"):
        raise ValueError(f"no tier instance of {kernel!r}")
    if kernel == "B5":
        kernel = sweep_tier_epilogue(m)
    per_sm = TENSOR_EPILOGUES[kernel][1]
    tiles = cdiv(m, tensor_rows(kernel))
    unit = LANE if kernel.startswith("B5") else MOMENT_CHUNK
    return _wave_parts(tiles, cdiv(n, unit), 1, per_sm)


def tier_score_chunks(q: torch.Tensor, r_op: torch.Tensor, n: int, precision: str):
    """(first column, (m, width) scores) over [0, n) in fused.SCORE_CHUNK
    pieces: tier_scores chunk by chunk, at fused.score_chunks' boundaries,
    so that B3's and B7's plain versions give a column the same score."""
    from tpu_knn_torch.kernels.fused import SCORE_CHUNK

    for c0 in range(0, n, SCORE_CHUNK):
        c1 = min(n, c0 + SCORE_CHUNK)
        yield c0, tier_scores(q, r_op[:, c0:c1], c1 - c0, precision)


def _stream(q):
    return launch_stream(q.device)


def banded_tier_launch(q, r_op, n: int, parts: int, bound_s, bound_i, precision: str):
    """B4's tier instance on the card (fused.banded_candidates' contract)."""
    from tpu_knn_torch.csrc.build import check

    what = f"B4 ({precision}) banded_candidates"
    mode, terms = _operand_instance(r_op, precision, q.shape[1])
    lib, qp, norms, (q_bits, r_bits) = _prepare(q, r_op, n, terms, what,
                                                packed_tier(precision, q.shape[1]))
    m, k = q.shape
    idx, score = _candidate_outputs(m, parts * LANE, q.device)
    with torch.cuda.device(q.device):
        err = lib.tk_tensor_banded(
            qp.data_ptr(), r_op.data_ptr(), norms.data_ptr(), bound_s.data_ptr(),
            bound_i.data_ptr(), idx.data_ptr(), score.data_ptr(), m, k, r_op.stride(0), n,
            parts, mode, len(terms), q_bits, r_bits, _stream(q))
    check(lib, err, what)
    TIER_LAUNCHES[topk_tier_row("B4", r_op, precision, k)] += 1
    return idx, score


def minima_tier_launch(q, r_op, n: int, depth: int, lo, precision: str):
    """B3's tier instance on the card over the first n columns
    (fused.minima_candidates' contract), P from tensor_topk_parts."""
    from tpu_knn_torch.csrc.build import check

    what = f"B3 ({precision}) minima_candidates"
    mode, terms = _operand_instance(r_op, precision, q.shape[1])
    lib, qp, norms, (q_bits, r_bits) = _prepare(q, r_op, n, terms, what,
                                                packed_tier(precision, q.shape[1]))
    m, k = q.shape
    parts = tensor_topk_parts("B3", m, n)
    # Depth 1 folds the partitions into out itself; depth 2 writes each
    # partition's pairs for the merge.
    partial = (torch.empty((m, parts * depth * LANE), dtype=torch.float32, device=q.device)
               if depth == 2 else None)
    out = torch.empty((m, depth * LANE), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = lib.tk_tensor_minima(
            qp.data_ptr(), r_op.data_ptr(), norms.data_ptr(),
            lo.data_ptr() if lo is not None else None,
            partial.data_ptr() if partial is not None else None, out.data_ptr(), m, k,
            r_op.stride(0), n, parts, depth, mode, len(terms), q_bits, r_bits, _stream(q))
    check(lib, err, what)
    TIER_LAUNCHES[topk_tier_row("B3", r_op, precision, k)] += 1
    return out


def sweep_cand_floats(m: int, parts: int) -> int:
    """Floats of B5's candidate tiles (csrc SweepEpi::Args::cand): two
    tiles (rows x 128) for each block of its instance at m."""
    rows = tensor_rows(sweep_tier_epilogue(m))
    return cdiv(m, rows) * parts * 2 * rows * LANE


def sweep_tier_launch(q, r_op, n: int, parts: int, kk: int, precision: str):
    """B5's tier instance on the card (topk.sweep_candidates' contract)."""
    from tpu_knn_torch.csrc.build import check

    what = f"B5 ({precision}) sweep_candidates"
    mode, terms = _operand_instance(r_op, precision, q.shape[1])
    lib, qp, norms, (q_bits, r_bits) = _prepare(q, r_op, n, terms, what,
                                                packed_tier(precision, q.shape[1]))
    m, k = q.shape
    idx, score = _candidate_outputs(m, parts * kk, q.device)
    cand = torch.empty(sweep_cand_floats(m, parts), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = lib.tk_tensor_sweep(
            qp.data_ptr(), r_op.data_ptr(), norms.data_ptr(), cand.data_ptr(), idx.data_ptr(),
            score.data_ptr(), m, k, r_op.stride(0), n, parts, kk, mode, len(terms), q_bits,
            r_bits, _stream(q))
    check(lib, err, what)
    TIER_LAUNCHES[topk_tier_row("B5", r_op, precision, k)] += 1
    return idx, score


def moments_tier_launch(q, r_op, n: int, bound, cell: int, cubic: bool, lo, emit_rem: bool,
                        precision: str):
    """B7's tier instance on the card (seeded.extract_moments' contract),
    over the operand's nc = width // cell cells, P from tensor_topk_parts.
    Returns (A, p3 or None, rem or None)."""
    from tpu_knn_torch.csrc.build import check

    what = f"B7 ({precision}) extract_moments"
    mode, terms = _operand_instance(r_op, precision, q.shape[1])
    lib, qp, norms, (q_bits, r_bits) = _prepare(q, r_op, n, terms, what,
                                                packed_tier(precision, q.shape[1]))
    m, k = q.shape
    n_ops = r_op.shape[1]
    nc = n_ops // cell
    banded = emit_rem or lo is not None
    parts = tensor_topk_parts("B7-band" if banded else "B7", m, nc * cell)
    dev = q.device
    a = torch.empty((m, nc), dtype=torch.int32, device=dev)
    p3 = torch.empty((m, nc), dtype=torch.int32, device=dev) if cubic else None
    rem_part = rem = None
    if emit_rem:
        rem_part = torch.empty((m, parts * LANE), dtype=torch.float32, device=dev)
        rem = torch.empty((m, LANE), dtype=torch.float32, device=dev)

    def ptr(t):
        return t.data_ptr() if t is not None else None

    with torch.cuda.device(dev):
        err = lib.tk_tensor_moments(
            qp.data_ptr(), r_op.data_ptr(), norms.data_ptr(), bound.data_ptr(), ptr(lo),
            a.data_ptr(), ptr(p3), ptr(rem_part), ptr(rem), m, k, r_op.stride(0), n, nc, cell,
            int(cubic), parts, mode, len(terms), q_bits, r_bits, _stream(q))
    check(lib, err, what)
    TIER_LAUNCHES[topk_tier_row("B7", r_op, precision, k)] += 1
    return a, p3, rem


# ---- the 1-NN ladder at a tier: v3, v6 and B10 ------------------------------
#
# B1's AoS (v3) and resident-query (v6) variants and B10 (v5) at a term-list
# tier: the tensor-core mainloop under the AoS and TMA staging policies, and
# with the q parts resident at every shape v6's guard admits (csrc
# tensor_ladder_kernels.cu). The wrappers (fused.aos_candidates,
# fused.const_query_candidates, dma_pipeline.dma_candidates) validate, take
# the plain versions on the CPU and send every tier other than "highest"
# here on the card. Each launch counts in TIER_LAUNCHES under its row
# (ladder_tier_row): "B1 v3 <tier>", "B1 v6 <tier>", "B10 <tier>".

#: The kernel-table row of each rung's tier instances.
LADDER_ROWS = {"v3": "B1 v3", "v6": "B1 v6", "v5": "B10"}

#: v6's resident q parts where a 64-row block's do not fit
#: TENSOR_Q_RESIDENT_BYTES: the live rows' (csrc kQResidentLiveBytes), the
#: most any shape v6's guard admits needs (102,816 bytes at (321, 51)).
TENSOR_Q_LIVE_BYTES = 101 * 1024


def ladder_terms(precision: str, k: int, aos: bool = False):
    """The term list a rung's tier instance runs: term_list's ("bf16x3_presplit"
    is bf16x3's terms over the f32 points, as tpu_knn's `_qr_dot` computes
    it for these kernels). "qsplit2" needs a bf16-exact operand, which the
    rungs' per-call f32 points are not; "highest" is the tiled f32
    kernels'."""
    if precision in ("highest", "qsplit2"):
        raise ValueError(f"the ladder's tier instances take no {precision!r} tier")
    return term_list(precision, k, aos)


def ladder_tier_row(rung: str, precision: str, k: int) -> str:
    """The TIER_LAUNCHES key of a rung's tier instance ("v3", "v5" or "v6"):
    its row and the instance's resolved tier (bf16x3_presplit runs bf16x3's
    instance, bf16_raw default's)."""
    tier = resolved_tier(precision, k, aos=rung == "v3")
    tier = {"bf16x3_presplit": "bf16x3", "bf16_raw": "default"}.get(tier, tier)
    return f"{LADDER_ROWS[rung]} {tier}"


def ladder_epilogue(m: int) -> str:
    """The LADDER_EPILOGUES key of v3's and B10's tier instances at m rows
    (csrc dispatch_ladder): "ladder-serve" at m <= LADDER_SERVE_ROWS, else
    "ladder"."""
    return "ladder-serve" if m <= LADDER_SERVE_ROWS else "ladder"


def ladder_tier_parts(m: int, n: int) -> int:
    """The partition count of v3's and B10's tier instances: lane slices
    of their block height at m (ladder_epilogue), at its blocks an SM,
    tuning._wave_parts' choice (at m = 1 over 2^24 points, 63 partitions of
    4 blocks fill 252 of the 264 slots of 32-row blocks; at ds11, 4 of 32
    fill 128 of the 132 slots of 128-row ones)."""
    epilogue = ladder_epilogue(m)
    return _wave_parts(cdiv(m, tensor_rows(epilogue)) * TENSOR_SLICES, cdiv(n, LANE),
                       TENSOR_TILE_GROUPS, tensor_blocks_per_sm(epilogue))


def tensor_q_resident(terms, k16: int) -> bool:
    """Whether a 64-row block's q parts fit TENSOR_Q_RESIDENT_BYTES (csrc
    q_resident) in f32 mode: then so do a 32- or 128-row block's within
    their limits (tensor_q_resident_limit)."""
    kc = tensor_chunk(k16, terms)
    nq = 1 + max(i for i, _ in terms)
    return k16 // kc * nq * TENSOR_LIVE_TILE_M * (kc + 8) * 2 <= TENSOR_Q_RESIDENT_BYTES


def _live_q_bytes(terms, m: int, k16: int, rows: int) -> int:
    kc = tensor_chunk(k16)
    nq = 1 + max(i for i, _ in terms)
    return nq * min(m, rows) * (k16 // kc) * (kc + 8) * 2


#: v6's live-row plans in the order of the C entry's ``live`` argument
#: (csrc tk_tensor_resident_candidates).
LIVE_PLANS = ("ladder-live", "ladder-live-pair")


def tensor_live_epilogue(terms, m: int, k16: int) -> str:
    """The LADDER_EPILOGUES key of v6's live-row instance at m rows (its
    plan, passed to the C entry as its index in LIVE_PLANS):
    "ladder-live-pair" (32-row blocks, two an SM) at m <= LADDER_SERVE_ROWS
    where the live rows' parts fit a 32-row block's q_resident_limit, else
    "ladder-live" (64-row blocks, one an SM, the split a step ahead). A
    32-row block alone on an SM measured 1.5x the 64-row block's time at
    (768, 16, 2^20) (PERF.md §6, PR 22), so no plan runs one."""
    pair = m <= LADDER_SERVE_ROWS and (_live_q_bytes(terms, m, k16, LADDER_SERVE_ROWS)
                                       <= tensor_q_resident_limit(LADDER_SERVE_ROWS))
    return "ladder-live-pair" if pair else "ladder-live"


def tensor_live_q_bytes(terms, m: int, k16: int) -> int:
    """The resident q parts of a live-row block: its live rows (at most
    its epilogue's rows) of each part, every chunk (csrc live_q_bytes)."""
    return _live_q_bytes(terms, m, k16, tensor_rows(tensor_live_epilogue(terms, m, k16)))


def tensor_live_smem(terms, m: int, k16: int) -> int:
    """Dynamic shared memory of v6's live-row instance (csrc live_smem):
    its epilogue's fixed bytes, the ring (r stages only) and part planes
    of its plan (tensor_stages, tensor_plane_sets at the epilogue's q
    budget) and the live q parts."""
    epilogue = tensor_live_epilogue(terms, m, k16)
    kc = tensor_chunk(k16)
    _, _, r_stage, _, planes = _tensor_plan(_MODE_F32, terms, kc, tensor_rows(epilogue))
    sets = tensor_plane_sets(_MODE_F32, terms, kc, epilogue)
    return (_fixed_bytes(_MODE_F32, epilogue, sets)
            + tensor_stages(_MODE_F32, terms, kc, epilogue) * r_stage + sets * planes
            + tensor_live_q_bytes(terms, m, k16))


def resident_tier_parts(precision: str, m: int, k: int, n: int) -> int:
    """v6's partition count at a tier: B1's (tensor_parts) where a 64-row
    block's q parts fit, its own launch then; else the live-row instance's,
    lane slices of its blocks (tensor_live_epilogue) at its blocks an SM."""
    terms, k16 = ladder_terms(precision, k), round_up(k, 16)
    if tensor_q_resident(terms, k16):
        return tensor_parts(m, n)
    epilogue = tensor_live_epilogue(terms, m, k16)
    return _wave_parts(cdiv(m, tensor_rows(epilogue)) * TENSOR_SLICES, cdiv(n, LANE),
                       TENSOR_TILE_GROUPS, tensor_blocks_per_sm(epilogue))


def aos_tier_candidates_plain(q, ref, n: int, parts: int, precision: str):
    """v3's tier candidates, plain: tier_scores over the first n points of
    the (>= n, k) array at the AoS term list (tpu_knn's `_score_tile` with
    soa=False), then the per-lane fold."""
    return _lane_fold(tier_scores(q, ref[:n].T, n, precision, aos=True), parts)


def dma_tier_candidates_plain(q, r_op, n: int, parts: int, precision: str):
    """B10's tier candidates, plain: B1's tier candidates, indices only."""
    return tensor_candidates_plain(q, r_op, n, parts, precision)[0]


def _ladder_launch(entry: str, rung: str, q, operand, n: int, parts: int, precision: str,
                   scores: bool = True):
    """Launch a rung's tier instance (tk_tensor_<entry>_candidates) over
    ``operand`` (v3: the (n, k) array; B10, v6: the SoA operand) and count
    it under ladder_tier_row. v3's, B10's and v6's live-row instances chain
    ‖r‖² in the kernel; v6's launch takes scratch for B1's norm pass where
    it is B1's own launch (tensor_q_resident), else none (null)."""
    from tpu_knn_torch.csrc.build import check

    m, k = q.shape
    terms = ladder_terms(precision, k, aos=rung == "v3")
    b1_own = rung == "v6" and tensor_q_resident(terms, round_up(k, 16))
    lib, qp, norms, (q_bits, r_bits) = _prepare_q(q, n if b1_own else 0, terms,
                                                  packed_tier(precision, k, aos=rung == "v3"))
    idx, score = _candidate_outputs(m, parts * LANE, q.device)
    outs = (idx.data_ptr(), score.data_ptr()) if scores else (idx.data_ptr(),)
    scratch = ((norms.data_ptr() if b1_own else None),) if rung == "v6" else ()
    live = ((LIVE_PLANS.index(tensor_live_epilogue(terms, m, round_up(k, 16))),)
            if rung == "v6" else ())
    with torch.cuda.device(q.device):
        err = getattr(lib, f"tk_tensor_{entry}_candidates")(
            qp.data_ptr(), operand.data_ptr(), *scratch, *outs, m, k, operand.stride(0), n,
            parts, len(terms), q_bits, r_bits, *live, _stream(q))
    row = ladder_tier_row(rung, precision, k)
    check(lib, err, f"{row} ({precision})")
    TIER_LAUNCHES[row] += 1
    return (idx, score) if scores else idx


def aos_tier_launch(q, ref, n: int, parts: int, precision: str):
    """v3's tier instance on the card (fused.aos_candidates' contract)."""
    return _ladder_launch("aos", "v3", q, ref, n, parts, precision)


def dma_tier_launch(q, r_op, n: int, parts: int, precision: str):
    """B10's tier instance on the card (dma_pipeline.dma_candidates'
    contract: indices only)."""
    return _ladder_launch("dma", "v5", q, r_op, n, parts, precision, scores=False)


def resident_tier_launch(q, r_op, n: int, parts: int, precision: str):
    """v6's tier instance on the card (fused.const_query_candidates'
    contract)."""
    return _ladder_launch("resident", "v6", q, r_op, n, parts, precision)


def tier_parts(precision: str, m: int, k: int, n: int) -> int:
    """The default partition count of the kernel a tier runs on."""
    if precision == "highest":
        from tpu_knn_torch.kernels.fused import tiled_parts

        return tiled_parts(m, k, n)
    return tensor_parts(m, n)


def merge_partitions(idx: torch.Tensor, score: torch.Tensor):
    """(m, P·128) candidates -> (m, 128): per lane, the lexicographically
    smallest (score, index) over the P partitions (a NaN score counts as
    +inf) — the set one partition's launch would give, tpu_knn's (m, 128)
    contract. The tier pipelines refine this set, so their certificate and
    exact rerank see tpu_knn's 128 lanes, and the full-width rerank of an
    uncertified batch gathers 128 rows per query, not P·128 (at k = 768
    and P = 17 that is 0.4 GB instead of 6.8 GB per 1024 queries)."""
    m, width = idx.shape
    parts = width // LANE
    if parts == 1:
        return idx, score
    s = torch.where(torch.isnan(score), torch.inf, score).view(m, parts, LANE)
    v = s.min(dim=1).values
    tie = torch.where(s == v[:, None], idx.view(m, parts, LANE), _I32_MAX)
    return tie.min(dim=1).values, v


def tier_candidates(q: torch.Tensor, r_ops, n: int, parts: int, precision: str):
    """B1's candidate contract by a tier's arithmetic over the operands
    the tier keeps: "highest" is B1 on the CUDA cores (its bf16 instance
    over a bf16 store's operand, upcast at the read), "bf16x3_presplit" is
    B12 over (hi, lo, rn), every other tier the tensor-core kernel over
    (r_op,)."""
    if precision == "bf16x3_presplit":
        return presplit_candidates(q, *r_ops, n, parts)
    (r_op,) = r_ops
    if precision == "highest":
        return fused_candidates(q, r_op, n, parts)
    return tensor_candidates(q, r_op, n, parts, precision)


def refine_candidates(q: torch.Tensor, r_ops, n: int, parts: int, precision: str):
    """The candidates a tier's pipeline refines: tier_candidates with the
    partitions merged to tpu_knn's 128 lanes (merge_partitions), for every
    tier."""
    return merge_partitions(*tier_candidates(q, r_ops, n, parts, precision))


def tier_candidates_plain(q: torch.Tensor, r_ops, n: int, parts: int, precision: str):
    """The plain version of tier_candidates' kernel for the tier."""
    if precision == "bf16x3_presplit":
        return presplit_candidates_plain(q, *r_ops, n, parts)
    if precision == "highest":
        return _lane_fold(norm_scores(q, r_ops[0], n), parts)
    return tensor_candidates_plain(q, r_ops[0], n, parts, precision)


# ---- the score error of a tier ------------------------------------------

#: f32's unit roundoff.
F32_UNIT = 2.0 ** -24


def f32_allowance(precision: str, k: int) -> float:
    """The score error of the f32 arithmetic every tier shares, relative to
    the set's largest |score|: u·(3 + 2·√N) for N roundings in f32 sums
    (the T·k16 products of the term list and the k of ‖r‖²; "highest" sums
    k products), a random walk of round-to-nearest errors at two standard
    deviations of its largest excursion."""
    k16 = round_up(k, 16)
    summed = k if precision == "highest" else len(term_list(precision, k)) * k16
    return F32_UNIT * (3.0 + 2.0 * math.sqrt(summed + k))


def tier_error_bound(precision: str, k: int) -> float:
    """The tier's nominal score error, relative to the largest |score| of
    the candidates it is measured over (score_errors) — the scale that
    `_refine_guarded`'s certificate reads (max |score| against
    select_cutoff, whose admitted error is cutoff·_TIER_EPS): the tier's
    `_TIER_EPS` (its split's representation error) plus f32_allowance.
    Without the latter no f32 result could meet packed3's 2^-26, below
    f32's own unit roundoff."""
    return _TIER_EPS.get(resolved_tier(precision, k), 2.0 ** -8) + f32_allowance(precision, k)


def tier_error_gate(precision: str, k: int, reference_err: float) -> float:
    """The error a kernel (or a port's plain version) may show for a tier:
    tier_error_bound, or where the tier's own arithmetic exceeds it on the
    data — the bf16x3 ladder at small k, whose dropped terms (q's and r's
    truncation, lo·lo, each up to 2^-16 of a term) do not average out over
    few coordinates — the reference arithmetic's error on the same data
    (``reference_err``: tpu_knn's `_score_tile`, or the plain version on
    the card) plus f32_allowance."""
    return max(tier_error_bound(precision, k), reference_err + f32_allowance(precision, k))


def score_errors(q: torch.Tensor, ref: torch.Tensor, idx: torch.Tensor,
                 score: torch.Tensor, chunk_elems: int = 1 << 25):
    """The score error of an (idx, score) candidate set over every
    reported candidate (idx < n), against s₆₄ = ‖r‖² − 2·q·r recomputed in
    f64 from the f32 queries and points (ref (n, k), the stored points
    upcast): (max |s − s₆₄| / max |s₆₄|, the gated measure of
    tier_error_bound; max |s − s₆₄| / M per candidate, M = ‖r‖² +
    2·Σ_d |q_d r_d| the magnitude of the score's terms; and max |s − s₆₄|
    itself)."""
    n = ref.shape[0]
    err_max, scale, worst_m = 0.0, 0.0, 0.0
    rows_per_chunk = max(1, chunk_elems // (idx.shape[1] * ref.shape[1]))
    for r0 in range(0, q.shape[0], rows_per_chunk):
        ii = idx[r0:r0 + rows_per_chunk].long()
        valid = ii < n
        if not bool(valid.any()):
            continue
        pts = ref[ii.clamp(max=n - 1)].double()                  # (rows, C, k)
        qd = q[r0:r0 + rows_per_chunk].double()[:, None, :]
        rr = (pts * pts).sum(dim=-1)
        prod = pts * qd
        s64 = rr - 2.0 * prod.sum(dim=-1)
        mag = rr + 2.0 * prod.abs().sum(dim=-1)
        err = torch.where(valid, (score[r0:r0 + rows_per_chunk].double() - s64).abs(), 0.0)
        err_max = max(err_max, float(err.max()))
        scale = max(scale, float(torch.where(valid, s64.abs(), 0.0).max()))
        worst_m = max(worst_m, float(torch.where(valid & (mag > 0), err / mag, 0.0).max()))
    return (err_max / scale if scale > 0 else 0.0), worst_m, err_max


def selection_slack(q: torch.Tensor, ref: torch.Tensor, idx: torch.Tensor, err_abs: float,
                    chunk_elems: int = 1 << 25) -> int:
    """The largest number, over the rows, of candidate lanes whose exact
    score (f64, as score_errors) lies within 2·err_abs of the row's exact
    minimum over the set. With scores off by at most err_abs, a lane can
    be ranked above a lane at the exact minimum only if it lies within
    that distance, so `_refine_guarded`'s top-T selection keeps every lane
    at the exact minimum wherever this count is at most T: the certified
    fast path is then exact on this candidate set at the measured error."""
    n = ref.shape[0]
    worst = 0
    rows_per_chunk = max(1, chunk_elems // (idx.shape[1] * ref.shape[1]))
    for r0 in range(0, q.shape[0], rows_per_chunk):
        ii = idx[r0:r0 + rows_per_chunk].long()
        valid = ii < n
        pts = ref[ii.clamp(max=n - 1)].double()
        qd = q[r0:r0 + rows_per_chunk].double()[:, None, :]
        s64 = torch.where(valid, (pts * pts).sum(dim=-1) - 2.0 * (pts * qd).sum(dim=-1),
                          torch.inf)
        near = s64 <= s64.min(dim=-1, keepdim=True).values + 2.0 * err_abs
        worst = max(worst, int(near.sum(dim=-1).max()))
    return worst
