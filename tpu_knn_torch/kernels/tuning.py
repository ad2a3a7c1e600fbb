"""Tile and launch-geometry selection (counterpart of tpu_knn/kernels/tuning.py).

`pick_tiles` is tpu_knn's policy, copied verbatim: the port keeps it
because it still fixes the prepared operand's n padding (NNIndex), so an
index's state carries across between the two packages unchanged. The
CUDA kernels do not use its tiles; they take their
launch geometry from the helpers below: `tiled_geometry` for the tiled
f32 kernels on B1's lanes (B1 "highest", B4, B3, and B1's AoS and
TMA-staged variants v3 and B10), `resident_geometry` for v6 (the same
kernel with the block's queries resident in shared memory),
`moments_geometry` for the same template over whole 256-column chunks
(B7), `sweep_geometry` for it over whole partitions (B5), and
`pick_parts` for the lane-per-thread kernels (B2, B6, B11).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

from tpu_knn_torch.utils.shapes import cdiv, round_up

#: f32 sublane granularity; lane granularity is 128.
SUBLANE = 8
LANE = 128

#: Max score-tile elements (tile_m * tile_n); 4 MB f32 measured safe.
SCORE_TILE_BUDGET = 1 << 20

#: Widest useful n tile (bandwidth-bound streaming).
MAX_TILE_N = 16384

#: Max elements of the (k_pad, tile_n) reference tile.
OPERAND_TILE_BUDGET = 1 << 18


def pick_tiles(k: int, m: int, n: int, tile_m: int | None = None,
               wide: bool = False) -> tuple[int, int]:
    """Return (tile_m, tile_n) — tpu_knn's policy, verbatim.

    wide: the caller's score matmul is the packed single-pass dot, whose
    bf16 operands leave room for 2x wider score tiles.
    """
    if tile_m is None:
        tile_m = min(512, round_up(m, SUBLANE))
    budget = SCORE_TILE_BUDGET
    if wide:
        budget *= 4
    tile_n = min(MAX_TILE_N, budget // tile_m)
    tile_n = min(tile_n, OPERAND_TILE_BUDGET // round_up(k, SUBLANE))
    tile_n = min(tile_n, round_up(n, LANE))
    tile_n = max(LANE, (tile_n // LANE) * LANE)
    return tile_m, tile_n


# ---- CUDA launch geometry -------------------------------------------

#: Streaming multiprocessors of one H100 SXM. Blocks of the candidate
#: kernels run in parallel with no carry between them, so the n sweep is
#: cut into partitions until the launch fills the card.
H100_SMS = 132

#: Shared memory of an SM, what the system keeps of it per resident block,
#: and what one block can address (csrc knn_common.cuh kSmemPerSm,
#: kSmemPerBlockReserved, kSmemPerBlock).
SMEM_PER_SM = 233472
SMEM_PER_BLOCK_RESERVED = 1024
SMEM_PER_BLOCK = 232448

#: The card hands a block its shared memory in units of this many bytes,
#: and ptxas lays a kernel's static shared memory out in units of
#: SMEM_STATIC_UNIT (its -v report).
SMEM_ALLOC_UNIT = 128
SMEM_STATIC_UNIT = 16


def pick_parts(m_tiles: int, n: int, blocks_per_sm: int) -> int:
    """Number of n-partitions P for a candidate launch of ``m_tiles`` row
    tiles: enough that the grid has ``blocks_per_sm`` blocks per SM,
    never more than one 128-column group per partition."""
    want = cdiv(blocks_per_sm * H100_SMS, m_tiles)
    return max(1, min(cdiv(n, LANE), want))


# ---- the tiled f32 kernels (B1 "highest", B4, v3, v6, B10, B3, B7) ------
# What tiled_geometry needs of their fixed shape (csrc/tiled.cuh):
# blocks of TILED_WARPS warps, warp w owning TM query rows and thread c one
# of TILED_SLICE_LANES lanes of a partition (a block covers a quarter of
# the 128), each thread a TM x TILED_TILE_GROUPS register micro-tile, so a
# column tile is TILED_TILE_GROUPS of the partition's 128-column groups.
# B7 gives a column tile one contiguous MOMENT_CHUNK-column chunk instead.
# Their shared memory does not depend on k, and the kernels' source checks
# at compile time that TILED_BLOCKS_PER_SM blocks of it fit an SM; only
# v6's resident queries add k-dependent bytes (resident_geometry).

TILED_WARPS = 8
TILED_SLICE_LANES = 32
TILED_TILE_GROUPS = 8

#: Rows per warp the kernels are built for (with_tiled_rows).
TILED_ROWS = (1, 4, 8)

#: Columns of one of B7's column tiles: its partitions are whole chunks.
MOMENT_CHUNK = TILED_TILE_GROUPS * TILED_SLICE_LANES

#: Blocks of 8 warps resident per SM (the kernel's __launch_bounds__).
TILED_BLOCKS_PER_SM = 2

#: The ring (csrc tiled.cuh): TILED_STAGES stages of a TILED_CHUNK-row
#: chunk of a column tile, beside the block's queries unless they are
#: resident (v6).
TILED_CHUNK = 16
TILED_STAGES = 3

#: tiled_geometry takes the smallest P whose modelled time is within this
#: share of the least.
TILED_COST_SLACK = 0.05


class TiledGeometry(NamedTuple):
    """A launch of the tiled kernel: TM rows per warp (TILED_WARPS * TM
    per block) and the partition count P."""
    tm: int
    parts: int


def tiled_blocks(m: int, tm: int, parts: int) -> int:
    """Blocks of one launch: row tiles x partitions x lane quarters."""
    return cdiv(m, TILED_WARPS * tm) * parts * (LANE // TILED_SLICE_LANES)


def tiled_geometry(m: int, k: int, n: int) -> TiledGeometry:
    """Launch geometry of the tiled f32 kernel on B1's lanes (B1, B4, B3)
    at (m, k, n).

    TM: the fewest rows per warp that leave no warp's rows wholly padding
    where m allows it (1 for m <= 8, 4 for m <= 32, else 8); k only sets
    how many chunks a column tile takes, so it does not enter. P: the card
    runs TILED_BLOCKS_PER_SM * 132 blocks at once, all with the same work,
    so a launch takes ceil(blocks / that) waves of one block's work, and
    one block's work is its partition's column tiles; P minimises waves x
    tiles per block, within TILED_COST_SLACK of its minimum the smallest
    P (fewer candidates for the caller to merge)."""
    if min(m, k, n) < 1:
        raise ValueError(f"empty launch (m={m}, k={k}, n={n})")
    tm = _tiled_rows(m)
    return TiledGeometry(tm, _wave_parts(tiled_blocks(m, tm, 1), cdiv(n, LANE),
                                         TILED_TILE_GROUPS))


def candidates_state_bytes(tm: int, tma: bool = False) -> int:
    """Static shared memory of B1's (and v3's, v6's) block as ptxas lays it
    out (csrc TiledState<TM, false>: a column tile's |r|^2, the fold's
    (score, index) per (row, lane) of the block's quarter, and B4's
    one-word bound pair); with ``tma`` B10's (csrc TmaState<TM>: that and
    the TMA ring's 8-byte mbarrier, one a stage)."""
    words = TILED_WARPS * TILED_SLICE_LANES + 2 * TILED_WARPS * tm * TILED_SLICE_LANES + 2
    return round_up(4 * words + (8 * TILED_STAGES if tma else 0), SMEM_STATIC_UNIT)


def resident_ld(m: int, tm: int) -> int:
    """Row stride of a v6 block's resident queries (csrc resident_ld): its
    rows, at most TILED_WARPS * tm, rounded to whole float4s at tm >= 4."""
    rows = min(m, TILED_WARPS * tm)
    return rows if tm == 1 else round_up(rows, 4)


def resident_block_smem(m: int, k: int, tm: int) -> int:
    """Shared memory of one v6 block: its ring of operand chunks only (csrc
    TiledRing<TM, false, true>::kBytes), the resident queries (k rows, zero
    to a whole chunk) and B1's static state."""
    ring = 4 * TILED_STAGES * TILED_CHUNK * TILED_TILE_GROUPS * TILED_SLICE_LANES
    return ring + 4 * round_up(k, TILED_CHUNK) * resident_ld(m, tm) + candidates_state_bytes(tm)


def resident_blocks_per_sm(m: int, k: int, tm: int) -> int:
    """How many v6 blocks of (m, k, tm) one SM holds, at most
    TILED_BLOCKS_PER_SM; 0 where one exceeds what a block can address."""
    smem = resident_block_smem(m, k, tm)
    if smem > SMEM_PER_BLOCK:
        return 0
    return min(TILED_BLOCKS_PER_SM,
               SMEM_PER_SM // (round_up(smem, SMEM_ALLOC_UNIT) + SMEM_PER_BLOCK_RESERVED))


def resident_geometry(m: int, k: int, n: int) -> TiledGeometry:
    """Launch geometry of v6 (B1's tiled kernel with each block's query
    rows resident in shared memory) at (m, k, n): tiled_geometry's, except
    that TM is the largest of TILED_ROWS up to tiled_geometry's whose
    blocks still fit TILED_BLOCKS_PER_SM to an SM beside their resident
    rows. Where none does (m <= 8 near the guard, k*m <= 16384: a 64 KB
    resident block beside the 48 KB ring), TM is 1 at one block per SM,
    and P comes from the wave model at that rate."""
    if min(m, k, n) < 1:
        raise ValueError(f"empty launch (m={m}, k={k}, n={n})")
    top = _tiled_rows(m)
    fits = [t for t in sorted(TILED_ROWS, reverse=True)
            if t <= top and resident_blocks_per_sm(m, k, t) == TILED_BLOCKS_PER_SM]
    tm = fits[0] if fits else 1
    per_sm = resident_blocks_per_sm(m, k, tm)
    if per_sm < 1:
        raise ValueError(f"(m={m}, k={k}): one v6 block's resident queries exceed "
                         f"{SMEM_PER_BLOCK} bytes of shared memory")
    return TiledGeometry(tm, _wave_parts(tiled_blocks(m, tm, 1), cdiv(n, LANE),
                                         TILED_TILE_GROUPS, per_sm))


def moments_geometry(m: int, k: int, n_ops: int) -> TiledGeometry:
    """Launch geometry of B7 (the tiled template over whole MOMENT_CHUNK-
    column chunks of the (k_pad, n_ops) operand, one block per row tile and
    partition): TM as tiled_geometry picks it, and the partition count P
    that minimises waves x chunks per block as there."""
    if min(m, k, n_ops) < 1:
        raise ValueError(f"empty launch (m={m}, k={k}, n_ops={n_ops})")
    tm = _tiled_rows(m)
    return TiledGeometry(tm, _wave_parts(cdiv(m, TILED_WARPS * tm), cdiv(n_ops, MOMENT_CHUNK), 1))


#: Rows per warp B5 is built for: at 8 its K-list fold beside the 64
#: scores a thread holds needs more registers than two blocks per SM leave.
SWEEP_ROWS = (1, 4)


def sweep_geometry(m: int, k: int, n: int) -> TiledGeometry:
    """Launch geometry of B5 (the tiled template with a K-list fold, one
    block per row tile and partition of whole 128-column groups, swept as
    256-column tiles): TM as tiled_geometry picks it, at most
    max(SWEEP_ROWS), and the partition count P that minimises waves x
    tiles per block as there. P is also the number of lists per row
    (kselect.cuh's list map)."""
    if min(m, k, n) < 1:
        raise ValueError(f"empty launch (m={m}, k={k}, n={n})")
    tm = min(_tiled_rows(m), max(SWEEP_ROWS))
    return TiledGeometry(tm, _wave_parts(cdiv(m, TILED_WARPS * tm), cdiv(n, LANE),
                                         MOMENT_CHUNK // LANE))


# ---- the K-selection of B5 and B6 (csrc kselect.cuh) -------------------

#: Slots of one (row, list)'s sorted list and of its queue.
KSELECT_LIST_SLOTS = 32
KSELECT_QUEUE_SLOTS = 32


def kselect_state_bytes(rows: int) -> int:
    """KSelectState<ROWS>: each of `rows` lists' (score, column) slots and
    queue slots, its queue count and its bound (a score and a column)."""
    return 4 * rows * (2 * KSELECT_LIST_SLOTS + 2 * KSELECT_QUEUE_SLOTS + 3)


def sweep_state_bytes(tm: int) -> int:
    """Static shared memory of a B5 block as ptxas lays it out (csrc
    SweepState<TM>: a column tile's |r|^2 and the K-selection of its
    TILED_WARPS * tm rows)."""
    return round_up(4 * TILED_TILE_GROUPS * TILED_SLICE_LANES
                    + kselect_state_bytes(TILED_WARPS * tm),
                    SMEM_STATIC_UNIT)


def smallm_topk_state_bytes(m: int, kmax: int) -> int:
    """Static shared memory of a B6 block of m rows (csrc
    smallm_kselect_kernel<M, KMAX>): the queries padded to kmax, and each
    of its 4 warps' K-selection of the m rows."""
    return round_up(4 * m * kmax + kselect_state_bytes(LANE // 32 * m), SMEM_STATIC_UNIT)


# ---- the wide-load scans B11 and B2-bf16 (csrc window_kernels.cu,
# smallm_kernels.cu): a thread owns v lanes of a group, a block reads v
# groups side by side and merges their lane folds in shared memory.


def window_state_bytes(v: int) -> int:
    """Static shared memory of a B11 block at load width v (csrc
    window_candidates_kernel<V>): the v slots' (max, column) merge of 128
    lanes; none at v = 1 (one slot). The queries are dynamic."""
    return 0 if v == 1 else round_up(8 * v * LANE, SMEM_STATIC_UNIT)


#: Threads of a B2-bf16 block (csrc kBf16Threads): 2v groups side by side.
SMALLM_BF16_THREADS = 256


def smallm_bf16_state_bytes(m: int, v: int) -> int:
    """Static shared memory of a B2-bf16 block of m rows at load width v
    (csrc smallm_bf16_candidates_kernel<M, V>): the queries as one float4
    per coordinate up to k = 32, and the (min, column) merge of m rows x
    128 lanes from each of its SMALLM_BF16_THREADS * v / 128 slots."""
    slots = SMALLM_BF16_THREADS * v // LANE
    return round_up(16 * 32 + 8 * slots * m * LANE, SMEM_STATIC_UNIT)


def smallm_bf16_topk_state_bytes(m: int, v: int) -> int:
    """Static shared memory of a B6-bf16 block of m rows at load width v
    (csrc smallm_bf16_kselect_kernel<M, V>): B2-bf16's queries (a float4
    per coordinate up to k = 32) and each of its SMALLM_BF16_THREADS / 32
    warps' K-selection of the m rows (the same at every v)."""
    return round_up(16 * 32 + kselect_state_bytes(SMALLM_BF16_THREADS // 32 * m),
                    SMEM_STATIC_UNIT)


def _tiled_rows(m: int) -> int:
    return 1 if m <= TILED_WARPS else 4 if m <= 4 * TILED_WARPS else 8


@functools.lru_cache(maxsize=None)
def _wave_parts(one_part: int, units: int, per_tile: int,
                per_sm: int = TILED_BLOCKS_PER_SM) -> int:
    """The partition count of a launch of one_part blocks per partition
    over `units` column units, per_tile of them to a column tile, at
    per_sm blocks to an SM: the smallest P whose waves x tiles per block
    is within TILED_COST_SLACK of the least."""
    per_wave = per_sm * H100_SMS
    costs = [cdiv(one_part * parts, per_wave) * cdiv(cdiv(units, parts), per_tile)
             for parts in range(1, min(units, 8 * cdiv(per_wave, one_part)) + 1)]
    least = min(costs)
    return 1 + next(p for p, c in enumerate(costs) if c <= least * (1 + TILED_COST_SLACK))
