"""Tile and launch-geometry selection (counterpart of tpu_knn/kernels/tuning.py).

`pick_tiles` is tpu_knn's policy, copied verbatim: the port keeps it
because it still fixes the prepared operand's n padding (NNIndex), so an
index's state carries across between the two packages unchanged. The
CUDA kernels do not use its tiles; they take their
launch geometry from the helpers below: `tiled_geometry` for the tiled
f32 kernels on B1's lanes (B1 "highest", B4 and B3), `moments_geometry`
for the same template over whole 256-column chunks (B7), `cuda_tile_m`
and `pick_parts` for the lane-per-thread kernels (B5, v3, v6, B10).
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

#: Shared memory one B1 block may use for its query tile (of the 227 KB
#: a Hopper block can address).
MAX_QUERY_SMEM = 200 * 1024


def cuda_tile_m(m: int, k: int) -> int:
    """Query rows per block of the fused candidate kernel (B1): 32 (each
    reference value loaded serves 32 FMAs), 8 for batches that 32 would
    mostly pad, 1 where even 8 rows of k floats exceed shared memory."""
    for tm in (32, 8, 1):
        if tm == 32 and m <= 8:
            continue
        if tm * k * 4 <= MAX_QUERY_SMEM:
            return tm
    raise ValueError(
        f"k={k} exceeds the fused kernel's shared-memory query tile "
        f"({MAX_QUERY_SMEM // 4} floats per row)")


def pick_parts(m_tiles: int, n: int, blocks_per_sm: int) -> int:
    """Number of n-partitions P for a candidate launch of ``m_tiles`` row
    tiles: enough that the grid has ``blocks_per_sm`` blocks per SM,
    never more than one 128-column group per partition."""
    want = cdiv(blocks_per_sm * H100_SMS, m_tiles)
    return max(1, min(cdiv(n, LANE), want))


# ---- the tiled f32 kernels (B1 "highest", B4, B3, B7) -------------------
# What tiled_geometry needs of their fixed shape (csrc/tiled.cuh):
# blocks of TILED_WARPS warps, warp w owning TM query rows and thread c one
# of TILED_SLICE_LANES lanes of a partition (a block covers a quarter of
# the 128), each thread a TM x TILED_TILE_GROUPS register micro-tile, so a
# column tile is TILED_TILE_GROUPS of the partition's 128-column groups.
# B7 gives a column tile one contiguous MOMENT_CHUNK-column chunk instead.
# Their shared memory does not depend on k, and the kernels' source checks
# at compile time that TILED_BLOCKS_PER_SM blocks of it fit an SM.

TILED_WARPS = 8
TILED_SLICE_LANES = 32
TILED_TILE_GROUPS = 8

#: Rows per warp the kernels are built for (with_tiled_rows).
TILED_ROWS = (1, 4, 8)

#: Columns of one of B7's column tiles: its partitions are whole chunks.
MOMENT_CHUNK = TILED_TILE_GROUPS * TILED_SLICE_LANES

#: Blocks of 8 warps resident per SM (the kernel's __launch_bounds__).
TILED_BLOCKS_PER_SM = 2

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


def moments_geometry(m: int, k: int, n_ops: int) -> TiledGeometry:
    """Launch geometry of B7 (the tiled template over whole MOMENT_CHUNK-
    column chunks of the (k_pad, n_ops) operand, one block per row tile and
    partition): TM as tiled_geometry picks it, and the partition count P
    that minimises waves x chunks per block as there."""
    if min(m, k, n_ops) < 1:
        raise ValueError(f"empty launch (m={m}, k={k}, n_ops={n_ops})")
    tm = _tiled_rows(m)
    return TiledGeometry(tm, _wave_parts(cdiv(m, TILED_WARPS * tm), cdiv(n_ops, MOMENT_CHUNK), 1))


def _tiled_rows(m: int) -> int:
    return 1 if m <= TILED_WARPS else 4 if m <= 4 * TILED_WARPS else 8


@functools.lru_cache(maxsize=None)
def _wave_parts(one_part: int, units: int, per_tile: int) -> int:
    """The partition count of a launch of one_part blocks per partition
    over `units` column units, per_tile of them to a column tile: the
    smallest P whose waves x tiles per block is within TILED_COST_SLACK of
    the least."""
    per_wave = TILED_BLOCKS_PER_SM * H100_SMS
    costs = [cdiv(one_part * parts, per_wave) * cdiv(cdiv(units, parts), per_tile)
             for parts in range(1, min(units, 8 * cdiv(per_wave, one_part)) + 1)]
    least = min(costs)
    return 1 + next(p for p, c in enumerate(costs) if c <= least * (1 + TILED_COST_SLACK))
