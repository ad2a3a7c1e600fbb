"""v8 — reference-set sharding over a mesh of devices (counterpart of
tpu_knn/distributed/sharded.py).

tpu_knn shards the points over the mesh's reference axes with
`shard_map`, runs the single-chip pipeline per shard, rebases each
shard's local indices by its offset and reduces over the mesh. The port
keeps every piece and name, in one process over `distributed.mesh.Mesh`:

- sharding: a ("dp", "sp") mesh: queries data-parallel over "dp" (the
  batch padded to dp·8 rows and cut into dp blocks), the points sharded
  over "sp"; a ("dcn", "dp", "sp") mesh shards them over ("dcn", "sp"),
  [dcn-major, sp-minor] along n.
- per-shard compute: the port's single-device pipelines, at the tier of
  the global n (`auto_precision(k, n)`; "qsplit2" over bf16-exact
  operands): B1's tier kernel + the exact refinement for 1-NN
  (`tiers.refine_candidates`, `fused._refine`), the top-K engines of
  kernels/topk.py, and for int8 grid shards at m <= 4 the masked AoS
  scans. Each shard's work runs under its own device. A shard scans its
  live columns only (n_local, or fewer on a trailing shard); one with
  none contributes (+inf, INT32_MAX) without a launch. Padding rows hold
  PAD_VALUE (engine/index.py's, tpu_knn's), which every kernel scores
  +inf (a mutable index's empty slots are such rows).
- index rebase: idx + shard_id · n_local, per query row.
- reduction: distributed/collectives.py over "sp", then over "dcn".

Every 1-NN pipeline enqueues all shards' candidate kernels before the
first host read (the guarded refinement's certificate), so the cards of
a mesh of distinct cards work at once. Answers come back on the mesh's
first device.

Adaptive dispatch as in tpu_knn: v8 delegates to v7 on one device
(`_v8_guard` counts distinct CUDA devices) and at small n.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from tpu_knn_torch.distributed.collectives import min_index_allreduce, topk_allreduce
from tpu_knn_torch.distributed.mesh import (
    Mesh, ShardedArray, axis_sizes, on_device, positions, shard_devices,
)
from tpu_knn_torch.engine.index import PAD_VALUE, _pad_like
from tpu_knn_torch.engine.registry import register_version
from tpu_knn_torch.kernels.fused import _refine, auto_precision, prep_soa, select_cutoff
from tpu_knn_torch.kernels.tuning import LANE, pick_tiles
from tpu_knn_torch.utils.platform import as_f32_pair
from tpu_knn_torch.utils.shapes import cdiv, round_up

_I32_MAX = 2**31 - 1


#: Below this reference-set size, delegate to the single-device path —
#: the reference's `n <= min(2^18, m << 10)` guard (core.cu:871-872).
def _small_n(k: int, m: int, n: int) -> bool:
    return n <= min(1 << 18, m << 10)


def _mesh_devices(devices, count: int | None) -> list:
    """The device list of a new mesh: every visible card, one each (None),
    ``count`` logical shards on one device (a device), or the sequence
    given."""
    if devices is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
            raise RuntimeError("default_mesh: no CUDA card is visible; pass devices= (for "
                               "example devices='cpu') for a mesh on another device")
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if isinstance(devices, (str, torch.device)):
        return [torch.device(devices)] * (count or 1)
    return [torch.device(d) for d in devices]


def _grid(devs: list, shape: tuple):
    need = int(np.prod(shape))
    if min(shape) < 1 or need > len(devs):
        raise ValueError(f"a mesh of shape {shape} needs {need} devices, got {len(devs)}")
    arr = np.empty(need, dtype=object)
    arr[:] = devs[:need]
    return arr.reshape(shape)


def default_mesh(dp: int = 1, sp: int | None = None, devices=None) -> Mesh:
    """Mesh ("dp", "sp") = (queries, points). ``devices``: None for every
    visible card, one each (raises where none is visible); one device for
    dp·sp logical shards on it (sp then defaults to 1); or a sequence."""
    devs = _mesh_devices(devices, dp * sp if sp is not None else dp)
    if sp is None:
        sp = len(devs) // dp
    return Mesh(_grid(devs, (dp, sp)), ("dp", "sp"))


def multislice_mesh(dcn: int, dp: int = 1, sp: int | None = None, devices=None) -> Mesh:
    """3-axis mesh ("dcn", "dp", "sp"): the points shard hierarchically over
    (dcn, sp) and the reduction runs in two stages, over "sp" then over
    "dcn". tpu_knn's "dcn" axis is logical on one slice; so it is here on
    one host. ``devices`` as default_mesh's."""
    devs = _mesh_devices(devices, dcn * dp * sp if sp is not None else dcn * dp)
    if sp is None:
        sp = len(devs) // (dcn * dp)
    return Mesh(_grid(devs, (dcn, dp, sp)), ("dcn", "dp", "sp"))


def _sweep_tiles(k: int, m: int, n: int, kk: int) -> tuple[int, int]:
    """tpu_knn's sweep tile geometry (kernels/topk.py `_sweep_tiles`): the
    1-NN table shrunk until the per-lane K-state fits its VMEM budget. The
    port's B5 has no tiles; the geometry only sets the sharded layout."""
    tile_m, tile_n = pick_tiles(k, m, n)

    def vmem(tm, tn):
        return 3 * kk * tm * 1024 + 8 * tm * tn

    while tile_m > 8 and vmem(tile_m, tile_n) > (10 << 20):
        tile_m = max(8, ((tile_m // 2) // 8) * 8)
    while tile_n > 512 and vmem(tile_m, tile_n) > (10 << 20):
        tile_n //= 2
    return max(8, tile_m), tile_n


def sharded_layout(n: int, k: int, mesh: Mesh, m_hint: int = 1024):
    """The (tile_n, n_local, n_pad) of a prepared sharded reference array:
    tpu_knn's `_build_sharded` tile choice at a batch of ``m_hint``."""
    _, dp, _ = axis_sizes(mesh)
    num_shards = _num_shards(mesh)
    _, tile_n = pick_tiles(k, round_up(m_hint, dp * 8) // dp, cdiv(n, num_shards),
                           wide=auto_precision(k, n) == "packed")
    n_local = round_up(cdiv(n, num_shards), tile_n)
    return tile_n, n_local, n_local * num_shards


def int8_sharded_layout(n: int, mesh: Mesh) -> tuple[int, int]:
    """(n_local, n_pad) of an int8 grid over the mesh's reference axes:
    128-row granularity. Padding rows are excluded by position (an int8
    value cannot be made to lose)."""
    num_shards = _num_shards(mesh)
    n_local = round_up(cdiv(n, num_shards), 128)
    return n_local, n_local * num_shards


def _num_shards(mesh: Mesh) -> int:
    dcn, _, sp = axis_sizes(mesh)
    return dcn * sp


def _shard_id_and_live(n: int, n_local: int, sp: int, dcn_i: int, sp_i: int):
    """(global shard id, live row count) of the shard at (dcn_i, sp_i):
    [dcn-major, sp-minor] layout along n, the ragged tail counted out."""
    shard_id = sp_i + dcn_i * sp
    return shard_id, int(np.clip(n - shard_id * n_local, 0, n_local))


# ---- placement ----------------------------------------------------------


def place_rows(mesh: Mesh, ref, n_local: int, dtype, fill=PAD_VALUE) -> ShardedArray:
    """Rows of ``ref`` ((n, k), NumPy or a tensor on any device) as a
    sharded (num_shards · n_local, k) array of ``dtype``: shard s holds rows
    [s · n_local, (s + 1) · n_local), the rows past n ``fill``."""
    n, k = ref.shape
    blocks = []
    for s in range(_num_shards(mesh)):
        dev = shard_devices(mesh, s)[0]
        block = torch.full((n_local, k), fill, dtype=dtype, device=dev)
        lo, hi = s * n_local, min(n, (s + 1) * n_local)
        if hi > lo:
            rows = ref[lo:hi]
            rows = torch.from_numpy(np.array(rows)) if isinstance(rows, np.ndarray) else rows
            block[: hi - lo] = rows.to(dev).to(dtype)
        blocks.append(block)
    return ShardedArray(mesh, blocks, axis=0)


def soa_block(block: torch.Tensor) -> torch.Tensor:
    """A shard's (k_pad, n_local) SoA operand of its (n_local, k) rows: the
    zero-padded transpose, a PAD_VALUE row PAD_VALUE in every row of its
    column (the port's layout of a PAD column)."""
    r_op = prep_soa(block, block.shape[0])
    if block.dtype.is_floating_point:
        pad = (block == _pad_like(block)).all(dim=1)
        if bool(pad.any()):
            r_op[:, pad] = _pad_like(r_op)
    return r_op


def place_soa(aos: ShardedArray) -> ShardedArray:
    """The SoA operand of a sharded row array, block by block."""
    return ShardedArray(aos.mesh, [soa_block(aos.block(s)) for s in range(aos.num_shards)],
                        axis=1)


# ---- the per-shard pipelines ----------------------------------------------


def _query_blocks(search: torch.Tensor, m_pad: int, dp: int):
    """The batch zero-padded to m_pad rows and cut into dp blocks."""
    m = search.shape[0]
    if m_pad != m:
        search = torch.cat([search, search.new_zeros((m_pad - m, search.shape[1]))])
    return list(search.split(m_pad // dp))


def _local_queries(q_blocks, mesh: Mesh):
    """Each position's query block on its device, moved once per (block,
    device)."""
    cache = {}
    for _, d, _, _, dev in positions(mesh):
        if (d, dev) not in cache:
            cache[d, dev] = q_blocks[d].to(dev)
    return cache


def _dead_pair(shape, device):
    return (torch.full(shape, torch.inf, dtype=torch.float32, device=device),
            torch.full(shape, _I32_MAX, dtype=torch.int32, device=device))


def _reduce(mesh: Mesh, partial: dict, reducer):
    """Reduce the per-position (d2, gidx) pairs over "sp", then over "dcn"
    (every position's result replicated, as tpu_knn's). Returns each dp
    block's pair, on its first position's device."""
    dcn, dp, sp = axis_sizes(mesh)
    stages = [[[(c, d, s) for s in range(sp)] for c in range(dcn) for d in range(dp)]]
    if dcn > 1:
        stages.append([[(c, d, s) for c in range(dcn)] for d in range(dp) for s in range(sp)])
    for groups in stages:
        for keys in groups:
            d2s, idxs = reducer([partial[key][0] for key in keys],
                                [partial[key][1] for key in keys])
            partial.update(zip(keys, zip(d2s, idxs)))
    return [partial[0, d, 0] for d in range(dp)]


def _answer(mesh: Mesh, blocks, m: int):
    """The dp blocks' (d2, gidx) concatenated on the mesh's first device,
    the padded rows cut: (idx, d2)."""
    home = mesh.home
    d2 = torch.cat([b[0].to(home) for b in blocks])[:m]
    idx = torch.cat([b[1].to(home) for b in blocks])[:m]
    return idx, d2


def _sharded_1nn(mesh, q_blocks, operands, n: int, n_local: int, precision: str,
                 cutoff: float, method: str, m: int):
    """The 1-NN pipeline over every position: the tier's candidate kernel
    on each shard (all enqueued first), then each shard's exact refinement,
    the rebase and the reduction. ``operands(shard, device)`` gives the
    shard's (rows, r_ops) there."""
    from tpu_knn_torch.kernels.tiers import refine_candidates, tier_parts

    _, _, sp = axis_sizes(mesh)
    qs = _local_queries(q_blocks, mesh)
    m_local = q_blocks[0].shape[0]
    k = q_blocks[0].shape[1]
    staged = {}
    for c, d, s_i, _, dev in positions(mesh):
        shard, live = _shard_id_and_live(n, n_local, sp, c, s_i)
        if live:
            with on_device(dev):
                rows, r_ops = operands(shard, dev)
                cand = refine_candidates(qs[d, dev], r_ops, live,
                                         tier_parts(precision, m_local, k, live), precision)
            staged[c, d, s_i] = (rows, cand, live, shard)
    partial = {}
    for c, d, s_i, _, dev in positions(mesh):
        if (c, d, s_i) not in staged:
            partial[c, d, s_i] = _dead_pair((m_local,), dev)
            continue
        rows, cand, live, shard = staged.pop((c, d, s_i))
        with on_device(dev):
            idx, d2 = _refine(qs[d, dev], rows, cand, live, cutoff=cutoff)
            partial[c, d, s_i] = (d2, idx + shard * n_local)
    blocks = _reduce(mesh, partial, functools.partial(min_index_allreduce, method=method))
    return _answer(mesh, blocks, m)


def _sharded_topk(mesh, q_blocks, local_topk, n: int, n_local: int, kk: int, m: int):
    """The top-K pipeline over every position: ``local_topk(shard, device,
    q, live)`` -> the shard's local (idx, d2) lists (idx < 0 or d2 = +inf
    dead), rebased, padded to the merge width, merged over the mesh."""
    _, _, sp = axis_sizes(mesh)
    qs = _local_queries(q_blocks, mesh)
    m_local = q_blocks[0].shape[0]
    partial = {}
    for c, d, s_i, _, dev in positions(mesh):
        shard, live = _shard_id_and_live(n, n_local, sp, c, s_i)
        if not live:
            partial[c, d, s_i] = _dead_pair((m_local, kk), dev)
            continue
        with on_device(dev):
            idx, d2 = local_topk(shard, dev, qs[d, dev], live)
            dead = (idx < 0) | torch.isinf(d2)
            gidx = torch.where(dead, _I32_MAX, idx + shard * n_local).to(torch.int32)
            d2 = torch.where(dead, torch.inf, d2)
            if gidx.shape[1] < kk:   # a clamped local list -> the merge width
                fill = _dead_pair((m_local, kk - gidx.shape[1]), dev)
                gidx = torch.cat([gidx, fill[1]], dim=1)
                d2 = torch.cat([d2, fill[0]], dim=1)
            partial[c, d, s_i] = (d2, gidx)
    blocks = _reduce(mesh, partial, functools.partial(topk_allreduce, kk=kk))
    idx, d2 = _answer(mesh, blocks, m)
    return torch.where(idx == _I32_MAX, -1, idx), d2


def _percall_operands(ref: torch.Tensor, n: int, n_local: int, mesh: Mesh):
    """operands(shard, device) of a per-call (n, k) array: the shard's live
    rows moved to the device once, and their SoA operand n_local wide."""
    cache = {}

    def operands(shard, dev):
        if (shard, dev) not in cache:
            rows = ref[shard * n_local: min(n, (shard + 1) * n_local)].to(dev)
            cache[shard, dev] = rows, (prep_soa(rows, n_local),)
        return cache[shard, dev]

    return operands


def _prepared_operands(aos: ShardedArray, soa: ShardedArray):
    def operands(shard, dev):
        return aos.local(shard, dev), (soa.local(shard, dev),)

    return operands


def _check_tier(precision: str) -> None:
    if precision == "bf16x3_presplit":
        raise ValueError("the sharded tier keeps plain operands: precision="
                         "'bf16x3_presplit' serves the fused strategy only")


def _check_prepared(ops: ShardedArray, mesh: Mesh, n_local: int) -> None:
    if ops.mesh != mesh or ops.width != n_local:
        raise ValueError(f"prepared operands of width {ops.width} on {ops.mesh} do not fit "
                         f"n_local={n_local} on {mesh}")


@functools.lru_cache(maxsize=None)
def _build_sharded(m: int, n: int, k: int, mesh: Mesh, method: str = "pmin",
                   tile_n: int | None = None, prepadded: bool = False,
                   precision: str | None = None):
    """Mesh-sharded exact 1-NN pipeline for (m, k) queries over n points.
    Returns run(search, ref) -> (idx (m,) int32, d2 (m,) f32) on the mesh's
    first device. ``ref``: the (n, k) points (any device; each shard's rows
    move to its devices per call), or with ``prepadded`` the (aos, soa)
    pair of ShardedArrays NNIndex prepares (n_local wide: PAD_VALUE rows
    past n). The tier is the global n's; ``tile_n`` fixes the layout."""
    dcn, dp, sp = axis_sizes(mesh)
    num_shards = dcn * sp
    m_pad = round_up(m, dp * 8)
    m_local = m_pad // dp
    if precision is None:
        precision = auto_precision(k, n)
    _check_tier(precision)
    _, auto_tile_n = pick_tiles(k, m_local, cdiv(n, num_shards), wide=precision == "packed")
    tile_n = tile_n or auto_tile_n
    n_local = round_up(cdiv(n, num_shards), tile_n)
    cutoff = select_cutoff(precision, k)

    def run(search, ref):
        if prepadded:
            aos, soa = ref
            _check_prepared(aos, mesh, n_local)
            operands = _prepared_operands(aos, soa)
        else:
            operands = _percall_operands(ref, n, n_local, mesh)
        return _sharded_1nn(mesh, _query_blocks(search, m_pad, dp), operands, n, n_local,
                            precision, cutoff, method, m)

    run.n_local = n_local
    return run


@functools.lru_cache(maxsize=None)
def _build_sharded_topk(m: int, n: int, k: int, kk: int, mesh: Mesh,
                        topk_method: str = "auto", n_local: int | None = None,
                        prepadded: bool = False, precision: str | None = None):
    """Mesh-sharded exact top-K: each shard's single-device top-K engine
    (kernels/topk.py, its method by tpu_knn's m·K rule at the shard's batch
    block), the global rebase, then the top-K merge over "sp" and "dcn".
    A shard with fewer live rows than K contributes its whole clamped
    list, padded with +inf to the merge width. ``prepadded``: run(search,
    ref, r_ops) over NNIndex's ShardedArrays, ``n_local`` their width.
    Returns run -> (idx (m, kk) int32, d2 (m, kk) f32), rows ascending by
    exact (d2, index)."""
    from tpu_knn_torch.kernels.topk import _auto_method, _build_topk

    dcn, dp, sp = axis_sizes(mesh)
    num_shards = dcn * sp
    m_pad = round_up(m, dp * 8)
    m_local = m_pad // dp
    if precision is None:
        precision = auto_precision(k, n)
    _check_tier(precision)
    method = _auto_method(m_local, kk) if topk_method == "auto" else topk_method
    if n_local is None:
        if method == "sweep":
            _, tile_n = _sweep_tiles(k, m_local, cdiv(n, num_shards), kk)
        else:
            _, tile_n = pick_tiles(k, m_local, cdiv(n, num_shards))
        n_local = round_up(cdiv(n, num_shards), tile_n)
    elif n_local * num_shards < n or n_local % LANE != 0:
        raise ValueError(f"prepared n_local={n_local} incompatible with "
                         f"n={n} over {num_shards} shards")
    kk_local = min(kk, n_local)

    def run(search, ref, r_ops=None):
        if prepadded:
            _check_prepared(ref, mesh, n_local)
            operands = _prepared_operands(ref, r_ops)
        else:
            operands = _percall_operands(ref, n, n_local, mesh)

        def local_topk(shard, dev, q, live):
            rows, ops = operands(shard, dev)
            return _build_topk(m_local, live, k, min(kk_local, live), n_local, method,
                               precision)(q, ops, rows)

        return _sharded_topk(mesh, _query_blocks(search, m_pad, dp), local_topk, n, n_local,
                             kk, m)

    run.n_local = n_local
    return run


def sharded_topk_knn(search, ref, neighbors: int, *, mesh: Mesh | None = None,
                     method: str = "auto", device="cuda"):
    """Mesh-sharded exact top-K. Returns (idx (m, K) int32, d2 (m, K) f32)
    on the mesh's first device, rows ascending by exact (d2, index).
    ``method`` picks the per-shard engine ("sweep"/"passes"/"seeded"/
    "auto"). NumPy inputs go to ``device``, then to the shards; the mesh
    defaults to default_mesh()."""
    from tpu_knn_torch.kernels.topk import PASSES_MAX_NEIGHBORS

    search, ref = as_f32_pair(search, ref, device)
    m, k = search.shape
    n = ref.shape[0]
    if not (1 <= neighbors <= min(n, PASSES_MAX_NEIGHBORS)):
        raise ValueError(
            f"neighbors must be in [1, min(n, {PASSES_MAX_NEIGHBORS})] "
            f"= [1, {min(n, PASSES_MAX_NEIGHBORS)}], got {neighbors}")
    if mesh is None:
        mesh = default_mesh()
    return _build_sharded_topk(m, n, k, neighbors, mesh, method)(search, ref)


def sharded_knn(search, ref, *, mesh: Mesh | None = None, method: str = "pmin",
                device="cuda"):
    """Mesh-sharded exact 1-NN. Returns (idx (m,) int32, d2 (m,) f32) on the
    mesh's first device. NumPy inputs go to ``device``, then to the
    shards; the mesh defaults to default_mesh()."""
    search, ref = as_f32_pair(search, ref, device)
    m, k = search.shape
    n = ref.shape[0]
    if mesh is None:
        mesh = default_mesh()
    return _build_sharded(m, n, k, mesh, method)(search, ref)


# ---- int8 grid shards -------------------------------------------------------


def _int8_precision(k: int, n: int) -> str:
    precision = auto_precision(k, n)
    return "qsplit2" if precision == "bf16x3" else precision   # the grid is bf16-exact


def _grid_soa(grid: torch.Tensor) -> torch.Tensor:
    """A grid shard's per-call bf16 SoA operand (grid integers are exact in
    bf16), as the single-device int8 batch route builds it."""
    return prep_soa(grid.to(torch.bfloat16), grid.shape[0])


@functools.lru_cache(maxsize=None)
def _build_sharded_int8(m: int, n: int, k: int, n_local: int, mesh: Mesh,
                        method: str = "pmin", cutoff_scale: float = 1.0):
    """Mesh-sharded exact 1-NN over an int8 grid (each shard holds only its
    (n_local, k) int8 rows). Queries arrive in grid space and d2 leave in
    grid units. m <= 4·dp: the masked AoS scan straight off each int8
    shard; batches: each shard's per-call bf16 operand through the tier's
    candidate kernel + the exact refinement, the certificate rescaled to
    grid units (``cutoff_scale`` = 1/s²). Padding rows are excluded by
    position. Returns run(search_grid, grid ShardedArray) -> (idx, d2)."""
    from tpu_knn_torch.kernels.smallm import SMALLM_MAX_M, _aos_scan

    dcn, dp, sp = axis_sizes(mesh)
    small = m <= SMALLM_MAX_M * dp
    m_pad = round_up(m, dp) if small else round_up(m, dp * 8)
    precision = _int8_precision(k, n)
    cutoff = select_cutoff(precision, k) * cutoff_scale

    def run(search_grid, grid):
        _check_prepared(grid, mesh, n_local)
        q_blocks = _query_blocks(search_grid, m_pad, dp)
        if not small:
            soas = {}

            def operands(shard, dev):
                if (shard, dev) not in soas:
                    soas[shard, dev] = (_grid_soa(grid.local(shard, dev)),)
                return grid.local(shard, dev), soas[shard, dev]

            return _sharded_1nn(mesh, q_blocks, operands, n, n_local, precision, cutoff,
                                method, m)
        qs = _local_queries(q_blocks, mesh)
        partial = {}
        for c, d, s_i, _, dev in positions(mesh):
            shard, live = _shard_id_and_live(n, n_local, sp, c, s_i)
            if not live:
                partial[c, d, s_i] = _dead_pair((m_pad // dp,), dev)
                continue
            with on_device(dev):
                idx, d2 = _aos_scan(qs[d, dev], grid.local(shard, dev), live=live)
                partial[c, d, s_i] = (d2, idx + shard * n_local)
        blocks = _reduce(mesh, partial, functools.partial(min_index_allreduce, method=method))
        return _answer(mesh, blocks, m)

    return run


@functools.lru_cache(maxsize=None)
def _build_sharded_int8_topk(m: int, n: int, k: int, kk: int, n_local: int, mesh: Mesh):
    """Mesh-sharded exact top-K over an int8 grid, in grid space: m <= 4·dp
    (and K <= MAX_NEIGHBORS) the masked AoS cell engine straight off each
    int8 shard; batches the batch engines over each shard's per-call bf16
    operand. Rebase and merge as _build_sharded_topk's; unfilled slots
    come back -1 / +inf."""
    from tpu_knn_torch.kernels.smallm import SMALLM_MAX_M
    from tpu_knn_torch.kernels.topk import (
        MAX_NEIGHBORS, _auto_method, _build_aos_topk, _build_topk,
    )

    dcn, dp, sp = axis_sizes(mesh)
    kk_local = min(kk, n_local)
    small = m <= SMALLM_MAX_M * dp and kk_local <= MAX_NEIGHBORS
    m_pad = round_up(m, dp) if small else round_up(m, dp * 8)
    m_local = m_pad // dp
    precision = _int8_precision(k, n)
    method = _auto_method(m_local, kk_local)

    def run(search_grid, grid):
        _check_prepared(grid, mesh, n_local)

        def local_topk(shard, dev, q, live):
            g = grid.local(shard, dev)
            if small:
                return _build_aos_topk(m_local, n_local, k, kk_local, masked=True)(q, g, live)
            return _build_topk(m_local, live, k, min(kk_local, live), n_local, method,
                               precision)(q, (_grid_soa(g),), g)

        return _sharded_topk(mesh, _query_blocks(search_grid, m_pad, dp), local_topk, n,
                             n_local, kk, m)

    return run


# ---- v8 ---------------------------------------------------------------------


def v8_callback(k, m, n, search, ref):
    """v8 over every visible card (default_mesh()); CPU tensors take v7
    (the port's CPU meshes are logical: one device)."""
    if search.device.type != "cuda":
        from tpu_knn_torch.engine.registry import get_version

        return get_version("v7").fn(k, m, n, search, ref)
    idx, _ = sharded_knn(search, ref)
    return idx.cpu().numpy().astype(np.int32)


def _v8_shape_ok(k: int, m: int, n: int, num: int) -> bool:
    """tpu_knn's guard over ``num`` devices: more than one, n not small,
    at least one point a shard."""
    return num > 1 and not _small_n(k, m, n) and n >= num


def _v8_guard(k: int, m: int, n: int) -> bool:
    # Delegate like the reference: one device or small n -> v7
    # (core.cu:865-872). The devices counted are distinct CUDA cards.
    return _v8_shape_ok(k, m, n, torch.cuda.device_count() if torch.cuda.is_available() else 0)


register_version(
    "v8",
    v8_callback,
    "multi-card reference-set sharding over a (dp, sp) mesh of cards: per-shard B1 "
    "tier kernel + exact refine, rebase, min-index reduction (reference v8, "
    "core.cu:790-959)",
    guard=_v8_guard,
    fallback="v7",
)
