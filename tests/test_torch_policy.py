"""The port's copies of tpu_knn's routing and tuning policy, pinned to the
originals over a grid of (k, m, n): routing cannot drift silently."""

import numpy as np
import pytest
import torch

from tpu_knn.engine import index as jx_index
from tpu_knn.engine import registry as jx_registry
from tpu_knn.kernels import dense as jx_dense
from tpu_knn.kernels import fused as jx_fused
from tpu_knn.kernels import smallm as jx_smallm
from tpu_knn.kernels import topk as jx_topk
from tpu_knn.kernels import tuning as jx_tuning
from tpu_knn.kernels import twolevel as jx_twolevel
from tpu_knn_torch.engine import index as pt_index
from tpu_knn_torch.engine import registry as pt_registry
from tpu_knn_torch.kernels import dense as pt_dense
from tpu_knn_torch.kernels import fused as pt_fused
from tpu_knn_torch.kernels import smallm as pt_smallm
from tpu_knn_torch.kernels import topk as pt_topk
from tpu_knn_torch.kernels import tuning as pt_tuning
from tpu_knn_torch.kernels import twolevel as pt_twolevel

KS = [1, 2, 3, 7, 8, 9, 15, 16, 17, 31, 32, 33, 40, 64, 128, 768, 2048]
MS = [0, 1, 2, 3, 4, 5, 8, 9, 100, 1000, 1024, 4096]
NS = [1, 2, 127, 128, 129, 1000, 4096, 4097, 65536, 100_000, 1 << 20, 1 << 24]
TIERS = ["packed", "packed3", "packed2", "bf16x3", "bf16x3_presplit", "bf16x4",
         "highest", "default", "qsplit2", "bf16_raw", "exact"]


@pytest.mark.parametrize("k", KS)
def test_precision_policy(k):
    k_pad = -(-k // 8) * 8
    assert pt_fused._packed_terms(k_pad) == jx_fused._packed_terms(k_pad)
    for n in NS:
        assert pt_fused.auto_precision(k, n) == jx_fused.auto_precision(k, n), n
    for tier in TIERS:
        assert pt_fused.select_cutoff(tier, k) == jx_fused.select_cutoff(tier, k), tier


def test_ported_tiers_and_term_lists():
    """PORTED_PRECISIONS are the tiers tpu_knn's fused path computes (the
    branches of `_qr_dot` and the presplit builder); each tier's term list
    is `_packed_terms`' for "packed" and sums, term by term in f64, to
    tpu_knn's `_qr_dot` to f32 rounding (a missing or extra hi·lo term,
    2^-9 of a product, would show)."""
    assert pt_fused.PORTED_PRECISIONS == {"packed", "bf16x3", "bf16x3_presplit", "bf16x4",
                                          "qsplit2", "highest", "default", "bf16_raw"}
    from tpu_knn_torch.kernels import tiers

    for k in KS:
        k_pad = -(-k // 8) * 8
        n_splits, pairs = jx_fused._packed_terms(k_pad)
        if n_splits:
            assert list(tiers.term_list("packed", k)) == pairs
        else:
            assert tiers.term_list("packed", k) == tiers.term_list("bf16x3", k)
    import torch

    rng = np.random.default_rng(0)
    for tier in ("bf16x3", "bf16x4", "qsplit2", "bf16_raw"):
        k = 40
        q = (rng.random((6, k), np.float32) + 0.5).astype(np.float32)
        r = (rng.random((k, 50), np.float32) + 0.5).astype(np.float32)
        if tier == "qsplit2":
            r = np.asarray(jx_fused._split_bf16(r)[0], np.float32)
        qp = [p.double().numpy() for p in tiers.split_bf16_3(torch.from_numpy(q))]
        rp = [p.double().numpy() for p in tiers.split_bf16_3(torch.from_numpy(r))]
        ours = sum(qp[i] @ rp[j] for i, j in tiers.term_list(tier, k))
        theirs = np.asarray(jx_fused._qr_dot(q, r, tier), np.float64)
        np.testing.assert_allclose(theirs, ours, rtol=4e-7)


@pytest.mark.parametrize("k", [3, 16, 24, 40, 128])
def test_index_tier_and_tile_follow_tpu_knn(k):
    """NNIndex's resolved tier (auto_precision, "qsplit2" for "bf16x3" over a
    quantized store) and its operand's tile (pick_tiles with wide= for the
    packed tier, where a fixed wide=False once padded n differently) equal
    tpu_knn's index's
    over a (k, n, store) grid."""
    import tpu_knn_torch
    from tpu_knn.engine.index import NNIndex as JaxIndex

    rng = np.random.default_rng(k)
    for n in (300, 5000, 40_000):
        r = rng.random((n, k), np.float32)
        for store in ("float32", "bf16", "int8"):
            jx = JaxIndex(r, store=store)
            ix = tpu_knn_torch.NNIndex(r, store=store, device="cpu")
            assert (ix.precision, ix.tile_n) == (jx.precision, jx.tile_n), (n, store)
            if store != "int8":
                assert ix.r_ops[0].shape == jx.r_ops[0].shape


def test_tier_constants():
    assert pt_fused._TIER_EPS == jx_fused._TIER_EPS
    assert pt_fused.SELECT_SCORE_CUTOFF == jx_fused.SELECT_SCORE_CUTOFF
    assert pt_fused.REFINE_TOP_T == jx_fused.REFINE_TOP_T
    # The port also treats "default" as selection-approximate (one bf16
    # pass, gate errors measured at ds11), where tpu_knn certifies it.
    assert pt_fused.UNCERTIFIED_PRECISIONS == jx_fused.UNCERTIFIED_PRECISIONS | {"default"}
    assert pt_smallm.SMALLM_MAX_M == jx_smallm.SMALLM_MAX_M
    assert pt_smallm.SMALLM_MAX_K == jx_smallm.SMALLM_MAX_K
    assert pt_smallm.AOS_SCAN_MAX_KPAD_WASTE_K == jx_smallm.AOS_SCAN_MAX_KPAD_WASTE_K
    assert pt_dense.DENSE_MAX_N == jx_dense.DENSE_MAX_N
    assert pt_dense.DENSE_MAX_ELEMS == jx_dense.DENSE_MAX_ELEMS
    assert pt_twolevel.DEFAULT_PARTITIONS == jx_twolevel.DEFAULT_PARTITIONS
    assert pt_registry.PREFERENCE_ORDER == jx_registry.PREFERENCE_ORDER


@pytest.mark.parametrize("k", KS)
def test_pick_tiles(k):
    for m in MS[1:]:
        for n in NS:
            for wide in (False, True):
                assert (pt_tuning.pick_tiles(k, m, n, wide=wide)
                        == jx_tuning.pick_tiles(k, m, n, wide=wide)), (m, n, wide)
            assert (pt_tuning.pick_tiles(k, m, n, tile_m=256)
                    == jx_tuning.pick_tiles(k, m, n, tile_m=256))


@pytest.mark.parametrize("k", KS)
def test_routing_predicates(k):
    for n in NS:
        if k <= pt_smallm.SMALLM_MAX_K:
            assert pt_smallm.pick_tile_n(k, n) == jx_smallm.pick_tile_n(k, n)
        for m in MS:
            args = (m, k, n)
            assert pt_smallm.smallm_applicable(*args) == jx_smallm.smallm_applicable(*args)
            assert pt_smallm.aos_scan_applicable(*args) == jx_smallm.aos_scan_applicable(*args)
            assert pt_dense.dense_applicable(*args) == jx_dense.dense_applicable(*args)


def test_m_bucket():
    got = [pt_index.NNIndex._m_bucket(m) for m in range(1, 5000)]
    want = [jx_index.NNIndex._m_bucket(m) for m in range(1, 5000)]
    assert got == want
    assert pt_index.NNIndex.bucket_m == jx_index.NNIndex.bucket_m


@pytest.mark.parametrize("kk", [1, 2, 7, 8, 16, 31, 32, 33, 64, 65, 128, 129, 256,
                                511, 512, 513, 1000])
def test_topk_auto_method(kk):
    for m in MS + [16, 17, 31, 32, 33, 64, 256, 257, 2048]:
        assert pt_topk._auto_method(m, kk) == jx_topk._auto_method(m, kk), m


def test_topk_constants():
    for name in ("MAX_NEIGHBORS", "PASSES_MAX_NEIGHBORS", "SWEEP_MAX_NEIGHBORS",
                 "SWEEP_AUTO_BUDGET", "SEEDED_MAX_NEIGHBORS"):
        assert getattr(pt_topk, name) == getattr(jx_topk, name), name


def _old_topk_width(m, kk, n):
    """Candidates per row of the lane-per-thread B5 and B6 this layout
    replaced: P partitions x a list of the bucket at or above K per lane
    (B5, 32/bucket rows a block at 4 blocks an SM), or of K (B6, as many
    blocks an SM as 200 KB of per-lane lists allowed, at most 4)."""
    if m > 4:
        kb = next(b for b in (4, 8, 16, 32) if kk <= b)
        return pt_tuning.pick_parts(-(-m // (32 // kb)), n, 4) * kb * 128
    per_sm = max(1, min(4, 200 * 1024 // (m * kk * 128 * 8)))
    return pt_tuning.pick_parts(1, n, per_sm) * kk * 128


def test_topk_launch_geometry():
    """B5 and B6 partition counts never exceed the 128-column groups of n,
    B5's is the tiled template's wave-model choice at its TM, and one list
    per (row, partition) makes the candidate width at the main path's
    shapes at most 1/32 of the lane-per-thread kernels'."""
    for n in NS:
        groups = -(-n // 128)
        for k in (1, 16, 17, 32):
            per_sm = pt_topk.B6_BLOCKS_PER_SM if k <= 16 else pt_topk.B6_WIDE_BLOCKS_PER_SM
            assert 1 <= pt_topk.smallm_topk_parts(n, k) == pt_tuning.pick_parts(
                1, n, per_sm) <= groups
        for m in (1, 5, 8, 9, 33, 64, 256, 1024):
            for k in (1, 16, 40, 768):
                g = pt_tuning.sweep_geometry(m, k, n)
                assert g.tm == min(4, pt_tuning.tiled_geometry(m, k, n).tm)
                assert g.tm in pt_tuning.SWEEP_ROWS
                assert 1 <= g.parts == pt_topk.sweep_parts(m, k, n) <= groups
    for m, n, kk in ((8, 1 << 20, 32), (32, 1 << 20, 8)):      # B5's main-path launches
        assert pt_topk.sweep_parts(m, 16, n) * kk * 32 <= _old_topk_width(m, kk, n)
    for m, n, kk in ((4, 1 << 24, 16), (3, 1 << 20, 8)):       # B6's
        assert pt_topk.smallm_topk_parts(n, 16) * kk * 32 <= _old_topk_width(m, kk, n)
    assert _old_topk_width(8, 32, 1 << 20) == 66 * 32 * 128
    assert _old_topk_width(4, 16, 1 << 24) == 396 * 16 * 128
    q, r_op = torch.zeros((5, 3)), torch.zeros((8, 256))
    with pytest.raises(ValueError, match="sweep"):
        pt_topk.sweep_candidates(q, r_op, 200, 1, pt_topk.SWEEP_MAX_NEIGHBORS + 1)


def test_topk_list_map():
    """topk.list_of is the partition map of the candidate kernels (column
    groups of 128, G = ceil(ceil(n/128)/P) to a partition): the list of
    every column, ascending with the column, below P."""
    for n in (1, 127, 128, 129, 1000, 4097, 100_000):
        groups = -(-n // 128)
        for parts in sorted({1, 2, 3, 7, groups}):
            if parts > groups:
                continue
            col = np.arange(n)
            gpp = -(-groups // parts)
            lists = pt_topk.list_of(col, n, parts)
            assert np.array_equal(lists, col // 128 // gpp)
            assert lists.max() < parts and np.all(np.diff(lists) >= 0)


def test_cuda_launch_geometry_covers_n():
    """The partition count never exceeds the 128-column groups of n, and
    the launch's work is within 5% of the same column tiles spread evenly
    over whole waves (v6's resident_geometry here, within v6's guard, at
    the blocks per SM its shared memory admits; B1's tiled_geometry
    below)."""
    for k in KS:
        for m in MS[1:]:
            if not pt_fused.const_query_fits(m, k):
                continue
            for n in NS:
                g = pt_tuning.resident_geometry(m, k, n)
                assert g.tm in pt_tuning.TILED_ROWS
                assert g.tm <= pt_tuning.tiled_geometry(m, k, n).tm
                groups = -(-n // 128)
                assert 1 <= g.parts <= groups
                per_wave = pt_tuning.resident_blocks_per_sm(m, k, g.tm) * pt_tuning.H100_SMS
                waves = -(-pt_tuning.tiled_blocks(m, g.tm, g.parts) // per_wave)
                per_block = -(-(-(-groups // g.parts)) // pt_tuning.TILED_TILE_GROUPS)
                tiles = -(-groups // pt_tuning.TILED_TILE_GROUPS)
                even = -(-pt_tuning.tiled_blocks(m, g.tm, 1) * tiles // per_wave)
                assert waves * per_block <= 1.05 * even, (m, k, n)
    assert np.all([pt_smallm.default_parts(n) <= -(-n // 128) for n in NS])
    from tpu_knn_torch.kernels import tiers

    for m in MS[1:]:
        for n in NS:
            assert 1 <= tiers.tensor_parts(m, n) <= -(-n // 128)
    # Two blocks per SM: 16 row tiles x 4 lane slices x 4 = 256 blocks, one
    # wave of the 264 slots, at ds11.
    assert tiers.tensor_parts(1024, 1 << 20) == 4
    # The tiled f32 kernel (B1 "highest", B4): every geometry is one of its
    # built instances (no other kernel serves B1 or B4) and the same at
    # every k (k only streams through the ring, so the launch and its
    # shared memory, which the kernel's source checks against 2 blocks per
    # SM when it is compiled, are those of k = 1), P stays within the
    # groups of n, and the launch's work (waves of 2 blocks per SM x column
    # tiles per block) is within 5% of the same column tiles spread evenly
    # over whole waves.
    per_wave = pt_tuning.TILED_BLOCKS_PER_SM * pt_tuning.H100_SMS
    for m in MS[1:]:
        for n in NS:
            groups = -(-n // 128)
            g = pt_tuning.tiled_geometry(m, 1, n)
            for k in KS:
                assert pt_tuning.tiled_geometry(m, k, n) == g
                assert pt_fused.tiled_parts(m, k, n) == g.parts
            assert g.tm in pt_tuning.TILED_ROWS
            # A smaller TM only where it would take more row tiles.
            assert all(m > pt_tuning.TILED_WARPS * t for t in pt_tuning.TILED_ROWS if t < g.tm)
            assert 1 <= g.parts <= groups
            tiles = -(-groups // pt_tuning.TILED_TILE_GROUPS)
            waves = -(-pt_tuning.tiled_blocks(m, g.tm, g.parts) // per_wave)
            per_block = -(-(-(-groups // g.parts)) // pt_tuning.TILED_TILE_GROUPS)
            even = -(-pt_tuning.tiled_blocks(m, g.tm, 1) * tiles // per_wave)
            assert waves * per_block <= 1.05 * even
    # Named shapes: ds11 and k = 768 take 16 row tiles of 64 x 4
    # partitions x 4 lane quarters = 256 blocks, one wave; the passes
    # engine's m = 64 and the m <= 8 per-call queries spread over many
    # partitions instead.
    for k in (16, 768):
        assert pt_tuning.tiled_geometry(1024, k, 1 << 20) == (8, 4)
    assert pt_tuning.tiled_geometry(64, 16, 1 << 20) == (8, 64)
    assert pt_tuning.tiled_geometry(100, 16, 1 << 20) == (8, 32)
    assert pt_tuning.tiled_geometry(16, 64, 1 << 20) == (4, 64)
    assert pt_tuning.tiled_geometry(1, 16, 1 << 24) == (1, 63)
    assert pt_tuning.tiled_geometry(4096, 16, 1 << 20) == (8, 1)
    with pytest.raises(ValueError, match="empty"):
        pt_tuning.tiled_geometry(8, 0, 1000)


def test_b1_variants_take_b1s_geometry(monkeypatch):
    """At "highest" v3 launches at B1's geometry (tiled_geometry) at every
    k; v6 at resident_geometry's, which is tiled_geometry's wherever two
    blocks with their resident query rows fit an SM, else a smaller TM (and
    one block per SM only at m <= 8, near the guard). At their resolved
    tier (precision=None) they take their tensor-core instances' P: v3's
    own (tiers.ladder_tier_parts), v6's (tiers.resident_tier_parts)."""
    from tpu_knn_torch.kernels import tiers as pt_tiers

    calls = []
    for name in ("aos_candidates", "const_query_candidates"):
        orig = getattr(pt_fused, name)
        monkeypatch.setattr(pt_fused, name,
                            lambda q, r, n, parts, precision="highest", orig=orig, name=name:
                            calls.append((name, parts)) or orig(q, r, n, parts, precision))
    rng = np.random.default_rng(7)
    for m, k, n in ((8, 3, 5000), (40, 40, 9001), (3, 500, 3000), (1, 16, 70_000)):
        q, r = rng.random((m, k), np.float32), rng.random((n, k), np.float32)
        calls.clear()
        pt_fused.fused_knn(q, r, soa=False, precision="highest", device="cpu")
        pt_fused.const_query_knn(q, r, precision="highest", device="cpu")
        assert calls == [("aos_candidates", pt_tuning.tiled_geometry(m, k, n).parts),
                         ("const_query_candidates", pt_tuning.resident_geometry(m, k, n).parts)]
        calls.clear()
        pt_fused.fused_knn(q, r, soa=False, device="cpu")
        pt_fused.const_query_knn(q, r, device="cpu")
        tier = pt_fused.auto_precision(k, n)
        assert calls == [("aos_candidates", pt_tiers.ladder_tier_parts(m, n)),
                         ("const_query_candidates",
                          pt_tiers.resident_tier_parts(tier, m, k, n))]
    for m in MS[1:]:
        for k in KS:
            if not pt_fused.const_query_fits(m, k):
                continue
            g, b1 = pt_tuning.resident_geometry(m, k, 1 << 20), pt_tuning.tiled_geometry(m, k, 1 << 20)
            two = pt_tuning.resident_blocks_per_sm(m, k, b1.tm) == pt_tuning.TILED_BLOCKS_PER_SM
            assert (g == b1) == two or g.tm != b1.tm, (m, k)
            if two:
                assert g == b1
    assert pt_tuning.resident_geometry(1024, 16, 1 << 20) == pt_tuning.tiled_geometry(
        1024, 16, 1 << 20) == (8, 4)
    assert pt_tuning.resident_geometry(64, 256, 1 << 20).tm == 4


def _csrc_constants():
    """The integer constants (constexpr int / size_t) of csrc's shared
    headers, their expressions evaluated in order."""
    import os
    import re

    import tpu_knn_torch.csrc as csrc

    found = {}
    for name in ("knn_common.cuh", "tiled.cuh", "kselect.cuh", "smallm_kernels.cu",
                 "window_kernels.cu"):
        with open(os.path.join(os.path.dirname(csrc.__file__), name)) as f:
            text = f.read()
        for key, expr in re.findall(r"^constexpr (?:int|size_t) (\w+) = ([^;]+);", text, re.M):
            found[key] = eval(expr.replace("/", "//"), {}, dict(found))
    return found


def test_topk_shared_memory_mirror_matches_the_kernel_constants():
    """tuning's mirror of B5's and B6's static shared memory (the
    K-selection state of kselect.cuh: per (row, list) 32 list and 32 queue
    (score, column) slots, a count and a bound) agrees with csrc's constants; two
    B5 blocks with their ring fit an SM at every TM, and
    B6_BLOCKS_PER_SM B6 blocks at every (m, KMAX)."""
    c = _csrc_constants()
    assert (pt_tuning.KSELECT_LIST_SLOTS, pt_tuning.KSELECT_QUEUE_SLOTS) == (
        c["kListSlots"], c["kQueueSlots"])
    assert (pt_topk.B6_BLOCKS_PER_SM, pt_topk.B6_WIDE_BLOCKS_PER_SM) == (
        c["kSmallmTopkBlocksPerSm"], c["kSmallmTopkWideBlocksPerSm"])
    cols = c["kTileCols"]
    for tm in pt_tuning.SWEEP_ROWS:
        rows = c["kTiledWarps"] * tm
        state = 4 * cols + 4 * rows * (2 * c["kListSlots"] + 2 * c["kQueueSlots"] + 3)
        # ptxas's report on the card: 5216 and 17792 bytes at TM = 1, 4.
        assert pt_tuning.sweep_state_bytes(tm) == state == {1: 5216, 4: 17792}[tm]
        ring = 4 * c["kTiledStages"] * c["kChunk"] * (cols + rows)    # TiledRing<TM>
        assert c["kTiledBlocksPerSm"] * (ring + state + c["kSmemPerBlockReserved"]) <= (
            c["kSmemPerSm"])
    for m in (1, 2, 3, 4):
        for kmax in (8, 16, 32):
            rows = c["kSmallmWarps"] * m
            state = 4 * m * kmax + 4 * rows * (2 * c["kListSlots"] + 2 * c["kQueueSlots"] + 3)
            assert pt_tuning.smallm_topk_state_bytes(m, kmax) == state
            granted = -(-state // pt_tuning.SMEM_ALLOC_UNIT) * pt_tuning.SMEM_ALLOC_UNIT
            per_sm = c["kSmallmTopkBlocksPerSm" if kmax <= 16 else "kSmallmTopkWideBlocksPerSm"]
            assert per_sm * (granted + c["kSmemPerBlockReserved"]) <= c["kSmemPerSm"]


def test_b6_bf16_shared_memory_mirror_matches_the_kernel_constants():
    """B6-bf16 (smallm_bf16_kselect_kernel<M, V>) holds B2-bf16's queries
    and each of its kBf16Warps warps' K-selection of its m rows: tuning's
    mirror names those constants (ptxas on the card: 4704 bytes at m = 1),
    and kSmallmBf16BlocksPerSm blocks fit an SM at every m; its partition
    count is B2-bf16's."""
    c = _csrc_constants()
    assert c["kBf16Warps"] == pt_tuning.SMALLM_BF16_THREADS // 32
    for m in (1, 2, 3, 4):
        rows = c["kBf16Warps"] * m
        state = 16 * c["kSmallmMaxK"] + 4 * rows * (2 * c["kListSlots"]
                                                    + 2 * c["kQueueSlots"] + 3)
        assert pt_tuning.smallm_bf16_topk_state_bytes(m, 8) == state
        granted = -(-state // pt_tuning.SMEM_ALLOC_UNIT) * pt_tuning.SMEM_ALLOC_UNIT
        assert c["kSmallmBf16BlocksPerSm"] * (granted + c["kSmemPerBlockReserved"]) <= (
            c["kSmemPerSm"])
    assert pt_tuning.smallm_bf16_topk_state_bytes(1, 8) == 4704
    r_bf = torch.zeros((16, 1 << 20), dtype=torch.bfloat16)
    assert pt_topk.smallm_topk_operand_parts(r_bf, 1 << 20, 16) == pt_smallm.bf16_parts(1 << 20)
    assert pt_topk.smallm_topk_operand_parts(r_bf.float(), 1 << 20, 16) == (
        pt_topk.smallm_topk_parts(1 << 20, 16))


@pytest.mark.parametrize("k", [3, 16, 40])
def test_mutable_capacity_and_tier_follow_tpu_knn(k):
    """A mutable index's capacity (round_up(max(capacity, 2n, 1024),
    tile_n)), its tier (auto_precision(k, max(n, capacity))) and tile, and
    its operand's shape equal tpu_knn's over a (n, capacity, store) grid;
    an immutable index with capacity= takes the same tier, as in tpu_knn."""
    import tpu_knn_torch
    from tpu_knn.engine.index import NNIndex as JaxIndex

    rng = np.random.default_rng(k)
    for n in (300, 5000):
        r = rng.random((n, k), np.float32)
        for capacity in (None, 1000, 70_000):
            for store in ("float32", "bf16"):
                jx = JaxIndex(r, store=store, mutable=True, capacity=capacity)
                ix = tpu_knn_torch.NNIndex(r, store=store, mutable=True, capacity=capacity,
                                           device="cpu")
                assert (ix.capacity, ix.precision, ix.tile_n) == (
                    jx.capacity, jx.precision, jx.tile_n), (n, capacity, store)
                assert ix.r_ops[0].shape == jx.r_ops[0].shape
            if capacity:
                assert tpu_knn_torch.NNIndex(r, capacity=capacity, device="cpu").precision == (
                    JaxIndex(r, capacity=capacity).precision)


def test_wide_load_scans_mirror_the_kernel_constants():
    """B11's and B2-bf16's Python geometry names the constants of their
    CUDA source: blocks per SM (their __launch_bounds__), B2-bf16's load
    widths and their cap at m > 2, k's limit, B2-bf16's block size; each
    width's row chunk divides the queries' 32 coordinates; the static
    shared memory mirrors
    (tuning.window_state_bytes, smallm_bf16_state_bytes) admit the blocks
    per SM that the grids are sized to."""
    from tpu_knn_torch.kernels import projection as pt_proj

    c = _csrc_constants()
    assert pt_proj.B11_BLOCKS_PER_SM == c["kWindowBlocksPerSm"]
    assert pt_smallm.B2_BF16_BLOCKS_PER_SM == c["kSmallmBf16BlocksPerSm"]
    assert pt_tuning.SMALLM_BF16_THREADS == c["kBf16Threads"]
    assert (pt_smallm.BF16_WIDE_MAX_M, pt_smallm.BF16_NARROW_WIDTH) == (
        c["kBf16WideMaxM"], c["kBf16NarrowVec"])
    assert pt_smallm.SMALLM_MAX_K == c["kSmallmMaxK"]
    assert pt_proj.TILE_W == c["kTileW"]
    for v in pt_smallm.BF16_LOAD_WIDTHS:
        rows = min(2 * c["kBf16ChunkWords"] // v, c["kBf16MaxRows"])    # csrc bf16_rows
        assert c["kLanes"] % v == 0 and c["kSmallmMaxK"] % rows == 0
        for m in range(1, pt_smallm.SMALLM_MAX_M + 1):
            if m > pt_smallm.BF16_WIDE_MAX_M and v > pt_smallm.BF16_NARROW_WIDTH:
                continue                                  # no such instance
            state = pt_tuning.smallm_bf16_state_bytes(m, v)
            slots = c["kBf16Threads"] // (c["kLanes"] // v)
            assert state == 16 * c["kSmallmMaxK"] + 8 * slots * m * c["kLanes"] <= 48 * 1024
            granted = -(-state // pt_tuning.SMEM_ALLOC_UNIT) * pt_tuning.SMEM_ALLOC_UNIT
            assert c["kSmallmBf16BlocksPerSm"] * (granted + c["kSmemPerBlockReserved"]) <= (
                c["kSmemPerSm"])
    for v in (1, 4):
        state = pt_tuning.window_state_bytes(v) + 4 * 40     # and k = 40's queries
        assert c["kWindowBlocksPerSm"] * (state + c["kSmemPerBlockReserved"]) <= c["kSmemPerSm"]


@pytest.mark.parametrize("m", [1, 2, 3, 4])
def test_b2_bf16_load_width_choice(m):
    """The width B2-bf16's launcher picks (smallm.bf16_load_width, csrc
    bf16_vec): the widest of 8, 4, 2, 1 values whose bytes divide the base
    address and whose count divides ld, at most 4 past m = 2; over every
    base offset and ld residue mod 8."""
    rows = 3
    base = torch.zeros(8 + rows * 1032, dtype=torch.bfloat16)
    start = (-base.data_ptr() // 2) % 8                  # a 16-byte aligned element
    seen = set()
    for offset in range(8):
        for ld in range(1024, 1032):
            v = base[start + offset:start + offset + rows * ld].view(rows, ld)
            w = pt_smallm.bf16_load_width(v, m)
            fits = [x for x in pt_smallm.BF16_LOAD_WIDTHS
                    if v.data_ptr() % (2 * x) == 0 and ld % x == 0
                    and (m <= 2 or x <= pt_smallm.BF16_NARROW_WIDTH)]
            assert w == max(fits)
            seen.add(w)
    assert seen == ({8, 4, 2, 1} if m <= 2 else {4, 2, 1})


def test_wide_load_scans_fill_the_card():
    """B11's split count and B2-bf16's partition count never exceed the
    window's or the operand's 128-column groups, and give the grid the
    blocks per SM their kernels' __launch_bounds__ are built for (one wave),
    unless every group already has its block."""
    from tpu_knn_torch.kernels import projection as pt_proj

    for n in NS[3:]:
        for window in (4096, 5000, 1 << 18, pt_proj.auto_window(3, n)):
            w_tiles = pt_proj.window_tiles(n, window)
            groups = w_tiles * pt_proj.TILE_W // 128
            for m in MS[1:]:
                splits = pt_proj.window_splits(m, w_tiles)
                assert 1 <= splits <= groups
                assert splits == groups or splits * m >= (
                    pt_proj.B11_BLOCKS_PER_SM * pt_tuning.H100_SMS)
                assert (splits - 1) * m < pt_proj.B11_BLOCKS_PER_SM * pt_tuning.H100_SMS
    for n in NS:
        groups = -(-n // 128)
        parts = pt_smallm.bf16_parts(n)
        assert 1 <= parts <= groups
        assert parts == groups or parts == pt_smallm.B2_BF16_BLOCKS_PER_SM * pt_tuning.H100_SMS
    # The auto path's launch over (3, 2^24) at m = 16, and ds8's at m = 1.
    w_tiles = pt_proj.window_tiles(1 << 24, pt_proj.auto_window(3, 1 << 24))
    assert w_tiles == 65
    assert pt_proj.window_splits(16, w_tiles) == -(-pt_proj.B11_BLOCKS_PER_SM * 132 // 16)


def test_v6_shared_memory_mirror_matches_the_kernel_constants():
    """tuning's mirror of v6's shared memory (its operand-only ring, the
    resident rows, B1's state) and of B10's static state (B1's and the TMA
    ring's mbarriers) agrees with what csrc's constants imply, and on a
    grid of (m, k) up to v6's guard (k*m <= 16384) the geometry it picks
    fits: two blocks and the system's reserve per SM where it claims two,
    one block's 227 KB always."""
    c = _csrc_constants()
    assert (pt_tuning.SMEM_PER_SM, pt_tuning.SMEM_PER_BLOCK_RESERVED, pt_tuning.SMEM_PER_BLOCK) == (
        c["kSmemPerSm"], c["kSmemPerBlockReserved"], c["kSmemPerBlock"])
    assert (pt_tuning.TILED_CHUNK, pt_tuning.TILED_STAGES, pt_tuning.TILED_WARPS,
            pt_tuning.TILED_SLICE_LANES, pt_tuning.TILED_TILE_GROUPS,
            pt_tuning.TILED_BLOCKS_PER_SM) == (
        c["kChunk"], c["kTiledStages"], c["kTiledWarps"], c["kSliceLanes"], c["kTileGroups"],
        c["kTiledBlocksPerSm"])
    cols = c["kTileCols"]
    ring = 4 * c["kTiledStages"] * c["kChunk"] * cols    # TiledRing<TM, false, true>
    for tm in pt_tuning.TILED_ROWS:
        # TiledState<TM, false>: norm_s, best_s and best_i, b_s[1], b_i[1],
        # in ptxas's 16-byte units (its report on the card: 3088, 9232 and
        # 17424 bytes at TM = 1, 4, 8).
        bm = c["kTiledWarps"] * tm
        state = -(-4 * (cols + 2 * bm * c["kSliceLanes"] + 2) // 16) * 16
        assert state == {1: 3088, 4: 9232, 8: 17424}[tm]
        assert pt_tuning.candidates_state_bytes(tm) == state
        # TmaState<TM>: B1's state (a multiple of 8 bytes), then one 8-byte
        # mbarrier a ring stage; two blocks of it and its full ring (the
        # operand and the queries) with its alignment slack fit an SM.
        tma_state = -(-(4 * (cols + 2 * bm * c["kSliceLanes"] + 2)
                        + 8 * c["kTiledStages"]) // 16) * 16
        assert tma_state == {1: 3104, 4: 9248, 8: 17440}[tm]
        assert pt_tuning.candidates_state_bytes(tm, tma=True) == tma_state
        tma_ring = 4 * c["kTiledStages"] * c["kChunk"] * (cols + bm) + c["kTmaAlign"]
        assert c["kTiledBlocksPerSm"] * (tma_ring + tma_state + c["kSmemPerBlockReserved"]) <= (
            c["kSmemPerSm"])
    one_only = set()
    ms = sorted({*range(1, 70), 100, 128, 200, 256, 500, 1000, 1024, 4096, 16384})
    for m in ms:
        for k in {1, 3, 16, 17, 40, 256, 16384 // m, max(1, 16384 // m - 1)}:
            if not pt_fused._v6_guard(k, m, 4096):
                continue
            g = pt_tuning.resident_geometry(m, k, 4096)
            rows = min(m, c["kTiledWarps"] * g.tm)
            ldr = rows if g.tm == 1 else -(-rows // 4) * 4
            resident = 4 * -(-k // c["kChunk"]) * c["kChunk"] * ldr
            smem = ring + resident + pt_tuning.candidates_state_bytes(g.tm)
            assert pt_tuning.resident_block_smem(m, k, g.tm) == smem
            assert smem <= c["kSmemPerBlock"]
            per_sm = pt_tuning.resident_blocks_per_sm(m, k, g.tm)
            granted = -(-smem // pt_tuning.SMEM_ALLOC_UNIT) * pt_tuning.SMEM_ALLOC_UNIT
            assert per_sm * (granted + c["kSmemPerBlockReserved"]) <= c["kSmemPerSm"]
            if per_sm < c["kTiledBlocksPerSm"]:
                one_only.add((m, k))
                assert g.tm == 1 and m <= 8 and per_sm == 1
    # The guard's extremes: (2, 7000) keeps two blocks; k*m = 16384 at
    # m = 1 is one 64 KB resident block beside the ring, one per SM.
    assert (2, 7000) not in one_only and pt_tuning.resident_geometry(2, 7000, 300).tm == 1
    assert (1, 16384) in one_only


def test_tensor_kernel_shared_memory_admits_two_blocks_per_sm():
    """The Python mirror of the tensor-core kernel's shared-memory plan
    (tiers.tensor_smem, csrc tensor_smem): for every instance (operand
    mode, T) and chunk KC the C entry dispatches, at every k16 = 16 ...
    4096 it takes (T = 8 and 9 only at k16 = 16, the only width their
    term lists come at), its blocks an SM (one 128-row block, which holds
    two 64-row blocks' rows) and the system's reserve fit an SM; the ring
    keeps at least two stages (one landing while one is multiplied) and
    the q parts stay resident up to the limit, then ride in the ring. The
    instances' term lists are those term_list sends, and the packed ones
    (tiers.TENSOR_PACKED_INSTANCES) those of packed_tier's tiers."""
    from tpu_knn_torch.kernels import tiers

    sent = set()
    for precision in ("default", "bf16_raw", "qsplit2", "packed", "bf16x3", "bf16x4"):
        for k in range(1, 800):
            terms = tiers.term_list(precision, k)
            sent.add((0, terms))
            sent.add((1, tuple(t for t in terms if t[1] == 0)))
    sent.add((2, tiers.term_list("bf16x3_presplit", 16)))
    assert all(k <= 16 for k in range(1, 800) if len(tiers.term_list("packed", k)) >= 8)
    assert sent <= {(mode, terms) for (mode, _), terms in tiers.TENSOR_INSTANCES.items()}
    assert all(len(terms) == t for (_, t), terms in tiers.TENSOR_INSTANCES.items())
    packed = set()
    for k in range(1, 33):
        terms = tiers.term_list("packed", k)
        assert tiers.packed_tier("packed", k)
        packed |= {(0, len(terms)), (1, sum(1 for t in terms if t[1] == 0))}
    assert packed == tiers.TENSOR_PACKED_INSTANCES
    assert not any(tiers.packed_tier(p, k) for p in ("bf16x3", "bf16x4", "qsplit2", "default")
                   for k in range(1, 800))
    budget = min(tiers.SMEM_PER_SM // tiers.TENSOR_BLOCKS_PER_SM - tiers.SMEM_PER_BLOCK_RESERVED,
                 tiers.SMEM_PER_BLOCK)
    for (mode, _), terms in tiers.TENSOR_INSTANCES.items():
        nq = 1 + max(i for i, _ in terms)
        for kc in (16, 32) if len(terms) < 8 else (16,):
            assert 2 <= tiers.tensor_stages(mode, terms, kc) <= 4
            # At the widest k16 the q parts never fit: the plan of q in
            # the ring, which no k16 changes.
            in_ring = tiers.tensor_smem(mode, terms, kc, 4096 if kc == 32 else 4080)
            for k16 in range(16, 4097 if len(terms) < 8 else 17, 16):
                if tiers.tensor_chunk(k16) != kc:
                    continue
                smem = tiers.tensor_smem(mode, terms, kc, k16)
                assert smem <= budget, (mode, terms, kc, k16, smem)
                assert smem % 16 == 0
                resident = k16 // kc * nq * tiers.TENSOR_TILE_M * (kc + 8) * 2
                if resident <= tiers.tensor_q_resident_limit():
                    assert smem >= resident + 4 * 128
                else:
                    assert smem == in_ring
    assert [tiers.tensor_chunk(k16) for k16 in (16, 32, 48, 64, 768, 4096)] == [
        16, 32, 16, 32, 32, 32]
    # Named plans: bf16x3 over f32 at k = 768 rides q in a 4-stage ring
    # beside two sets of split planes (32 KB of fold slots and two |r|^2
    # rows, 4 x (16.5 KB of r + 20 KB of q), 2 x 17 KB of planes: 218112
    # bytes, one 128-row block); B12 and qsplit2 over a bf16 operand take 4
    # stages too, with no planes.
    assert tiers.tensor_stages(0, tiers.TENSOR_INSTANCES[0, 3], 32) == 4
    assert tiers.tensor_plane_sets(0, tiers.TENSOR_INSTANCES[0, 3], 32) == 2
    assert tiers.tensor_smem(0, tiers.TENSOR_INSTANCES[0, 3], 32, 768) == 218112 <= budget
    assert tiers.tensor_stages(2, tiers.TENSOR_INSTANCES[2, 3], 32) == 4
    assert tiers.tensor_stages(1, tiers.TENSOR_INSTANCES[1, 2], 32) == 4


@pytest.mark.parametrize("m,n", [(1, 1000), (16, 1 << 20), (64, 1 << 20), (100, 70_000),
                                 (1024, 1 << 17), (1024, 1 << 20), (4096, 1 << 20),
                                 (1 << 14, 1 << 20)])
def test_tensor_parts_fills_whole_waves_of_two_blocks_per_sm(m, n):
    """tiers.tensor_parts' cost model: a launch of ceil(m / 128) row tiles
    x 4 lane slices x P blocks runs in waves of 1 x 132 (one 128-row block
    an SM, the rows of two 64-row blocks), each block walking
    ceil(ceil(G / P) / 4) column tiles; P stays within the groups of n,
    and its waves x tiles per block is within 5% of the least any P gives
    (and never above the same tiles spread evenly over whole waves by more
    than one wave's worth)."""
    from tpu_knn_torch.kernels import tiers

    groups = -(-n // 128)
    one_part = -(-m // tiers.TENSOR_TILE_M) * tiers.TENSOR_SLICES
    per_wave = tiers.TENSOR_BLOCKS_PER_SM * pt_tuning.H100_SMS

    def cost(parts):
        return -(-one_part * parts // per_wave) * -(-(-(-groups // parts))
                                                     // tiers.TENSOR_TILE_GROUPS)

    parts = tiers.tensor_parts(m, n)
    assert 1 <= parts <= groups
    least = min(cost(p) for p in range(1, groups + 1))
    assert cost(parts) <= (1 + pt_tuning.TILED_COST_SLACK) * least
    assert all(cost(p) > (1 + pt_tuning.TILED_COST_SLACK) * least for p in range(1, parts))
    tiles = -(-groups // tiers.TENSOR_TILE_GROUPS)
    assert cost(parts) <= -(-one_part * tiles // per_wave) + tiles


def test_b7_launch_geometry_takes_whole_chunks_in_whole_waves():
    """B7's grid (tuning.moments_geometry): the same template as
    tiled_geometry's, one block per row tile and partition of whole
    256-column chunks. TM is the built instance tiled_geometry picks at m,
    the geometry is the same at every k (k only streams through the ring),
    P stays within the chunks of n, and waves of 2 blocks per SM x chunks
    per block is within 5% of the same chunks spread evenly over whole
    waves."""
    per_wave = pt_tuning.TILED_BLOCKS_PER_SM * pt_tuning.H100_SMS
    assert pt_tuning.MOMENT_CHUNK == 256
    for m in MS[1:]:
        rows_per_block = pt_tuning.TILED_WARPS * pt_tuning.tiled_geometry(m, 1, 1).tm
        for n in NS:
            g = pt_tuning.moments_geometry(m, 1, n)
            for k in KS:
                assert pt_tuning.moments_geometry(m, k, n) == g
            assert g.tm in pt_tuning.TILED_ROWS
            assert pt_tuning.TILED_WARPS * g.tm == rows_per_block
            chunks = -(-n // pt_tuning.MOMENT_CHUNK)
            assert 1 <= g.parts <= chunks
            row_tiles = -(-m // rows_per_block)
            waves = -(-row_tiles * g.parts // per_wave)
            per_block = -(-chunks // g.parts)
            even = -(-row_tiles * chunks // per_wave)
            assert waves * per_block <= 1.05 * even
    # Named shapes: ds11 (and each 1024-row chunk of knn_graph over 2^17
    # points) takes 16 row tiles x 16 partitions = 256 blocks, one wave, as
    # B1 does there; the planted m = 64 cases spread over 256 partitions.
    assert pt_tuning.moments_geometry(1024, 16, 1 << 20) == (8, 16)
    assert pt_tuning.moments_geometry(1024, 16, 1 << 17) == (8, 16)
    assert pt_tuning.moments_geometry(64, 16, 1 << 20) == (8, 256)
    assert pt_tuning.moments_geometry(8, 16, 1 << 20) == (1, 256)
    with pytest.raises(ValueError, match="empty"):
        pt_tuning.moments_geometry(8, 16, 0)


# ---- the seeded engine's cell policy and capacity ladder ------------------

SEEDED_KS = [1, 2, 8, 9, 16, 17, 32, 33, 48, 64, 65, 96, 128, 129, 200, 300, 512]
N_OPS = [128, 384, 1024, 1536, 2048, 6016, 8192, 32768, 65536, 70016, 1 << 20, 1 << 22]


def test_seeded_constants():
    from tpu_knn_torch.kernels import seeded as pt_seeded

    for name in ("SEEDED_ROUND_K", "EXTRACT_TILE_N_CUBIC", "EXTRACT_TILE_N_HEX",
                 "EXTRACT_TILE_N_QUAD", "EXTRACT_TILE_N_OCT", "SEEDED_CHUNK_ROWS",
                 "_EXTRACT_FIELDS", "_EXTRACT_FIELDS_CUBIC", "RERANK_COMPACT_CAP"):
        assert getattr(pt_seeded, name) == getattr(jx_topk, name), name
    for nf in (4, 8):
        assert pt_seeded._solvable_for(nf) == jx_topk._solvable_for(nf)


@pytest.mark.parametrize("k", [1, 3, 8, 16, 17, 64, 128, 768])
def test_extract_mode_and_tile(k):
    from tpu_knn_torch.kernels import seeded as pt_seeded

    for n_ops in N_OPS:
        for max_t in (2048, 4096, 8192):
            t = pt_seeded._extract_tile_n(n_ops, max_t, k)
            assert t == jx_topk._extract_tile_n(n_ops, max_t, k), (n_ops, max_t)
            for kk in SEEDED_KS:
                assert pt_seeded._extract_mode(t, kk) == jx_topk._extract_mode(t, kk)


def _jax_ladder(m, n, k, kk, n_ops, precision):
    """tpu_knn's single-round capacity ladder, read from its builders where
    they expose it (the extraction's cell and fields) and otherwise
    transcribed from tpu_knn/kernels/topk.py:1671-1772 and :1909-1916."""
    max_tile_n = (jx_topk.EXTRACT_TILE_N_QUAD if kk <= 16 else
                  jx_topk.EXTRACT_TILE_N_OCT if kk <= 32 else
                  jx_topk.EXTRACT_TILE_N_CUBIC if kk <= 64 else jx_topk.EXTRACT_TILE_N_HEX)
    tile_n = jx_topk._extract_tile_n(n_ops, max_tile_n, k)
    ext = jx_topk._build_extract_candidates(m, n, k, 8, tile_n, precision,
                                            n_ops=n_ops, kk=kk)
    _, p1_tile_n = jx_tuning.pick_tiles(k, m, n, wide=precision == "packed")
    p1_tile_n = min(p1_tile_n, n_ops)
    while n_ops % p1_tile_n != 0:
        p1_tile_n -= 128
    p1_limit = None
    if kk <= 16 and n_ops >= (1 << 16):
        num, den = (1, 2) if kk <= 8 else (3, 4)
        part = (n_ops * num // den) // p1_tile_n * p1_tile_n
        if part >= p1_tile_n and min(n, part) >= 1024:
            p1_limit = part
    nc = n_ops // ext.cell
    cap_full = min(nc, ((4 if kk <= 8 else 3) * kk + 16) if p1_limit else (2 * kk + 16), 256)
    cap_fast = cap_full if p1_limit else min(cap_full, 96 if kk > 64 else 48)
    nparts = 8 if kk > 64 else 4 if kk > 32 else 1
    while nc % nparts != 0 or (nparts > 1 and nc // nparts % 128):
        nparts //= 2
    esc_parts = 2 if kk > 64 and nc % 2 == 0 and (nc // 2) % 128 == 0 else 1
    return {"cell": ext.cell, "n_fields": ext.n_fields, "solvable": ext.solvable,
            "depth": 2 if kk > 64 else 1, "p1_limit": p1_limit, "nc": nc,
            "cap_fast": cap_fast, "nparts": nparts,
            "escalates": not (cap_full == cap_fast and nparts == 1),
            "esc_cap": min(cap_full, 192) if esc_parts > 1 else cap_full,
            "esc_parts": esc_parts}


@pytest.mark.parametrize("k", [3, 8, 16, 64])
def test_seeded_ladder(k):
    """The port's seeded_geometry (cells, bound prefix, caps and parts)
    equals tpu_knn's on the operand widths the per-call path pads to, at
    tpu_knn's own score tier for (k, n)."""
    from tpu_knn_torch.kernels import seeded as pt_seeded

    for m in (40, 1024):
        for n in (3000, 40_000, 70_000, 1 << 20):
            _, tile_n = jx_tuning.pick_tiles(k, m, n)
            n_ops = -(-n // tile_n) * tile_n
            for kk in SEEDED_KS:
                if pt_seeded.uses_rounds(kk, n_ops):
                    got = pt_seeded.rounds_geometry(n_ops, k, kk)
                    t = jx_topk._extract_tile_n(n_ops, jx_topk.EXTRACT_TILE_N_CUBIC, k)
                    assert (got["cell"], got["n_fields"]) == jx_topk._extract_mode(t, 64)
                    continue
                want = _jax_ladder(m, n, k, kk, n_ops, jx_fused.auto_precision(k, n))
                assert pt_seeded.seeded_geometry(m, n, k, kk, n_ops) == want, (m, n, kk)


@pytest.mark.parametrize("k", [3, 16, 64, 768])
def test_percall_width(k):
    """A per-call seeded operand is as wide as tpu_knn's (its cells depend
    on the width); the sweep and passes engines pad only to the lane."""
    for m in (5, 8, 64, 256, 1024):
        for n in NS:
            for kk in (1, 8, 32, 64, 300):
                for method in ("auto", "seeded", "passes"):
                    want = 128
                    if (jx_topk._auto_method(m, kk) if method == "auto"
                            else method) == "seeded":
                        want = jx_tuning.pick_tiles(k, m, n)[1]
                    got = pt_topk._percall_width(m, n, k, kk, method)
                    assert got == -(-n // want) * want, (m, n, kk, method)


# ---- the rest of the 1-NN ladder and the projection index ------------------


def test_ladder_constants():
    from tpu_knn.engine.index import NNIndex as JaxIndex
    from tpu_knn.kernels import projection as jx_proj
    from tpu_knn.kernels import twophase as jx_twophase
    from tpu_knn_torch.kernels import projection as pt_proj
    from tpu_knn_torch.kernels import twophase as pt_twophase

    assert pt_twophase.V1_MAX_TOTAL_BYTES == jx_twophase.V1_MAX_TOTAL_BYTES
    assert pt_twophase.V2_CHUNK == jx_twophase.V2_CHUNK
    for name in ("PAD_VALUE", "DEFAULT_WINDOW", "TILE_W", "DEFAULT_GROUP"):
        assert getattr(pt_proj, name) == getattr(jx_proj, name), name
    for name in ("CERT_RATE_MIN", "PROJ_REALIZED_MIN", "PROJ_FEEDBACK_PERIOD"):
        assert getattr(pt_index.NNIndex, name) == getattr(JaxIndex, name), name


@pytest.mark.parametrize("k", KS)
def test_twophase_and_dma_policy(k):
    from tpu_knn.kernels import dma_pipeline as jx_dma
    from tpu_knn.kernels import twophase as jx_twophase
    from tpu_knn_torch.kernels import dma_pipeline as pt_dma
    from tpu_knn_torch.kernels import twophase as pt_twophase

    for m in MS:
        for n in NS:
            assert pt_twophase._v1_guard(k, m, n) == jx_twophase._v1_guard(k, m, n), (m, n)
            if m:
                assert pt_dma._dma_tiles(k, m, n) == jx_dma._dma_tiles(k, m, n), (m, n)


@pytest.mark.parametrize("k", [1, 2, 3, 4, 5, 8, 9, 16])
def test_projection_policy(k):
    from tpu_knn.kernels import projection as jx_proj
    from tpu_knn_torch.kernels import projection as pt_proj

    for n in NS + [3000, 1 << 17, 1 << 22]:
        assert pt_proj.auto_window(k, n) == jx_proj.auto_window(k, n), n
        for m in MS + [16, 63, 64, 65, 128]:
            assert pt_proj.projection_work(k, n, m) == jx_proj.projection_work(k, n, m)
            assert pt_proj.projection_wins(k, m, n) == jx_proj.projection_wins(k, m, n)


class _Group(Exception):
    pass


def test_projection_group_choice(monkeypatch):
    """projection_knn's scan engine groups one query per slice up to
    m = 64 and DEFAULT_GROUP queries beyond, in both packages."""
    from tpu_knn.kernels import projection as jx_proj
    from tpu_knn_torch.kernels import projection as pt_proj

    def capture(m, n, k, window, group):
        raise _Group(group)

    monkeypatch.setattr(jx_proj, "_build_window_query", capture)
    monkeypatch.setattr(pt_proj, "_build_window_query", capture)
    r = np.random.default_rng(0).random((300, 3), np.float32)
    for m in (1, 5, 63, 64, 65, 100, 1000):
        q = r[:1].repeat(m, 0)
        groups = []
        for fn, kw in ((jx_proj.projection_knn, {}), (pt_proj.projection_knn,
                                                       {"device": "cpu"})):
            with pytest.raises(_Group) as e:
                fn(q, r, engine="scan", prebuilt=(None,) * 7, **kw)
            groups.append(e.value.args[0])
        assert groups[0] == groups[1] == (1 if m <= 64 else jx_proj.DEFAULT_GROUP), m


SHAPES_TA_BIG = [
    (3, 1, 2), (3, 2, 8), (3, 1, 1024), (3, 1, 65536), (16, 1, 65536), (3, 1024, 1024),
    (3, 1024, 65536), (16, 1024, 65536),                      # TA (main.cu:28-39)
    (3, 1, 1 << 24), (16, 1, 1 << 24), (3, 1024, 1 << 20), (16, 1024, 1 << 20)]   # BIG


def test_hopper_guards_on_the_reference_shapes():
    """The v3, v5 and v6 guards are the Hopper kernels' own limits
    (ROADMAP C): every TA and BIG shape runs its version (tpu_knn's v3 sent
    ds8/ds9 to v4 for the TPU's tiled HBM pages); v3 and v5 have no guard
    at all (their tiled kernel takes every k, where the lane-per-thread
    kernels before it stopped at k = 393 and k = 199), so the port's v5
    answers tpu_knn's wide-k case itself, which tpu_knn's 2 x (k, tile_n)
    VMEM scratch sent to v4; v6 keeps the reference's own guard, k*m <=
    16384, so it takes ds11 and delegates a query set past it, which
    tpu_knn's 4 MB VMEM block admitted."""
    from tpu_knn.harness.generator import BIG_SHAPES, TA_SHAPES
    from tpu_knn.kernels import dma_pipeline as jx_dma

    assert SHAPES_TA_BIG == list(TA_SHAPES) + list(BIG_SHAPES)
    assert pt_registry.get_version("v3").guard is None
    assert pt_registry.get_version("v5").guard is None
    guards = {v: pt_registry.get_version(v).guard for v in ("v6",)}
    jx_guards = {v: jx_registry.get_version(v).guard for v in ("v3", "v5", "v6")}
    for k, m, n in SHAPES_TA_BIG:
        assert all(g(k, m, n) for g in guards.values()), (k, m, n)
        assert jx_guards["v5"](k, m, n) and jx_guards["v6"](k, m, n)
        assert jx_guards["v3"](k, m, n) == (n < (1 << 24))
    assert not jx_dma._v5_guard(2048, 8, 4096)
    assert jx_guards["v3"](2048, 8, 4096)
    assert not guards["v6"](16, 1025, 1 << 20) and jx_guards["v6"](16, 1025, 1 << 20)
    assert not guards["v6"](16, 2048, 4096) and jx_guards["v6"](16, 2048, 4096)
    assert guards["v6"](3, 5461, 4096) and not guards["v6"](3, 5462, 4096)
    assert guards["v6"](7000, 2, 4096) and guards["v6"](16384, 1, 4096)


def test_hopper_launch_geometry_fits(monkeypatch):
    """B10 (v5) and B1's AoS variant (v3) take B1's geometry at every k
    (their shared memory does not depend on k: B10's TMA ring and its
    barriers fit two blocks per SM at every TM), so v5 has no guard; v6's
    blocks fit one SM wherever its guard admits; B11's splits never
    exceed the window's groups."""
    from tpu_knn_torch.kernels import dma_pipeline as pt_dma
    from tpu_knn_torch.kernels import projection as pt_proj

    assert pt_registry.get_version("v5").guard is None
    for tm in pt_tuning.TILED_ROWS:
        ring = 4 * pt_tuning.TILED_STAGES * pt_tuning.TILED_CHUNK * (
            pt_tuning.TILED_TILE_GROUPS * pt_tuning.TILED_SLICE_LANES
            + pt_tuning.TILED_WARPS * tm)
        block = ring + 128 + pt_tuning.candidates_state_bytes(tm, tma=True)   # kTmaAlign
        assert pt_tuning.TILED_BLOCKS_PER_SM * (
            block + pt_tuning.SMEM_PER_BLOCK_RESERVED) <= pt_tuning.SMEM_PER_SM
    for k in KS:
        for m in MS[1:]:
            assert pt_fused.tiled_parts(m, k, 4096) == pt_tuning.tiled_geometry(m, k, 4096).parts
            if pt_fused._v6_guard(k, m, 4096):
                tm = pt_tuning.resident_geometry(m, k, 4096).tm
                assert pt_tuning.resident_blocks_per_sm(m, k, tm) >= 1
    calls = []
    orig = pt_dma.dma_candidates
    monkeypatch.setattr(pt_dma, "dma_candidates",
                        lambda q, r_op, n, parts, precision="highest": calls.append(
                            (r_op.stride(0), parts)) or orig(q, r_op, n, parts, precision))
    rng = np.random.default_rng(9)
    for m, k, n in ((8, 3, 5000), (40, 40, 9001), (1, 250, 3000), (3, 2048, 700)):
        q, r = rng.random((m, k), np.float32), rng.random((n, k), np.float32)
        calls.clear()
        pt_dma.dma_knn(q, r, precision="highest", device="cpu")
        assert calls == [(calls[0][0], pt_tuning.tiled_geometry(m, k, n).parts)], (m, k, n)
        assert calls[0][0] % 128 == 0      # the stride B10's tensor map takes
    for n in NS[3:]:
        for window in (4096, 5000, 1 << 18):
            w_tiles = pt_proj.window_tiles(n, window)
            for m in MS[1:]:
                assert 1 <= pt_proj.window_splits(m, w_tiles) <= w_tiles * 32


# ---- the top-K engines' score tier ---------------------------------------------


@pytest.mark.parametrize("k", [3, 16, 32, 40, 128])
def test_topk_paths_resolve_tpu_knns_tier(k, monkeypatch):
    """The tier each top-K path hands its kernels, tied to tpu_knn's: per
    call (topk_knn, within_radius, knn_graph) auto_precision(k, n), as
    tpu_knn's topk_knn; an index (each store, precision= given or not, a
    mutable index after a remove, a filtered view) its own precision, which
    equals tpu_knn's index's and which tpu_knn's _query_topk and
    _i8_query_topk pass on; the int8 presplit index "highest" beside its
    plain grid operand (tpu_knn fails there), the presplit f32 index its
    ValueError."""
    import tpu_knn_torch
    from tpu_knn.engine.index import NNIndex as JaxIndex

    seen = []
    real_percall, real_build = pt_topk._build_topk_percall, pt_topk._build_topk

    def percall(m, n, k, kk, method="auto", precision="highest"):
        seen.append(precision)
        return real_percall(m, n, k, kk, method, precision)

    def build(m, n, k, kk, n_ops, method="auto", precision="highest"):
        seen.append(precision)
        return real_build(m, n, k, kk, n_ops, method, precision)

    monkeypatch.setattr(pt_topk, "_build_topk_percall", percall)
    monkeypatch.setattr(pt_topk, "_build_topk", build)
    rng = np.random.default_rng(k)
    for n in (700, 3000):
        q, r = rng.random((6, k), np.float32), rng.random((n, k), np.float32)
        want = jx_fused.auto_precision(k, n)
        for call in (lambda: pt_topk.topk_knn(q, r, 3, method="passes", device="cpu"),
                     lambda: pt_topk.within_radius(q, r, 0.4, 4, method="passes", device="cpu")):
            seen.clear()
            call()
            assert seen and set(seen) == {want}, (n, seen)
    seen.clear()
    tpu_knn_torch.knn_graph(r[:300], 3, device="cpu")
    assert seen and set(seen) == {jx_fused.auto_precision(k, 300)}
    q, r = rng.random((6, k), np.float32), rng.random((3000, k), np.float32)
    for store in ("float32", "bf16", "int8"):
        for precision in (None, "highest", "bf16x4", "bf16x3_presplit"):
            kwargs = dict(store=store, precision=precision)
            ix = tpu_knn_torch.NNIndex(r, device="cpu", **kwargs)
            assert ix.precision == JaxIndex(r, **kwargs).precision, (store, precision)
            seen.clear()
            if ix.precision == "bf16x3_presplit" and store != "int8":
                with pytest.raises(ValueError, match="neighbors>1 requires"):
                    ix.query(q, neighbors=3)
                continue
            ix.query(q, neighbors=3)
            want = "highest" if ix.precision == "bf16x3_presplit" else ix.precision
            assert seen and set(seen) == {want}, (store, precision, seen)
    for store in ("float32", "bf16"):
        mu = tpu_knn_torch.NNIndex(r[:2000], mutable=True, store=store, device="cpu")
        mu.add(r[2000:])
        mu.remove(np.arange(10, 40))
        view = tpu_knn_torch.NNIndex(r, store=store, device="cpu").filtered_view(
            np.arange(3000) % 2 == 0)
        for ix in (mu, view):
            seen.clear()
            ix.query(q, neighbors=3)
            assert seen and set(seen) == {ix.precision}
        assert mu.precision == JaxIndex(r[:2000], mutable=True, store=store).precision


def test_tensor_epilogues_mirror_the_kernel_constants_and_fit_the_sm():
    """tiers.TENSOR_EPILOGUES names each tensor-core epilogue's blocks an
    SM, layout and rows as its CUDA source declares them (kBlocksPerSm,
    kContig, kRows; B5's at each block height its C entry instantiates),
    and at every instance the C entries dispatch and every k16 each
    epilogue's plan (tiers.tensor_smem) fits its blocks
    (tiers.tensor_blocks_per_sm) and one block's limit with at least two
    ring stages; B1, B4, B3, B5 and B7 run one 128-row block an SM, B5 at
    m <= 32 two 32-row blocks; the ladder's epilogue (tiers.LADDER_EPILOGUES,
    at each height its C entry dispatches) one 128-row block for v3 and B10,
    two 32-row ones at m <= 32; v6's live rows (LiveEpi<BM, BPS>, each
    (policy, height) tk_tensor_resident_candidates dispatches) one 64-row
    block, or two 32-row ones."""
    import os
    import re

    from tpu_knn_torch.kernels import tiers

    csrc = os.path.join(os.path.dirname(tiers.__file__), "..", "csrc")
    declared = {}
    for kid, f, struct in (("B1", "tensor_kernels.cu", "CandidatesEpi"),
                           ("B4", "tensor_banded_kernels.cu", "BandedEpi"),
                           ("B3", "tensor_minima_kernels.cu", "MinimaEpi"),
                           ("B5", "tensor_sweep_kernels.cu", "SweepEpi"),
                           ("B7", "tensor_moments_kernels.cu", "MomentsEpi"),
                           ("ladder", "tensor_ladder_kernels.cu", "LadderEpi")):
        with open(os.path.join(csrc, f)) as fh:
            src = fh.read()
        body = src[src.index(f"struct {struct} {{"):]
        contig = re.search(r"kContig = (true|false);", body).group(1) == "true"
        per_sm = re.search(r"kBlocksPerSm = ([^;]+);", body).group(1)
        rows = re.search(r"kRows = ([^;]+);", body).group(1)
        override = re.search(r"blocks_per_sm\(int(?: t)?, int(?: kc)?\) \{\s*return ([^;]+);",
                             body)
        assert override.group(1) == "kBlocksPerSm"
        consts = {name: int(v) for name, v in
                  re.findall(r"^constexpr int (\w+) = (\d+);", src, re.M)}
        consts.update(kTBM=tiers.TENSOR_LIVE_TILE_M)
        # B5 and the ladder are templates on their rows (BM): each height
        # their entries dispatch (the ladder's: dispatch_ladder_rows).
        ladder_names = {"kLadderRows": "ladder", "kLadderServeRows": "ladder-serve"}
        live = {}
        if kid == "ladder":
            # v3's and B10's heights (POL) and v6's live rows' (policy, height).
            pair = re.search(r"LiveEpi<BM, POL == (\w+) \? 2 : 1>", src).group(1)
            live_body = src[src.index("struct LiveEpi : LadderEpi<true, BM> {"):]
            assert re.search(r"kBlocksPerSm = BPS;", live_body)
            heights = []
            for pol, h in re.findall(r"dispatch_ladder_rows<(\w+), (\w+)>", src):
                if pol == "POL":
                    heights.append((ladder_names[h], consts[h]))
                    continue
                name = "ladder-live" if h == "kTBM" else "ladder-live-pair"
                live[name] = 2 if pol == pair else 1
                heights.append((name, consts[h]))
        elif rows == "BM":
            heights = [(f"{kid}-serve" if h == "kServeRows" else kid, consts.get(h) or int(h))
                       for h in re.findall(rf"dispatch_tensor<{struct}<(\w+)>>", src)]
        else:
            heights = [(kid, None)]
        py_per_sm = re.sub(r"(.+)\?(.+):(.+)", r"(\2) if (\1) else (\3)",
                           per_sm.split("//")[0])
        for name, bm in heights:
            env = dict(consts, BM=bm)
            declared[name] = (live.get(name) or eval(py_per_sm, {}, env), contig,
                              eval(rows, {}, env))
    declared["B7-band"] = declared["B7"]
    assert {kid: declared.pop(kid) for kid in tiers.LADDER_EPILOGUES} == {
        kid: v[1:] for kid, v in tiers.LADDER_EPILOGUES.items()}
    assert declared == {kid: v[1:] for kid, v in tiers.TENSOR_EPILOGUES.items()}
    assert [tiers.TENSOR_EPILOGUES[kid][1] for kid in ("B1", "B4", "B3", "B5", "B7")] == [
        1, 1, 1, 1, 1]
    assert [tiers.tensor_rows(kid) for kid in ("B1", "B4", "B3", "B7", "B5", "B5-serve",
                                               "ladder", "ladder-serve", "ladder-live",
                                               "ladder-live-pair")] == [
        128, 128, 128, 128, 128, 32, 128, 32, 64, 32]
    assert [tiers.tensor_blocks_per_sm(kid) for kid in tiers.LIVE_PLANS] == [1, 2]
    assert tiers.sweep_tier_epilogue(32) == "B5-serve" and tiers.sweep_tier_epilogue(33) == "B5"
    assert tiers.ladder_epilogue(32) == "ladder-serve" and tiers.ladder_epilogue(33) == "ladder"
    for epilogue in (*tiers.TENSOR_EPILOGUES, "ladder", "ladder-serve"):
        for (mode, _), terms in tiers.TENSOR_INSTANCES.items():
            if mode == 2 and epilogue != "B1" or mode != 0 and epilogue.startswith("ladder"):
                continue
            for kc in (16, 32) if len(terms) < 8 else (16,):
                per_sm = tiers.tensor_blocks_per_sm(epilogue)
                assert per_sm == tiers._epilogue(epilogue)[1]
                budget = min(tiers.SMEM_PER_SM // per_sm - tiers.SMEM_PER_BLOCK_RESERVED,
                             tiers.SMEM_PER_BLOCK)
                assert 2 <= tiers.tensor_stages(mode, terms, kc, epilogue) <= 4
                for k16 in range(16, 4097 if len(terms) < 8 else 17, 16):
                    if tiers.tensor_chunk(k16) != kc:
                        continue
                    smem = tiers.tensor_smem(mode, terms, kc, k16, epilogue)
                    assert smem <= budget and smem % 16 == 0, (epilogue, mode, terms, k16)
    assert tiers.tensor_topk_parts("B4", 1024, 1 << 20) == tiers.tensor_parts(1024, 1 << 20)
    for kernel in ("B5", "B7", "B7-band"):
        for m, n in ((8, 1 << 20), (1024, 1 << 20), (1024, 1 << 18), (100, 70_144)):
            parts = tiers.tensor_topk_parts(kernel, m, n)
            unit = 128 if kernel == "B5" else 256
            assert 1 <= parts <= -(-n // unit)


class _Resolved(Exception):
    """Raised by a spy once it has seen the tier a path resolved."""


@pytest.mark.parametrize("k", [1, 3, 8, 9, 12, 14, 15, 16, 17, 24, 32, 33, 40, 128])
def test_ladder_paths_resolve_tpu_knns_tier(k, monkeypatch):
    """v3 (fused_knn(soa=False)), v5 (dma_knn) and v6 (const_query_knn)
    hand their kernels tpu_knn's tier at precision=None: auto_precision(k,
    n), read where each tpu_knn builder is called (_build_fused for v3 and
    v6, _build_dma for v5) on the same (k, m, n); an explicit tier passes
    through, bf16x3_presplit too. v3's "packed" runs tpu_knn's unpadded AoS
    term list, `_packed_terms(k)` (9 terms at k = 9..14, where the SoA
    paths' round_up(k, 8) gives 8), and its cutoff still resolves through
    round_up(k, 8)."""
    from tpu_knn.kernels import dma_pipeline as jx_dma
    from tpu_knn_torch.kernels import dma_pipeline as pt_dma
    from tpu_knn_torch.kernels import tiers

    seen = []

    def spy(*args):
        seen.append(args[-1])
        raise _Resolved

    monkeypatch.setattr(jx_fused, "_build_fused", lambda *a: spy(*a))
    monkeypatch.setattr(jx_dma, "_build_dma", lambda *a: spy(*a))
    monkeypatch.setattr(pt_fused, "aos_candidates", lambda *a: spy(*a))
    monkeypatch.setattr(pt_fused, "const_query_candidates", lambda *a: spy(*a))
    monkeypatch.setattr(pt_dma, "dma_candidates", lambda *a: spy(*a))
    runs = {
        "v3": (lambda q, r, p: jx_fused.fused_knn(q, r, soa=False, precision=p),
               lambda q, r, p: pt_fused.fused_knn(q, r, soa=False, precision=p, device="cpu")),
        "v5": (lambda q, r, p: jx_dma.dma_knn(q, r, precision=p),
               lambda q, r, p: pt_dma.dma_knn(q, r, precision=p, device="cpu")),
        "v6": (lambda q, r, p: jx_fused.fused_knn(q, r, soa=True, tile_m=-(-q.shape[0] // 8) * 8,
                                                  precision=p),
               lambda q, r, p: pt_fused.const_query_knn(q, r, precision=p, device="cpu")),
    }
    for m in (1, 4, 16, 64):
        for n in (100, 3000):
            q, r = np.zeros((m, k), np.float32), np.ones((n, k), np.float32)
            for rung, (jx, pt) in runs.items():
                if rung == "v6" and not pt_fused.const_query_fits(m, k):
                    continue
                for precision in (None, "bf16x4", "bf16x3_presplit", "highest"):
                    seen.clear()
                    for call in (jx, pt):
                        with pytest.raises(_Resolved):
                            call(q, r, precision)
                    assert seen[0] == seen[1], (rung, m, n, precision, seen)
                    assert seen[0] == (precision or jx_fused.auto_precision(k, n))
    n_splits, pairs = jx_fused._packed_terms(k)
    want = tuple(pairs) if n_splits else tiers.term_list("bf16x3", k)
    assert tiers.term_list("packed", k, aos=True) == want
    assert len(want) == (9 if k <= 14 else 8 if k <= 16 else 4 if k <= 32 else 3)
    assert tiers.resolved_tier("packed", k, aos=True) == (
        {3: "packed3", 2: "packed2"}.get(n_splits, "bf16x3"))
    assert pt_fused.select_cutoff("packed", k) == jx_fused.select_cutoff("packed", k)


#: The (k, m, n) of phase 2's tier launches in chip_smoke.py: ds11, packed2
#: at (32, 1024, 2^20), the embedding widths, the sweep's and the planted
#: small m (B5's serving shapes (16, 8, 2^20) K = 32 and (16, 32, 2^20) K =
#: 8, and the sweep at k = 128), ds10's k = 3, knn_graph's 1024-row chunks
#: over 2^17 points.
PHASE2_TIER_SHAPES = [(16, 1024, 1 << 20), (32, 1024, 1 << 20), (128, 1024, 1 << 20),
                      (768, 1024, 1 << 20), (768, 1024, 1 << 18), (16, 16, 1 << 20),
                      (16, 8, 1 << 20), (16, 32, 1 << 20), (16, 64, 1 << 20),
                      (3, 1024, 1 << 20), (16, 1024, 1 << 17), (128, 8, 1 << 20)]


@pytest.mark.parametrize("k,m,n", PHASE2_TIER_SHAPES)
def test_tensor_tile_geometry_at_the_main_path_shapes(k, m, n):
    """The Python geometry of the tensor-core tile at each tier launch of
    phase 2: for every epilogue and the instance each tier resolves to
    there (over f32 and bf16 operands), one block's plan (tensor_smem) is
    at most 227 KB and its blocks an SM (tensor_blocks_per_sm) fit the SM's
    shared memory and its 64K registers at 128 a thread; each launch's
    blocks (row tiles of the epilogue's rows x lane slices x P) fill at
    least 90% of one wave of those slots and no more (B5 at the block
    height its m takes, tiers.sweep_tier_epilogue)."""
    from tpu_knn_torch.kernels import tiers

    k16 = -(-k // 16) * 16
    sms = pt_tuning.H100_SMS
    for precision in ("packed", "bf16x3", "bf16x4", "qsplit2", "default"):
        for mode, r_dtype in ((0, torch.float32), (1, torch.bfloat16)):
            if precision == "qsplit2" and mode == 0:
                continue
            op = torch.zeros((1, 1), dtype=r_dtype)
            got_mode, terms = tiers._operand_instance(op, precision, k)
            assert got_mode == mode
            packed = tiers.packed_tier(precision, k)
            kc = tiers.tensor_chunk(k16, terms, packed)
            for epilogue in tiers.TENSOR_EPILOGUES:
                per_sm = tiers.tensor_blocks_per_sm(epilogue)
                rows = tiers.tensor_rows(epilogue)
                smem = tiers.tensor_smem(mode, terms, kc, k16, epilogue)
                assert smem <= tiers.SMEM_PER_BLOCK == 227 * 1024
                assert per_sm * (smem + tiers.SMEM_PER_BLOCK_RESERVED) <= tiers.SMEM_PER_SM
                assert per_sm * 4 * rows * 128 <= 65536
                if epilogue.startswith("B5") and tiers.sweep_tier_epilogue(m) != epilogue:
                    continue  # B5's other block height, not launched at this m
                parts = tiers.tensor_topk_parts("B4" if epilogue == "B1" else epilogue, m, n)
                slices = 1 if tiers.TENSOR_EPILOGUES[epilogue][2] else tiers.TENSOR_SLICES
                blocks = -(-m // rows) * slices * parts
                assert 0.9 * per_sm * sms <= blocks <= per_sm * sms, (epilogue, blocks)
    assert tiers.tensor_rows("B4") == tiers.tensor_rows("B7") == tiers.tensor_rows("ladder") == (
        4 * tiers.tensor_rows("ladder-serve"))


def test_b3_and_b5_plans_mirror_the_sources_and_fill_one_wave():
    """B3's and B5's shared-memory plans are their sources' (MinimaEpi's and
    SweepEpi's kStateBytes, evaluated from the constexpr offsets in the .cu
    files at each block height; kServeRows and kRowSlots are
    tiers.B5_SERVE_ROWS and B5_ROW_SLOTS), each instance a phase 2 launch
    takes fits 227 KB and its blocks an SM, and B3's and B5's launches at
    phase 2's shapes (the seeded engine's prefix at ds11, knn_graph's
    chunks, the embedding width; B5 at ds11, k = 768 and its serving
    shapes) fill at least 90% of one wave of their slots and no more."""
    import os
    import re

    from tpu_knn_torch.kernels import seeded, tiers, topk

    csrc = os.path.join(os.path.dirname(tiers.__file__), "..", "csrc")

    def state_bytes(f, struct, env):
        with open(os.path.join(csrc, f)) as fh:
            src = fh.read()
        env = dict(env, **{k: int(v) for k, v in
                           re.findall(r"^constexpr int (\w+) = (\d+);", src, re.M)})
        body = src[src.index(f"struct {struct} {{"):]
        for name, expr in re.findall(r"static constexpr size_t (\w+) =\s*([^;]+);", body):
            expr = re.sub(r"sizeof\(KSelectState<BM>\)", str(env.get("kselect")), expr)
            expr = expr.replace("fold_slot_bytes<kRows>()", str(tiers.tensor_fold_bytes()))
            expr = expr.replace("static_cast<size_t>", "").replace("sizeof(float)", "4")
            env[name] = eval(expr, {}, env)
        return env

    sweep = state_bytes("tensor_sweep_kernels.cu", "SweepEpi", {"BM": 0, "kselect": 0})
    assert (sweep["kServeRows"], sweep["kRowSlots"]) == (tiers.B5_SERVE_ROWS, tiers.B5_ROW_SLOTS)
    for epilogue in ("B5", "B5-serve"):
        rows = tiers.tensor_rows(epilogue)
        env = state_bytes("tensor_sweep_kernels.cu", "SweepEpi",
                          {"BM": rows, "kselect": pt_tuning.kselect_state_bytes(rows)})
        assert env["kStateBytes"] == tiers.TENSOR_EPILOGUES[epilogue][0]
    env = state_bytes("tensor_minima_kernels.cu", "MinimaEpi", {"kRows": tiers.tensor_rows("B3")})
    assert env["kStateBytes"] == tiers.TENSOR_EPILOGUES["B3"][0]
    sms = pt_tuning.H100_SMS
    for kernel, (k, m, n, kk) in [("B3", (16, 1024, 1 << 20, 8)), ("B3", (16, 1024, 1 << 17, 16)),
                                  ("B3", (768, 1024, 1 << 18, 8)), ("B5", (16, 1024, 1 << 20, 8)),
                                  ("B5", (768, 1024, 1 << 18, 8)), ("B5", (16, 8, 1 << 20, 32)),
                                  ("B5", (16, 32, 1 << 20, 8)), ("B5", (128, 8, 1 << 20, 32))]:
        precision = "packed" if k <= 32 else "bf16x3"
        terms = tiers.term_list(precision, k)
        kc = tiers.tensor_chunk(-(-k // 16) * 16, terms, tiers.packed_tier(precision, k))
        if kernel == "B3":
            g = seeded.seeded_geometry(m, n, k, kk, n, precision)
            n = g["p1_limit"] or n
            epilogue, parts, slices = "B3", tiers.tensor_topk_parts("B3", m, n), 4
        else:
            epilogue, parts, slices = tiers.sweep_tier_epilogue(m), topk.sweep_parts(
                m, k, n, precision), 1
        per_sm = tiers.tensor_blocks_per_sm(epilogue)
        smem = tiers.tensor_smem(0, terms, kc, -(-k // 16) * 16, epilogue)
        assert smem <= 227 * 1024 and per_sm * (smem + 1024) <= tiers.SMEM_PER_SM
        blocks = -(-m // tiers.tensor_rows(epilogue)) * slices * parts
        assert 0.9 * per_sm * sms <= blocks <= per_sm * sms, (kernel, k, m, n, blocks)


def test_v6_live_instance_plan_fits_one_block_an_sm():
    """v6's tier instance keeps its q parts resident at every shape its
    guard admits: B1's own launch where a 64-row block's parts fit
    TENSOR_Q_RESIDENT_BYTES (every k <= 80, ds11 among them), else the
    live rows' parts within TENSOR_Q_LIVE_BYTES (csrc kQResidentLiveBytes)
    in the plan tiers.tensor_live_epilogue picks: two 32-row blocks an SM
    at m <= 32 where the parts fit a 32-row block's q_resident_limit, else
    one 64-row block. Each plan (tiers.tensor_live_smem, csrc live_smem)
    fits its blocks an SM beside a 4-stage ring, one block an SM with two
    plane sets (the split a step ahead); P is its blocks' wave."""
    import os
    import re

    from tpu_knn_torch.kernels import tiers

    csrc = os.path.join(os.path.dirname(tiers.__file__), "..", "csrc")
    with open(os.path.join(csrc, "tensor_mainloop.cuh")) as f:
        live = re.search(r"kQResidentLiveBytes = (\d+) \* 1024;", f.read())
    assert int(live.group(1)) * 1024 == tiers.TENSOR_Q_LIVE_BYTES
    for precision in ("bf16x3", "bf16x4", "default", "bf16x3_presplit", "packed"):
        for k in list(range(1, 200, 7)) + [256, 768, 1000, 2048, 7000, 16368, 16384]:
            terms = tiers.ladder_terms(precision, k)
            k16 = -(-k // 16) * 16
            for m in (1, 2, 3, 16, 63, 64, 65, 100, 1024):
                if not pt_fused.const_query_fits(m, k):
                    continue
                if tiers.tensor_q_resident(terms, k16):
                    assert k16 <= (96 if len(terms) > 1 else 192)
                    continue
                epilogue = tiers.tensor_live_epilogue(terms, m, k16)
                rows, per_sm = tiers.tensor_rows(epilogue), tiers.tensor_blocks_per_sm(epilogue)
                assert (rows, per_sm) == ((32, 2) if m <= 32 and tiers._live_q_bytes(
                    terms, m, k16, 32) <= tiers.tensor_q_resident_limit(32) else (64, 1))
                budget = min(tiers.SMEM_PER_SM // per_sm - tiers.SMEM_PER_BLOCK_RESERVED,
                             tiers.SMEM_PER_BLOCK)
                assert tiers.tensor_live_q_bytes(terms, m, k16) <= (
                    tiers.TENSOR_Q_LIVE_BYTES if per_sm == 1 else
                    tiers.tensor_q_resident_limit(rows))
                kc = tiers.tensor_chunk(k16)
                assert tiers.tensor_stages(0, terms, kc, epilogue) == 4
                assert tiers.tensor_plane_sets(0, terms, kc, epilogue) == 3 - per_sm
                assert tiers.tensor_live_smem(terms, m, k16) <= budget
                wave = pt_tuning._wave_parts(-(-m // rows) * 4, 8192, 4, per_sm)
                assert tiers.resident_tier_parts(precision, m, k, 1 << 20) == wave
    assert tiers.resident_tier_parts("packed", 1024, 16, 1 << 20) == tiers.tensor_parts(
        1024, 1 << 20)


@pytest.mark.parametrize("precision", ["bf16x3", "bf16x4", "default"])
def test_v6_live_plans_fit_at_both_heights_and_fill_the_card(precision):
    """Every live-row epilogue's plan, at its q budget (csrc
    LiveEpi::kLiveQBytes: TENSOR_Q_LIVE_BYTES one block an SM, a block's
    q_resident_limit two), fits its blocks an SM with a 4-stage ring for
    every term list v6 runs and both chunks; one block an SM keeps two
    plane sets. At every m <= 64 and k <= 16384 the guard admits beyond
    B1's own launch, the chosen plan holds the live rows' parts, and its P
    fills 90-100% of one wave of the card's slots at n = 2^20."""
    from tpu_knn_torch.kernels import tiers

    terms_k = tiers.ladder_terms(precision, 768)
    for epilogue in tiers.LIVE_PLANS:
        per_sm = tiers.tensor_blocks_per_sm(epilogue)
        budget = min(tiers.SMEM_PER_SM // per_sm - tiers.SMEM_PER_BLOCK_RESERVED,
                     tiers.SMEM_PER_BLOCK)
        for kc in (16, 32):
            sets = tiers.tensor_plane_sets(0, terms_k, kc, epilogue)
            stages = tiers.tensor_stages(0, terms_k, kc, epilogue)
            _, _, r_stage, _, planes = tiers._tensor_plan(0, terms_k, kc,
                                                          tiers.tensor_rows(epilogue))
            most = (tiers._fixed_bytes(0, epilogue, sets) + stages * r_stage + sets * planes
                    + tiers._live_q_budget(epilogue))
            assert (stages, sets) == (4, 3 - per_sm) and most <= budget, (epilogue, kc)
    for k in [81, 97, 128, 200, 496, 512, 768, 780, 1024, 4000, 16368, 16384]:
        terms, k16 = tiers.ladder_terms(precision, k), -(-k // 16) * 16
        for m in range(1, 65):
            if not pt_fused.const_query_fits(m, k) or tiers.tensor_q_resident(terms, k16):
                continue
            epilogue = tiers.tensor_live_epilogue(terms, m, k16)
            assert tiers.tensor_live_q_bytes(terms, m, k16) <= tiers._live_q_budget(epilogue)
            parts = tiers.resident_tier_parts(precision, m, k, 1 << 20)
            slots = tiers.tensor_blocks_per_sm(epilogue) * pt_tuning.H100_SMS
            blocks = -(-m // tiers.tensor_rows(epilogue)) * 4 * parts
            assert 0.9 * slots <= blocks <= slots, (precision, k, m, epilogue, parts)


@pytest.mark.parametrize("k,m,n", [(16, 1, 1 << 24), (3, 1, 1 << 24), (16, 1024, 1 << 20),
                                   (3, 1024, 1 << 20), (768, 1024, 1 << 18), (16, 32, 1 << 20),
                                   (16, 33, 1 << 20), (40, 129, 1 << 20)])
def test_ladder_tier_parts_are_their_own_and_fill_the_card(k, m, n):
    """v3's and B10's tier instances take P from their own plan
    (tiers.ladder_tier_parts, not B1's tensor_parts): lane slices of
    32-row blocks, two an SM, at m <= 32, else of 128-row blocks, one an
    SM; at m = 1 over 2^24 points and at ds11 alike the launch's blocks
    fill 90-100% of one wave of the card's slots."""
    from tpu_knn_torch.kernels import tiers

    sms = pt_tuning.H100_SMS
    epilogue = tiers.ladder_epilogue(m)
    assert epilogue == ("ladder-serve" if m <= 32 else "ladder")
    parts = tiers.ladder_tier_parts(m, n)
    for rung in ("v3", "v5"):
        for precision in ("packed", "bf16x3", "default"):
            assert pt_fused.ladder_parts(rung, precision, m, k, n) == parts
    per_sm = tiers.tensor_blocks_per_sm(epilogue)
    blocks = -(-m // tiers.tensor_rows(epilogue)) * tiers.TENSOR_SLICES * parts
    assert 0.9 * per_sm * sms <= blocks <= per_sm * sms, (epilogue, parts, blocks)
    if m == 1:
        assert per_sm == 2 and parts > tiers.tensor_parts(m, n)


@pytest.mark.parametrize("epilogue", ["ladder", "ladder-serve"])
def test_ladder_heights_shared_memory_plans_fit_an_sm(epilogue):
    """Each ladder block height's plan (tiers.tensor_smem, csrc tensor_smem
    at LadderEpi<., BM>), for every term list v3 and B10 take at every k16,
    fits its blocks an SM and one block's limit beside a 4-stage ring: the
    128-row blocks with two sets of part planes (the split of chunk s + 1
    runs during step s, under the TMA policy too; csrc AosStaging::ahead
    keeps v3's bf16x4 with its q parts in the ring at its step), the
    32-row ones, two an SM, with one; the state is B1's fold at the
    block's rows."""
    from tpu_knn_torch.kernels import tiers

    per_sm = tiers.tensor_blocks_per_sm(epilogue)
    rows = tiers.tensor_rows(epilogue)
    assert tiers._epilogue(epilogue)[0] == tiers.tensor_fold_bytes(rows) == 8 * 4 * rows * 8
    budget = min(tiers.SMEM_PER_SM // per_sm - tiers.SMEM_PER_BLOCK_RESERVED,
                 tiers.SMEM_PER_BLOCK)
    seen = set()
    for precision in ("packed", "bf16x3", "bf16x4", "default"):
        for k in range(1, 1025):
            for aos in (True, False):
                terms = tiers.ladder_terms(precision, k, aos=aos)
                k16 = -(-k // 16) * 16
                kc = tiers.tensor_chunk(k16, terms, tiers.packed_tier(precision, k, aos=aos))
                smem = tiers.tensor_smem(0, terms, kc, k16, epilogue)
                assert smem <= budget and smem % 16 == 0, (precision, k, smem)
                assert tiers.tensor_stages(0, terms, kc, epilogue) == 4
                assert tiers.tensor_plane_sets(0, terms, kc, epilogue) == (
                    2 if epilogue == "ladder" else 1)
                seen.add(len(terms))
    assert seen == {1, 3, 4, 8, 9}
    if epilogue == "ladder":  # B1's block: its plan to the byte
        for terms, kc, k16 in ((tiers.term_list("packed", 16), 16, 16),
                               (tiers.term_list("bf16x3", 768), 32, 768)):
            assert tiers.tensor_smem(0, terms, kc, k16, "ladder") == tiers.tensor_smem(
                0, terms, kc, k16, "B1")


# ---- the sharded tier (distributed/sharded.py) --------------------------------

#: Mesh shapes the sharded layouts are pinned at, tpu_knn's on its 8
#: virtual devices beside the port's of logical CPU shards.
MESH_SHAPES = [(None, 1, 8), (None, 2, 4), (None, 8, 1), (2, 1, 4), (2, 2, 2), (4, 1, 2)]


def _meshes(dcn, dp, sp):
    from tpu_knn.distributed import sharded as jx_sharded
    from tpu_knn_torch.distributed import sharded as pt_sharded

    if dcn is None:
        return (jx_sharded.default_mesh(dp=dp, sp=sp),
                pt_sharded.default_mesh(dp=dp, sp=sp, devices="cpu"))
    return (jx_sharded.multislice_mesh(dcn, dp=dp, sp=sp),
            pt_sharded.multislice_mesh(dcn, dp=dp, sp=sp, devices="cpu"))


@pytest.mark.parametrize("k", KS)
def test_sharded_small_n_and_v8_shape_guard(k):
    """_small_n verbatim, and v8's guard over a count of devices: tpu_knn's
    over its 8 devices is the port's shape part at 8 (the port counts
    distinct CUDA cards, none here)."""
    from tpu_knn.distributed import sharded as jx_sharded
    from tpu_knn_torch.distributed import sharded as pt_sharded

    for m in MS:
        for n in NS:
            assert pt_sharded._small_n(k, m, n) == jx_sharded._small_n(k, m, n)
            assert pt_sharded._v8_shape_ok(k, m, n, 8) == jx_sharded._v8_guard(k, m, n)
            assert not pt_sharded._v8_shape_ok(k, m, n, 1)


@pytest.mark.parametrize("shape", MESH_SHAPES)
def test_sharded_layouts_follow_tpu_knn(shape):
    """sharded_layout (the prepared f32/bf16 layout, at tpu_knn's m_hint and
    at other batches), int8_sharded_layout, and the n_local the per-call
    builders pick, on meshes of equal shape."""
    from tpu_knn.distributed import sharded as jx_sharded
    from tpu_knn_torch.distributed import sharded as pt_sharded

    jx_mesh, pt_mesh = _meshes(*shape)
    for k in (1, 3, 8, 16, 33, 128, 768):
        for n in (1, 5, 130, 1000, 4097, 100_000, 1 << 20, 1 << 24):
            for m_hint in (1, 8, 100, 1024):
                assert (pt_sharded.sharded_layout(n, k, pt_mesh, m_hint)
                        == jx_sharded.sharded_layout(n, k, jx_mesh, m_hint)), (k, n, m_hint)
            assert (pt_sharded.int8_sharded_layout(n, pt_mesh)
                    == jx_sharded.int8_sharded_layout(n, jx_mesh))
    # The per-call builders' n_local: tpu_knn's tile rules at the shard's
    # batch block (sharded.py:104-108 and 195-205).
    shards = pt_mesh.shape["sp"] * pt_mesh.shape.get("dcn", 1)
    dp = pt_mesh.shape["dp"]
    for k, m, n, kk in ((6, 17, 20_000, 6), (16, 1024, 1 << 20, 8), (5, 80, 4096, 32),
                        (3, 4, 1030, 16), (16, 64, 1 << 20, 64), (4, 12, 8192, 160)):
        m_local = -(-m // (dp * 8)) * 8
        per_shard = -(-n // shards)
        packed = jx_fused.auto_precision(k, n) == "packed"
        _, tile_n = jx_tuning.pick_tiles(k, m_local, per_shard, wide=packed)
        want = -(-per_shard // tile_n) * tile_n
        assert pt_sharded._build_sharded(m, n, k, pt_mesh).n_local == want
        if jx_topk._auto_method(m_local, kk) == "sweep":
            _, tile_n = jx_topk._sweep_tiles(k, m_local, per_shard, kk,
                                             jx_fused.auto_precision(k, n))
        else:
            _, tile_n = jx_tuning.pick_tiles(k, m_local, per_shard)
        assert (pt_sharded._build_sharded_topk(m, n, k, kk, pt_mesh).n_local
                == -(-per_shard // tile_n) * tile_n), (k, m, n, kk)

