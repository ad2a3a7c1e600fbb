"""The rest of the one-device 1-NN ladder (v1, v2, v3, v5, v6) against the
same tpu_knn versions on seeded numpy inputs, on the CPU: the port runs
its kernels' plain versions, tpu_knn its Pallas kernels in interpret mode.

Where both sides rerank their candidates exactly (v3, v5, v6) the indices
must be identical; v1/v2 select on f32 norm-trick scores (both sides), so
there `check_results` must report 0 errors at ±1e-3."""

import os

import numpy as np
import pytest

import tpu_knn
import tpu_knn_torch
from tpu_knn.harness.checker import check_results
from tpu_knn.harness.generator import TA_SHAPES
from tpu_knn.kernels.tuning import pick_tiles
from tpu_knn.oracle import oracle_knn
from tpu_knn_torch.engine.registry import get_version
from tpu_knn_torch.kernels import dma_pipeline, fused, twophase
from tpu_knn_torch.kernels.tuning import TILED_TILE_GROUPS, resident_geometry
from tpu_knn_torch.utils.platform import as_f32_pair

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                      "results_seed1000.csv")


def _golden_indices():
    with open(GOLDEN) as f:
        lines = [ln.strip().rstrip(",") for ln in f if ln.strip()]
    return [np.array([int(x) for x in lines[2 * i].split(",")])
            for i in range(len(TA_SHAPES))]


EXACT = ["v3", "v5", "v6"]
LADDER = ["v1", "v2"] + EXACT


@pytest.mark.parametrize("version", LADDER)
def test_ta_shapes_match_golden(ta_datasets, version):
    for ((k, m, n), search, ref), gold in zip(ta_datasets, _golden_indices()):
        idx = tpu_knn_torch.knn_callback(k, m, n, search, ref, version=version,
                                         device="cpu")
        assert idx.dtype == np.int32 and idx.shape == (m,)
        assert check_results(gold, idx, search, ref)[0] == 0, (k, m, n)
        if version in EXACT:
            np.testing.assert_array_equal(idx, gold, err_msg=f"{(k, m, n)}")


def _planted(m, n, k, seed):
    """Exact duplicates of query i's point at two adjacent columns astride
    a lane boundary (127 | 128), tpu_knn's n tile boundary for v3/v4/v6
    and for v5, and the port's partition boundaries (B1's, which v3 and
    B10 take, and v6's), so ties decide every planted row; points 0.5
    away from the queries otherwise."""
    rng = np.random.default_rng(seed)
    q = rng.random((m, k), np.float32)
    r = rng.random((n, k), np.float32) + 0.5
    cols = [127, pick_tiles(k, m, n)[1] - 1, dma_pipeline._dma_tiles(k, m, n)[1] - 1]
    for parts in (fused.tiled_parts(m, k, n), resident_geometry(m, k, n).parts):
        gpp = -(-(-(-n // 128)) // parts)
        cols += [p * gpp * 128 - 1 for p in range(1, min(parts, 4))]
    cols = sorted({c for c in cols if 0 < c < n - 1})[:m]
    for i, c in enumerate(cols):
        r[c] = r[c + 1] = q[i]
    return q, r, cols


@pytest.mark.parametrize("version", LADDER)
@pytest.mark.parametrize("m,n,k", [(12, 6000, 6), (3, 9000, 16), (40, 5000, 3)])
def test_matches_tpu_knn_with_planted_duplicates(version, m, n, k):
    q, r, cols = _planted(m, n, k, seed=m * n + k)
    want = tpu_knn.nearest_neighbors(q, r, version=version)
    got = tpu_knn_torch.nearest_neighbors(q, r, version=version, device="cpu")
    oracle = oracle_knn(q, r)
    np.testing.assert_array_equal(got[:len(cols)], cols)
    if version in EXACT:
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, oracle)
    else:
        assert check_results(want, got, q, r)[0] == 0
        assert check_results(oracle, got, q, r)[0] == 0


@pytest.mark.parametrize("version", ["v3", "v6"])
@pytest.mark.parametrize("m,n,k", [(5, 3001, 3), (40, 4099, 5), (9, 2777, 40),
                                   (2, 1500, 500), (1, 4097, 16)])
def test_b1_variants_match_tpu_knn(version, m, n, k):
    """v3 and v6 (B1's tiled kernel over the (n, k) array, and with
    resident queries) against tpu_knn's v3 and v6 at k in {3, 5, 16, 40,
    500} (500 above the lane-per-thread v3's old limit of 393), n ragged
    against 128, with duplicates planted astride their partition
    boundaries: identical indices, equal to the oracle's."""
    q, r, cols = _planted(m, n, k, seed=7 * n + k)
    want = tpu_knn.nearest_neighbors(q, r, version=version)
    got = tpu_knn_torch.nearest_neighbors(q, r, version=version, device="cpu")
    np.testing.assert_array_equal(got[:len(cols)], cols)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, oracle_knn(q, r))


@pytest.mark.parametrize("version", LADDER)
def test_winner_at_chunk_and_slice_edges(version):
    """A unique planted winner at the first and last column, at v2's chunk
    boundary and at the tiled kernel's column-tile and partition edges (B1's
    geometry, which v3 and B10 take), with n ragged against every tile."""
    rng = np.random.default_rng(11)
    n, k = 70_001, 5
    search = np.full((1, k), 0.5, np.float32)
    tile_cols = TILED_TILE_GROUPS * 128
    part_cols = -(-(-(-n // 128)) // fused.tiled_parts(1, k, n)) * 128
    assert tile_cols < part_cols < 65535
    for pos in (0, tile_cols - 1, tile_cols, part_cols - 1, part_cols, 65535, 65536, n - 1):
        ref = rng.random((n, k), np.float32)
        ref[pos] = 0.5
        got = get_version(version)(k, 1, n, *as_f32_pair(search, ref, "cpu"))
        assert np.sum((ref[got[0]] - 0.5) ** 2) == 0.0, (version, pos, got)


def test_v1_delegates_to_v2_past_its_budget(monkeypatch):
    assert not twophase._v1_guard(3, 1 << 16, 1 << 15)
    assert twophase._v1_guard(16, 1024, 1 << 20)
    monkeypatch.setattr(twophase, "V1_MAX_TOTAL_BYTES", 1 << 20)
    k, m, n = 3, 4, 50_000
    assert not twophase._v1_guard(k, m, n)
    calls = []
    monkeypatch.setattr(twophase, "_v2_argmin",
                        lambda *a, f=twophase._v2_argmin: calls.append(1) or f(*a))
    rng = np.random.default_rng(33)
    q, r = rng.random((m, k), np.float32), rng.random((n, k), np.float32)
    got = tpu_knn_torch.knn_callback(k, m, n, q, r, version="v1", device="cpu")
    assert calls == [1]
    assert check_results(oracle_knn(q, r), got, q, r)[0] == 0


def test_v5_delegates_wide_k_to_v4(monkeypatch):
    """At tpu_knn's own delegation case (k = 2048, where its v5 guard sends
    the call to v4) the port's v5 has no guard to fail: B10's ring does not
    grow with k, so v5 answers through B10 itself (at its resolved tier,
    bf16x3, B10's tensor-core instance at its own P), with tpu_knn's v5
    (that is, v4) answer."""
    from tpu_knn_torch.kernels import tiers

    from tpu_knn.kernels import dma_pipeline as jx_dma

    rng = np.random.default_rng(55)
    k, m, n = 2048, 4, 4096
    assert not jx_dma._v5_guard(k, m, n)
    assert get_version("v5").guard is None and get_version("v5").fallback == "v4"
    calls = []
    orig = dma_pipeline.dma_candidates
    monkeypatch.setattr(dma_pipeline, "dma_candidates",
                        lambda *a: calls.append(a[3:]) or orig(*a))
    q, r = rng.random((m, k), np.float32), rng.random((n, k), np.float32)
    got = tpu_knn_torch.knn_callback(k, m, n, q, r, version="v5", device="cpu")
    assert calls == [(tiers.ladder_tier_parts(m, n), "bf16x3")]
    np.testing.assert_array_equal(got, tpu_knn.knn_callback(k, m, n, q, r, version="v5"))
    np.testing.assert_array_equal(got, oracle_knn(q, r))


@pytest.mark.parametrize("m,n,k", [(6, 3000, 250), (4, 4096, 2048)])
def test_b10_matches_tpu_knn_past_the_old_guard(m, n, k):
    """v5 at k = 250 and 2048, past the lane-per-thread B10's guard (k <=
    199 at m = 1), against tpu_knn's v5 (its own DMA kernel at k = 250, v4
    at 2048), with duplicates planted astride B1's partition edges:
    identical indices, equal to the oracle's."""
    q, r, cols = _planted(m, n, k, seed=n + k)
    got = tpu_knn_torch.nearest_neighbors(q, r, version="v5", device="cpu")
    np.testing.assert_array_equal(got[:len(cols)], cols)
    np.testing.assert_array_equal(got, tpu_knn.nearest_neighbors(q, r, version="v5"))
    np.testing.assert_array_equal(got, oracle_knn(q, r))


def test_refine_takes_bare_indices():
    """v5's candidates are indices only: the bare-index _refine reranks
    every lane exactly, and equals the (idx, score) form's full rerank."""
    import torch

    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.random((7, 4), np.float32))
    r = torch.from_numpy(rng.random((3000, 4), np.float32))
    r_op = fused.prep_soa(r, 3072)
    parts = 3
    idx = dma_pipeline.dma_candidates(q, r_op, 3000, parts)
    assert idx.shape == (7, parts * 128) and idx.dtype == torch.int32
    got = fused._refine(q, r, idx, 3000)
    want = fused._exact_rerank(q, r, fused.fused_candidates(q, r_op, 3000, parts)[0], 3000)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    np.testing.assert_array_equal(got[0].numpy(), oracle_knn(q.numpy(), r.numpy()))


def test_b10_plain_candidates_against_tpu_knn():
    """B10's plain candidates at one partition against tpu_knn's B1
    contract (v5's kernel shares it): lane indices agree but for f32
    near-ties, and the refined answers are identical to tpu_knn's v5."""
    import torch
    from tpu_knn.kernels.dma_pipeline import dma_knn as jx_dma_knn
    from tpu_knn.kernels.fused import _build_fused_candidates

    m, n, k = 24, 9000, 8
    q, r, _ = _planted(m, n, k, seed=8)
    tm, tn = pick_tiles(k, m, n)
    ji, _ = _build_fused_candidates(m, n, k, tm, tn, True, "highest")(q, r)
    pt = torch.from_numpy
    got = dma_pipeline.dma_candidates_plain(pt(q), fused.prep_soa(pt(r), 9088), n, 1)
    assert (got.numpy() == np.asarray(ji)).mean() >= 0.99
    pi, pd = dma_pipeline.dma_knn(q, r, device="cpu")
    wi, wd = jx_dma_knn(q, r)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(pd.numpy(), np.asarray(wd), rtol=1e-6, atol=1e-7)


def test_every_ladder_version_registered():
    assert set(tpu_knn_torch.list_versions()) == {f"v{i}" for i in
                                                  (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11)}
    for name in ("v1", "v3", "v5", "v6", "v8", "v9", "v10", "v11"):
        assert get_version(name).fallback == tpu_knn.get_version(name).fallback
    assert get_version("v2").guard is None and get_version("v4").guard is None
    assert len(TA_SHAPES) == 8
