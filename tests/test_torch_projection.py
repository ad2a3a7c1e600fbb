"""v11, NNIndex(strategy="projection") and strategy="auto" against
tpu_knn's on seeded numpy inputs, on the CPU (the port's B11 runs its
plain version, tpu_knn's window kernel runs in interpret mode). The
scenarios mirror tests/test_projection.py; indices are compared exactly
(both sides rerank their window candidates exactly and tie on the
original index), distances within f32 rounding (rtol 1e-6)."""

import numpy as np
import pytest
import torch

import tpu_knn
import tpu_knn_torch
from tpu_knn.engine.index import NNIndex as JaxIndex
from tpu_knn.harness.checker import check_results
from tpu_knn.kernels import projection as jx_proj
from tpu_knn.oracle import oracle_knn
from tpu_knn_torch.kernels import projection as pt_proj
from tpu_knn_torch.kernels.fused import _exact_rerank

ENGINES = {"kernel": "pallas", "scan": "scan"}   # port engine -> tpu_knn's


def _both(q, r, engine="kernel", **kw):
    """(port idx, port d2, tpu_knn idx, tpu_knn d2) from projection_knn."""
    pi, pd = pt_proj.projection_knn(q, r, engine=engine, device="cpu", **kw)
    ji, jd = jx_proj.projection_knn(q, r, engine=ENGINES[engine], **kw)
    return pi.numpy(), pd.numpy(), np.asarray(ji), np.asarray(jd)


def _tally():
    return dict(pt_proj.TALLY)


@pytest.mark.parametrize("engine", list(ENGINES))
def test_uniform_matches_tpu_knn(engine):
    """Both engines on uniform data: answers equal tpu_knn's and the
    oracle; the per-query certificates equal tpu_knn's engine's on the same
    index; the kernel engine (8192 covered columns) certifies every query,
    so it takes no fallback."""
    rng = np.random.default_rng(0)
    n, m, k = 50_000, 64, 3
    r = rng.random((n, k), np.float32)
    q = rng.random((m, k), np.float32)
    before = _tally()
    pi, pd, ji, jd = _both(q, r, engine, window=2048)
    assert pt_proj.TALLY["host_reads"] == before["host_reads"] + 1
    if engine == "kernel":
        assert pt_proj.TALLY["fallback_batches"] == before["fallback_batches"]
    np.testing.assert_array_equal(pi, ji)
    np.testing.assert_array_equal(pi, oracle_knn(q, r))
    np.testing.assert_allclose(pd, jd, rtol=1e-6)
    np.testing.assert_allclose(pd, ((q - r[pi]) ** 2).sum(1), rtol=1e-6)
    jx_index = jx_proj.build_projection_index(r)
    pt_index = tpu_knn_torch.NNIndex.from_state(
        {"ref": r, "proj_index": tuple(np.asarray(a) for a in jx_index)},
        device="cpu").proj_index
    if engine == "kernel":
        jok = jx_proj._build_pallas_window_query(m, n, k, 2048)(q, *jx_index)[2]
        pok = pt_proj._build_kernel_window_query(m, n, k, 2048)(torch.from_numpy(q),
                                                                *pt_index)[2]
    else:
        jok = jx_proj._build_window_query(m, n, k, 2048, 1)(q, *jx_index)[2]
        pok = pt_proj._build_window_query(m, n, k, 2048, 1)(torch.from_numpy(q), *pt_index)[2]
    np.testing.assert_array_equal(pok.numpy(), np.asarray(jok))


def test_build_projection_index_equals_tpu_knns():
    """order, axis, proj and inv_order exactly; r_aug apart from its ‖r‖²
    row (f32 summation order: within 1e-6 relative); the rest exactly."""
    rng = np.random.default_rng(12)
    r = rng.random((9000, 5), np.float32) * np.array([1, 3, 2, 1, 0.5], np.float32)
    r[100:110] = r[50]                                   # ties in the sort
    got = pt_proj.build_projection_index(r, device="cpu")
    want = [np.asarray(a) for a in jx_proj.build_projection_index(r)]
    for name, g, w in zip(("ref_sorted", "order", "axis", "proj"), got[:4], want[:4]):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    assert int(got[2]) == 1
    np.testing.assert_allclose(got[4].numpy(), want[4], rtol=1e-6)
    np.testing.assert_array_equal(got[5].numpy(), want[5])
    aug, jaug = got[6].numpy(), want[6]
    assert aug.shape == jaug.shape
    np.testing.assert_array_equal(np.delete(aug, 5, axis=0), np.delete(jaug, 5, axis=0))
    np.testing.assert_allclose(aug[5], jaug[5], rtol=1e-6)
    forced = pt_proj.build_projection_index(r, axis=3, device="cpu")
    np.testing.assert_array_equal(forced[1].numpy(),
                                  np.asarray(jx_proj.build_projection_index(r, axis=3)[1]))


def test_adversarial_identical_projections_fall_back():
    """Every point shares the split-axis coordinate: the bound never holds,
    so the batch takes B1's full scan and stays exact."""
    rng = np.random.default_rng(1)
    r = rng.random((5_000, 4), np.float32)
    r[:, 0] = 0.5
    r[:, 1] = 0.5
    q = rng.random((16, 4), np.float32)
    pre = pt_proj.build_projection_index(r, axis=0, device="cpu")
    before = _tally()
    pi, _ = pt_proj.projection_knn(q, r, window=256, prebuilt=pre, device="cpu")
    assert pt_proj.TALLY["fallback_batches"] == before["fallback_batches"] + 1
    ji, _ = jx_proj.projection_knn(q, r, window=256,
                                   prebuilt=jx_proj.build_projection_index(r, axis=0))
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(pi.numpy(), oracle_knn(q, r))


def test_exact_duplicate_beats_near_tie():
    rng = np.random.default_rng(7)
    r = rng.random((20_000, 4), np.float32)
    q = r[777][None, :].copy()
    r[500] = q[0]
    r[10] = q[0] + np.float32(1e-4) * np.eye(4, dtype=np.float32)[0]
    pi, pd, ji, _ = _both(q, r, window=2048)
    assert float(pd[0]) == 0.0 and int(pi[0]) == 500 == int(ji[0])


def test_duplicate_ties_to_lowest_original_index():
    """The tie_src rule: a duplicate pair, sorted in either order by the
    projection, ties to the lowest ORIGINAL index, not the sorted position."""
    rng = np.random.default_rng(2)
    r = rng.random((4_000, 3), np.float32)
    r[3000] = r[100]
    r[20] = r[2500]
    q = np.stack([r[100], r[2500]]) + np.float32(1e-4)
    for engine in ENGINES:
        pi, _, ji, _ = _both(q, r, engine, window=1024)
        np.testing.assert_array_equal(pi, [100, 20])
        np.testing.assert_array_equal(pi, ji)
    # The rerank itself: candidates in sorted space, ties reported on order.
    src = torch.from_numpy(np.stack([r[3000], r[100], r[7]]))
    order = torch.tensor([3000, 100, 7], dtype=torch.int32)
    idx, d2 = _exact_rerank(
        torch.from_numpy(q[:1]), src, torch.tensor([[0, 1, 2]], dtype=torch.int32), 3,
        tie_src=order)
    assert int(idx[0]) == 100


def test_tiny_n_takes_the_fused_path():
    rng = np.random.default_rng(3)
    r = rng.random((10, 5), np.float32)
    q = rng.random((4, 5), np.float32)
    pi, _, ji, _ = _both(q, r, window=4096)
    np.testing.assert_array_equal(pi, ji)
    np.testing.assert_array_equal(pi, oracle_knn(q, r))


def test_clustered_near_duplicates():
    rng = np.random.default_rng(5)
    centers = rng.random((16, 4), np.float32)
    r = (centers[rng.integers(0, 16, 20_000)]
         + rng.normal(0, 1e-4, (20_000, 4))).astype(np.float32)
    q = (centers[rng.integers(0, 16, 32)] + rng.normal(0, 1e-4, (32, 4))).astype(np.float32)
    pi, _, ji, _ = _both(q, r, window=2048)
    assert check_results(oracle_knn(q, r), pi, q, r)[0] == 0
    assert check_results(ji, pi, q, r)[0] == 0


@pytest.mark.parametrize("engine", list(ENGINES))
def test_per_query_fallback_merge(engine):
    """Outlier queries fail the bound and get B1's answers; certified ones
    keep the window's: exact for both populations."""
    rng = np.random.default_rng(9)
    r = rng.random((30_000, 3), np.float32)
    q = np.concatenate([rng.random((8, 3)), 5.0 + rng.random((8, 3))]).astype(np.float32)
    before = _tally()
    pi, _, ji, _ = _both(q, r, engine, window=1024)
    assert pt_proj.TALLY["fallback_batches"] == before["fallback_batches"] + 1
    np.testing.assert_array_equal(pi, ji)
    np.testing.assert_array_equal(pi, oracle_knn(q, r))


def test_ragged_groups_in_the_scan_engine():
    rng = np.random.default_rng(8)
    r = rng.random((50_000, 3), np.float32)
    q = rng.random((100, 3), np.float32)             # 100 % 8 != 0
    pi, _, ji, _ = _both(q, r, "scan", window=2048, group=8)
    np.testing.assert_array_equal(pi, ji)
    np.testing.assert_array_equal(pi, oracle_knn(q, r))


def test_window_query_equals_tpu_knns_on_one_index():
    """The window engine alone (no fallback) on tpu_knn's own index: the
    port's B11 plain candidates, rerank and certificate give tpu_knn's
    (idx, d2, ok) exactly, with the window ragged against TILE_W and its
    start at the last tile; and the candidates cut into splits agree with
    one split's after the rerank. (tpu_knn does not expose its raw lane
    candidates, so the comparison is after the exact rerank.)"""
    rng = np.random.default_rng(21)
    n, k, m = 13_000, 3, 24
    r = rng.random((n, k), np.float32)
    q = rng.random((m, k), np.float32)
    q[0, :] = 0.999                                  # window at the last tile
    r[12_990] = q[0]
    jx_index = jx_proj.build_projection_index(r)
    pt_index = tpu_knn_torch.NNIndex.from_state(
        {"ref": r, "proj_index": tuple(np.asarray(a) for a in jx_index)},
        device="cpu").proj_index
    for window in (4096, 5000):
        ji, jd, jok = (np.asarray(a) for a in jx_proj._build_pallas_window_query(
            m, n, k, window)(q, *jx_index))
        run = pt_proj._build_kernel_window_query(m, n, k, window)
        pi, pd, pok = (a.numpy() for a in run(torch.from_numpy(q), *pt_index))
        np.testing.assert_array_equal(pi, ji)
        np.testing.assert_allclose(pd, jd, rtol=1e-6)
        np.testing.assert_array_equal(pok, jok)
        assert int(pi[0]) == 12_990 and pd[0] == 0.0
    w_tiles = pt_proj.window_tiles(n, 4096)
    tiles = torch.full((m,), (n - 4096) // pt_proj.TILE_W, dtype=torch.int32)
    qt = torch.from_numpy(q)
    one = pt_proj.window_candidates(qt, pt_index[6], tiles, w_tiles, 1)
    many = pt_proj.window_candidates(qt, pt_index[6], tiles, w_tiles, 5)
    a = _exact_rerank(qt, pt_index[0], one, n, tie_src=pt_index[1])
    b = _exact_rerank(qt, pt_index[0], many, n, tie_src=pt_index[1])
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_registered_version_v11():
    rng = np.random.default_rng(4)
    r = rng.random((30_000, 3), np.float32)
    q = rng.random((32, 3), np.float32)
    got = tpu_knn_torch.knn_callback(3, 32, 30_000, q, r, version="v11", device="cpu")
    np.testing.assert_array_equal(got, tpu_knn.knn_callback(3, 32, 30_000, q, r,
                                                            version="v11"))
    np.testing.assert_array_equal(got, oracle_knn(q, r))


# ---- the indexes ----------------------------------------------------------


def test_projection_index_and_from_state():
    rng = np.random.default_rng(6)
    r = rng.random((20_000, 3), np.float32)
    q = rng.random((10, 3), np.float32)
    q[3] = r[4321]
    jx = JaxIndex(r, strategy="projection")
    want = np.asarray(jx.query(q)[0])
    fresh = tpu_knn_torch.NNIndex(r, strategy="projection", device="cpu")
    state = {"ref": r, "proj_index": tuple(np.asarray(a) for a in jx.proj_index)}
    carried = tpu_knn_torch.NNIndex.from_state(state, device="cpu")
    for ix in (fresh, carried):
        assert ix.strategy == "projection"
        np.testing.assert_array_equal(ix.query(q)[0].numpy(), want)
    np.testing.assert_array_equal(carried.proj_index[6].numpy(), state["proj_index"][6])
    with pytest.raises(ValueError, match="neighbors>1"):
        carried.query(q, neighbors=3)
    with pytest.raises(ValueError, match="pipeline"):
        carried.pipeline(4)
    bad = list(state["proj_index"])
    bad[1] = bad[1].copy()
    bad[1][:2] = bad[1][0]
    with pytest.raises(ValueError, match="permutation"):
        tpu_knn_torch.NNIndex.from_state({"ref": r, "proj_index": bad}, device="cpu")
    bad = list(state["proj_index"])
    bad[6] = bad[6].copy()
    bad[6][0, 5] += 1.0
    with pytest.raises(ValueError, match="augmented"):
        tpu_knn_torch.NNIndex.from_state({"ref": r, "proj_index": bad}, device="cpu")


@pytest.fixture
def small_wins(monkeypatch):
    """projection_wins with the n and work clauses dropped, in both
    packages, so that auto routes to the window path at test sizes."""
    def wins(k, m, n):
        return k <= 4 and m <= 64

    monkeypatch.setattr(jx_proj, "projection_wins", wins)
    monkeypatch.setattr(pt_proj, "projection_wins", wins)


@pytest.mark.parametrize("flat", [False, True])
def test_auto_probe_and_routing_equal_tpu_knns(small_wins, flat):
    rng = np.random.default_rng(10)
    r = rng.random((12_000, 3), np.float32)
    if flat:
        # The widest axis takes two values only: every window edge has the
        # query's own projection, so the probe's bound never holds.
        r[:, 0] = rng.integers(0, 2, r.shape[0])
    jx = JaxIndex(r, strategy="auto")
    pt = tpu_knn_torch.NNIndex(r, strategy="auto", device="cpu")
    assert pt.cert_rate == jx.cert_rate
    assert (pt.proj_index is None) == (jx.proj_index is None) == flat
    for m in (1, 3, 16, 64, 65, 100):
        q = rng.random((m, 3), np.float32)
        pi = pt.query(q)[0].numpy()
        ji = np.asarray(jx.query(q)[0])
        assert pt.last_strategy == jx.last_strategy, m
        assert pt.last_strategy == ("projection" if m <= 64 and not flat else "fused")
        np.testing.assert_array_equal(pi, ji)
        np.testing.assert_array_equal(pi, oracle_knn(q, r))
    ki, _ = pt.query(r[:5], neighbors=4)             # top-K: the fused engines
    np.testing.assert_array_equal(ki.numpy()[:, 0], np.arange(5))
    assert pt.pipeline(16)[0] is not None


def test_auto_demotes_after_a_failing_window(small_wins):
    """10 certified batches and 22 failing ones (outliers) in one
    PROJ_FEEDBACK_PERIOD window: realized 10/32 < 0.5 demotes the route,
    as in tpu_knn, and the next batch serves fused."""
    rng = np.random.default_rng(13)
    r = rng.random((20_000, 3), np.float32)       # wider than one window's coverage
    jx = JaxIndex(r, strategy="auto")
    pt = tpu_knn_torch.NNIndex(r, strategy="auto", device="cpu")
    assert pt.PROJ_FEEDBACK_PERIOD == jx.PROJ_FEEDBACK_PERIOD == 32
    assert pt.PROJ_REALIZED_MIN == jx.PROJ_REALIZED_MIN
    assert pt.CERT_RATE_MIN == jx.CERT_RATE_MIN
    good = r[:2] + np.float32(1e-4)
    bad = 5.0 + rng.random((2, 3)).astype(np.float32)
    for b in range(32):
        q = good if b < 10 else bad
        np.testing.assert_array_equal(pt.query(q)[0].numpy(), np.asarray(jx.query(q)[0]))
        assert pt.last_strategy == jx.last_strategy == "projection"
        assert pt.proj_demoted == jx.proj_demoted == (b == 31)
    assert pt.realized_cert_rate == jx.realized_cert_rate == 10 / 32
    pt.query(good)
    jx.query(good)
    assert pt.last_strategy == jx.last_strategy == "fused"
