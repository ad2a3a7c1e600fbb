"""NNIndex metric="cosine"/"ip" in the port, held against tpu_knn's on
the same numpy inputs (after tests/test_metrics.py).

Both packages transform NumPy points with the same f32 NumPy arithmetic,
so the stored points are equal bit for bit; the queries are transformed on
each package's device, so the gate is index equality (1-NN, top-K, radius)
and scores within 1e-5 (cosine similarity, or the exact f32 q·r).
"""

import numpy as np
import pytest
import torch

import tpu_knn_torch
from tpu_knn.engine.index import NNIndex as JaxIndex

NNIndex = tpu_knn_torch.NNIndex

SCORE_TOL = 1e-5


def _same(got, want):
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    a, b = got[1].numpy(), np.asarray(want[1])
    np.testing.assert_array_equal(np.isfinite(a), np.isfinite(b))
    np.testing.assert_allclose(a[np.isfinite(a)], b[np.isfinite(b)], rtol=SCORE_TOL,
                               atol=SCORE_TOL)


def _points(seed, n, k, shift=0.3, scale=5.0):
    rng = np.random.default_rng(seed)
    return rng, (rng.random((n, k), np.float32) - shift) * scale


@pytest.mark.parametrize("metric", ["cosine", "ip"])
@pytest.mark.parametrize("k,n", [(6, 5000), (16, 4000), (128, 3000)])
def test_metric_index_matches_tpu_knn(metric, k, n):
    """The transformed points equal tpu_knn's bit for bit, the tier is
    auto_precision's at the stored k (at k = 128 a tensor-core tier), and
    1-NN and top-K at m = 1, 3, 40 give tpu_knn's indices and scores."""
    rng, ref = _points(k, n, k)
    ix, jx = NNIndex(ref, metric=metric, device="cpu"), JaxIndex(ref, metric=metric)
    np.testing.assert_array_equal(ix.ref_dev.numpy(), np.asarray(jx.ref_dev))
    assert (ix.k, ix.k_user, ix.precision, ix.tile_n) == (jx.k, jx.k_user, jx.precision,
                                                          jx.tile_n)
    if metric == "ip":
        assert ix._ip_m2 == jx._ip_m2 and ix.k == k + 1
    for m in (1, 3, 40):
        q = (rng.random((m, k), np.float32) - 0.3) * 2.0
        _same(ix.query(q), jx.query(q))
        _same(ix.query(q, neighbors=10), jx.query(q, neighbors=10))


def test_cosine_radius_takes_a_minimum_similarity():
    rng, ref = _points(4, 6000, 3, shift=-0.1, scale=1.0)
    ix, jx = NNIndex(ref, metric="cosine", device="cpu"), JaxIndex(ref, metric="cosine")
    q = rng.random((5, 3), np.float32) + 0.1
    for s_min, cap in ((0.999, None), (0.9999, 4)):
        got, want = ix.query_radius(q, s_min, cap), jx.query_radius(q, s_min, cap)
        _same(got[:2], want[:2])
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
        sim = got[1].numpy()
        assert (sim[np.isfinite(sim)] >= s_min - SCORE_TOL).all()
        assert (got[2].numpy() > 0).any()


def test_ip_planted_winner_beats_the_nearer_point():
    """MIPS is not 1-NN: a far point of large norm wins, as in tpu_knn."""
    rng = np.random.default_rng(6)
    ref = rng.random((4096, 4), np.float32)
    q = np.ones((1, 4), np.float32)
    ref[100] = q[0] * 1.001
    ref[200] = q[0] * 5.0
    ix = NNIndex(ref, metric="ip", device="cpu")
    assert int(ix.query(q)[0][0]) == 200
    assert int(NNIndex(ref, device="cpu").query(q)[0][0]) == 100
    _same(ix.query(q, neighbors=3), JaxIndex(ref, metric="ip").query(q, neighbors=3))


def test_metric_from_state_answers_like_tpu_knn():
    """A tpu_knn metric index's state (the transformed points, metric,
    k_user, _ip_m2) gives the port an index that answers as tpu_knn's."""
    rng, ref = _points(9, 4500, 7)
    q = (rng.random((20, 7), np.float32) - 0.3) * 2.0
    for metric in ("cosine", "ip"):
        jx = JaxIndex(ref, metric=metric)
        state = {"ref": np.asarray(jx.ref_dev), "r_op": np.asarray(jx.r_ops[0]),
                 "metric": metric, "k_user": jx.k_user}
        if metric == "ip":
            state["_ip_m2"] = jx._ip_m2
        ix = NNIndex.from_state(state, device="cpu")
        assert (ix.metric, ix.k_user) == (metric, 7)
        _same(ix.query(q), jx.query(q))
        _same(ix.query(q[:2], neighbors=5), jx.query(q[:2], neighbors=5))
        with pytest.raises(ValueError, match="k_user"):
            NNIndex.from_state(dict(state, k_user=3), device="cpu")


def test_metric_tensor_inputs_match_numpy_inputs():
    """Points handed over as a tensor are transformed in torch; the answers
    are the NumPy build's."""
    rng, ref = _points(11, 3000, 5)
    q = (rng.random((6, 5), np.float32) - 0.3) * 2.0
    for metric in ("cosine", "ip"):
        a = NNIndex(ref, metric=metric, device="cpu")
        b = NNIndex(torch.from_numpy(ref), metric=metric, device="cpu")
        torch.testing.assert_close(a.ref_dev, b.ref_dev, rtol=1e-6, atol=1e-6)
        assert torch.equal(a.query(q, neighbors=4)[0], b.query(q, neighbors=4)[0])
        assert torch.equal(a.query(torch.from_numpy(q))[0], a.query(q)[0])


def test_metric_validation_matches_tpu_knn():
    ref = np.ones((256, 3), np.float32)
    with pytest.raises(ValueError, match="metric must be"):
        NNIndex(ref, metric="l1", device="cpu")
    for strategy in ("kdtree", "auto", "projection"):
        with pytest.raises(ValueError, match="strategy='fused' or"):
            NNIndex(ref, strategy=strategy, metric="cosine", device="cpu")
    for store in ("bf16", "int8"):
        with pytest.raises(ValueError, match="store='float32'"):
            NNIndex(ref, metric="ip", store=store, device="cpu")
    z = ref.copy()
    z[7] = 0.0
    with pytest.raises(ValueError, match="zero vector"):
        NNIndex(z, metric="cosine", device="cpu")
    ip = NNIndex(ref, metric="ip", device="cpu")
    with pytest.raises(ValueError, match="radius"):
        ip.query_radius(np.ones((1, 3), np.float32), 1.0)
    cos = NNIndex(ref, metric="cosine", device="cpu")
    with pytest.raises(ValueError, match="minimum similarity"):
        cos.query_radius(np.ones((1, 3), np.float32), 2.0)
    with pytest.raises(ValueError, match="k=3"):
        cos.query(np.ones((1, 5), np.float32))
    with pytest.raises(ValueError, match="zero query"):
        cos.query(np.zeros((1, 3), np.float32))
    with pytest.raises(ValueError, match="k=3"):
        ip.query(np.ones((2, 4), np.float32), neighbors=2)
