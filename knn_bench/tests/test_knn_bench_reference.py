import numpy as np
import pytest
import torch

from knn_bench import reference, spec

L2 = spec.reference("l2")
COSINE = spec.reference("cosine")


def brute(points, queries, kk, metric):
    """Every key in float64 NumPy, rows ordered by (key, index)."""
    p, q = points.astype(np.float64), queries.astype(np.float64)
    if metric == "l2":
        keys = ((q[:, None, :] - p[None, :, :]) ** 2).sum(-1)
    else:
        pn = p / np.linalg.norm(p, axis=1, keepdims=True)
        qn = q / np.linalg.norm(q, axis=1, keepdims=True)
        keys = -(qn @ pn.T)
    idx = np.stack([np.lexsort((np.arange(len(p)), row))[:kk] for row in keys])
    return np.take_along_axis(keys, idx, 1), idx


@pytest.mark.parametrize("metric, ref", [("l2", L2), ("cosine", COSINE)])
@pytest.mark.parametrize("kk, block", [(1, 65536), (5, 64), (12, 7)])
def test_exact_topk_is_brute_force(metric, ref, kk, block):
    rng = np.random.default_rng(3)
    points = rng.standard_normal((300, 9)).astype(np.float32)
    queries = rng.standard_normal((17, 9)).astype(np.float32)
    keys, idx = reference.exact_topk(torch.from_numpy(points), torch.from_numpy(queries), kk,
                                     ref, "f64", block=block)
    want_keys, want_idx = brute(points, queries, kk, metric)
    np.testing.assert_array_equal(idx.numpy(), want_idx)
    np.testing.assert_allclose(keys.numpy(), want_keys, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("block", [65536, 10, 3])
def test_planted_ties_go_to_the_lowest_index(block):
    """Copies of one point at several indices, in different blocks: the
    lower indices come first, and a tie straddling the K-th answer keeps
    the lowest."""
    rng = np.random.default_rng(5)
    points = rng.random((40, 4)).astype(np.float32)
    for i in (3, 11, 12, 29, 38):
        points[i] = points[20]
    queries = points[[20, 20]].copy()
    queries[1] += 1e-3
    _, idx = reference.exact_topk(torch.from_numpy(points), torch.from_numpy(queries), 4, L2,
                                  "f64", block=block)
    assert idx[0].tolist() == [3, 11, 12, 20]
    assert idx[1].tolist() == [3, 11, 12, 20]


def test_round_tf32_keeps_ten_mantissa_bits_to_nearest():
    x = torch.tensor([1.0, 1 + 2**-11, 1 + 3 * 2**-11, 1 + 2**-12, -3.14159, 1e-20],
                     dtype=torch.float32)
    r = reference.round_tf32(x)
    assert (r.view(torch.int32) & 0x1FFF).eq(0).all()
    assert r[0] == 1.0 and r[1] == 1.0 and r[2] == 1 + 4 * 2**-11 and r[3] == 1.0
    assert ((r - x).abs() <= x.abs() * 2**-11).all()


def test_the_control_answers_as_the_index_does():
    rng = np.random.default_rng(8)
    points = torch.from_numpy(rng.random((500, 16)).astype(np.float32))
    queries = torch.from_numpy(rng.random((6, 16)).astype(np.float32))
    idx, scores = reference.answer(points, queries, 3, COSINE, "tf32")
    assert idx.dtype == torch.int32 and scores.dtype == torch.float32
    assert (scores[:, :-1] >= scores[:, 1:]).all()   # similarity, descending
    _, exact = reference.exact_topk(points, queries, 3, COSINE, "f64")
    assert (idx.long() == exact).float().mean() > 0.5
