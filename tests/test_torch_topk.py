"""Exact top-K in tpu_knn_torch (kernels/topk.py, B4's wrapper in
kernels/fused.py, the index and API entries), held against tpu_knn on the
same numpy inputs (Pallas in interpret mode, as tests/test_topk.py runs it
on the CPU) and against a numpy lexicographic oracle."""

import numpy as np
import pytest
import torch

import tpu_knn
import tpu_knn_torch
from tpu_knn.engine.index import NNIndex as JaxIndex
from tpu_knn.kernels import fused as jx_fused
from tpu_knn.kernels import topk as jx_topk
from tpu_knn_torch.kernels import fused as pt_fused
from tpu_knn_torch.kernels import topk as pt_topk
from tpu_knn_torch.kernels.fused import prep_soa
from tpu_knn_torch.kernels.smallm import diff_scores

I32_MAX = 2**31 - 1
GRID = [            # tests/test_topk.py's conformance grid
    (3, 4, 1000, 5),
    (16, 8, 4096, 8),
    (5, 1, 2000, 16),
    (3, 2, 128, 128),   # K = n: full ordering
    (8, 4, 777, 3),     # ragged n
]


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.float32))


def _d2(q, r):
    return ((q[:, None, :] - r[None, :, :]) ** 2).sum(-1)


def oracle_topk(q, r, kk):
    return np.array([np.lexsort((np.arange(len(row)), row))[:kk]
                     for row in _d2(q, r)])


def _np(pair):
    return tuple(np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a)
                 for a in pair)


def _cases():
    for k, m, n, kk in GRID:
        for method in ("aos", "sweep", "passes"):
            if method == "aos" and m > 4:
                continue
            if method == "sweep" and kk > pt_topk.SWEEP_MAX_NEIGHBORS:
                continue
            yield k, m, n, kk, method
    yield 16, 12, 8192, 10, "sweep"       # B5, a second m > 4 shape
    yield 9, 3, 5000, 32, "sweep"         # B2 + B6 at the largest sweep K
    yield 1, 9, 3000, 8, "sweep"          # B5 at k = 1, m not a multiple of 8*TM
    yield 40, 3, 2000, 5, "sweep"         # B5 at k = 40 (m <= 4 but k > 32)
    yield 40, 13, 2000, 16, "sweep"       # B5 at k = 40, m = 13


@pytest.mark.parametrize("k,m,n,kk,method", list(_cases()))
def test_topk_matches_tpu_knn_and_oracle(k, m, n, kk, method):
    rng = np.random.default_rng(hash((k, m, n, kk)) % 2**31)
    q = rng.random((m, k), np.float32)
    r = rng.random((n, k), np.float32)
    want = oracle_topk(q, r, kk)
    ji, jd = _np(jx_topk.topk_knn(q, r, kk, method=method))
    pi, pd = _np(pt_topk.topk_knn(q, r, kk, method=method, device="cpu"))
    assert pi.dtype == np.int32 and pi.shape == (m, kk)
    np.testing.assert_array_equal(pi, want)
    np.testing.assert_array_equal(pi, ji)
    np.testing.assert_allclose(pd, jd, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(pd, np.take_along_axis(_d2(q, r), want, axis=1),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("kk", [2, 7, 32])
def test_sweep_and_passes_agree_exactly(kk):
    """The port's own differential (tests/test_topk.py's, mirrored): sweep
    and passes select by one lex (score, index) rule over one score
    function, so they agree bit for bit, planted duplicates included."""
    rng = np.random.default_rng(11)
    q = rng.random((16, 5), np.float32)
    r = rng.random((7000, 5), np.float32)
    r[303] = r[5999]  # exact duplicate pair crossing the candidate lanes
    r[42] = q[3]
    si, sd = pt_topk.topk_knn(q, r, kk, method="sweep", device="cpu")
    pi, pd = pt_topk.topk_knn(q, r, kk, method="passes", device="cpu")
    assert torch.equal(si, pi) and torch.equal(sd, pd)
    np.testing.assert_array_equal(si.numpy(), oracle_topk(q, r, kk))
    with pytest.raises(ValueError, match="sweep"):
        pt_topk.topk_knn(q, r, pt_topk.SWEEP_MAX_NEIGHBORS + 1, method="sweep",
                         device="cpu")


@pytest.mark.parametrize("method", ["auto", "aos", "sweep", "passes"])
@pytest.mark.parametrize("spots", [(401, 77, 240, 333, 105),
                                   (100, 228, 356, 484, 612)])  # one lane
def test_duplicates_ordered_by_index(method, spots):
    rng = np.random.default_rng(2)
    q = rng.random((1, 3), np.float32)
    r = rng.random((4000, 3), np.float32) + 2.0
    for s in spots:
        r[s] = q[0]
    for kk in (3, 5):
        idx, d2 = pt_topk.topk_knn(q, r, kk, method=method, device="cpu")
        np.testing.assert_array_equal(idx.numpy()[0], sorted(spots)[:kk])
        assert np.all(d2.numpy()[0] == 0.0)


@pytest.mark.parametrize("m,method", [(6, "auto"), (6, "passes"), (3, "sweep")])
def test_k1_equals_the_ports_1nn(m, method):
    rng = np.random.default_rng(3)
    q = rng.random((m, 4), np.float32)
    r = rng.random((3000, 4), np.float32)
    idx, _ = pt_topk.topk_knn(q, r, 1, method=method, device="cpu")
    np.testing.assert_array_equal(
        idx.numpy()[:, 0], tpu_knn_torch.nearest_neighbors(q, r, device="cpu"))


@pytest.fixture(scope="module")
def indexes():
    rng = np.random.default_rng(4)
    ref = rng.random((8000, 7), np.float32)
    ref[5000] = ref[17]
    jx = JaxIndex(ref, strategy="fused")
    state = {"ref": np.asarray(jx.ref_dev), "r_op": np.asarray(jx.r_ops[0])}
    return ref, jx, {"built": tpu_knn_torch.NNIndex(ref, device="cpu"),
                     "from_state": tpu_knn_torch.NNIndex.from_state(state,
                                                                   device="cpu")}


@pytest.mark.parametrize("kind", ["built", "from_state"])
@pytest.mark.parametrize("m,kk", [(1, 6), (3, 6), (8, 6), (3, 1), (8, 32)])
def test_index_topk_answers_like_tpu_knn(indexes, kind, m, kk):
    ref, jx, ours = indexes
    rng = np.random.default_rng(m * kk)
    q = rng.random((m, 7), np.float32)
    q[0] = ref[17]
    gi, gd = ours[kind].query(q, neighbors=kk)
    ji, jd = _np(jx.query(q, neighbors=kk))
    assert gi.shape == (m, kk) and gd.shape == (m, kk)
    np.testing.assert_array_equal(gi.numpy(), ji)
    np.testing.assert_array_equal(gi.numpy(), oracle_topk(q, ref, kk))
    np.testing.assert_allclose(gd.numpy(), jd, rtol=1e-6, atol=1e-7)
    if kk >= 2:
        np.testing.assert_array_equal(gi.numpy()[0, :2], [17, 5000])


def test_nearest_neighbors_topk_and_validation():
    rng = np.random.default_rng(95)
    r = rng.random((500, 3), np.float32)
    q = rng.random((3, 3), np.float32)
    got = tpu_knn_torch.nearest_neighbors(q, r, neighbors=6, device="cpu")
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, tpu_knn.nearest_neighbors(q, r, neighbors=6))
    np.testing.assert_array_equal(got, oracle_topk(q, r, 6))
    one = tpu_knn_torch.nearest_neighbors(q, r, neighbors=1, device="cpu")
    assert one.shape == (3, 1)
    empty = np.zeros((0, 3), np.float32)
    assert tpu_knn_torch.nearest_neighbors(empty, r, neighbors=5,
                                           device="cpu").shape == (0, 5)
    for bad in (0, -3, 501):
        for qq in (empty, q):
            with pytest.raises(ValueError, match="neighbors"):
                tpu_knn_torch.nearest_neighbors(qq, r, neighbors=bad, device="cpu")
    with pytest.raises(ValueError, match="version"):
        tpu_knn_torch.nearest_neighbors(q, r, version="v4", neighbors=3, device="cpu")
    with pytest.raises(ValueError, match="neighbors"):
        pt_topk.topk_knn(q, r, 0, device="cpu")
    with pytest.raises(ValueError, match="requires method"):
        pt_topk.topk_knn(q, rng.random((200, 3), np.float32), 129, method="aos",
                         device="cpu")


def test_seeded_batch_regime_answers():
    """The calls that raised until the seeded engine was ported now
    answer, as the passes engine and the oracle do."""
    rng = np.random.default_rng(5)
    r = rng.random((3000, 4), np.float32)
    q = rng.random((40, 4), np.float32)
    assert pt_topk._auto_method(40, 8) == "seeded"
    want = oracle_topk(q, r, 8)
    for kwargs in ({"method": "seeded"}, {}, {"method": "passes"}):
        idx, _ = pt_topk.topk_knn(q, r, 8, device="cpu", **kwargs)
        np.testing.assert_array_equal(idx.numpy(), want)
    idx, _ = pt_topk.topk_knn(q[:8], r, 33, device="cpu")     # K > 32: seeded
    np.testing.assert_array_equal(idx.numpy(), oracle_topk(q[:8], r, 33))
    idx, _ = tpu_knn_torch.NNIndex(r, device="cpu").query(q, neighbors=8)
    np.testing.assert_array_equal(idx.numpy(), want)


@pytest.mark.parametrize("m,cap,method", [(3, 16, "auto"), (6, 16, "auto"),
                                          (2, 8, "aos"), (3, 16, "passes")])
def test_within_radius_matches_tpu_knn(m, cap, method):
    rng = np.random.default_rng(90)
    q = rng.random((m, 4), np.float32)
    r = rng.random((3000, 4), np.float32)
    radius = 0.22
    got = _np(pt_topk.within_radius(q, r, radius, cap, method=method, device="cpu"))
    want = _np(jx_topk.within_radius(q, r, radius, cap, method=method))
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(got[2], want[2])
    D = _d2(q, r)
    for i in range(m):
        true = np.nonzero(D[i] <= radius ** 2)[0]
        row = got[0][i][got[0][i] >= 0]
        np.testing.assert_array_equal(row, true[np.lexsort((true, D[i, true]))][:cap])
    _, _, cnt0 = pt_topk.within_radius(q, r + 50.0, 0.1, 4, device="cpu")
    assert np.all(cnt0.numpy() == 0)
    with pytest.raises(ValueError, match="radius"):
        pt_topk.within_radius(q, r, -1.0, 4, device="cpu")


@pytest.mark.parametrize("m", [2, 3])
def test_within_radius_complete_escalates_like_tpu_knn(m):
    """70 points within the radius of query 0, more than the start cap
    of 32: the cap escalates 32 -> 64 -> 128 (aos at m = 2, the B2 + B6
    sweep at m = 3 while the cap stays <= 32, then passes at K > 32
    is not needed: auto resolves m = 3, K = 64 to the seeded engine, so
    m = 3 runs with method='passes')."""
    rng = np.random.default_rng(92)
    r = rng.random((1200, 3), np.float32) * 10.0
    q = rng.random((m, 3), np.float32)
    r[100:170] = q[0] + rng.normal(0, 0.1, (70, 3)).astype(np.float32)
    method = "auto" if m <= 2 else "passes"
    got = _np(pt_topk.within_radius_complete(q, r, 0.5, start_cap=32, method=method,
                                             device="cpu"))
    want = _np(jx_topk.within_radius_complete(q, r, 0.5, start_cap=32, method=method))
    assert got[0].shape == want[0].shape
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[2], want[2])
    D = _d2(q, r)
    for i in range(m):
        true = np.nonzero(D[i] <= 0.25)[0]
        assert got[2][i] == len(true) < got[0].shape[1]
    small = rng.random((40, 3), np.float32)
    idx, _, cnt = pt_topk.within_radius(q, small, 10.0, 64, device="cpu")
    assert idx.shape == (m, 64) and np.all(cnt.numpy() == 40)
    assert np.all(idx.numpy()[:, 40:] == -1)
    big = rng.random((pt_topk.PASSES_MAX_NEIGHBORS + 100, 3), np.float32)
    with pytest.raises(ValueError, match="max_results"):
        pt_topk.within_radius(q, big, 0.1, pt_topk.PASSES_MAX_NEIGHBORS + 1,
                              device="cpu")


@pytest.mark.parametrize("kind", ["built", "from_state"])
def test_query_radius_matches_tpu_knn(indexes, kind):
    """m = 1 escalates through the aos engine (more than the start cap of
    32 points in the radius); m = 2 stays within the B2 + B6 sweep's
    K <= 32 (its escalation past 32 would resolve to the seeded engine)."""
    ref, jx, ours = indexes
    rng = np.random.default_rng(94)
    q = rng.random((2, 7), np.float32)
    q1 = ref[3000:3001] + np.float32(0.01)
    for qq, radius, caps in ((q, 0.3, (None, 8, 24)), (q1, 0.45, (None, 16))):
        for cap in caps:
            got = _np(ours[kind].query_radius(qq, radius, cap))
            want = _np(jx.query_radius(qq, radius, cap))
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_allclose(got[1], want[1], rtol=1e-6, atol=1e-7)
            np.testing.assert_array_equal(got[2], want[2])
    assert int(_np(ours[kind].query_radius(q1, 0.45))[2][0]) > 32
    with pytest.raises(ValueError, match="ceiling"):
        ours[kind].query_radius(q, 30.0, 900)


# ---- plain versions of B4, B5, B6 against their contracts -----------------


def _lex_rank(s_row):
    return np.lexsort((np.arange(len(s_row)), s_row))


def _lists_of(ci, cs, parts, kk):
    """(m, parts*kk) candidates -> per (row, list) arrays (m, parts, kk)."""
    m = ci.shape[0]
    return ci.reshape(m, parts, kk), cs.reshape(m, parts, kk)


def _check_list_contract(s, ci, cs, n, parts, kk, seed=None):
    """Every list of every row is exactly its partition's kk lex-smallest
    (score, column) pairs below +inf (and, with seed, <= seed[row]),
    sorted; each real column maps to its list (topk.list_of); the slots
    left over hold (+inf, I32_MAX) or (seed[row], I32_MAX); the union of a
    row's lists holds the row's lex top-K."""
    m = s.shape[0]
    li, ls = _lists_of(ci, cs, parts, kk)
    gpp = -(-(-(-n // 128)) // parts)
    for i in range(m):
        ok = np.isfinite(s[i]) if seed is None else s[i] <= seed[i]
        for p in range(parts):
            cols = np.arange(p * gpp * 128, min(n, (p + 1) * gpp * 128))
            cols = cols[ok[cols]]
            want = cols[np.lexsort((cols, s[i][cols]))][:kk]
            real = li[i, p] < n
            assert real.sum() == len(want)
            np.testing.assert_array_equal(li[i, p][:len(want)], want)
            assert np.all(pt_topk.list_of(li[i, p][real], n, parts) == p)
            np.testing.assert_array_equal(ls[i, p][real], s[i][li[i, p][real]])
            assert np.all(li[i, p][~real] == I32_MAX)
            fill = np.inf if seed is None else seed[i]
            assert np.all(ls[i, p][~real] == fill)
        top = _lex_rank(np.where(ok, s[i], np.inf))[:kk]
        assert set(top[ok[top]]) <= set(ci[i])


@pytest.mark.parametrize("m,n,k,parts,kk", [
    (5, 3000, 4, 1, 8), (3, 1000, 16, 3, 32), (9, 777, 3, 2, 5), (2, 300, 6, 1, 1),
    (4, 266, 5, 3, 16),   # ragged n: the last list has 10 real columns for K = 16
])
def test_b5_plain_contract(m, n, k, parts, kk):
    """Each (row, partition) list holds the partition's lex top-K of the
    scores, sorted, empty slots (+inf, I32_MAX); the union holds the row's
    lex top-K."""
    rng = np.random.default_rng(m + n)
    q, r = _t(rng.random((m, k))), _t(rng.random((n, k)))
    r[100] = r[100 + 128] = r[50]                       # duplicates in one list
    r_op = prep_soa(r, -(-n // 128) * 128)
    ci, cs = pt_topk.sweep_candidates(q, r_op, n, parts, kk)
    assert ci.shape == cs.shape == (m, parts * kk)
    s = pt_fused.norm_scores(q, r_op, n).numpy()
    _check_list_contract(s, ci.numpy(), cs.numpy(), n, parts, kk)


@pytest.mark.parametrize("m,n,k,parts,kk", [
    (1, 3000, 8, 2, 8), (4, 5000, 16, 5, 32), (2, 700, 3, 1, 1), (3, 1000, 32, 3, 4),
    (4, 266, 5, 3, 16),   # ragged n: the last list has 10 real columns for K = 16
])
def test_b6_plain_contract(m, n, k, parts, kk):
    """Only scores <= the bound enter; the rest of each list is the seed
    (bound, I32_MAX); with the bound from a B2 pass the union holds the
    lex top-K."""
    from tpu_knn_torch.kernels import smallm

    rng = np.random.default_rng(m * n)
    q, r = _t(rng.random((m, k))), _t(rng.random((n, k)))
    r[10] = r[10 + 128] = q[0]
    r_op = prep_soa(r, -(-n // 128) * 128)
    _, cs1 = smallm.smallm_candidates(q, r_op, n, smallm.default_parts(n))
    bound = torch.topk(cs1, kk, dim=-1, largest=False).values[:, -1].contiguous()
    ci, cs = pt_topk.smallm_topk_candidates(q, r_op, n, parts, kk, bound)
    assert ci.shape == (m, parts * kk)
    s = diff_scores(q, r_op, n).numpy()
    ci, cs, b = ci.numpy(), cs.numpy(), bound.numpy()
    _check_list_contract(s, ci, cs, n, parts, kk, seed=b)
    for i in range(m):
        assert set(_lex_rank(s[i])[:kk]) <= set(ci[i][ci[i] < n])
    if kk >= 2:
        idx, _ = pt_topk._finalize_topk(q, r, torch.from_numpy(ci),
                                        torch.from_numpy(cs), kk, n)
        assert idx[0, :2].tolist() == [10, 138]


@pytest.mark.parametrize("kernel", ["B5", "B6"])
def test_topk_lists_keep_duplicates_across_lists(kernel):
    """Exact duplicates of query 0 at the last column of partition 0 and
    the first of partition 1 land in two lists, and the top-K takes them
    in index order; a third copy later in partition 1 follows them."""
    from tpu_knn_torch.kernels import smallm

    m, n, k, parts, kk = (6, 2000, 7, 4, 3) if kernel == "B5" else (3, 2000, 7, 4, 3)
    rng = np.random.default_rng(17)
    q, r = _t(rng.random((m, k))), _t(rng.random((n, k)))
    b = 4 * 128                                         # partition 1's first column
    for c in (b - 1, b, b + 300):
        r[c] = q[0]
    r_op = prep_soa(r, -(-n // 128) * 128)
    if kernel == "B5":
        ci, cs = pt_topk.sweep_candidates(q, r_op, n, parts, kk)
    else:
        _, cs1 = smallm.smallm_candidates(q, r_op, n, smallm.default_parts(n))
        bound = torch.topk(cs1, kk, dim=-1, largest=False).values[:, -1].contiguous()
        ci, cs = pt_topk.smallm_topk_candidates(q, r_op, n, parts, kk, bound)
    assert pt_topk.list_of(b - 1, n, parts) == 0 and pt_topk.list_of(b, n, parts) == 1
    li, _ = _lists_of(ci.numpy(), cs.numpy(), parts, kk)
    assert li[0, 0, 0] == b - 1 and li[0, 1, :2].tolist() == [b, b + 300]
    idx, d2 = pt_topk._finalize_topk(q, r, ci, cs, kk, n)
    assert idx[0].tolist() == [b - 1, b, b + 300] and float(d2[0, 0]) == 0.0


@pytest.mark.parametrize("m,n,k,parts", [(4, 3000, 5, 1), (7, 1000, 16, 3)])
def test_b4_plain_bound_masks_exactly(m, n, k, parts):
    """With the bound at the element of lex rank j, the banded fold's
    lex minimum is the element of rank j + 1, and no candidate is lex <=
    the bound; K passes enumerate the lex order."""
    rng = np.random.default_rng(n + k)
    q, r = _t(rng.random((m, k))), _t(rng.random((n, k)))
    r[127] = r[128] = r[300]                      # a tie across a lane boundary
    r_op = prep_soa(r, -(-n // 128) * 128)
    s = pt_fused.norm_scores(q, r_op, n).numpy()
    b_s = torch.full((m,), -torch.inf)
    b_i = torch.full((m,), -1, dtype=torch.int32)
    for j in range(6):
        ci, cs = pt_fused.banded_candidates(q, r_op, n, parts, b_s, b_i)
        ok = (cs.numpy() > b_s.numpy()[:, None]) | (
            (cs.numpy() == b_s.numpy()[:, None]) & (ci.numpy() > b_i.numpy()[:, None]))
        assert np.all(ok | (ci.numpy() == I32_MAX))
        b_i, b_s = pt_topk._lex_min(ci, cs)
        want = [_lex_rank(s[i])[j] for i in range(m)]
        np.testing.assert_array_equal(b_i.numpy(), want)


@pytest.mark.parametrize("m,n,k,tile_m,tile_n", [(20, 1000, 5, 8, 256),
                                                  (8, 1024, 16, 8, 512)])
def test_b4_plain_matches_pallas(m, n, k, tile_m, tile_n):
    """P = 1 is the Pallas banded kernel's (m, 128) contract."""
    rng = np.random.default_rng(m * n + k)
    q = rng.random((m, k), np.float32)
    r = rng.random((n, k), np.float32)
    s = pt_fused.norm_scores(_t(q), prep_soa(_t(r), n), n).numpy()
    srt = np.sort(s, axis=1)
    b_s = ((srt[:, 3] + srt[:, 4]) / 2).astype(np.float32)   # between ranks 3 and 4
    b_i = np.full((m,), 7, np.int32)
    cand = jx_fused._build_banded_candidates(m, n, k, tile_m, tile_n, "highest")
    ji, js = _np(cand(q, cand.prep_soa(r), b_s[:, None], b_i[:, None]))
    pi, ps = pt_fused.banded_candidates(_t(q), prep_soa(_t(r), -(-n // 128) * 128),
                                        n, 1, _t(b_s), torch.from_numpy(b_i))
    fin = np.isfinite(js)
    np.testing.assert_array_equal(pi.numpy()[fin], ji[fin])
    np.testing.assert_allclose(ps.numpy()[fin], js[fin], rtol=1e-5,
                               atol=1e-5 * np.abs(js[fin]).max())


@pytest.mark.parametrize("m,n,k,ties", [
    (65, 3149, 17, False),   # m past a 64-row block, k past a 16-row chunk
    (9, 2049, 1, True),      # k = 1, n = 16 groups + 1
    (33, 1300, 40, True),
])
def test_b4_plain_matches_pallas_at_tile_edges(m, n, k, ties):
    """The tiled f32 kernel's edges with the bound between lex ranks, and
    a tie inside one lane within and across column tiles (query 2 copied
    into columns 165, 293 and 1189): the banded fold keeps the tie's
    earliest column above the bound, as tpu_knn's kernel does."""
    rng = np.random.default_rng(m * k + n)
    q = rng.random((m, k), np.float32)
    r = rng.random((n, k), np.float32)
    if ties:
        for g in (1, 2, 9):
            r[g * 128 + 37] = q[2]
    s = pt_fused.norm_scores(_t(q), prep_soa(_t(r), n), n).numpy()
    srt = np.sort(s, axis=1)
    b_s = ((srt[:, 1] + srt[:, 2]) / 2).astype(np.float32)   # between ranks 1 and 2
    b_i = np.full((m,), 7, np.int32)
    if ties:   # row 2: bound at the tie's first column, so its second must win
        b_s[2], b_i[2] = s[2, 128 + 37], 128 + 37
    cand = jx_fused._build_banded_candidates(m, n, k, 8, 256, "highest")
    ji, js = _np(cand(q, cand.prep_soa(r), b_s[:, None], b_i[:, None]))
    pi, ps = pt_fused.banded_candidates(_t(q), prep_soa(_t(r), -(-n // 128) * 128),
                                        n, 1, _t(b_s), torch.from_numpy(b_i))
    fin = np.isfinite(js)
    # Two f32 summation orders: a slot may differ only where its two
    # columns' scores, or one of them and the row's bound, are a near-tie.
    tol = 1e-5 * np.abs(s).max()
    rows, lanes = np.nonzero(fin & (pi.numpy() != ji))
    for i, l in zip(rows, lanes):
        a, b = s[i, pi[i, l]], s[i, ji[i, l]]
        assert min(abs(a - b), abs(a - b_s[i]), abs(b - b_s[i])) <= tol, (i, l)
    assert len(rows) <= 1e-3 * fin.sum()
    same = fin & (pi.numpy() == ji)
    np.testing.assert_allclose(ps.numpy()[same], js[same], rtol=1e-5,
                               atol=1e-5 * np.abs(js[fin]).max())
    if ties:
        assert int(pi[2, 37]) == 256 + 37


@pytest.mark.parametrize("k,m,n,kk", [(17, 65, 3149, 4), (1, 9, 2049, 3), (40, 33, 1300, 5)])
def test_passes_matches_tpu_knn_at_tile_edges(k, m, n, kk):
    """The passes engine at the tiled f32 kernel's edges, with exact
    duplicates of query 2 inside one lane: the same top-K as tpu_knn's
    passes engine and the oracle, duplicates in index order."""
    rng = np.random.default_rng(k * m + n)
    q = rng.random((m, k), np.float32)
    r = rng.random((n, k), np.float32)
    for g in (1, 2, 9):
        r[g * 128 + 37] = q[2]
    want = oracle_topk(q, r, kk)
    ji, jd = _np(jx_topk.topk_knn(q, r, kk, method="passes"))
    pi, pd = _np(pt_topk.topk_knn(q, r, kk, method="passes", device="cpu"))
    np.testing.assert_array_equal(pi, want)
    np.testing.assert_array_equal(pi, ji)
    np.testing.assert_allclose(pd, jd, rtol=1e-6, atol=1e-7)
    assert pi[2, :3].tolist() == [165, 293, 1189]


def _reduce_lane_lists(ji, js, n, parts, kk, seed=None):
    """tpu_knn's per-lane K-lists (m, K*128) -> the port's per-partition
    lists (m, parts*kk): per (row, partition), the lex-smallest kk of the
    real entries (column < n, finite score) whose column lies in the
    partition, the rest (+inf, I32_MAX) or (seed[row], I32_MAX)."""
    m = ji.shape[0]
    out_i = np.full((m, parts * kk), I32_MAX, np.int32)
    out_s = np.full((m, parts * kk), np.inf, np.float32)
    for i in range(m):
        real = (ji[i] < n) & np.isfinite(js[i])
        cols, scores = ji[i][real], js[i][real]
        lists = pt_topk.list_of(cols, n, parts)
        if seed is not None:
            out_s[i] = seed[i]
        for p in range(parts):
            c, v = cols[lists == p], scores[lists == p]
            order = np.lexsort((c, v))[:kk]
            out_i[i, p * kk:p * kk + len(order)] = c[order]
            out_s[i, p * kk:p * kk + len(order)] = v[order]
    return out_i, out_s


@pytest.mark.parametrize("m,n,k,kk,parts", [(8, 1000, 5, 8, 1), (16, 2048, 3, 4, 3)])
def test_b5_plain_matches_pallas(m, n, k, kk, parts):
    """tpu_knn's Pallas sweep kernel's per-lane lists (its (m, K*128)
    contract, level-major), reduced to the lex-K of each of the port's
    per-partition lists, are the port's lists."""
    rng = np.random.default_rng(m + n + kk)
    q = rng.random((m, k), np.float32)
    r = rng.random((n, k), np.float32)
    cand = jx_topk._build_sweep_candidates(m, n, k, kk, 8, 512, "highest")
    ji, js = _np(cand(q, cand.prep_soa(r)))
    wi, ws = _reduce_lane_lists(ji, js, n, parts, kk)
    pi, ps = pt_topk.sweep_candidates(_t(q), prep_soa(_t(r), -(-n // 128) * 128),
                                      n, parts, kk)
    np.testing.assert_array_equal(pi.numpy(), wi)
    fin = np.isfinite(ws)
    np.testing.assert_allclose(ps.numpy()[fin], ws[fin], rtol=1e-5,
                               atol=1e-5 * np.abs(ws[fin]).max())
    assert np.all(np.isinf(ps.numpy()[~fin]))


@pytest.mark.parametrize("m,n,k,kk,parts", [(1, 3000, 8, 8, 1), (4, 2000, 16, 5, 4)])
def test_b6_plain_matches_pallas(m, n, k, kk, parts):
    rng = np.random.default_rng(m + n + kk)
    q = rng.random((m, k), np.float32)
    r = rng.random((n, k), np.float32)
    s = np.sort(_d2(q, r), axis=1)
    bound = ((s[:, 3 * kk] + s[:, 3 * kk + 1]) / 2).astype(np.float32)
    cand = jx_topk._build_smallm_topk_candidates(m, n, k, kk)
    ji, js = _np(cand(q, cand.prep_soa(r), bound[:, None]))
    wi, ws = _reduce_lane_lists(ji, js, n, parts, kk, seed=bound)
    pi, ps = pt_topk.smallm_topk_candidates(
        _t(q), prep_soa(_t(r), -(-n // 128) * 128), n, parts, kk, _t(bound))
    np.testing.assert_array_equal(pi.numpy(), wi)
    np.testing.assert_allclose(ps.numpy(), ws, rtol=1e-6, atol=1e-7)


def test_lex_order_keys():
    """The packed int64 key orders (score, index) lexicographically, with
    negative scores, -0.0 before +0.0, +inf and NaN last, as lax.sort."""
    s = torch.tensor([3.0, -1.0, 0.0, -0.0, float("inf"), float("nan"), -2.5, 3.0,
                      -float("inf"), 1e-30])
    i = torch.tensor([5, 2, 9, 1, 0, 3, 7, 4, -1, 6], dtype=torch.int32)
    got_s, got_i = pt_topk._lex_sort(s, i)
    # numpy sorts NaN last; its -0.0 == +0.0 tie goes to index 1 < 9 here.
    want = np.lexsort((i.numpy(), s.numpy()))
    assert got_i.tolist() == i.numpy()[want].tolist()
    sel_s, sel_i = pt_topk._lex_smallest(s[None], i[None], 4)
    assert sel_i[0].tolist() == got_i[:4].tolist()
    mi, ms = pt_topk._lex_min(torch.tensor([[4, 2, 9]], dtype=torch.int32),
                              torch.tensor([[1.0, 1.0, 0.5]]))
    assert int(mi[0]) == 9 and float(ms[0]) == 0.5


def _bf16_operand(seed, k, n, width):
    """A bf16 store's operand (PAD columns planted at 3 and n - 1) and its
    exact f32 upcast."""
    rng = np.random.default_rng(seed)
    r_op = prep_soa(torch.from_numpy(rng.random((n, k), np.float32)).to(torch.bfloat16),
                    width)
    r_op[:, [3, n - 1]] = torch.tensor(1e30, dtype=torch.bfloat16)
    return _t(rng.random((6, k), np.float32)), r_op, r_op.float()


@pytest.mark.parametrize("k,n,width", [(3, 1000, 1024), (16, 5000, 5120), (40, 777, 896)])
def test_plain_versions_over_a_bf16_operand_are_the_upcast_operands_bit_for_bit(k, n, width):
    """B1's, B4's and B5's plain versions (and B6's at k <= 32) over a
    bf16 store's operand equal them over its f32 upcast bit for bit, as the
    kernels' bf16 instances equal their f32 instances; the CPU wrappers
    take the bf16 operand as it is, and the planted PAD columns are never
    reported."""
    q, rb, rf = _bf16_operand(k, k, n, width)
    parts = 3
    bs, bi = torch.full((6,), 0.5 * k / 3), torch.full((6,), n // 2, dtype=torch.int32)
    bound = torch.full((6,), 0.3 * k)
    cases = [(pt_fused.fused_candidates, ()), (pt_fused.banded_candidates, (bs, bi)),
             (pt_topk.sweep_candidates, (8,))]
    if k <= 32:
        cases.append((pt_topk.smallm_topk_candidates, (8, bound)))
        q = q[:4]
        bs, bi, bound = bs[:4], bi[:4], bound[:4]
        cases = [(f, tuple(x[:4] if isinstance(x, torch.Tensor) else x for x in extra))
                 for f, extra in cases]
    for wrapper, extra in cases:
        got, want = wrapper(q, rb, n, parts, *extra), wrapper(q, rf, n, parts, *extra)
        for a, b in zip(got, want):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32)), wrapper.__name__
        assert not ({3, n - 1} & set(got[0].reshape(-1).tolist())), wrapper.__name__
    assert torch.equal(pt_fused.norm_scores(q, rb, n), pt_fused.norm_scores(q, rf, n))
    assert torch.equal(diff_scores(q, rb, n), diff_scores(q, rf, n))


def test_wrappers_take_bf16_and_f32_operands_only():
    q, rb, _ = _bf16_operand(1, 8, 500, 512)
    for wrapper, extra in ((pt_fused.fused_candidates, ()),
                           (pt_topk.sweep_candidates, (4,))):
        with pytest.raises(TypeError, match="bfloat16"):
            wrapper(q, rb.to(torch.float16), 500, 1, *extra)
