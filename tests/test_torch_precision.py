"""The score tiers of the fused 1-NN path (kernels/tiers.py) held against
tpu_knn's on the same numpy inputs: each tier's plain scores against an
f64 recomputation and against tpu_knn's `_score_tile`, B12's presplit
operands and scores, the candidate stage against
`_build_fused_candidates` (Pallas in interpret mode), and `fused_knn(
precision=)` per call, v4 and v7 against tpu_knn's and the oracle.

The score-error gate is tiers.tier_error_gate: the tier's `_TIER_EPS`
plus the f32 arithmetic every tier shares, relative to the largest |score|
of the set (the scale `_refine_guarded`'s certificate reads) — or, where
tpu_knn's own arithmetic of the tier exceeds that on the data (the bf16x3
ladder at k <= 16), tpu_knn's error plus the f32 allowance."""

import ml_dtypes
import numpy as np
import pytest
import torch

import tpu_knn
from tpu_knn.harness.checker import check_results
from tpu_knn.kernels import fused as jx_fused
from tpu_knn.kernels import twolevel as jx_twolevel
from tpu_knn.oracle import oracle_knn
from tpu_knn_torch.kernels import fused as pt_fused
from tpu_knn_torch.kernels import tiers
from tpu_knn_torch.kernels import twolevel as pt_twolevel


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.float32))


def _bf16_exact(x):
    return x.astype(ml_dtypes.bfloat16).astype(np.float32)


def _f64_scores(q, r):
    """s = ‖r‖² − 2 q·r of every (query, column) in f64."""
    q, r = q.astype(np.float64), r.astype(np.float64)
    return (r * r).sum(axis=1)[None, :] - 2.0 * q @ r.T


def _rel_err(s, s64):
    """Largest |s − s64| relative to the largest |s64|."""
    return float(np.max(np.abs(np.asarray(s, np.float64) - s64)) / np.max(np.abs(s64)))


TIER_CASES = [("packed", 1), ("packed", 3), ("packed", 16), ("packed", 24), ("packed", 32),
              ("packed", 40), ("bf16x3", 16), ("bf16x3", 40), ("bf16x3", 128),
              ("bf16x4", 16), ("bf16x4", 40), ("qsplit2", 16), ("qsplit2", 128),
              ("bf16_raw", 24), ("highest", 16)]


@pytest.mark.parametrize("precision,k", TIER_CASES)
def test_tier_scores_match_f64_and_tpu_knn(precision, k):
    """The port's tier_scores and tpu_knn's `_score_tile` (plain jnp) both
    lie within the tier's bound of an f64 recomputation, and within twice
    it of each other. qsplit2 runs over a bf16-exact operand, as the
    quantized stores give it."""
    rng = np.random.default_rng(7 * k + len(precision))
    q = rng.random((24, k), np.float32) * 2 - 0.5
    r = rng.random((2000, k), np.float32) * 2 - 0.5
    if precision == "qsplit2":
        r = _bf16_exact(r)
    r_soa = np.zeros((-(-k // 8) * 8, 2048), np.float32)
    r_soa[:k, :2000] = r.T
    s64 = _f64_scores(q, r)
    bound = tiers.tier_error_bound(precision, k)
    if precision == "highest":
        ours = pt_fused.norm_scores(_t(q), _t(r_soa), 2000).numpy()
    else:
        ours = tiers.tier_scores(_t(q), _t(r_soa), 2000, precision).numpy()
    q_pad = np.zeros((24, r_soa.shape[0]), np.float32)
    q_pad[:, :k] = q
    theirs = np.asarray(jx_fused._score_tile(q_pad, r_soa[:, :2000], soa=True,
                                             precision=precision))
    assert _rel_err(ours, s64) <= tiers.tier_error_gate(precision, k, _rel_err(theirs, s64))
    assert _rel_err(ours, theirs) <= 2 * bound
    if precision in ("packed", "qsplit2", "highest") or k >= 40:
        # Where the tier is selected (auto_precision, the stores) both
        # packages meet its nominal bound.
        assert max(_rel_err(ours, s64), _rel_err(theirs, s64)) <= bound


def test_default_is_the_ports_bf16_raw():
    """"default" is the TPU's DEFAULT precision, one bf16 pass: the port
    computes it as bf16_raw's term list (tpu_knn's CPU backend would
    compute f32 there)."""
    rng = np.random.default_rng(3)
    q, r_op = _t(rng.random((9, 20))), _t(rng.random((24, 700)))
    assert tiers.term_list("default", 20) == tiers.term_list("bf16_raw", 20) == ((0, 0),)
    assert torch.equal(tiers.tier_scores(q, r_op, 700, "default"),
                       tiers.tier_scores(q, r_op, 700, "bf16_raw"))
    r = rng.random((3000, 20), np.float32)
    a = pt_fused.fused_knn(r[:40] + 1e-3, r, precision="default", allow_approximate=True,
                           device="cpu")
    b = pt_fused.fused_knn(r[:40] + 1e-3, r, precision="bf16_raw", allow_approximate=True,
                           device="cpu")
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("k", [3, 16, 40])
def test_presplit_prep_and_scores_match_tpu_knn(k):
    """B12's operands are tpu_knn's presplit prep_soa bit for bit (‖r‖² to
    rtol 1e-6: f32 summation order), and its plain scores lie within the
    bf16x3 bound of f64 and of tpu_knn's `_score_tile_presplit`."""
    rng = np.random.default_rng(k)
    n, m = 3000, 16
    q = rng.random((m, k), np.float32)
    r = rng.random((n, k), np.float32)
    cand = jx_fused._build_fused_candidates(m, n, k, 8, 1024, soa=True,
                                            precision="bf16x3_presplit")
    j_hi, j_lo, j_rn = (np.asarray(a) for a in cand.prep_soa(r))
    hi, lo, rn = tiers.presplit_ops(_t(r), j_hi.shape[1])
    np.testing.assert_array_equal(hi.view(torch.int16).numpy(), j_hi.view(np.int16))
    np.testing.assert_array_equal(lo.view(torch.int16).numpy(), j_lo.view(np.int16))
    np.testing.assert_allclose(rn.numpy(), j_rn, rtol=1e-6)
    s64 = _f64_scores(q, r)
    bound = tiers.tier_error_bound("bf16x3_presplit", k)
    ours = tiers.presplit_scores(_t(q), hi, lo, rn, n).numpy()
    qp = np.zeros((m, hi.shape[0]), np.float32)
    qp[:, :k] = q
    theirs = np.asarray(jx_fused._score_tile_presplit(qp, j_hi, j_lo, j_rn))[:, :n]
    assert _rel_err(ours, s64) <= tiers.tier_error_gate("bf16x3_presplit", k,
                                                         _rel_err(theirs, s64))
    assert _rel_err(ours, theirs) <= 2 * bound


CANDIDATE_CASES = [  # precision, k, m, n, tile_m, tile_n
    ("packed", 3, 16, 2001, 8, 1024), ("packed", 16, 24, 2500, 8, 1024),
    ("packed", 32, 8, 2000, 8, 1024), ("bf16x3", 40, 12, 2000, 8, 1024),
    ("bf16x4", 24, 8, 2000, 8, 1024), ("bf16x3", 128, 8, 2000, 8, 1024),
    ("bf16x3_presplit", 16, 16, 2500, 8, 1024), ("bf16x3_presplit", 40, 8, 2000, 8, 1024),
]


@pytest.mark.parametrize("precision,k,m,n,tile_m,tile_n", CANDIDATE_CASES)
def test_candidates_match_tpu_knn(precision, k, m, n, tile_m, tile_n):
    """The port's plain candidates (P = 1, tpu_knn's (m, 128) contract)
    against `_build_fused_candidates(..., precision=tier)`: indices agree
    but for f32 near-ties inside a lane, scores within the tier's bound;
    after `_refine` on each side the answers are identical."""
    rng = np.random.default_rng(m * k + n)
    q = rng.random((m, k), np.float32)
    r = rng.random((n, k), np.float32)
    r[n // 2] = r[n // 3] = q[0]                      # an exact duplicate pair
    cand = jx_fused._build_fused_candidates(m, n, k, tile_m, tile_n, soa=True,
                                            precision=precision)
    ji, js = (np.asarray(a) for a in cand(q, r))
    n_pad = -(-n // 128) * 128
    r_ops = (tiers.presplit_ops(_t(r), n_pad) if precision == "bf16x3_presplit"
             else (pt_fused.prep_soa(_t(r), n_pad),))
    pi, ps = tiers.tier_candidates(_t(q), r_ops, n, 1, precision)
    agree = pi.numpy() == ji
    assert agree.mean() >= 0.99
    scale = np.abs(js[agree]).max()
    assert np.max(np.abs(ps.numpy() - js)[agree]) <= 2 * tiers.tier_error_bound(precision, k) * scale
    cutoff = pt_fused.select_cutoff(precision, k)
    wi, wd = (np.asarray(a) for a in jx_fused._refine(q, r, (ji, js), n, cutoff=cutoff))
    gi, gd = pt_fused._refine(_t(q), _t(r), (pi, ps), n, cutoff=cutoff)
    np.testing.assert_array_equal(gi.numpy(), wi)
    np.testing.assert_allclose(gd.numpy(), wd, rtol=1e-6)
    assert int(gi[0]) == n // 3


def _large_coordinates():
    rng = np.random.default_rng(2)
    ref = (rng.random((3000, 4), np.float32) * 1e3 - 500).astype(np.float32)
    return (rng.random((16, 4), np.float32) * 1e3 - 500).astype(np.float32), ref


def _near_duplicate_shell():
    """tests/test_numerics.py's shell: k = 40 at coordinate scale 9, twelve
    near duplicates of each query (more than the top-T cut)."""
    rng = np.random.default_rng(1234)
    k, m, n = 40, 16, 6000
    ref = (rng.random((n, k)) * 9.0).astype(np.float32)
    search = (rng.random((m, k)) * 9.0).astype(np.float32)
    for i in range(m):
        for j in range(12):
            ref[(37 * i + 211 * j) % n] = search[i] + rng.normal(0, 2e-2, k).astype(np.float32)
    return search, ref


def _uniform(k, m=24, n=3000, seed=0):
    rng = np.random.default_rng(seed + k)
    return rng.random((m, k), np.float32), rng.random((n, k), np.float32)


PER_CALL = [("packed", _uniform(3)), ("packed", _uniform(16)), ("packed", _uniform(32)),
            ("bf16x3", _uniform(40)), ("bf16x4", _uniform(16)),
            ("bf16x3_presplit", _uniform(16)), ("highest", _uniform(16)),
            ("packed", _large_coordinates()), ("bf16x3", _large_coordinates()),
            ("bf16x3", _near_duplicate_shell()), ("bf16x3_presplit", _near_duplicate_shell())]


@pytest.mark.parametrize("case", range(len(PER_CALL)))
def test_fused_knn_tiers_match_tpu_knn(case):
    """fused_knn(precision=tier) gives tpu_knn's indices, and the harness
    checker finds 0 errors against the oracle (test_numerics.py:89-113,
    with its large-coordinate and near-duplicate-shell data)."""
    precision, (q, r) = PER_CALL[case]
    ji, _ = jx_fused.fused_knn(q, r, precision=precision)
    pi, pd = pt_fused.fused_knn(q, r, precision=precision, device="cpu")
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    errors, _ = check_results(oracle_knn(q, r), pi.numpy(), q, r)
    assert errors == 0
    np.testing.assert_allclose(pd.numpy(), ((q - r[pi.numpy()]) ** 2).sum(1),
                               rtol=1e-5, atol=1e-6)


def test_default_is_selection_approximate_in_the_port():
    """A divergence from tpu_knn (ROADMAP C): tpu_knn certifies "default"
    (one bf16 pass) and answers; the port requires allow_approximate=True
    for it, as for bf16_raw, because fused_knn at "default" answered a
    ds11 query outside the ±1e-3 contract on the card."""
    q, r = _uniform(16, m=8, n=2000)
    ji, _ = jx_fused.fused_knn(q, r, precision="default")
    assert np.asarray(ji).shape == (8,)
    assert "default" not in jx_fused.UNCERTIFIED_PRECISIONS
    with pytest.raises(ValueError, match="selection-approximate"):
        pt_fused.fused_knn(q, r, precision="default", device="cpu")
    pi, _ = pt_fused.fused_knn(q, r, precision="default", allow_approximate=True, device="cpu")
    assert pi.shape == (8,)


def test_certification_checks():
    q, r = _uniform(16, m=8, n=2000)
    with pytest.raises(ValueError, match="selection-approximate"):
        pt_fused.fused_knn(q, r, precision="bf16_raw", device="cpu")
    idx, _ = pt_fused.fused_knn(q, r, precision="bf16_raw", allow_approximate=True,
                                device="cpu")
    assert idx.shape == (8,)
    with pytest.raises(ValueError, match="qsplit2"):
        pt_fused.fused_knn(q, r, precision="qsplit2", device="cpu")
    with pytest.raises(ValueError, match="unknown precision"):
        pt_fused.fused_knn(q, r, precision="tf32", device="cpu")
    # v3 (soa=False), v5 and v6 answer at every certified tier, and certify
    # theirs as fused_knn does.
    from tpu_knn_torch.kernels.dma_pipeline import dma_knn

    want = pt_fused.fused_knn(q, r, precision="highest", device="cpu")[0]
    for precision in ("packed", "bf16x3", "bf16x4", "bf16x3_presplit", "highest"):
        for got in (pt_fused.fused_knn(q, r, soa=False, precision=precision, device="cpu"),
                    dma_knn(q, r, precision=precision, device="cpu"),
                    pt_fused.const_query_knn(q, r, precision=precision, device="cpu")):
            assert torch.equal(got[0], want), precision
    for call in (lambda p: pt_fused.fused_knn(q, r, soa=False, precision=p, device="cpu"),
                 lambda p: dma_knn(q, r, precision=p, device="cpu"),
                 lambda p: pt_fused.const_query_knn(q, r, precision=p, device="cpu")):
        with pytest.raises(ValueError, match="qsplit2"):
            call("qsplit2")
        for approximate in ("bf16_raw", "default"):
            with pytest.raises(ValueError, match="selection-approximate"):
                call(approximate)


def test_precision_none_resolves_as_tpu_knn(monkeypatch):
    """fused_knn (v4) and v7 resolve precision=None through auto_precision
    and certify with that tier's cutoff, in both packages; v7 reads the
    global (k, n)."""
    seen = {}

    def spy(name, fn):
        def wrapper(*args, **kwargs):
            seen.setdefault(name, []).append((args, kwargs))
            return fn(*args, **kwargs)
        return wrapper

    monkeypatch.setattr(pt_twolevel, "refine_candidates",
                        spy("pt_v7", pt_twolevel.refine_candidates))
    monkeypatch.setattr(pt_twolevel, "select_cutoff", spy("pt_cut", pt_twolevel.select_cutoff))
    monkeypatch.setattr(jx_twolevel, "_build_fused_candidates",
                        spy("jx_v7", jx_twolevel._build_fused_candidates))
    monkeypatch.setattr(jx_fused, "select_cutoff", spy("jx_cut", jx_fused.select_cutoff))
    for k, n in ((16, 2321), (40, 2123)):
        q, r = _uniform(k, m=9, n=n, seed=11)
        want = oracle_knn(q, r)
        np.testing.assert_array_equal(
            tpu_knn.nearest_neighbors(q, r, version="v7"), want)
        np.testing.assert_array_equal(
            tpu_knn_torch_v7(q, r), want)
        jx_tier = seen["jx_v7"][-1][1]["precision"]
        assert seen["pt_v7"][-1][0][4] == jx_tier == jx_fused.auto_precision(k, n)
        assert seen["pt_cut"][-1][0] == seen["jx_cut"][-1][0] == (jx_tier, k)


def tpu_knn_torch_v7(q, r):
    import tpu_knn_torch

    return tpu_knn_torch.nearest_neighbors(q, r, version="v7", device="cpu")


@pytest.mark.parametrize("k", [3, 16, 40])
def test_v4_default_tier_is_auto_precision(k, monkeypatch):
    seen = []
    real = pt_fused.select_cutoff
    monkeypatch.setattr(pt_fused, "select_cutoff",
                        lambda p, kk: seen.append(p) or real(p, kk))
    q, r = _uniform(k, m=12, n=4500, seed=5)
    idx, _ = pt_fused.fused_knn(q, r, device="cpu")
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jx_fused.fused_knn(q, r)[0]))
    assert seen == [jx_fused.auto_precision(k, 4500)]


@pytest.mark.parametrize("precision,parts", [("packed", 3), ("bf16x3", 7), ("qsplit2", 2)])
def test_merged_partitions_are_the_one_partition_candidates(precision, parts):
    """merge_partitions turns P partitions' lanes into the (m, 128) set a
    single-partition launch gives (tpu_knn's contract), ties to the lowest
    column; a lane with no column stays (+inf, I32_MAX)."""
    rng = np.random.default_rng(parts)
    k, n = 40 if precision != "packed" else 8, 1500
    q = _t(rng.random((6, k)))
    r = rng.random((n, k), np.float32)
    r[3] = r[3 + 128 * 5] = r[3 + 128 * 9] = q[0].numpy()   # one lane, three partitions
    r_op = pt_fused.prep_soa(_t(_bf16_exact(r) if precision == "qsplit2" else r), 1536)
    one = tiers.tier_candidates(q, (r_op,), n, 1, precision)
    merged = tiers.merge_partitions(*tiers.tier_candidates(q, (r_op,), n, parts, precision))
    assert torch.equal(merged[0], one[0]) and torch.equal(merged[1], one[1])
    assert int(merged[0][0, 3]) == 3
    short = tiers.merge_partitions(*tiers.tier_candidates(q, (r_op,), 100, 1, precision))
    assert (short[0][:, 100:] == 2**31 - 1).all() and torch.isinf(short[1][:, 100:]).all()
