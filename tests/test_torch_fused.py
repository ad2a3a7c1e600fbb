"""B1's plain version and the fused pipeline of tpu_knn_torch, held against
tpu_knn on the same numpy inputs (Pallas in interpret mode, as the JAX
suite runs it on the CPU)."""

import numpy as np
import pytest
import torch

from tpu_knn.kernels import fused as jx_fused
from tpu_knn.oracle import oracle_knn
from tpu_knn_torch.kernels import fused as pt_fused
from tpu_knn_torch.kernels.fused import fused_candidates, fused_knn, prep_soa
from tpu_knn.kernels.twolevel import PAD_VALUE
from tpu_knn_torch.kernels.twolevel import twolevel_knn

I32_MAX = 2**31 - 1


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.float32))


def _operand(r, n_pad=None):
    n = r.shape[0]
    return prep_soa(_t(r), n_pad or -(-n // 128) * 128)


@pytest.mark.parametrize("m,n,k,tile_m,tile_n", [
    (20, 1000, 5, 8, 256),     # ragged n, multi-tile m
    (8, 1024, 16, 8, 512),     # even n
    (37, 3001, 3, 16, 1024),   # ragged both axes
])
def test_b1_plain_matches_pallas_highest(m, n, k, tile_m, tile_n):
    """P = 1 is the Pallas kernel's (m, 128) contract: per-lane (min score,
    lowest index). Scores in f32 agree to summation order (rtol 1e-5)."""
    rng = np.random.default_rng(m * n + k)
    q = rng.random((m, k), np.float32)
    r = rng.random((n, k), np.float32)
    cand = jx_fused._build_fused_candidates(m, n, k, tile_m, tile_n, soa=True,
                                            precision="highest")
    ji, js = (np.asarray(a) for a in cand(q, r))
    pi, ps = fused_candidates(_t(q), _operand(r), n, 1)
    np.testing.assert_array_equal(pi.numpy(), ji)
    np.testing.assert_allclose(ps.numpy(), js, rtol=1e-5,
                               atol=1e-5 * np.abs(js).max())


def _plant_lane_ties(q, r, row=2, lane=37, groups=(1, 2, 9)):
    """Query `row` copied into one lane's columns: groups 1 and 2 share a
    column tile of the card's tiled kernel, group 9 lies in the next."""
    for g in groups:
        if g * 128 + lane < r.shape[0]:
            r[g * 128 + lane] = q[row]
    return r


@pytest.mark.parametrize("m,n,k,tile_m,tile_n,ties", [
    (65, 3149, 17, 8, 1024, False),   # m past a 64-row block, k past a 16-row chunk
    (9, 2049, 1, 8, 256, True),       # k = 1, m past an 8-row block, n = 16 groups + 1
    (33, 1300, 40, 16, 512, True),    # m past a 32-row block, ragged n
    (3, 1200, 768, 8, 256, True),     # the many-chunk k
])
def test_b1_plain_matches_pallas_at_tile_edges(m, n, k, tile_m, tile_n, ties):
    """The tiled f32 kernel's edges (rows, chunks, column tiles) and a tie
    inside one lane, within and across column tiles: the plain version's
    candidates are tpu_knn's at P = 1, the earliest column winning."""
    rng = np.random.default_rng(m + n + k)
    q = rng.random((m, k), np.float32)
    r = rng.random((n, k), np.float32)
    if ties:
        _plant_lane_ties(q, r)
    cand = jx_fused._build_fused_candidates(m, n, k, tile_m, tile_n, soa=True,
                                            precision="highest")
    ji, js = (np.asarray(a) for a in cand(q, r))
    pi, ps = fused_candidates(_t(q), _operand(r), n, 1)
    np.testing.assert_array_equal(pi.numpy(), ji)
    np.testing.assert_allclose(ps.numpy(), js, rtol=1e-5,
                               atol=max(1e-5, 4 * k * 2.0 ** -24) * np.abs(js).max())
    if ties:
        assert int(pi[2, 37]) == 128 + 37


@pytest.mark.parametrize("m,n,k", [
    (20, 5000, 5),      # B1 + certified top-T refine
    (64, 10_000, 16),
    (9, 4500, 40),      # k beyond the packed range
    (3, 10_000, 7),     # m <= 4: AoS scan
    (2, 3000, 48),      # m <= 4, k > 32: AoS scan
    (50, 1000, 3),      # small n: dense
])
def test_fused_knn_matches_tpu_knn_and_oracle(m, n, k):
    rng = np.random.default_rng(n + k)
    q = rng.random((m, k), np.float32)
    r = rng.random((n, k), np.float32)
    want = oracle_knn(q, r)
    ji, jd = (np.asarray(a) for a in jx_fused.fused_knn(q, r))
    pi, pd = fused_knn(q, r, device="cpu")
    np.testing.assert_array_equal(pi.numpy(), want)
    np.testing.assert_array_equal(pi.numpy(), ji)
    np.testing.assert_allclose(pd.numpy(), jd, rtol=1e-6)
    np.testing.assert_allclose(pd.numpy(), np.sum((q - r[want]) ** 2, axis=1),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("parts", [1, 2, 3])
def test_refine_full_width_branch(parts):
    """Scores above the tier cutoff take the all-lanes exact rerank
    (_refine_guarded's uncertified branch): large coordinates."""
    rng = np.random.default_rng(parts)
    q = rng.random((10, 4), np.float32) * 4000
    r = rng.random((3000, 4), np.float32) * 4000
    idx, d2 = fused_knn(q, r, parts=parts, device="cpu")
    np.testing.assert_array_equal(idx.numpy(), oracle_knn(q, r))


def test_tie_break_lowest_index_across_partitions():
    q = np.zeros((1, 4), np.float32)
    r = np.ones((600, 4), np.float32)
    r[200] = 0.5  # partition 0 (3 groups of 128 per partition)
    r[500] = 0.5  # duplicate in partition 1
    idx, _ = fused_knn(q, r, parts=2, device="cpu")
    assert int(idx[0]) == 200


@pytest.mark.parametrize("dup", [18, 17 + 128])
def test_tie_break_within_and_across_lanes(dup):
    """17 and 18 sit in neighbouring lanes; 17 and 145 in one lane, where
    the strict fold must keep the earlier column."""
    q = np.zeros((1, 4), np.float32)
    r = np.ones((256, 4), np.float32)
    r[17] = 0.5
    r[dup] = 0.5
    idx, _ = fused_knn(q, r, parts=1, device="cpu")
    assert int(idx[0]) == 17
    ci, _ = fused_candidates(_t(q), _operand(r), 256, 1)
    assert int(ci[0, 17]) == 17


def test_padding_never_wins():
    # All points far away; n not a multiple of 128 — the zero padding
    # would be nearest if unmasked.
    q = np.zeros((3, 4), np.float32)
    r = np.full((130, 4), 10.0, np.float32)
    r[129] = 9.0
    idx, _ = fused_knn(q, r, parts=1, device="cpu")
    np.testing.assert_array_equal(idx.numpy(), [129, 129, 129])


def test_pad_value_rows_never_win():
    """Columns filled with tpu_knn's v7 PAD_VALUE (as its padded
    partitions are) are folded, not masked, and self-exclude: their score
    is +inf, so a lane that saw only such columns reports (+inf, I32_MAX)
    and none of them is ever a candidate."""
    rng = np.random.default_rng(5)
    n, n_pad = 300, 1024
    q = rng.random((5, 3), np.float32) * 100
    r = rng.random((n, 3), np.float32) - 100
    padded = np.full((n_pad, 3), PAD_VALUE, np.float32)
    padded[:n] = r
    ci, cs = fused_candidates(_t(q), _operand(padded), n_pad, 2)
    ci, cs = ci.numpy(), cs.numpy()
    assert np.all((ci < n) | (ci == I32_MAX))
    assert np.all(np.isinf(cs[ci == I32_MAX]))
    assert np.all(ci[:, 128:] == I32_MAX)   # partition 1 holds only padding
    idx, _ = fused_knn(q, padded, parts=8, device="cpu")
    np.testing.assert_array_equal(idx.numpy(), oracle_knn(q, r))
    idx, _ = twolevel_knn(q, r, parts=8, device="cpu")
    np.testing.assert_array_equal(idx.numpy(), oracle_knn(q, r))


def test_precision_tiers():
    q = np.zeros((8, 3), np.float32)
    r = np.ones((5000, 3), np.float32)
    r[4321] = 0.5
    for tier in ("highest", "bf16x3", "packed", "bf16x4", "bf16x3_presplit"):
        idx, d2 = fused_knn(q, r, precision=tier, device="cpu")
        np.testing.assert_array_equal(idx.numpy(), np.full(8, 4321))
        np.testing.assert_array_equal(d2.numpy(), np.full(8, 0.75, np.float32))
    with pytest.raises(ValueError, match="selection-approximate"):
        fused_knn(q, r, precision="bf16_raw", device="cpu")
    with pytest.raises(ValueError, match="qsplit2"):
        fused_knn(q, r, precision="qsplit2", device="cpu")


def test_cpu_tensors_take_the_plain_version():
    """The wrapper counts kernel launches only; CPU tensors never launch."""
    rng = np.random.default_rng(3)
    q = _t(rng.random((9, 5)))
    before = pt_fused.fused_candidates.launches
    ci, cs = fused_candidates(q, _operand(rng.random((700, 5))), 700, 2)
    assert pt_fused.fused_candidates.launches == before
    assert ci.shape == cs.shape == (9, 256) and ci.dtype == torch.int32


def test_candidate_operand_checks():
    q = torch.zeros((4, 3))
    r_op = torch.zeros((8, 256))
    with pytest.raises(TypeError):
        fused_candidates(q.double(), r_op, 200, 1)
    with pytest.raises(ValueError, match="contiguous"):
        fused_candidates(q, torch.zeros((256, 8)).T, 200, 1)
    with pytest.raises(ValueError, match="parts"):
        fused_candidates(q, r_op, 200, 3)
    with pytest.raises(ValueError, match="n=300"):
        fused_candidates(q, r_op, 300, 1)
