"""NNIndex.filtered_view in the port, held against tpu_knn's on the same
numpy inputs (after tests/test_index.py:492-560 and
test_bf16_store.py:142).

A view shares the parent's AoS copy and holds one SoA operand whose
excluded columns are PAD_VALUE; it reports original ids, and it stays off
every route that scans the unmasked AoS copy (the dense path, the AoS
scan, the m = 1 AoS top-K engine).
"""

import ml_dtypes
import numpy as np
import pytest
import torch

import tpu_knn_torch
from tpu_knn.engine.index import NNIndex as JaxIndex
from tpu_knn_torch.engine.index import PAD_VALUE

NNIndex = tpu_knn_torch.NNIndex


def _same(got, want, tol=1e-6):
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=tol, atol=1e-7)


def _masked_d2(q, ref, keep):
    d = ((q[:, None, :] - ref[None, :, :]) ** 2).sum(-1, dtype=np.float32)
    return np.where(keep[None, :], d, np.inf)


@pytest.mark.parametrize("store", ["float32", "bf16"])
@pytest.mark.parametrize("k,n", [(4, 5000), (16, 6000)])
def test_view_matches_tpu_knn_and_the_masked_oracle(store, k, n):
    """1-NN, top-K (m = 1: the sweep over the masked operand, not the AoS
    engine) and radius over the kept half give tpu_knn's answers and the
    masked oracle's ids; the parent is untouched."""
    rng = np.random.default_rng(9 + k)
    ref = rng.random((n, k), np.float32)
    q = rng.random((12, k), np.float32)
    keep = rng.random(n) < 0.5
    keep[:10] = False
    ix, jx = NNIndex(ref, store=store, device="cpu"), JaxIndex(ref, store=store)
    view, jview = ix.filtered_view(keep), jx.filtered_view(keep)
    assert view.n_live == jview.n_live == int(keep.sum())
    assert view.ref_dev is ix.ref_dev
    assert view.r_ops[0].dtype == ix.r_ops[0].dtype
    pad = torch.tensor(PAD_VALUE, dtype=ix.r_ops[0].dtype)
    assert (view.r_ops[0][:, :n][:, torch.as_tensor(~keep)] == pad).all()
    stored = (ref.astype(ml_dtypes.bfloat16).astype(np.float32) if store == "bf16" else ref)
    want = _masked_d2(q, stored, keep)
    for m in (1, 4, 12):
        got = view.query(q[:m])
        _same(got, jview.query(q[:m]))
        np.testing.assert_array_equal(got[0].numpy(), want[:m].argmin(1))
        got = view.query(q[:m], neighbors=5)
        _same(got, jview.query(q[:m], neighbors=5))
        np.testing.assert_array_equal(got[0].numpy(),
                                      np.argsort(want[:m], axis=1, kind="stable")[:, :5])
    radius = 0.15 if k == 4 else 0.7
    got, jgot = view.query_radius(q, radius), jview.query_radius(q, radius)
    _same(got[:2], jgot[:2])
    np.testing.assert_array_equal(got[2].numpy(), (want <= np.float32(radius) ** 2).sum(1))
    assert int(got[2].sum()) > 0
    np.testing.assert_array_equal(ix.query(q)[0].numpy(), np.asarray(jx.query(q)[0]))


def test_view_never_scans_the_unmasked_aos_copy():
    """The globally nearest point is planted outside the kept set at each
    route that would scan the AoS copy: the dense path (small n, m > 4),
    the m = 1 scan at k < 8 and the m = 1 AoS top-K engine."""
    rng = np.random.default_rng(13)
    ref = rng.random((500, 3), np.float32)
    q = rng.random((8, 3), np.float32)
    ref[123] = q[0]
    keep = np.ones(500, bool)
    keep[123] = False
    view = NNIndex(ref, device="cpu").filtered_view(keep)
    jview = JaxIndex(ref).filtered_view(keep)
    want = _masked_d2(q, ref, keep)
    gi, gd = view.query(q)
    assert int(gi[0]) != 123 and float(gd[0]) > 0.0
    np.testing.assert_array_equal(gi.numpy(), want.argmin(1))
    _same(view.query(q[:1]), jview.query(q[:1]))
    gk, gkd = view.query(q[:1], neighbors=3)
    np.testing.assert_array_equal(gk.numpy()[0], np.argsort(want[0], kind="stable")[:3])
    assert float(gkd[0, 0]) > 0.0
    ri, _, _ = view.query_radius(q[:1], 0.05)
    assert 123 not in set(ri.numpy()[0].tolist())


def test_view_from_state_answers_like_tpu_knn():
    """A tpu_knn view's state (the parent's AoS copy, the masked operand,
    _view_live) gives the port a view that answers as tpu_knn's."""
    rng = np.random.default_rng(14)
    ref = rng.random((4000, 8), np.float32)
    q = rng.random((20, 8), np.float32)
    keep = rng.random(4000) < 0.4
    for store in ("float32", "bf16"):
        jview = JaxIndex(ref, store=store).filtered_view(keep)
        state = {"ref": np.asarray(jview.ref_dev), "r_op": np.asarray(jview.r_ops[0]),
                 "_view_live": jview._view_live}
        view = NNIndex.from_state(state, device="cpu")
        assert (view.n_live, view.store, view._aos_selfmasked) == (int(keep.sum()), store,
                                                                    False)
        for m in (1, 20):
            _same(view.query(q[:m]), jview.query(q[:m]))
            _same(view.query(q[:m], neighbors=6), jview.query(q[:m], neighbors=6))
        with pytest.raises(ValueError, match="_view_live"):
            NNIndex.from_state(dict(state, _view_live=3), device="cpu")


def test_view_validation_matches_tpu_knn():
    rng = np.random.default_rng(10)
    ref = rng.random((400, 3), np.float32)
    ix = NNIndex(ref, device="cpu")
    with pytest.raises(ValueError, match="keep"):
        ix.filtered_view(np.ones(399, bool))
    with pytest.raises(ValueError, match="no points"):
        ix.filtered_view(np.zeros(400, bool))
    with pytest.raises(ValueError, match="mutable"):
        NNIndex(ref, mutable=True, device="cpu").filtered_view(np.ones(400, bool))
    with pytest.raises(ValueError, match="store='int8'"):
        NNIndex(ref, store="int8", device="cpu").filtered_view(np.ones(400, bool))
    for kwargs in ({"strategy": "projection"}, {"precision": "bf16x3_presplit"}):
        with pytest.raises(ValueError, match="fused/auto/sharded"):
            NNIndex(ref, device="cpu", **kwargs).filtered_view(np.ones(400, bool))
    small = ix.filtered_view(np.arange(400) < 3)
    with pytest.raises(ValueError, match="neighbors"):
        small.query(rng.random((2, 3), np.float32), neighbors=4)
    np.testing.assert_array_equal(small.query(ref[:3], neighbors=3)[0].numpy()[:, 0],
                                  [0, 1, 2])
    # A view of an "auto" index is a fused view over the same operand.
    even = np.arange(400) % 2 == 0
    auto = NNIndex(ref, strategy="auto", device="cpu").filtered_view(even)
    assert auto.strategy == "fused"
    np.testing.assert_array_equal(auto.query(ref[:4])[0].numpy(),
                                  _masked_d2(ref[:4], ref, even).argmin(1))
