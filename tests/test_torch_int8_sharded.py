"""Sharded int8 grid storage in the port (NNIndex(store="int8",
strategy="sharded"), from_int8_grid(strategy="sharded")) on CPU meshes of
logical shards: tpu_knn's scenarios (tests/test_int8_sharded.py), held
against the grid-space oracle, the port's unsharded int8 index and
tpu_knn's sharded index on conftest's 8 virtual devices (built once per
module): indices identical, top-K rows identical by (d2, index), d2 within
rtol 1e-6 (the rescale by s² of grid-space d2 that are exact integers)."""

import numpy as np
import pytest
import torch

import tpu_knn_torch
from tpu_knn.distributed.sharded import default_mesh as tk_mesh
from tpu_knn.distributed.sharded import multislice_mesh as tk_multislice
from tpu_knn.engine.index import NNIndex as JaxIndex
from tpu_knn.oracle import oracle_callback
from tpu_knn_torch.distributed.sharded import (
    _build_sharded_int8, default_mesh, int8_sharded_layout, multislice_mesh, place_rows,
)

NNIndex = tpu_knn_torch.NNIndex

RTOL = 1e-6


def cpu_mesh(dp=1, sp=8, dcn=None):
    if dcn is None:
        return default_mesh(dp=dp, sp=sp, devices="cpu")
    return multislice_mesh(dcn, dp=dp, sp=sp, devices="cpu")


def _grid(ix):
    g = ix.r_sharded.gather()[: ix.n]
    assert g.dtype == torch.int8
    return g.numpy().astype(np.float32)


def _q_grid(ix, q):
    return ((q.astype(np.float32) - ix._i8_zero.astype(np.float32))
            * np.float32(ix._i8_inv_s)).astype(np.float32)


def _oracle(ix, q):
    g, qg = _grid(ix), _q_grid(ix, q)
    return oracle_callback(qg.shape[1], qg.shape[0], g.shape[0], qg, g)


def _gold_topk(ix, q, kk):
    g, qg = _grid(ix), _q_grid(ix, q)
    d = ((qg[:, None, :] - g[None, :, :]) ** 2).sum(-1, dtype=np.float32)
    return np.array([np.lexsort((np.arange(g.shape[0]), row))[:kk] for row in d])


def same(got, want):
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=RTOL)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The sharded pipelines are many small torch ops a shard; beside the
    suite's other workers, torch's intra-op thread pool waits on threads
    the CPUs cannot run, and these tests took 10-100x their time alone.
    One thread for the module, the caller's setting restored after."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(20)
    ref = rng.random((6_000, 6), np.float32)
    ref[700] = ref[5100] = ref[100]     # duplicates across shards 0, 0 and 6 of 8 x 768
    return ref, rng.random((3, 6), np.float32), rng.random((32, 6), np.float32)


@pytest.fixture(scope="module")
def tk(data):
    """tpu_knn's sharded int8 answers: both regimes of both builders, at
    sp = 8 and at (dcn, dp, sp) = (2, 1, 4)."""
    ref, q, qb = data
    out = {}
    for tag, mesh in (("sp8", tk_mesh(dp=1, sp=8)), ("(2,1,4)", tk_multislice(2, 1, 4))):
        ix = JaxIndex(ref, store="int8", strategy="sharded", mesh=mesh)
        out[tag] = [tuple(np.asarray(a) for a in r) for r in (
            ix.query(q), ix.query(qb), ix.query(q, neighbors=8), ix.query(qb, neighbors=8))]
    return out


@pytest.mark.parametrize("tag", ["sp8", "(2,1,4)"])
def test_sharded_int8_against_tpu_knn(tag, data, tk):
    ref, q, qb = data
    mesh = cpu_mesh(sp=8) if tag == "sp8" else cpu_mesh(dp=1, sp=4, dcn=2)
    ix = NNIndex(ref, store="int8", strategy="sharded", mesh=mesh)
    got = [ix.query(q), ix.query(qb), ix.query(q, neighbors=8), ix.query(qb, neighbors=8)]
    for g, w in zip(got, tk[tag]):
        same(g, w)
    assert int(got[0][0][0]) == int(_oracle(ix, q)[0])


@pytest.mark.parametrize("k", [3, 16])
@pytest.mark.parametrize("m", [1, 3, 32])
def test_sharded_int8_matches_grid_oracle(k, m):
    rng = np.random.default_rng(0)
    ref = rng.random((20_000, k), np.float32)
    ix = NNIndex(ref, store="int8", strategy="sharded", mesh=cpu_mesh(sp=8))
    q = rng.random((m, k), np.float32)
    idx, d2 = ix.query(q)
    np.testing.assert_array_equal(idx.numpy(), _oracle(ix, q))
    g, qg = _grid(ix), _q_grid(ix, q)
    want = ((qg - g[idx.numpy()]) ** 2).sum(-1, dtype=np.float32)
    np.testing.assert_allclose(d2.numpy(), want * np.float32(ix._i8_s2), rtol=RTOL)


def test_sharded_int8_matches_single_device():
    rng = np.random.default_rng(1)
    ref = rng.random((10_000, 8), np.float32)
    ix_s = NNIndex(ref, store="int8", strategy="sharded", mesh=cpu_mesh(sp=8))
    ix_f = NNIndex(ref, store="int8", device="cpu")
    assert ix_s._i8_s2 == ix_f._i8_s2
    np.testing.assert_array_equal(ix_s._i8_zero, ix_f._i8_zero)
    np.testing.assert_array_equal(_grid(ix_s), ix_f.ref_dev.numpy().astype(np.float32))
    for m in (1, 4, 16):
        q = rng.random((m, 8), np.float32)
        for kk in (None, 5):
            i_s, d_s = ix_s.query(q, neighbors=kk)
            i_f, d_f = ix_f.query(q, neighbors=kk)
            np.testing.assert_array_equal(i_s.numpy(), i_f.numpy())
            np.testing.assert_allclose(d_s.numpy(), d_f.numpy(), rtol=RTOL)


def test_sharded_int8_tie_across_shards_lowest_index():
    rng = np.random.default_rng(2)
    n = 2048
    ref = rng.random((n, 4), np.float32)
    dup = ref[100].copy()
    for pos in (700, 1300, 1900):
        ref[pos] = dup
    ix = NNIndex(ref, store="int8", strategy="sharded", mesh=cpu_mesh(sp=8))
    q = dup[None, :] + 1e-5
    assert int(ix.query(q)[0][0]) == 100
    ti = ix.query(q, neighbors=4)[0].numpy()[0]
    assert list(ti) == sorted(ti.tolist()) and set(ti) >= {100, 700, 1300}


@pytest.mark.parametrize("n", [1000, 5, 130])
def test_sharded_int8_ragged_and_tiny_n(n):
    """Ragged n and n below one shard's 128 rows: at n = 5 and 130 the
    trailing shards hold no row and contribute without a launch."""
    rng = np.random.default_rng(3)
    ref = rng.random((n, 3), np.float32)
    ix = NNIndex(ref, store="int8", strategy="sharded", mesh=cpu_mesh(sp=8))
    assert ix._n_local == int8_sharded_layout(n, ix.mesh)[0] == 128
    for m in (3, 16):
        q = rng.random((m, 3), np.float32)
        got = ix.query(q)[0].numpy()
        assert (got >= 0).all() and (got < n).all()
        np.testing.assert_array_equal(got, _oracle(ix, q))
        kk = min(n, 6)
        np.testing.assert_array_equal(ix.query(q, neighbors=kk)[0].numpy(), _gold_topk(ix, q, kk))


@pytest.mark.parametrize("m,kk", [(1, 8), (3, 16), (32, 8)])
def test_sharded_int8_topk(m, kk):
    rng = np.random.default_rng(4)
    ref = rng.random((6_000, 6), np.float32)
    ix = NNIndex(ref, store="int8", strategy="sharded", mesh=cpu_mesh(sp=8))
    q = rng.random((m, 6), np.float32)
    idx, d2 = ix.query(q, neighbors=kk)
    np.testing.assert_array_equal(idx.numpy(), _gold_topk(ix, q, kk))
    assert (np.diff(d2.numpy(), axis=1) >= 0).all()


@pytest.mark.parametrize("shape", [(2, 4, None), (2, 2, 2), (1, 2, 4)])
def test_sharded_int8_dp2_and_multislice_meshes(shape):
    dp, sp, dcn = shape
    rng = np.random.default_rng(5)
    ref = rng.random((4_000, 5), np.float32)
    ix = NNIndex(ref, store="int8", strategy="sharded", mesh=cpu_mesh(dp=dp, sp=sp, dcn=dcn))
    q = rng.random((6, 5), np.float32)   # m <= 4·dp: the scan regime at dp = 2
    np.testing.assert_array_equal(ix.query(q)[0].numpy(), _oracle(ix, q))
    np.testing.assert_array_equal(ix.query(q, neighbors=3)[0].numpy(), _gold_topk(ix, q, 3))
    qb = rng.random((32, 5), np.float32)
    np.testing.assert_array_equal(ix.query(qb)[0].numpy(), _oracle(ix, qb))
    np.testing.assert_array_equal(ix.query(qb, neighbors=6)[0].numpy(), _gold_topk(ix, qb, 6))


def test_sharded_int8_from_grid():
    rng = np.random.default_rng(6)
    grid = rng.integers(-127, 128, size=(3_000, 4), dtype=np.int8)
    zero = rng.random(4).astype(np.float32)
    ix_s = NNIndex.from_int8_grid(grid, zero, 0.01, strategy="sharded", mesh=cpu_mesh(sp=8))
    ix_f = NNIndex.from_int8_grid(grid, zero, 0.01, device="cpu")
    assert (ix_s.strategy, ix_s.store, ix_s.precision) == ("sharded", "int8", ix_f.precision)
    q = rng.random((4, 4), np.float32)
    for kk in (None, 5):
        for a, b in zip(ix_s.query(q, neighbors=kk), ix_f.query(q, neighbors=kk)):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
    # A tensor grid is placed shard by shard too.
    ix_t = NNIndex.from_int8_grid(torch.from_numpy(grid), zero, 0.01, strategy="sharded",
                                  mesh=cpu_mesh(dp=2, sp=4))
    np.testing.assert_array_equal(ix_t.query(q)[0].numpy(), ix_f.query(q)[0].numpy())


def test_sharded_int8_query_radius():
    rng = np.random.default_rng(8)
    ref = rng.random((3_000, 3), np.float32)
    ix = NNIndex(ref, store="int8", strategy="sharded", mesh=cpu_mesh(sp=8))
    q = rng.random((4, 3), np.float32)
    radius = 0.18
    idx, _, cnt = ix.query_radius(q, radius)
    idx, cnt = idx.numpy(), cnt.numpy()
    g, qg = _grid(ix), _q_grid(ix, q)
    D = ((qg[:, None, :] - g[None, :, :]) ** 2).sum(-1, dtype=np.float32) * np.float32(ix._i8_s2)
    for i in range(4):
        assert set(idx[i, : cnt[i]].tolist()) == set(np.nonzero(np.sqrt(D[i]) <= radius)[0])
        assert (idx[i, cnt[i]:] == -1).all()


def test_sharded_int8_k_beyond_shard_width():
    rng = np.random.default_rng(9)
    ref = rng.random((1_000, 4), np.float32)
    ix = NNIndex(ref, store="int8", strategy="sharded", mesh=cpu_mesh(sp=8))
    assert ix._n_local == 128
    q = rng.random((3, 4), np.float32)
    for kk in (129, 200, 512):
        idx, d2 = ix.query(q, neighbors=kk)
        np.testing.assert_array_equal(idx.numpy(), _gold_topk(ix, q, kk))
        assert (np.diff(d2.numpy(), axis=1) >= 0).all()
    idx, _, cnt = ix.query_radius(q, 0.55)
    g, qg = _grid(ix), _q_grid(ix, q)
    D = ((qg[:, None, :] - g[None, :, :]) ** 2).sum(-1, dtype=np.float32) * np.float32(ix._i8_s2)
    for i in range(3):
        want = set(np.nonzero(np.sqrt(D[i]) <= 0.55)[0].tolist())
        assert len(want) > 128
        assert set(idx.numpy()[i, : int(cnt[i])].tolist()) == want


def test_sharded_int8_tensor_input_matches_numpy_input():
    """A tensor quantizes in torch on its device, NumPy in host arithmetic
    (tpu_knn's two builds): the same grid and embed either way."""
    rng = np.random.default_rng(12)
    ref = rng.random((3_000, 5), np.float32)
    mesh = cpu_mesh(sp=8)
    ix_h = NNIndex(ref, store="int8", strategy="sharded", mesh=mesh)
    ix_d = NNIndex(torch.from_numpy(ref), store="int8", strategy="sharded", mesh=mesh)
    assert ix_d._i8_s2 == ix_h._i8_s2
    np.testing.assert_array_equal(ix_d._i8_zero, ix_h._i8_zero)
    assert torch.equal(ix_d.r_sharded.gather(), ix_h.r_sharded.gather())
    tk = JaxIndex(ref, store="int8", strategy="sharded", mesh=tk_mesh(dp=1, sp=8))
    np.testing.assert_array_equal(ix_h.r_sharded.gather().numpy(), np.asarray(tk.r_sharded))
    assert ix_h._i8_s2 == tk._i8_s2


def test_from_int8_grid_mesh_requires_sharded():
    rng = np.random.default_rng(10)
    grid = rng.integers(-127, 128, size=(256, 3), dtype=np.int8)
    with pytest.raises(ValueError, match="strategy='sharded'"):
        NNIndex.from_int8_grid(grid, np.zeros(3, np.float32), 0.5, mesh=cpu_mesh(sp=8))


def test_sharded_int8_pipeline_exposed():
    rng = np.random.default_rng(13)
    ref = rng.random((4_000, 6), np.float32)
    q = torch.from_numpy(rng.random((8, 6), np.float32))
    for store in ("float32", "int8"):
        ix = NNIndex(ref, store=store, strategy="sharded", mesh=cpu_mesh(sp=8))
        run, ops = ix.pipeline(8)
        pi, pd = run(q, *ops)
        qi, qd = ix.query(q)
        np.testing.assert_array_equal(pi.numpy(), qi.numpy())
        np.testing.assert_allclose(pd.numpy(), qd.numpy(), rtol=RTOL)
    # A grid laid out for another width is refused.
    wider = place_rows(ix.mesh, ix.r_sharded.gather(), ix._n_local + 128, torch.int8, fill=0)
    with pytest.raises(ValueError, match="n_local"):
        _build_sharded_int8(3, 4_000, 6, ix._n_local, ix.mesh)(q[:3], wider)


def test_sharded_int8_save_load_and_from_state(tmp_path):
    rng = np.random.default_rng(7)
    r = rng.random((1_000, 3), np.float32)
    q = rng.random((5, 3), np.float32)
    ix = NNIndex(r, store="int8", strategy="sharded", mesh=cpu_mesh(sp=8))
    p = str(tmp_path / "i8s.npz")
    ix.save(p)
    lx = NNIndex.load(p, device="cpu")
    assert lx.strategy == "sharded" and lx.store == "int8"
    assert lx.mesh.shape == {"dp": 1, "sp": 8}
    for a, b in zip(lx.query(q), ix.query(q)):
        assert torch.equal(a, b)
    # tpu_knn's sharded int8 state over a port mesh of the same shape.
    tk = JaxIndex(r, store="int8", strategy="sharded", mesh=tk_mesh(dp=2, sp=4))
    state = {"grid": np.asarray(tk.r_sharded), "zero": tk._i8_zero, "inv_s": tk._i8_inv_s,
             "n": tk.n}
    sx = NNIndex.from_state(state, mesh=cpu_mesh(dp=2, sp=4))
    for kk in (None, 4):
        same(sx.query(q, neighbors=kk), tk.query(q, neighbors=kk))
    with pytest.raises(ValueError, match="int8 layout"):
        NNIndex.from_state(dict(state, grid=np.asarray(tk.r_sharded)[:-128]),
                           mesh=cpu_mesh(dp=2, sp=4))
