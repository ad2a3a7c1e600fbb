"""The sharded tier of the port (distributed/, NNIndex(strategy="sharded"),
knn_graph(mesh=)) on CPU meshes of logical shards, against tpu_knn's on
conftest's 8 virtual devices and against the oracle.

The scenarios are tpu_knn's own (tests/test_sharded.py, test_graph.py,
test_bf16_store.py, test_metrics.py), on meshes of the same shapes: sp = 8,
(dp, sp) = (2, 4), (dcn, dp, sp) in {(2, 1, 4), (2, 2, 2), (4, 1, 2)}.
Against tpu_knn (one shape per builder and per store, each built once per
module): indices identical, top-K rows identical by (d2, index), d2 within
rtol 1e-6 / atol 1e-7 (f32 summation order: tpu_knn's exact rerank and the
port's sum the k squares in different orders)."""

import ml_dtypes
import numpy as np
import pytest
import torch

import tpu_knn
import tpu_knn_torch
from tpu_knn.distributed.sharded import default_mesh as tk_mesh
from tpu_knn.distributed.sharded import multislice_mesh as tk_multislice
from tpu_knn.distributed.sharded import sharded_knn as tk_sharded_knn
from tpu_knn.distributed.sharded import sharded_topk_knn as tk_sharded_topk_knn
from tpu_knn.engine.index import NNIndex as JaxIndex
from tpu_knn.oracle import oracle_callback
from tpu_knn_torch.distributed import collectives
from tpu_knn_torch.distributed.mesh import Mesh, ShardedArray
from tpu_knn_torch.distributed.sharded import (
    PAD_VALUE, _build_sharded, default_mesh, multislice_mesh, sharded_knn, sharded_topk_knn,
)

NNIndex = tpu_knn_torch.NNIndex

RTOL, ATOL = 1e-6, 1e-7


def cpu_mesh(dp=1, sp=8, dcn=None):
    if dcn is None:
        return default_mesh(dp=dp, sp=sp, devices="cpu")
    return multislice_mesh(dcn, dp=dp, sp=sp, devices="cpu")


def oracle(search, ref):
    m, k = search.shape
    return oracle_callback(k, m, ref.shape[0], search, ref)


def oracle_topk(q, r, kk):
    d2 = ((q[:, None, :] - r[None, :, :]) ** 2).sum(-1)
    return np.array([np.lexsort((np.arange(len(row)), row))[:kk] for row in d2])


def _masked_oracle(q, r, dead, kk=None):
    d2 = ((q[:, None, :] - r[None, :, :]) ** 2).sum(-1, dtype=np.float32)
    d2[:, dead] = np.inf
    order = np.lexsort((np.tile(np.arange(r.shape[0]), (q.shape[0], 1)), d2))
    return order[:, 0] if kk is None else order[:, :kk]


def _quantized(a):
    return a.astype(ml_dtypes.bfloat16).astype(np.float32)


def same(got, want):
    """Indices identical, d2 (or score) within RTOL / ATOL."""
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=RTOL, atol=ATOL)


# ---- tpu_knn's answers, once per module ---------------------------------


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
    rng = np.random.default_rng(0)
    q = rng.random((17, 6), np.float32)
    r = rng.random((20_000, 6), np.float32)
    r[1200] = r[7000] = q[2]          # a tie across shards 0 and 2 of sp = 8
    qb = rng.random((80, 6), np.float32)
    return q, r, qb


@pytest.fixture(scope="module")
def tk(data):
    """tpu_knn's answers: each builder at one shape, each store's index at
    (2, 4)."""
    q, r, qb = data
    out = {
        "knn sp8": tk_sharded_knn(q, r, mesh=tk_mesh(dp=1, sp=8)),
        "knn (2,2,2)": tk_sharded_knn(q, r, mesh=tk_multislice(dcn=2, dp=2, sp=2)),
        "topk (2,4) sweep": tk_sharded_topk_knn(q, r, 6, mesh=tk_mesh(dp=2, sp=4)),
        "topk sp8 seeded": tk_sharded_topk_knn(qb, r, 8, mesh=tk_mesh(dp=1, sp=8)),
    }
    for store in ("float32", "bf16"):
        ix = JaxIndex(r, strategy="sharded", store=store, mesh=tk_mesh(dp=2, sp=4))
        out[f"index {store}"] = [ix.query(q[:3]), ix.query(qb), ix.query(q[:3], neighbors=8),
                                 ix.query(qb, neighbors=8)]
    return {key: jax_np(v) for key, v in out.items()}


def jax_np(v):
    if isinstance(v, list):
        return [jax_np(x) for x in v]
    return tuple(np.asarray(x) for x in v)


# ---- the mesh and the collectives ---------------------------------------------


def test_mesh_stands_in_for_jaxs():
    mesh = cpu_mesh(dp=2, sp=4)
    assert mesh.shape == {"dp": 2, "sp": 4} == dict(tk_mesh(dp=2, sp=4).shape)
    assert mesh.axis_names == ("dp", "sp") and mesh.home == torch.device("cpu")
    assert mesh == cpu_mesh(dp=2, sp=4) and hash(mesh) == hash(cpu_mesh(dp=2, sp=4))
    assert mesh != cpu_mesh(dp=1, sp=8)
    ms = cpu_mesh(dp=1, sp=4, dcn=2)
    assert ms.shape == {"dcn": 2, "dp": 1, "sp": 4} == dict(tk_multislice(dcn=2, dp=1,
                                                                           sp=4).shape)
    # An explicit sequence; sp from its length, as JAX's default_mesh.
    assert default_mesh(dp=2, devices=["cpu"] * 6).shape == {"dp": 2, "sp": 3}
    with pytest.raises(ValueError, match="devices"):
        Mesh(np.array(["cpu"] * 4, dtype=object), ("dp", "sp"))
    with pytest.raises(ValueError, match="needs 8 devices"):
        default_mesh(dp=2, sp=4, devices=["cpu"] * 4)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            default_mesh()
        with pytest.raises(RuntimeError, match="no CUDA card"):
            sharded_knn(np.zeros((2, 3)), np.zeros((5, 3)), device="cpu")
    with pytest.raises(ValueError, match="mesh"):
        sharded_knn(np.zeros((2, 3)), np.zeros((5, 3)), device="cpu",
                    mesh=Mesh(np.array([["cpu"]], dtype=object), ("a", "b")))


def test_sharded_array_places_and_gathers():
    mesh = cpu_mesh(dp=2, sp=2, dcn=2)
    blocks = [torch.full((3, 2), float(s)) for s in range(4)]
    arr = ShardedArray(mesh, blocks, axis=0)
    assert arr.shape == (12, 2) and arr.num_shards == 4 and arr.width == 3
    np.testing.assert_array_equal(arr.gather()[:, 0].numpy(), np.repeat(np.arange(4.0), 3))
    np.testing.assert_array_equal(arr.rows(torch.tensor([[11, 0], [4, 7]]))[..., 0].numpy(),
                                  [[3.0, 0.0], [1.0, 2.0]])


@pytest.mark.parametrize("p", [1, 2, 5])
def test_pmin_and_ring_reduce_alike(p):
    """Both methods on partials with exact ties across shards: the lowest
    index among the minima, replicated on every shard."""
    rng = np.random.default_rng(p)
    d2s = [torch.from_numpy(rng.integers(0, 4, 9).astype(np.float32)) for _ in range(p)]
    idxs = [torch.from_numpy(rng.integers(0, 1000, 9).astype(np.int32)) for _ in range(p)]
    d = np.stack([x.numpy() for x in d2s])
    i = np.stack([x.numpy() for x in idxs])
    best = d.min(0)
    want = np.where(d == best, i, 2**31 - 1).min(0)
    for method in ("pmin", "ring"):
        out_d, out_i = collectives.min_index_allreduce(d2s, idxs, method=method)
        assert len(out_d) == p
        for od, oi in zip(out_d, out_i):
            np.testing.assert_array_equal(od.numpy(), best)
            np.testing.assert_array_equal(oi.numpy(), want)
    with pytest.raises(ValueError, match="method"):
        collectives.min_index_allreduce(d2s, idxs, method="tree")
    kd, ki = collectives.topk_allreduce([x[:, None].repeat(1, 3) for x in d2s],
                                        [x[:, None].repeat(1, 3) + np.int32(j)
                                         for j, x in enumerate(idxs)], 3)
    assert len(kd) == p and kd[0].shape == (9, 3)
    assert (np.diff(kd[0].numpy(), axis=1) >= 0).all()


# ---- 1-NN (tpu_knn's test_sharded.py) ------------------------------------------


@pytest.mark.parametrize("method", ["pmin", "ring"])
def test_matches_oracle_sp8(method, data, tk):
    q, r, _ = data
    got = sharded_knn(q, r, mesh=cpu_mesh(sp=8), method=method, device="cpu")
    np.testing.assert_array_equal(got[0].numpy(), oracle(q, r))
    assert int(got[0][2]) == 1200
    same(got, tk["knn sp8"])
    np.testing.assert_allclose(got[1].numpy(), np.sum((q - r[got[0].numpy()]) ** 2, axis=1),
                               rtol=RTOL)


def test_dp2_sp4_mesh():
    rng = np.random.default_rng(1)
    q = rng.random((64, 8), np.float32)
    r = rng.random((10_000, 8), np.float32)
    idx, _ = sharded_knn(q, r, mesh=cpu_mesh(dp=2, sp=4), device="cpu")
    np.testing.assert_array_equal(idx.numpy(), oracle(q, r))


def test_winner_in_every_shard():
    rng = np.random.default_rng(2)
    m, k, n = 8, 4, 16_384
    ref = rng.random((n, k), np.float32) + 2.0
    search = rng.random((m, k), np.float32)
    winners = [i * (n // 8) + 7 * i + 3 for i in range(m)]
    for i, pos in enumerate(winners):
        ref[pos] = search[i]
    idx, d2 = sharded_knn(search, ref, mesh=cpu_mesh(sp=8), device="cpu")
    np.testing.assert_array_equal(idx.numpy(), winners)
    np.testing.assert_array_equal(d2.numpy(), np.zeros(m, np.float32))


def test_tie_across_shards_lowest_global_index():
    q = np.zeros((1, 3), np.float32)
    r = np.ones((8192, 3), np.float32)
    r[1200] = r[7000] = 0.5        # shards 1 and 6
    for method in ("pmin", "ring"):
        idx, _ = sharded_knn(q, r, mesh=cpu_mesh(sp=8), method=method, device="cpu")
        assert int(idx[0]) == 1200


@pytest.mark.parametrize("n", [10_001, 1030])
def test_ragged_n_and_empty_trailing_shards(n):
    """Ragged n; at n = 1030 over 8 shards of 256 the last three shards
    hold no point and contribute without a launch."""
    rng = np.random.default_rng(3)
    q = rng.random((5, 4), np.float32)
    r = rng.random((n, 4), np.float32)
    run = _build_sharded(5, n, 4, cpu_mesh(sp=8))
    assert (n == 1030) == (run.n_local * 5 >= n)
    idx, _ = run(torch.from_numpy(q), torch.from_numpy(r))
    np.testing.assert_array_equal(idx.numpy(), oracle(q, r))


@pytest.mark.parametrize("dcn,dp,sp", [(2, 1, 4), (2, 2, 2), (4, 1, 2)])
def test_multislice_mesh(dcn, dp, sp, data, tk):
    q, r, _ = data
    got = sharded_knn(q, r, mesh=cpu_mesh(dp=dp, sp=sp, dcn=dcn), device="cpu")
    np.testing.assert_array_equal(got[0].numpy(), oracle(q, r))
    same(got, tk["knn (2,2,2)"])


def test_multislice_tie_across_slices():
    q = np.zeros((1, 3), np.float32)
    r = np.ones((8192, 3), np.float32)
    r[500] = r[6000] = 0.5         # slices 0 and 1
    for method in ("pmin", "ring"):
        idx, _ = sharded_knn(q, r, mesh=cpu_mesh(dp=1, sp=4, dcn=2), method=method,
                             device="cpu")
        assert int(idx[0]) == 500


def test_multislice_prepared_index():
    rng = np.random.default_rng(6)
    r = rng.random((10_000, 4), np.float32)
    index = NNIndex(r, strategy="sharded", mesh=cpu_mesh(dp=1, sp=4, dcn=2))
    q = rng.random((8, 4), np.float32)
    np.testing.assert_array_equal(index.query(q)[0].numpy(), oracle(q, r))


def test_v8_delegates_and_answers():
    """v8's guard counts distinct cards (none here): dispatch lands on v7,
    and v8 named explicitly answers (CPU tensors take v7)."""
    v8 = tpu_knn_torch.get_version("v8")
    assert v8.fallback == "v7" == tpu_knn.get_version("v8").fallback
    assert not v8.guard(3, 1024, 1024)
    assert v8.guard(3, 1024, 1 << 20) == (torch.cuda.device_count() > 1)
    rng = np.random.default_rng(4)
    q = rng.random((32, 16), np.float32)
    r = rng.random((1 << 14, 16), np.float32)
    got = tpu_knn_torch.knn_callback(16, 32, 1 << 14, q, r, version="v8", device="cpu")
    np.testing.assert_array_equal(got, oracle(q, r))
    np.testing.assert_array_equal(v8.fn(16, 32, 1 << 14, torch.from_numpy(q),
                                        torch.from_numpy(r)), oracle(q, r))


# ---- top-K ----------------------------------------------------------------


@pytest.mark.parametrize("method", ["sweep", "passes", "seeded"])
def test_sharded_topk_matches_oracle(method):
    rng = np.random.default_rng(7)
    q = rng.random((9, 5), np.float32)
    r = rng.random((12_000, 5), np.float32)
    idx, d2 = sharded_topk_knn(q, r, 6, mesh=cpu_mesh(sp=8), method=method, device="cpu")
    want = oracle_topk(q, r, 6)
    np.testing.assert_array_equal(idx.numpy(), want)
    D = ((q[:, None, :] - r[None, :, :]) ** 2).sum(-1)
    np.testing.assert_allclose(d2.numpy(), np.take_along_axis(D, want, 1), rtol=RTOL)


def test_sharded_topk_against_tpu_knn(data, tk):
    q, r, qb = data
    same(sharded_topk_knn(q, r, 6, mesh=cpu_mesh(dp=2, sp=4), device="cpu"),
         tk["topk (2,4) sweep"])
    got = sharded_topk_knn(qb, r, 8, mesh=cpu_mesh(sp=8), device="cpu")
    same(got, tk["topk sp8 seeded"])
    np.testing.assert_array_equal(got[0].numpy(), oracle_topk(qb, r, 8))


def test_sharded_topk_batch_regime_routes_seeded_per_shard():
    from tpu_knn_torch.kernels.topk import _auto_method

    rng = np.random.default_rng(17)
    m, n, kk = 80, 4096, 8
    assert _auto_method(m, kk) == "seeded"
    q = rng.random((m, 5), np.float32)
    r = rng.random((n, 5), np.float32) + 2.0
    r[100] = r[600] = q[3]
    r[512 + 7] = r[3 * 512 + 7] = q[5]
    for c in (5, 17, 29, 41):
        r[c] = q[11]
    idx, _ = sharded_topk_knn(q, r, kk, mesh=cpu_mesh(sp=8), device="cpu")
    idx = idx.numpy()
    np.testing.assert_array_equal(idx, oracle_topk(q, r, kk))
    assert list(idx[3, :2]) == [100, 600]
    assert list(idx[5, :2]) == [512 + 7, 3 * 512 + 7]
    assert list(idx[11, :4]) == [5, 17, 29, 41]


def test_sharded_topk_k_beyond_128():
    rng = np.random.default_rng(23)
    m, n, kk = 12, 8192, 160
    q = rng.random((m, 5), np.float32)
    r = rng.random((n, 5), np.float32) + 2.0
    r[100] = r[5 * 1024 + 9] = q[3]
    idx, _ = sharded_topk_knn(q, r, kk, mesh=cpu_mesh(sp=8), device="cpu")
    np.testing.assert_array_equal(idx.numpy(), oracle_topk(q, r, kk))
    assert list(idx.numpy()[3, :2]) == [100, 5 * 1024 + 9]
    r_small = rng.random((1024, 5), np.float32)
    idx, _ = sharded_topk_knn(q, r_small, 512, mesh=cpu_mesh(sp=8), device="cpu")
    np.testing.assert_array_equal(idx.numpy(), oracle_topk(q, r_small, 512))


def test_topk_k_beyond_shard_width():
    rng = np.random.default_rng(11)
    ref = rng.random((1_000, 4), np.float32)
    q = rng.random((3, 4), np.float32)
    D = ((q[:, None, :] - ref[None, :, :]) ** 2).sum(-1)
    mesh = cpu_mesh(sp=8)
    ix = NNIndex(ref, strategy="sharded", mesh=mesh)
    for kk in (ix._n_local + 1, 512):
        want = np.array([np.lexsort((np.arange(1000), row))[:kk] for row in D])
        np.testing.assert_array_equal(ix.query(q, neighbors=kk)[0].numpy(), want)
        np.testing.assert_array_equal(sharded_topk_knn(q, ref, kk, mesh=mesh,
                                                       device="cpu")[0].numpy(), want)
    idx, _, cnt = ix.query_radius(q, 0.55)
    for i in range(3):
        want = set(np.nonzero(np.sqrt(D[i]) <= 0.55)[0].tolist())
        assert set(idx.numpy()[i, : int(cnt[i])].tolist()) == want


def test_sharded_topk_duplicates_across_shards():
    rng = np.random.default_rng(8)
    n = 16_384
    q = rng.random((3, 4), np.float32)
    r = rng.random((n, 4), np.float32) + 2.0
    shard = n // 8
    spots = [5 * shard + 11, 1 * shard + 3, 7 * shard + 200, 3 * shard + 9]
    for s in spots:
        r[s] = q[1]
    idx, d2 = sharded_topk_knn(q, r, 4, mesh=cpu_mesh(sp=8), device="cpu")
    np.testing.assert_array_equal(idx.numpy()[1], sorted(spots))
    assert np.all(d2.numpy()[1] == 0.0)


def test_sharded_topk_dp2_sp4_and_multislice():
    rng = np.random.default_rng(9)
    q = rng.random((32, 6), np.float32)
    r = rng.random((7_777, 6), np.float32)
    want = oracle_topk(q, r, 5)
    for mesh in (cpu_mesh(dp=2, sp=4), cpu_mesh(dp=2, sp=2, dcn=2), cpu_mesh(dp=1, sp=2, dcn=4)):
        idx, _ = sharded_topk_knn(q, r, 5, mesh=mesh, device="cpu")
        np.testing.assert_array_equal(idx.numpy(), want)


def test_sharded_topk_k_exceeds_smallest_shard():
    rng = np.random.default_rng(10)
    q = rng.random((4, 3), np.float32)
    r = rng.random((1030, 3), np.float32)
    idx, _ = sharded_topk_knn(q, r, 16, mesh=cpu_mesh(sp=8), device="cpu")
    np.testing.assert_array_equal(idx.numpy(), oracle_topk(q, r, 16))


def test_prepadded_sharded_topk_index():
    rng = np.random.default_rng(31)
    q = rng.random((12, 5), np.float32)
    r = rng.random((5_555, 5), np.float32)
    spots = (4777, 123, 2900)
    for s in spots:
        r[s] = q[4]
    for mesh in (cpu_mesh(sp=8), cpu_mesh(dp=2, sp=4), cpu_mesh(dp=2, sp=2, dcn=2)):
        ix = NNIndex(r, strategy="sharded", mesh=mesh)
        gi, gd = ix.query(q, neighbors=6)
        np.testing.assert_array_equal(gi.numpy(), oracle_topk(q, r, 6))
        assert np.all(gd.numpy()[4, :3] == 0.0)
        np.testing.assert_array_equal(gi.numpy()[4, :3], sorted(spots))
        np.testing.assert_array_equal(ix.query(q)[0].numpy(), gi.numpy()[:, 0])
        ri, _, _ = ix.query_radius(q, 0.05, 4)
        assert ri.shape == (12, 4)


# ---- NNIndex(strategy="sharded") over the stores -------------------------------


@pytest.mark.parametrize("store", ["float32", "bf16"])
def test_sharded_index_against_tpu_knn_and_unsharded(store, data, tk):
    """The (2, 4) index of each store: tpu_knn's answers at m = 3 and 80,
    1-NN and top-K, and the port's unsharded index's."""
    q, r, qb = data
    ix = NNIndex(r, strategy="sharded", store=store, mesh=cpu_mesh(dp=2, sp=4))
    assert ix.r_sharded.dtype == (torch.bfloat16 if store == "bf16" else torch.float32)
    assert ix.r_ops_sharded.dtype == ix.r_sharded.dtype
    got = [ix.query(q[:3]), ix.query(qb), ix.query(q[:3], neighbors=8),
           ix.query(qb, neighbors=8)]
    for g, w in zip(got, tk[f"index {store}"]):
        same(g, w)
    flat = NNIndex(r, store=store, device="cpu")
    for g, w in zip(got, [flat.query(q[:3]), flat.query(qb), flat.query(q[:3], neighbors=8),
                          flat.query(qb, neighbors=8)]):
        same(g, w)


def test_bf16_sharded_1nn_and_topk():
    rng = np.random.default_rng(21)
    ref = rng.random((16_384, 6), np.float32)
    ix = NNIndex(ref, strategy="sharded", store="bf16", mesh=cpu_mesh(sp=8))
    ref_q = _quantized(ref)
    q = rng.random((24, 6), np.float32)
    idx, d2 = ix.query(q)
    np.testing.assert_array_equal(idx.numpy(), oracle(q, ref_q))
    np.testing.assert_allclose(d2.numpy(), np.sum((q - ref_q[idx.numpy()]) ** 2, axis=1),
                               rtol=RTOL)
    np.testing.assert_array_equal(ix.query(q, neighbors=8)[0].numpy(), oracle_topk(q, ref_q, 8))


def test_bf16_sharded_cross_shard_quantization_tie():
    rng = np.random.default_rng(22)
    ref = rng.random((4_096, 4), np.float32)
    q = rng.random((3, 4), np.float32)
    base = q[1] + 1e-4
    ref[300] = base
    ref[3_900] = base + 1e-4
    ref_q = _quantized(ref)
    assert (ref_q[300] == ref_q[3_900]).all()
    ix = NNIndex(ref, strategy="sharded", store="bf16", mesh=cpu_mesh(sp=8))
    idx, _ = ix.query(q)
    np.testing.assert_array_equal(idx.numpy(), oracle(q, ref_q))
    assert int(idx[1]) == 300


@pytest.mark.parametrize("metric", ["cosine", "ip"])
def test_metric_sharded(metric, data):
    """tpu_knn's test_metric_sharded: the metric's answers over the shards
    are the unsharded index's (itself held to tpu_knn's in
    test_torch_metrics.py), 1-NN and top-K."""
    q, r, _ = data
    ix = NNIndex(r - 0.4, strategy="sharded", metric=metric, mesh=cpu_mesh(sp=8))
    flat = NNIndex(r - 0.4, metric=metric, device="cpu")
    for kk in (None, 8):
        same(ix.query(q, neighbors=kk), flat.query(q, neighbors=kk))


def test_sharded_pipeline_exposed():
    rng = np.random.default_rng(13)
    ref = rng.random((4_000, 6), np.float32)
    q = torch.from_numpy(rng.random((8, 6), np.float32))
    ix = NNIndex(ref, strategy="sharded", mesh=cpu_mesh(sp=8))
    run, ops = ix.pipeline(8)
    for a, b in zip(run(q, *ops), ix.query(q)):
        assert torch.equal(a, b)


def test_sharded_presplit_and_bad_mesh_raise():
    r = np.random.default_rng(0).random((500, 4), np.float32)
    with pytest.raises(ValueError, match="presplit"):
        NNIndex(r, strategy="sharded", precision="bf16x3_presplit", mesh=cpu_mesh(sp=8))
    with pytest.raises(ValueError, match="strategy='sharded'"):
        NNIndex(r, mesh=cpu_mesh(sp=8), device="cpu")


def test_from_state_of_a_tpu_knn_sharded_index():
    """A tpu_knn sharded index's state (the padded layout) over a port mesh
    of the same shape answers as tpu_knn's index: f32 and mutable bf16."""
    rng = np.random.default_rng(50)
    r = rng.random((3_000, 5), np.float32)
    q = rng.random((6, 5), np.float32)
    jx = JaxIndex(r, strategy="sharded", mesh=tk_mesh(dp=2, sp=4))
    state = {"ref": np.asarray(jx.r_sharded), "r_op": np.asarray(jx.r_ops_sharded), "n": jx.n}
    ix = NNIndex.from_state(state, mesh=cpu_mesh(dp=2, sp=4))
    assert ix.strategy == "sharded" and ix._n_local == jx._n_local
    same(ix.query(q), jax_np(jx.query(q)))
    jm = JaxIndex(r[:700], strategy="sharded", store="bf16", mutable=True,
                  mesh=tk_mesh(dp=1, sp=8))
    ids = jm.add(q[:2])
    jm.remove([3, int(ids[0])])
    state = {"ref": np.asarray(jm.r_sharded), "r_op": np.asarray(jm.r_ops_sharded),
             "n": jm.n, "_n_slots": jm._n_slots, "_live": jm._live}
    im = NNIndex.from_state(state, mesh=cpu_mesh(sp=8))
    assert (im.capacity, im.n_live, im.store) == (jm.capacity, jm.n_live, "bf16")
    for kk in (None, 4):
        same(im.query(q, neighbors=kk), jax_np(jm.query(q, neighbors=kk)))
    bad = dict(state, r_op=np.asarray(jm.r_ops_sharded)[:, :-128])
    with pytest.raises(ValueError, match="transpose"):
        NNIndex.from_state(bad, mesh=cpu_mesh(sp=8))
    with pytest.raises(ValueError, match="layout"):
        NNIndex.from_state({"ref": np.asarray(jx.r_sharded), "r_op": np.asarray(
            jx.r_ops_sharded), "n": jx.n}, mesh=cpu_mesh(dp=1, sp=5))   # 3200 rows


# ---- dynamic serving on the sharded tier -------------------------------------


def test_sharded_mutable_add_remove():
    rng = np.random.default_rng(40)
    k, n = 6, 600
    r = rng.random((n, k), np.float32)
    q = rng.random((5, k), np.float32)
    ix = NNIndex(r, strategy="sharded", mesh=cpu_mesh(dp=2, sp=4), mutable=True)
    assert ix.n_live == n
    ids = ix.add(q[:3])
    assert ix.n_live == n + 3
    i1, d1 = ix.query(q[:3])
    np.testing.assert_array_equal(i1.numpy(), ids)
    np.testing.assert_array_equal(d1.numpy(), np.zeros(3, np.float32))
    ix.remove(ids)
    np.testing.assert_array_equal(ix.query(q[:3])[0].numpy(), _masked_oracle(q[:3], r, []))
    dead = np.asarray([0, 7, 150, 299, 580])
    ix.remove(dead)
    assert ix.n_live == n - dead.size
    np.testing.assert_array_equal(ix.query(q, neighbors=4)[0].numpy(),
                                  _masked_oracle(q, r, dead, 4))
    _, _, rc = ix.query_radius(q, 0.3)
    d2 = ((q[:, None, :] - r[None, :, :]) ** 2).sum(-1, dtype=np.float32)
    d2[:, dead] = np.inf
    np.testing.assert_array_equal(rc.numpy(), (d2 <= 0.3 ** 2).sum(1))
    with pytest.raises(ValueError, match="already removed"):
        ix.remove([7])


def test_sharded_mutable_growth_preserves_ids():
    rng = np.random.default_rng(41)
    k, n = 5, 400
    r = rng.random((n, k), np.float32)
    ix = NNIndex(r, strategy="sharded", mesh=cpu_mesh(sp=8), mutable=True)
    cap0, n_local0 = ix.capacity, ix._n_local
    extra = rng.random((cap0 - n + 64, k), np.float32)
    ids = ix.add(extra)
    assert ix.capacity > cap0 and ix._n_local > n_local0
    np.testing.assert_array_equal(ids, np.arange(n, n + extra.shape[0], dtype=np.int32))
    q = rng.random((4, k), np.float32)
    allpts = np.concatenate([r, extra])
    np.testing.assert_array_equal(ix.query(q)[0].numpy(), _masked_oracle(q, allpts, []))
    ix.remove([3])
    np.testing.assert_array_equal(ix.query(q)[0].numpy(), _masked_oracle(q, allpts, [3]))


def test_sharded_mutable_compact_and_bf16():
    rng = np.random.default_rng(42)
    k, n = 4, 300
    r = rng.random((n, k), np.float32)
    q = rng.random((3, k), np.float32)
    ix = NNIndex(r, strategy="sharded", mesh=cpu_mesh(dp=2, sp=4), mutable=True, store="bf16")
    rq = _quantized(r)
    dead = [5, 50, 250]
    ix.remove(dead)
    mapping = ix.compact()
    assert ix.n_live == n - len(dead)
    assert all(mapping[d] == -1 for d in dead)
    np.testing.assert_array_equal(ix.query(q)[0].numpy(), mapping[_masked_oracle(q, rq, dead)])
    ids = ix.add(q[:1])
    i1, d1 = ix.query(q[:1])
    assert int(i1[0]) == int(ids[0])
    assert float(d1[0]) <= 4 * (2.0 ** -9) ** 2


def test_sharded_filtered_view():
    rng = np.random.default_rng(43)
    k, n = 6, 3000
    r = rng.random((n, k), np.float32)
    q = rng.random((6, k), np.float32)
    for store in ("float32", "bf16"):
        ix = NNIndex(r, strategy="sharded", mesh=cpu_mesh(sp=8), store=store)
        keep = rng.random(n) < 0.4
        view = ix.filtered_view(keep)
        assert view.n_live == int(keep.sum()) and view.strategy == "sharded"
        rs = _quantized(r) if store == "bf16" else r
        dead = np.nonzero(~keep)[0]
        np.testing.assert_array_equal(view.query(q)[0].numpy(), _masked_oracle(q, rs, dead))
        np.testing.assert_array_equal(view.query(q, neighbors=5)[0].numpy(),
                                      _masked_oracle(q, rs, dead, 5))
        np.testing.assert_array_equal(ix.query(q)[0].numpy(), _masked_oracle(q, rs, []))
        with pytest.raises(ValueError, match="ephemeral"):
            view.save("unused.npz")


def test_sharded_save_load_roundtrip(tmp_path):
    rng = np.random.default_rng(44)
    k, n = 5, 900
    r = rng.random((n, k), np.float32)
    q = rng.random((4, k), np.float32)
    mesh = cpu_mesh(dp=2, sp=4)
    ix = NNIndex(r, strategy="sharded", mesh=mesh)
    p = str(tmp_path / "s_f32.npz")
    ix.save(p)
    lx = NNIndex.load(p, device="cpu")
    assert lx.strategy == "sharded" and lx.mesh.shape == {"dp": 2, "sp": 4}
    for a, b in zip(lx.query(q), ix.query(q)):
        assert torch.equal(a, b)
    lx2 = NNIndex.load(p, mesh=cpu_mesh(sp=8), device="cpu")
    assert lx2.mesh.shape == {"dp": 1, "sp": 8}
    np.testing.assert_array_equal(lx2.query(q)[0].numpy(), ix.query(q)[0].numpy())
    ixb = NNIndex(r, strategy="sharded", mesh=mesh, store="bf16")
    ixb.save(str(tmp_path / "s_bf16.npz"))
    lb = NNIndex.load(str(tmp_path / "s_bf16.npz"), device="cpu")
    assert torch.equal(lb.r_sharded.gather().view(torch.int16),
                       ixb.r_sharded.gather().view(torch.int16))
    np.testing.assert_array_equal(lb.query(q)[0].numpy(), ixb.query(q)[0].numpy())
    ixm = NNIndex(r, strategy="sharded", mesh=mesh, mutable=True)
    ids = ixm.add(q[:2])
    ixm.remove([10, 20])
    ixm.save(str(tmp_path / "s_mut.npz"))
    lm = NNIndex.load(str(tmp_path / "s_mut.npz"), device="cpu")
    assert lm.mutable and lm.n_live == ixm.n_live
    np.testing.assert_array_equal(lm.query(q)[0].numpy(), ixm.query(q)[0].numpy())
    i1, d1 = lm.query(q[:2])
    np.testing.assert_array_equal(i1.numpy(), ids)
    np.testing.assert_array_equal(d1.numpy(), np.zeros(2, np.float32))


def test_sharded_metric_dynamic_composition(tmp_path):
    rng = np.random.default_rng(45)
    k, n = 4, 500
    r = (rng.random((n, k), np.float32) - 0.3) * 2 + 0.01
    q = (rng.random((3, k), np.float32) - 0.3) * 2 + 0.01
    mesh = cpu_mesh(sp=8)
    ix = NNIndex(r, strategy="sharded", mesh=mesh, metric="cosine", mutable=True)
    ids = ix.add(q[:1] * 7.0)
    i1, sim = ix.query(q[:1])
    assert int(i1[0]) == int(ids[0]) and float(sim[0]) >= 1.0 - 1e-6
    ixs = NNIndex(r, strategy="sharded", mesh=mesh, metric="cosine")
    keep = rng.random(n) < 0.5
    rn = r / np.sqrt((r * r).sum(1))[:, None]
    qn = q / np.sqrt((q * q).sum(1))[:, None]
    np.testing.assert_array_equal(ixs.filtered_view(keep).query(q)[0].numpy(),
                                  _masked_oracle(qn, rn, np.nonzero(~keep)[0]))
    ixs.save(str(tmp_path / "cos.npz"))
    back = NNIndex.load(str(tmp_path / "cos.npz"), device="cpu")
    for a, b in zip(back.query(q, neighbors=3), ixs.query(q, neighbors=3)):
        assert torch.equal(a, b)


# ---- knn_graph(mesh=) (tpu_knn's test_graph.py) ------------------------------


def _gold_graph(pts, kk):
    d2 = ((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
    n = pts.shape[0]
    idx = np.empty((n, kk), np.int64)
    for i in range(n):
        order = [j for j in np.lexsort((np.arange(n), d2[i])) if j != i][:kk]
        idx[i] = order
    return idx, np.take_along_axis(d2, idx, 1)


def test_graph_sharded_mesh_matches_bruteforce():
    rng = np.random.default_rng(11)
    pts = rng.random((1_000, 5), np.float32)
    gi, gd = tpu_knn_torch.knn_graph(pts, 6, mesh=cpu_mesh(dp=2, sp=4))
    wi, wd = _gold_graph(pts, 6)
    np.testing.assert_array_equal(gi.numpy(), wi)
    np.testing.assert_allclose(gd.numpy(), wd, rtol=RTOL)
    assert not (gi.numpy() == np.arange(1_000)[:, None]).any()
    ji, jd = tpu_knn.knn_graph(pts, 6, mesh=tk_mesh(dp=2, sp=4))
    same((gi, gd), (ji, jd))


def test_graph_sharded_duplicates_across_shards():
    rng = np.random.default_rng(12)
    pts = rng.random((800, 4), np.float32)
    dup = [3, 203, 403, 603]
    for i in dup[1:]:
        pts[i] = pts[dup[0]]
    gi, gd = tpu_knn_torch.knn_graph(pts, 3, mesh=cpu_mesh(sp=8))
    for i in dup:
        assert list(gi.numpy()[i]) == [j for j in dup if j != i][:3]
        np.testing.assert_array_equal(gd.numpy()[i], 0.0)


def test_pad_value_is_tpu_knns():
    from tpu_knn.distributed.sharded import PAD_VALUE as TK_PAD

    assert PAD_VALUE == TK_PAD
