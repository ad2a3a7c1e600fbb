"""The port's main path as a whole: public entry points against the golden
fixture and tpu_knn, v7's multi-partial regression, the prepared index
built from a tpu_knn index's state, and the port's independence of jax."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import tpu_knn
import tpu_knn_torch
from tpu_knn.engine.index import NNIndex as JaxIndex
from tpu_knn.harness.checker import check_results
from tpu_knn.harness.generator import TA_SHAPES
from tpu_knn.oracle import oracle_knn
from tpu_knn_torch.kernels.tuning import pick_tiles
from tpu_knn_torch.kernels.twolevel import twolevel_knn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _golden_indices():
    path = os.path.join(REPO, "tests", "golden", "results_seed1000.csv")
    with open(path) as f:
        lines = [ln.strip().rstrip(",") for ln in f if ln.strip()]
    assert len(lines) == 2 * len(TA_SHAPES)
    return [np.array([int(x) for x in lines[2 * i].split(",")])
            for i in range(len(TA_SHAPES))]


@pytest.mark.parametrize("version", ["v0", "v4", "v7", None])
def test_ta_shapes_match_golden(ta_datasets, version):
    for ((k, m, n), search, ref), gold in zip(ta_datasets, _golden_indices()):
        idx = tpu_knn_torch.nearest_neighbors(search, ref, version=version,
                                              device="cpu")
        assert idx.dtype == np.int32 and idx.shape == (m,)
        np.testing.assert_array_equal(idx, gold, err_msg=f"{(k, m, n)}")
        assert check_results(gold, idx, search, ref)[0] == 0


def _planted(m, n, k, seed):
    """Random points with exact duplicates astride tpu_knn's eight v7
    partition boundaries and a lane boundary (at these sizes each
    128-column group is a partition of the port's v7): query i's point is
    planted at two adjacent columns, so ties decide every planted row."""
    rng = np.random.default_rng(seed)
    q = rng.random((m, k), np.float32)
    r = rng.random((n, k), np.float32) + 0.5
    parts = 8
    _, tile_n = pick_tiles(k, m, -(-n // parts))
    n_shard = -(-(-(-n // parts)) // tile_n) * tile_n
    cols = [127] + [p * n_shard - 1 for p in range(1, parts) if p * n_shard < n]
    for i, c in enumerate(cols[:m]):
        r[c] = r[c + 1] = q[i]
    return q, r, cols[:m]


@pytest.mark.parametrize("version", ["v4", "v7"])
@pytest.mark.parametrize("m,n,k", [(12, 6000, 6), (3, 9000, 16)])
def test_matches_tpu_knn_with_planted_duplicates(version, m, n, k):
    q, r, cols = _planted(m, n, k, seed=m + n)
    want = tpu_knn.nearest_neighbors(q, r, version=version)
    got = tpu_knn_torch.nearest_neighbors(q, r, version=version, device="cpu")
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, oracle_knn(q, r))
    np.testing.assert_array_equal(got[:len(cols)], cols)


def test_v7_m_greater_1_with_forced_multi_partial():
    """The reference's latent v7 bug (core.cu:771-773, SURVEY §2.4): many
    queries AND many partitions, each query's winner planted in a
    different partition — any cross-query candidate mixup mispicks."""
    rng = np.random.default_rng(0)
    m, k, parts = 16, 4, 8
    n = 8 * 1024
    ref = rng.random((n, k), np.float32) + 2.0
    search = rng.random((m, k), np.float32)
    winners = []
    for i in range(m):
        pos = (i % parts) * 1024 + 100 + i
        ref[pos] = search[i]
        winners.append(pos)
    idx, d2 = twolevel_knn(search, ref, parts=parts, device="cpu")
    np.testing.assert_array_equal(idx.numpy(), winners)
    np.testing.assert_array_equal(d2.numpy(), np.zeros(m, np.float32))


@pytest.mark.parametrize("parts", [1, 2, 8])
def test_v7_matches_oracle(parts):
    rng = np.random.default_rng(1)
    q = rng.random((9, 6), np.float32)
    r = rng.random((5000, 6), np.float32)
    idx, _ = twolevel_knn(q, r, parts=parts, device="cpu")
    np.testing.assert_array_equal(idx.numpy(), oracle_knn(q, r))


@pytest.fixture(scope="module")
def jax_index():
    rng = np.random.default_rng(11)
    r = rng.random((5000, 16), np.float32)
    r[4999] = r[17]
    return r, JaxIndex(r, strategy="fused")


@pytest.mark.parametrize("m", [1, 3, 8, 100])
def test_from_state_answers_like_tpu_knn(jax_index, m):
    r, jx = jax_index
    state = {"ref": np.asarray(jx.ref_dev), "r_op": np.asarray(jx.r_ops[0])}
    ix = tpu_knn_torch.NNIndex.from_state(state, device="cpu")
    assert ix.r_ops[0].shape == state["r_op"].shape
    rng = np.random.default_rng(m)
    q = rng.random((m, 16), np.float32)
    q[0] = r[17]
    ji, jd = (np.asarray(a) for a in jx.query(q))
    pi, pd = ix.query(q)
    np.testing.assert_array_equal(pi.numpy(), ji)
    np.testing.assert_array_equal(pi.numpy(), oracle_knn(q, r))
    assert int(pi[0]) == 17
    np.testing.assert_allclose(pd.numpy(), jd, rtol=1e-6, atol=1e-7)
    fresh = tpu_knn_torch.NNIndex(r, device="cpu")
    np.testing.assert_array_equal(fresh.query(q)[0].numpy(), ji)


def test_from_state_rejects_a_foreign_operand(jax_index):
    r, jx = jax_index
    r_op = np.array(jx.r_ops[0])
    r_op[3, 10] += 1.0
    with pytest.raises(ValueError, match="transpose"):
        tpu_knn_torch.NNIndex.from_state({"ref": r, "r_op": r_op}, device="cpu")
    with pytest.raises(ValueError, match="r_op shape"):
        tpu_knn_torch.NNIndex.from_state({"ref": r, "r_op": r_op[:, :100]},
                                         device="cpu")


def test_index_surface_not_ported_yet_raises(tmp_path):
    r = np.random.default_rng(2).random((500, 4), np.float32)
    ix = tpu_knn_torch.NNIndex(r, device="cpu")
    # Top-K is served, the batch regime (m*K > 256, the seeded engine) too.
    assert ix.query(r[:2], neighbors=3)[0].shape == (2, 3)
    idx, _ = ix.query(r[:20], neighbors=20)
    np.testing.assert_array_equal(idx.numpy(), _oracle_topk(r[:20], r, 20))
    # save/load (A.6.5) are served: the loaded index answers as the saved one.
    ix.save(str(tmp_path / "ix.npz"))
    loaded = tpu_knn_torch.NNIndex.load(str(tmp_path / "ix.npz"), device="cpu")
    for a, b in zip(loaded.query(r[:20]), ix.query(r[:20])):
        assert torch.equal(a, b)
    # strategy="auto" and "projection" are served since the ladder slice,
    # "kdtree" since A.8.
    for strategy in ("auto", "projection", "kdtree"):
        other = tpu_knn_torch.NNIndex(r, strategy=strategy, device="cpu")
        np.testing.assert_array_equal(other.query(r[:3])[0].numpy(), [0, 1, 2])
    # The sharded strategy (A.9) is served over a CPU mesh, and answers as
    # the unsharded index; mesh= belongs to it alone.
    from tpu_knn_torch.distributed.sharded import default_mesh

    mesh = default_mesh(dp=2, sp=4, devices="cpu")
    sharded = tpu_knn_torch.NNIndex(r, strategy="sharded", mesh=mesh)
    for a, b in zip(sharded.query(r[:20]), ix.query(r[:20])):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(sharded.query(r[:20], neighbors=20)[0].numpy(),
                                  _oracle_topk(r[:20], r, 20))
    with pytest.raises(ValueError, match="strategy='sharded'"):
        tpu_knn_torch.NNIndex(r, device="cpu", mesh=mesh)
    # load(mesh=) of an unsharded file ignores the mesh, as tpu_knn's does.
    loaded = tpu_knn_torch.NNIndex.load(str(tmp_path / "ix.npz"), mesh=mesh, device="cpu")
    assert loaded.strategy == "fused"
    # The metrics, mutable indexes and filtered views are served
    # (ROADMAP A.6.1-A.6.4).
    cos = tpu_knn_torch.NNIndex(r + 0.1, metric="cosine", device="cpu")
    assert cos.query(r[:3] + 0.1)[0].shape == (3,)
    mut = tpu_knn_torch.NNIndex(r, mutable=True, device="cpu")
    np.testing.assert_array_equal(mut.query(r[:3])[0].numpy(), [0, 1, 2])
    view = ix.filtered_view(np.arange(500) >= 1)
    assert int(view.query(r[:1])[0][0]) != 0
    # The bf16 store answers top-K too, over its bf16 operand.
    bf16 = tpu_knn_torch.NNIndex(r, store="bf16", device="cpu")
    np.testing.assert_array_equal(bf16.query(r[:3])[0].numpy(), [0, 1, 2])
    np.testing.assert_array_equal(bf16.query(r[:3], neighbors=2)[0].numpy()[:, 0], [0, 1, 2])
    with pytest.raises(ValueError):
        tpu_knn_torch.NNIndex(r, strategy="nope", device="cpu")
    got = tpu_knn_torch.nearest_neighbors(r[:20], r, neighbors=20, device="cpu")
    np.testing.assert_array_equal(got, _oracle_topk(r[:20], r, 20))


def _oracle_topk(q, r, kk):
    d2 = ((q[:, None, :] - r[None, :, :]) ** 2).sum(-1)
    return np.lexsort((np.tile(np.arange(r.shape[0]), (q.shape[0], 1)), d2))[:, :kk]


def test_device_rule():
    """Tensors run where they are; NumPy goes to device=; nothing falls
    back to the CPU for want of a card."""
    r = np.random.default_rng(3).random((300, 5), np.float32)
    q = r[:4] + 1e-3
    idx = tpu_knn_torch.nearest_neighbors(torch.from_numpy(q), torch.from_numpy(r))
    np.testing.assert_array_equal(idx, [0, 1, 2, 3])
    ix = tpu_knn_torch.NNIndex(torch.from_numpy(r))
    assert ix.device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            tpu_knn_torch.nearest_neighbors(q, r)      # device="cuda" default
        with pytest.raises((RuntimeError, AssertionError)):
            tpu_knn_torch.NNIndex(r)


def test_registry():
    assert tpu_knn_torch.list_versions() == ["v0", "v1", "v10", "v11", "v2", "v3", "v4",
                                             "v5", "v6", "v7", "v8", "v9"]
    from tpu_knn_torch.engine.registry import best_available_version

    # tpu_knn's dispatch: v8 first, which hands one device (here: no card)
    # to v7.
    best = best_available_version()
    assert best.name == "v8" and best.fallback == "v7"
    assert best.guard(16, 1024, 1 << 20) == (torch.cuda.device_count() > 1)
    with pytest.raises(KeyError, match="v12"):
        tpu_knn_torch.get_version("v12")
    assert tpu_knn_torch.knn_callback(3, 0, 5, np.zeros((0, 3)), np.zeros((5, 3)),
                                      device="cpu").shape == (0,)


def test_port_never_imports_jax():
    """Neither the port nor chip_smoke.py imports jax or the JAX package
    tpu_knn, by an AST scan and in a live CPU run (v0 included)."""
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "tpu_knn_torch")):
        paths += [os.path.join(root, name) for name in files if name.endswith(".py")]
    offenders = []
    for path in paths:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            mods = ([a.name for a in node.names] if isinstance(node, ast.Import)
                    else [node.module or ""] if isinstance(node, ast.ImportFrom)
                    else [])
            offenders += [f"{path}: {m}" for m in mods
                          if m.split(".")[0] in ("jax", "tpu_knn")]
    assert not offenders
    code = (
        "import sys, numpy as np, tpu_knn_torch\n"
        "r = np.random.default_rng(0).random((5000, 16), np.float32)\n"
        "i = tpu_knn_torch.nearest_neighbors(r[:20], r, device='cpu')\n"
        "assert (i == np.arange(20)).all()\n"
        "i = tpu_knn_torch.nearest_neighbors(r[:3], r, version='v0', device='cpu')\n"
        "assert (i == np.arange(3)).all()\n"
        "ix = tpu_knn_torch.NNIndex(r, device='cpu')\n"
        "assert (ix.query(r[:2])[0].numpy() == [0, 1]).all()\n"
        "assert (ix.query(r[:2], neighbors=3)[0].numpy()[:, 0] == [0, 1]).all()\n"
        "i, _ = tpu_knn_torch.topk_knn(r[:9], r, 4, method='passes', device='cpu')\n"
        "assert (i.numpy()[:, 0] == np.arange(9)).all()\n"
        "i, _ = tpu_knn_torch.topk_knn(r[:40], r, 8, device='cpu')\n"
        "assert (i.numpy()[:, 0] == np.arange(40)).all()\n"
        "g, _ = tpu_knn_torch.knn_graph(r[:600], 5, device='cpu')\n"
        "for v in ('v1', 'v2', 'v3', 'v5', 'v6', 'v11'):\n"
        "    i = tpu_knn_torch.nearest_neighbors(r[:5, :3], r[:, :3], version=v, device='cpu')\n"
        "    assert (i == np.arange(5)).all(), v\n"
        "ix = tpu_knn_torch.NNIndex(r[:, :3], strategy='auto', device='cpu')\n"
        "assert (ix.query(r[:4, :3])[0].numpy() == np.arange(4)).all()\n"
        "assert g.shape == (600, 5)\n"
        "from tpu_knn_torch.distributed.sharded import default_mesh\n"
        "i, _ = tpu_knn_torch.sharded_knn(r[:20], r, mesh=default_mesh(dp=2, sp=4, "
        "devices='cpu'), device='cpu')\n"
        "assert (i.numpy() == np.arange(20)).all()\n"
        "print(sorted({'jax', 'tpu_knn'} & set(sys.modules)))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_cuda_sources_ship_and_build_is_content_hashed(monkeypatch):
    import tomllib

    from tpu_knn_torch.csrc import build

    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        meta = tomllib.load(f)
    shipped = meta["tool"]["setuptools"]["package-data"]["tpu_knn_torch"]
    assert "csrc/*.cu" in shipped and "csrc/*.cuh" in shipped
    assert "native/src/*.cc" in shipped
    assert meta["project"]["optional-dependencies"]["torch"] == ["torch"]
    assert [os.path.basename(s) for s in build.sources()] == [
        "fused_kernels.cu", "kdtree_kernels.cu", "knn_common.cuh", "kselect.cuh",
        "seeded_kernels.cu", "smallm_kernels.cu", "sweep_kernels.cu",
        "tensor_banded_kernels.cu", "tensor_kernels.cu", "tensor_ladder_kernels.cu",
        "tensor_mainloop.cuh",
        "tensor_minima_kernels.cu", "tensor_moments_kernels.cu", "tensor_sweep_kernels.cu",
        "tiled.cuh", "window_kernels.cu"]
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    path = build.lib_path()
    assert os.path.dirname(path) == build.BUILD_DIR and path == build.lib_path()
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ["-DPROBE"])
    assert build.lib_path() != path
