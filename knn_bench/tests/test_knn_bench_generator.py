import torch

from knn_bench import generator

CONFIG = {"n": 500, "k": 16, "distribution": "uniform01"}
MIX = {"batch": 8}


def test_the_same_seed_draws_the_same_inputs():
    seed = 2**31 + 12345
    p1, q1 = generator.draw(seed, CONFIG, MIX, "cpu", pool_mib=1)
    p2, q2 = generator.draw(seed, CONFIG, MIX, "cpu", pool_mib=1)
    assert torch.equal(p1, p2) and torch.equal(q1, q2)
    p3, q3 = generator.draw(seed + 1, CONFIG, MIX, "cpu", pool_mib=1)
    assert not torch.equal(p1, p3) and not torch.equal(q1, q3)


def test_shapes_pool_and_distributions():
    points, pool = generator.draw(7, CONFIG, MIX, "cpu", pool_mib=1)
    assert points.shape == (500, 16) and points.dtype == torch.float32
    assert pool.shape == (2**20 // (4 * 8 * 16), 8, 16)
    assert 0 <= float(points.min()) and float(points.max()) < 1
    normal, _ = generator.draw(7, dict(CONFIG, distribution="normal", n=20000), MIX, "cpu",
                               pool_mib=1)
    assert float(normal.min()) < 0 and abs(float(normal.mean())) < 0.02


def test_uniform_points_are_the_ports_device_stream():
    """A frozen copy: the points are tpu_knn_torch's device_sample_stream
    draw of the same shape and seed, and the same under every mix."""
    from tpu_knn_torch.harness.generator import device_sample_stream

    (_, _, ref), = device_sample_stream(99, [(16, 0, 500)], "cpu")
    points, _ = generator.draw(99, CONFIG, MIX, "cpu", pool_mib=1)
    assert torch.equal(points, ref)
    other, _ = generator.draw(99, CONFIG, {"batch": 32}, "cpu", pool_mib=2)
    assert torch.equal(points, other)
