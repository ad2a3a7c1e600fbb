import inspect

import pytest

from knn_bench import roofline


@pytest.mark.parametrize("entry, m, n, k, kk, ops, nbytes", [
    # sift128: 1,000,000 x 128, batches of 1024
    ("nn1", 1024, 10**6, 128, 1, 262_144_000_000, 4 * (1024 * 128 + 10**6 * 128) + 8 * 1024),
    ("topk", 1024, 10**6, 128, 10, 262_144_000_000,
     4 * (1024 * 128 + 10**6 * 128) + 8 * 1024 * 10),
    # cohere768: 1,000,000 x 768
    ("nn1", 1024, 10**6, 768, 1, 1_572_864_000_000, 4 * (1024 * 768 + 10**6 * 768) + 8 * 1024),
    ("topk", 1024, 10**6, 768, 100, 1_572_864_000_000,
     4 * (1024 * 768 + 10**6 * 768) + 8 * 1024 * 100),
])
def test_work_counts_each_byte_and_operation_once(entry, m, n, k, kk, ops, nbytes):
    assert roofline.work(entry, m, n, k, kk) == (ops, nbytes)


def test_least_time_is_the_larger_bound_on_the_h100():
    name = "NVIDIA H100 80GB HBM3"
    # sift128 1-NN: operations bound it (0.265 ms against 0.153 ms of bytes).
    assert roofline.least_seconds("nn1", 1024, 10**6, 128, 1, name) == pytest.approx(
        262_144_000_000 / 989e12)
    ops, nbytes = roofline.work("nn1", 1, 10**6, 128)
    assert roofline.least_seconds("nn1", 1, 10**6, 128, 1, name) == pytest.approx(
        nbytes / 3.35e12)
    assert nbytes / 3.35e12 > ops / 989e12


def test_a_card_without_peaks_has_no_roofline():
    assert roofline.least_seconds("nn1", 1024, 10**6, 128, 1, "cpu") is None


def test_no_tier_or_precision_enters_the_count():
    for fn in (roofline.work, roofline.least_seconds):
        params = set(inspect.signature(fn).parameters)
        assert params <= {"entry", "m", "n", "k", "neighbors", "device_name"}
        assert not {"precision", "tier", "terms", "store"} & params
    with pytest.raises(ValueError):
        roofline.work("bf16x3", 1024, 10**6, 128)
