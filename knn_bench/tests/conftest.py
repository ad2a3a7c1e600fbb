"""CPU tests of the benchmark's harness: ``python3 -m pytest knn_bench/tests``.
Tests marked ``cuda`` need an sm_90 card and skip without one."""

import dataclasses

import pytest

from knn_bench import harness, spec

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an sm_90 CUDA card (skipped without one)")


#: A run's sizes at a scale a CPU test holds: a smaller pool, one warm-up
#: batch, two batches checked.
SMALL = harness.Sizes(warmup_batches=1, check_batches=2, pool_mib=1)


def small_cell(name: str, n: int = 3000, batch: int = 32) -> spec.Cell:
    """The cell as BENCHMARK.json defines it, at a size a CPU test holds:
    fewer points, a smaller batch; run it with ``sizes=SMALL``."""
    cell = spec.cell(name)
    return dataclasses.replace(cell, config=dict(cell.config, n=n),
                               mix=dict(cell.mix, batch=batch))


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an sm_90 CUDA card")
    return torch.device("cuda")
