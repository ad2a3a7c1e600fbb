"""The output check against the faults a cell can have: each run drives the
harness as a benchmark run does (without its look for a card), with the
timed path broken underneath, and ``correct`` has to come out false. The
control, the plain reference in TF32 in the program's place, has to fail
the cell's limits too."""

import time

import pytest
import torch

from knn_bench import harness, spec
from knn_bench.tests.conftest import CELLS, SMALL, small_cell

TOPK = [name for name in CELLS if spec.cell(name).mix["neighbors"]]


class Altered:
    """The index, with one answer of every batch altered where it is made."""

    def __init__(self, index):
        self.index = index

    def query(self, q, neighbors=None):
        idx, scores = self.index.query(q, neighbors=neighbors)
        idx = idx.clone()
        flat = idx.view(-1)
        flat[0] = (flat[0] + 1) % self.index.n
        return idx, scores


class Reversed:
    """The index, with each row of its top-K answers in reverse order."""

    def __init__(self, index):
        self.index = index

    def query(self, q, neighbors=None):
        idx, scores = self.index.query(q, neighbors=neighbors)
        return idx.flip(1), scores.flip(1)


def _run(cell, seed=11):
    return harness.run_cell(cell, seed, 0.05, False, "cpu", time.perf_counter(), sizes=SMALL)


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name):
    run, verdict = _run(small_cell(name))
    assert verdict["correct"], verdict
    assert verdict["rows"] == 32 * min(2, run.batches) and verdict["failed_rows"] == 0


@pytest.mark.parametrize("name", CELLS)
def test_an_altered_answer_is_not_correct(name, monkeypatch):
    build = harness.build_index
    monkeypatch.setattr(harness, "build_index", lambda c, p: Altered(build(c, p)))
    run, verdict = _run(small_cell(name))
    assert not verdict["correct"] and verdict["failed_rows"] == min(2, run.batches)


@pytest.mark.parametrize("name", TOPK)
def test_a_row_out_of_order_is_not_correct(name, monkeypatch):
    build = harness.build_index
    monkeypatch.setattr(harness, "build_index", lambda c, p: Reversed(build(c, p)))
    run, verdict = _run(small_cell(name))
    assert not verdict["correct"] and verdict["failed_rows"] == 32 * min(2, run.batches)
    assert verdict["numbers"]["score_err"]["value"] <= verdict["numbers"]["score_err"]["limit"]


@pytest.mark.parametrize("name", CELLS)
def test_half_the_points_left_out_is_not_correct(name, monkeypatch):
    build = harness.build_index
    monkeypatch.setattr(harness, "build_index", lambda c, p: build(c, p[: p.shape[0] // 2]))
    assert not _run(small_cell(name))[1]["correct"]


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name):
    verdict = harness.control_readings(small_cell(name, n=20000), 21, "cpu", SMALL)
    assert not verdict["correct"], verdict


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_a_short_run_at_the_cells_own_size_is_correct(name, card):
    from knn_bench import spec

    run, verdict = harness.run_cell(spec.cell(name), 2**31 + 5, 1.0, False, card,
                                    time.perf_counter())
    assert verdict["correct"], verdict["numbers"]
    assert run.batches >= 1 and torch.cuda.max_memory_allocated(card) > 0
