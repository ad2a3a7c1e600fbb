import json
import os
import re
import shutil

import pytest

from knn_bench import spec
from knn_bench.tests.conftest import CELLS

BENCH = spec.benchmark()


def test_every_cell_loads_by_name():
    for name in CELLS:
        cell = spec.cell(name)
        assert cell.chips == 1
        assert set(cell.limits) == {"rank_gap", "score_err"}
        assert {m["name"] for m in cell.end_to_end} == {"qps", "p95_ms", "setup_s"}
        assert cell.config["n"] == 10**6 and cell.config["reduced"] == []


def test_every_config_mix_metric_and_reference_file_loads():
    for conf in BENCH["configs"]:
        with open(os.path.join(spec.ROOT, conf["file"])) as f:
            assert json.load(f)["name"] == conf["name"]
        spec.reference(spec.cell(next(w["name"] for w in BENCH["workloads"]
                                      if w["config"] == conf["name"])).config["reference"])
    for w in BENCH["workloads"]:
        assert set(spec.mix(w["traffic"])) == {"batch", "neighbors", "trace_s"}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(spec.metric_reader(m["name"]).read)


def test_each_moves_is_reported_wherever_its_metric_is():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            assert "workloads" not in e2e[m["moves"]] or cell in e2e[m["moves"]]["workloads"]


def test_names_and_sizes_keep_the_contract():
    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names)) and all(name.match(n) for n in names)
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}
    assert all(0.01 <= m["bound"] <= 0.25 for m in BENCH["end_to_end"])
    assert os.path.getsize(os.path.join(spec.ROOT, "BENCHMARK.json")) < 64 * 1024


def test_a_new_config_mix_metric_and_cell_are_found_without_an_edit(tmp_path):
    """A later cell is new files and new entries: copy the benchmark, add a
    configuration, a mix, a metric reader, a reference and a cell, and the
    loader finds them; no file that was there changes."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(spec.ROOT, "knn_bench"), root / "knn_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads(json.dumps(BENCH))
    before = {p: p.read_bytes() for p in (root / "knn_bench").rglob("*") if p.is_file()}
    (root / "knn_bench" / "configs" / "tiny.json").write_text(json.dumps(
        dict(spec.cell(CELLS[0]).config, name="tiny", reference="l1")))
    (root / "knn_bench" / "mixes" / "nn1.b8.json").write_text(json.dumps(
        dict(spec.mix("nn1.b1024"), batch=8)))
    (root / "knn_bench" / "cells" / "tiny.nn1.b8.json").write_text(json.dumps(
        {"limits": {"rank_gap": 0.5, "score_err": 0.5}}))
    (root / "knn_bench" / "metrics" / "batches.py").write_text(
        "def read(run):\n    return run.batches\n")
    (root / "knn_bench" / "references" / "l1.py").write_text(
        "RELATIVE = True\n")
    bench["configs"].append({"name": "tiny", "source": "a test", "file":
                             "knn_bench/configs/tiny.json", "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "tiny.nn1.b8", "config": "tiny", "traffic": "nn1.b8",
                               "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "batches", "unit": "batches", "better": "higher",
                               "source": "host_clock", "layer": "engine", "moves": "qps",
                               "workloads": ["tiny.nn1.b8"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.cell("tiny.nn1.b8", root=str(root))
    assert cell.mix["batch"] == 8 and cell.config["name"] == "tiny"
    assert [m["name"] for m in cell.per_layer] == ["batches"]
    assert spec.metric_reader("batches", root=str(root)).read(
        type("R", (), {"batches": 3})()) == 3
    assert spec.reference("l1", root=str(root)).RELATIVE
    assert {p: p.read_bytes() for p in before} == before


def test_names_that_are_not_names_are_refused():
    for bad in ("../configs/sift128", "a/b", "", "x" * 65):
        with pytest.raises(ValueError):
            spec.mix(bad)
