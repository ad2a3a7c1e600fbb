"""The port's harness runner (tpu_knn_torch.harness.runner) against
tpu_knn's: the reference's output lines, the golden CSV, the artifacts and
the flags, on the CPU."""

import json
import os
import re

import numpy as np
import pytest
import torch

from tpu_knn.harness import runner as jx_runner
from tpu_knn_torch.harness import generator as pt_generator
from tpu_knn_torch.harness import runner as pt_runner

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                      "results_seed1000.csv")
CALLBACK = re.compile(r"^Callback\d+, [ \d]{2}, [ \d]{4}, [ \d]{5,}, [ \d]{6,}\.\d{3}ms$")


def _without_times(lines):
    return [re.sub(r"[ \d]+\.\d{3}ms$", "<ms>", ln) for ln in lines]


def test_lines_match_tpu_knns(tmp_path):
    """One version, no check: the transcript is tpu_knn's but for the times."""
    pt_log, jx_log = str(tmp_path / "pt.log"), str(tmp_path / "jx.log")
    assert pt_runner.main(["--versions", "v0", "--no-warmup", "--cold", "--device", "cpu",
                           "--screen-log", pt_log]) == 0
    assert jx_runner.main(["--versions", "v0", "--no-warmup", "--cold",
                           "--screen-log", jx_log]) == 0
    pt_lines = open(pt_log).read().splitlines()
    jx_lines = open(jx_log).read().splitlines()
    assert _without_times(pt_lines) == _without_times(jx_lines)
    assert sum(bool(CALLBACK.match(ln)) for ln in pt_lines) == 8


def test_ta_run_artifacts_and_golden_csv(tmp_path):
    screen, csv, rec = (str(tmp_path / name) for name in ("s.log", "r.csv", "r.json"))
    rc = pt_runner.main(["--versions", "v0,v4", "--device", "cpu", "--no-warmup", "--cold",
                         "--screen-log", screen, "--results-csv", csv, "--json", rec])
    assert rc == 0
    log = open(screen).read()
    assert log.count("Callback1,") == log.count("Callback2,") == 8
    assert log.count("errors/total w.r.t. baseline: 0/") == 8
    assert all(CALLBACK.match(ln) for ln in log.splitlines() if ln.startswith("Callback"))
    assert open(csv).read().strip() == open(GOLDEN).read().strip()
    records = json.load(open(rec))
    assert len(records) == 16
    checked = [r for r in records if "errors" in r]
    assert len(checked) == 8 and all(r["errors"] == 0 and r["version"] == "v4"
                                      for r in checked)


def test_versions_default_to_the_registered_ladder(monkeypatch):
    assert pt_runner.registered_ladder() == ["v0", "v1", "v2", "v3", "v4", "v5", "v6",
                                             "v7", "v8", "v9", "v10", "v11"]
    seen = {}

    def fake_run(versions, shapes, **kw):
        seen["versions"] = versions
        return True, []

    monkeypatch.setattr(pt_runner, "run", fake_run)
    assert pt_runner.main(["--no-warmup", "--device", "cpu"]) == 0
    assert seen["versions"] == pt_runner.registered_ladder()


@pytest.mark.parametrize("name", ["v13", "v12", "v99"])
def test_unregistered_version_raises_keyerror(name):
    with pytest.raises(KeyError, match="available"):
        pt_runner.main(["--versions", f"v0,{name}", "--no-warmup", "--device", "cpu"])


def test_big_with_csv_rejected():
    with pytest.raises(SystemExit):
        pt_runner.main(["--shapes", "big", "--results-csv", "/unused.csv"])


def test_device_data_is_seeded_and_checked():
    """The big shapes' path at small shapes: every version draws the same
    seeded data on the device, and a version that differs from the
    baseline is checked on host copies of only the rows it needs."""
    shapes = [(3, 5, 3000), (16, 2, 700)]
    a = [tuple(t.numpy() for t in s[1:])
         for s in pt_generator.device_sample_stream(7, shapes, "cpu")]
    b = [tuple(t.numpy() for t in s[1:])
         for s in pt_generator.device_sample_stream(7, shapes, "cpu")]
    for (qa, ra), (qb, rb), (k, m, n) in zip(a, b, shapes):
        np.testing.assert_array_equal(qa, qb)
        np.testing.assert_array_equal(ra, rb)
        assert qa.shape == (m, k) and ra.shape == (n, k) and ra.dtype == np.float32
    records, lines = [], []
    ok, _ = pt_runner.run(["v0", "v5", "v11"], shapes, seed=7, log=lines.append,
                          device_data=True, records=records, device="cpu")
    assert ok and len(records) == 6
    assert [r.get("errors") for r in records] == [None, None, 0, 0, 0, 0]
    q, r = (torch.from_numpy(x) for x in a[0])
    base = np.array([0, 1, 2, 3, 4])
    far = base.copy()
    far[2] = 2999
    errors, total = pt_runner._check(base, far, q, r)
    d = lambda i: float(((q[2] - r[i]) ** 2).sum().sqrt())   # noqa: E731
    assert total == 5 and errors == int(abs(d(2) - d(2999)) > 1e-3)


def test_wall_ms_times_the_block():
    from tpu_knn_torch.utils.timing import wall_ms

    out = {}
    with wall_ms(out):
        sum(range(10_000))
    assert out["ms"] > 0
