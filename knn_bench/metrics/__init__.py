"""One reader a metric, ``<metric>.py``, found by the metric's name in
BENCHMARK.json. Each has ``read(run) -> float | None``: the metric's value
from the run's record (knn_bench.harness.Run), or None where the run holds
nothing to read, and the metric is then left out of the run's line."""
