import os
import subprocess
import sys

from knn_bench import spec

SCRIPT = """
import sys, time
import knn_bench.run, knn_bench.reference
from knn_bench import harness
from knn_bench.tests.conftest import SMALL, small_cell
for name in {cells!r}:
    harness.run_cell(small_cell(name, n=2000, batch=16), 5, 0.05, False, "cpu",
                     time.perf_counter(), sizes=SMALL)
print(",".join(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_level(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT, capture_output=True,
                         text=True, timeout=600, env=dict(os.environ, PYTHONPATH=spec.ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    return set(out.stdout.strip().splitlines()[-1].split(","))


def test_a_run_loads_neither_jax_nor_the_jax_package():
    """Whole top-level names: tpu_knn_torch is the port, tpu_knn the JAX package."""
    from knn_bench.tests.conftest import CELLS

    loaded = _top_level(SCRIPT.format(cells=CELLS))
    assert "tpu_knn_torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "tpu_knn"}


def test_the_reference_loads_nothing_of_the_port():
    loaded = _top_level("import sys, knn_bench.reference, knn_bench.check\n"
                        "from knn_bench import spec\n"
                        "spec.reference('l2'); spec.reference('cosine')\n"
                        "print(','.join(sorted({m.split('.')[0] for m in sys.modules})))")
    assert not loaded & {"jax", "jaxlib", "flax", "tpu_knn", "tpu_knn_torch"}


def test_the_foreign_check_compares_whole_names(monkeypatch):
    from knn_bench import harness

    monkeypatch.setitem(sys.modules, "tpu_knn_torch_extra", sys)
    assert harness.foreign_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert harness.foreign_modules() == ["jax"]
