"""The benchmark of tpu_knn_torch, the PyTorch and CUDA port, on one NVIDIA H100.

One command runs one cell (a configuration under a traffic mix, named in
BENCHMARK.json at the checkout's root) once::

    python3 -m knn_bench.run --workload sift128.nn1.b1024 --seed 7 --seconds 20 --trace 0

and prints one JSON line. Everything that belongs to one configuration,
traffic mix, cell or metric is a file of its own, found by its name:
``configs/<config>.json``, ``mixes/<traffic>.json``, ``cells/<cell>.json``
(the limits of the output check), ``metrics/<metric>.py`` (its reader)
and ``references/<reference>.py`` (the plain reference's score).
Nothing here imports jax or tpu_knn; the plain reference imports nothing
of tpu_knn_torch either.
"""
