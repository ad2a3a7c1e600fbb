"""The benchmark's inputs, drawn on the device from the run's seed.

A frozen copy of tpu_knn_torch/harness/generator.py's
``device_sample_stream`` (uniform [0, 1) float32 from one torch.Generator
on the device), widened to the
distributions the configurations name. One general generator serves every
traffic mix: the mix gives the batch size. The pool of query batches,
``pool_mib`` MiB of them, is drawn before the window so that every batch
the window sends holds fresh queries (the pool is taken again from its
start only if a window outruns it).
"""

from __future__ import annotations

import torch

#: A configuration's "distribution": how each coordinate is drawn.
DISTRIBUTIONS = {
    "uniform01": torch.rand,   # i.i.d. uniform [0, 1), device_sample_stream's draw
    "normal": torch.randn,     # i.i.d. standard normal
}


#: MiB of float32 queries in a run's pool.
POOL_MIB = 2048


def pool_batches(config: dict, mix: dict, pool_mib: int) -> int:
    """Batches in the query pool: as many as ``pool_mib`` MiB of float32
    queries hold, at least one."""
    batch_bytes = 4 * mix["batch"] * config["k"]
    return max(1, pool_mib * 2**20 // batch_bytes)


def draw(seed: int, config: dict, mix: dict, device,
         pool_mib: int = POOL_MIB) -> tuple[torch.Tensor, torch.Tensor]:
    """(points (n, k), pool (batches, m, k)) float32 on ``device``, from one
    generator seeded with ``seed``: the points first, then the pool's
    queries, each in one call. The same seed gives the same inputs, and
    the same points under every mix."""
    fn = DISTRIBUTIONS[config["distribution"]]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    m, k, n = mix["batch"], config["k"], config["n"]
    points = fn((n, k), generator=gen, device=device)
    pool = fn((pool_batches(config, mix, pool_mib) * m, k), generator=gen, device=device)
    return points, pool.view(-1, m, k)
