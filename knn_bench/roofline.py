"""The least time the card could take for a batch: the function's work,
counted once, whatever tier or kernel implements it.

For a batch of m queries over n points of k dimensions, K answers a query
(1 for 1-NN), keyed by the entry ("nn1": ``NNIndex.query(q)``, "topk":
``NNIndex.query(q, neighbors=K)``) and by nothing else:

- operations: 2·m·n·k (each query against each point, a multiply and an
  add per dimension);
- bytes: 4·(m·k + n·k), the queries and the points read once, plus the
  answers written once: 8·m (an index and a score a query) for 1-NN and
  8·m·K for top-K.

The least time is the larger of operations over the card's peak rate and
bytes over its memory bandwidth. The peak rate is the card's dense bf16
rate, the highest at which any exact float32 product on this card runs
(the port's split tiers already pass float32's 67 TFLOP/s), so a share of
it cannot pass 100% while the counts are right.
"""

from __future__ import annotations

#: Published peaks, by torch.cuda.get_device_name(): (dense bf16 FLOP/s,
#: memory bytes/s). NVIDIA H100 SXM5 data sheet: 989 TFLOP/s, 3.35 TB/s,
#: at its 700 W power limit.
PEAKS = {"NVIDIA H100 80GB HBM3": (989e12, 3.35e12)}

ENTRIES = ("nn1", "topk")


def work(entry: str, m: int, n: int, k: int, neighbors: int = 1) -> tuple[int, int]:
    """(operations, bytes) of one batch."""
    if entry not in ENTRIES:
        raise ValueError(f"unknown entry {entry!r}")
    answers = 1 if entry == "nn1" else neighbors
    return 2 * m * n * k, 4 * (m * k + n * k) + 8 * m * answers


def least_seconds(entry: str, m: int, n: int, k: int, neighbors: int,
                  device_name: str) -> float | None:
    """The batch's least time on the named card; None for a card without
    published peaks here."""
    if device_name not in PEAKS:
        return None
    flops, bandwidth = PEAKS[device_name]
    ops, nbytes = work(entry, m, n, k, neighbors)
    return max(ops / flops, nbytes / bandwidth)
