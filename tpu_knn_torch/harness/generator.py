"""Deterministic sample generation (copy of tpu_knn/harness/generator.py's
glibc stream, TA_SHAPES and BIG_SHAPES; the big shapes' data is drawn on
the device instead, device_sample_stream).

The reference harness draws its inputs from glibc `rand()` seeded with
`srand(1000)`, each draw mapped to [0, 1] as float(rand() / double(RAND_MAX))
(generator.h:17-19, main.cu:43,59). Reproducing that stream bit for bit
makes the reference's results.csv (tests/golden/results_seed1000.csv) a
golden fixture. `GlibcRand` is glibc's TYPE_3 additive-feedback generator
(degree 31, separation 3, 310 warm-up discards) in pure Python; the port
has no native build of it, and the 8 TA shapes take about a second.
"""

from __future__ import annotations

from typing import Iterator, List, Sequence, Tuple

import numpy as np

RAND_MAX = 2147483647  # glibc RAND_MAX (== 2**31 - 1)

# The 8 TA dataset shapes (k, m, n) — reference main.cu:28-39.
TA_SHAPES: Tuple[Tuple[int, int, int], ...] = (
    (3, 1, 2),
    (3, 2, 8),
    (3, 1, 1024),
    (3, 1, 65536),
    (16, 1, 65536),
    (3, 1024, 1024),
    (3, 1024, 65536),
    (16, 1024, 65536),
)

# The 4 large custom benchmark shapes (k, m, n), ds8..ds11 — reference
# core.cu:1276-1281.
BIG_SHAPES: Tuple[Tuple[int, int, int], ...] = (
    (3, 1, 1 << 24),
    (16, 1, 1 << 24),
    (3, 1024, 1 << 20),
    (16, 1024, 1 << 20),
)

DEFAULT_SEED = 1000  # main.cu:43


class GlibcRand:
    """glibc `rand()` — TYPE_3 additive feedback generator.

    State init: r[0] = seed; r[i] = 16807 * r[i-1] mod (2^31 - 1) for
    i in [1, 31); r[i] = r[i-31] for i in [31, 34); then 310 outputs of the
    recurrence r[i] = (r[i-3] + r[i-31]) mod 2^32 are discarded. Each
    subsequent output is the next recurrence value shifted right by one.
    """

    def __init__(self, seed: int = DEFAULT_SEED):
        self.seed(seed)

    def seed(self, seed: int) -> None:
        # glibc __srandom_r: the seed is taken as unsigned, 0 becomes 1,
        # and state expansion is Schrage's method on the int32 view of the
        # seed (C truncated division, not a plain mod for negative words).
        s = seed & 0xFFFFFFFF
        if s == 0:
            s = 1
        word = s - (1 << 32) if s >= (1 << 31) else s
        r: List[int] = [0] * 34
        r[0] = word
        for i in range(1, 31):
            hi, lo = divmod(abs(word), 127773)
            if word < 0:
                hi, lo = -hi, -lo
            word = 16807 * lo - 2836 * hi
            if word < 0:
                word += 2147483647
            r[i] = word
        for i in range(31, 34):
            r[i] = r[i - 31]
        # Circular buffer over the last 31 values; position i of the
        # stream lives at buf[i % 31] since i - 31 == i (mod 31).
        buf = [0] * 31
        for i in range(3, 34):
            buf[i % 31] = r[i]
        self._buf = buf
        self._pos = 34
        self._raw(310)  # the warm-up discards

    def _raw(self, count: int) -> List[int]:
        """Next `count` raw 31-bit outputs."""
        buf = self._buf
        pos = self._pos
        out = [0] * count
        for j in range(count):
            i = pos % 31
            v = (buf[i] + buf[(pos - 3) % 31]) & 0xFFFFFFFF
            buf[i] = v
            out[j] = v >> 1
            pos += 1
        self._pos = pos
        return out

    def floats(self, count: int) -> np.ndarray:
        """`count` draws mapped like the reference's getRandNum:
        float(rand() / double(RAND_MAX)) — generator.h:14-19."""
        raw = np.array(self._raw(count), dtype=np.float64)
        return (raw / float(RAND_MAX)).astype(np.float32)


class SampleStream:
    """Sequential dataset generation from one glibc stream, seeded anew
    per stream (the reference test() flow, main.cu:55-65: one srand(seed),
    then per dataset k*m floats of search points followed by k*n of
    reference points, both row-major)."""

    def __init__(self, seed: int = DEFAULT_SEED):
        self._rng = GlibcRand(seed)

    def get_sample(self, k: int, m: int, n: int) -> Tuple[np.ndarray, np.ndarray]:
        search = self._rng.floats(k * m).reshape(m, k)
        ref = self._rng.floats(k * n).reshape(n, k)
        return search, ref


def ta_sample_stream(
    seed: int = DEFAULT_SEED,
    shapes: Sequence[Tuple[int, int, int]] = TA_SHAPES,
) -> Iterator[Tuple[Tuple[int, int, int], np.ndarray, np.ndarray]]:
    """Yield ((k, m, n), search, ref) for each shape, drawn in turn from one
    freshly seeded stream — the reference harness's order."""
    stream = SampleStream(seed)
    for (k, m, n) in shapes:
        search, ref = stream.get_sample(k, m, n)
        yield (k, m, n), search, ref


def device_sample_stream(seed: int, shapes: Sequence[Tuple[int, int, int]], device):
    """Yield ((k, m, n), search, ref) uniform-[0, 1) f32 tensors drawn on
    ``device`` from one torch.Generator seeded with ``seed`` (search, then
    ref, shape by shape): the big shapes, where the reference switches to
    per-thread rand_r (core.cu:1209-1218) and glibc parity is neither
    possible nor needed. Not bit-identical to tpu_knn's jax.random data."""
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    for (k, m, n) in shapes:
        search = torch.rand((m, k), generator=gen, device=device)
        ref = torch.rand((n, k), generator=gen, device=device)
        yield (k, m, n), search, ref
