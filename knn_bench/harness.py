"""One run of one cell: set-up, the measured window, the traced slice and
the output check.

The window is a closed loop with one client: it hands a batch of the pool
to ``NNIndex.query``, waits until the answers are in host memory, keeps
them, and sends the next, until ``seconds`` have passed; the batch in
flight then completes and the window closes. With ``trace`` a
torch.profiler trace (CPU and CUDA activities) is taken over a slice of
the window, held in memory and written when the window has closed.
After the window the peak of device memory is read and the index freed;
then the plain reference checks a sample of the window's batches, drawn
from the seed.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import gzip
import json
import os
import sys
import time

import numpy as np
import torch

from knn_bench import check, generator, reference, roofline, spec
from knn_bench import trace as trace_reduce

#: Top-level module names that no run may load: the JAX package and JAX.
FOREIGN = ("jax", "jaxlib", "flax", "tpu_knn")

#: Where a traced run writes its trace (inside the checkout).
TRACE_DIR = os.path.join(spec.ROOT, "knn_bench_traces")


@dataclasses.dataclass(frozen=True)
class Sizes:
    """What every run holds to, whatever its cell."""
    #: Batches of the cell's shape sent before the window.
    warmup_batches: int = 3
    #: The window's batches, drawn from the seed, that the output check judges.
    check_batches: int = 8
    #: MiB of float32 queries drawn before the window.
    pool_mib: int = generator.POOL_MIB
    #: Seconds into the window at which the traced slice starts.
    trace_skip_s: float = 2.0


SIZES = Sizes()


@dataclasses.dataclass
class Run:
    """What a run's metric readers read (knn_bench/metrics)."""
    setup_s: float
    window_s: float
    batches: int
    queries: int
    latencies_ms: list
    #: Host seconds from the window's start to each batch's answers.
    ends_s: list
    answers: list
    tiers: dict
    trace: dict | None
    least_s: float | None
    memory_peak_bytes: int
    #: Seconds of set-up by step, in order: the caller's (run.py:
    #: "imports", "cuda_init"), then "program" (the port's import), "data",
    #: "index" (its build), "warm_up" (the kernel library's load, or its
    #: build in a checkout's first run, and the cell's shape).
    setup_parts: dict


def foreign_modules() -> list[str]:
    """The FOREIGN names loaded in this process, by whole top-level name."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FOREIGN))


def build_index(config: dict, points: torch.Tensor):
    from tpu_knn_torch.engine.index import NNIndex

    return NNIndex(points, strategy=config["strategy"], store=config["store"],
                   metric=config["metric"], precision=config["precision"],
                   device=points.device)


class _Slice:
    """The traced slice: a profiler started ``skip_s`` into the window and
    stopped ``length_s`` later, at batch boundaries."""

    def __init__(self, skip_s: float, length_s: float):
        self.skip_s, self.length_s = skip_s, length_s
        self.prof, self.started, self.done = None, 0.0, False
        #: Seconds the profiler took to start inside the window.
        self.start_s = 0.0

    @staticmethod
    def _profile():
        from torch.profiler import ProfilerActivity, profile

        return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])

    def warm(self, fn):
        """fn() under a profile of its own, in set-up: a process's first
        profile starts the CUDA tracing library, which takes seconds."""
        with self._profile():
            return fn()

    def span(self, elapsed: float):
        if not self.done and self.prof is None and elapsed >= self.skip_s:
            t = time.perf_counter()
            self.prof = self._profile()
            self.prof.start()
            self.started = time.perf_counter()
            self.start_s = self.started - t
        elif self.prof is not None and not self.done \
                and time.perf_counter() - self.started >= self.length_s:
            self.stop()
        if self.prof is None or self.done:
            return contextlib.nullcontext()
        return torch.profiler.record_function(trace_reduce.BATCH_SPAN)

    def stop(self):
        if self.prof is not None and not self.done:
            self.prof.stop()
        self.done = True

    def events(self, path: str) -> list:
        """Write the trace to ``path`` (gzip) and return its events."""
        if self.prof is None:
            return []
        raw = path[:-len(".gz")]
        self.prof.export_chrome_trace(raw)
        with open(raw, "rb") as f:
            data = f.read()
        os.remove(raw)
        with gzip.open(path, "wb") as f:
            f.write(data)
        return json.loads(data)["traceEvents"]


def warm_up(index, pool: torch.Tensor, mix: dict, batches: int):
    """The cell's own shape, ``batches`` times; its last answers."""
    for b in range(batches):
        out = index.query(pool[b % pool.shape[0]], neighbors=mix["neighbors"])
    if pool.device.type == "cuda":
        torch.cuda.synchronize()
    return out


def window(index, pool: torch.Tensor, mix: dict, seconds: float, tracer: _Slice | None,
           like):
    """The window. ``like``: answers of the cell's shape (warm_up's).
    Returns (t0, window_s, latencies_ms, ends_s, answers): t0 the host
    clock at the first timed batch, ends_s each batch's end after it."""
    kk = mix["neighbors"]
    batches = pool.shape[0]
    cuda = pool.device.type == "cuda"
    if cuda:
        idx, scores = like
        h_idx = torch.empty(idx.shape, dtype=idx.dtype, pin_memory=True)
        h_scores = torch.empty(scores.shape, dtype=scores.dtype, pin_memory=True)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
    lat, ends, answers = [], [], []
    b = 0
    t0 = time.perf_counter()
    while True:
        span = tracer.span(time.perf_counter() - t0) if tracer else contextlib.nullcontext()
        with span:
            q = pool[b % batches]
            if cuda:
                start.record()
                idx, scores = index.query(q, neighbors=kk)
                h_idx.copy_(idx, non_blocking=True)
                h_scores.copy_(scores, non_blocking=True)
                end.record()
                end.synchronize()
                lat.append(start.elapsed_time(end))
                answers.append((h_idx.numpy().copy(), h_scores.numpy().copy()))
            else:
                t = time.perf_counter()
                idx, scores = index.query(q, neighbors=kk)
                answers.append((idx.numpy().copy(), scores.numpy().copy()))
                lat.append((time.perf_counter() - t) * 1e3)
        b += 1
        ends.append(time.perf_counter() - t0)
        if ends[-1] >= seconds:
            break
    window_s = time.perf_counter() - t0
    if tracer:
        tracer.stop()
    return t0, window_s, lat, ends, answers


def check_window(cell: spec.Cell, seed: int, points, pool, answers, batches: int) -> dict:
    """The output check over ``batches`` of the window's batches, drawn
    from the seed (knn_bench.check)."""
    rng = np.random.default_rng(seed)
    picks = sorted(rng.choice(len(answers), size=min(batches, len(answers)),
                              replace=False).tolist())
    ref = spec.reference(cell.config["reference"])
    readings = [check.judge(points, pool[b % pool.shape[0]], *answers[b], ref) for b in picks]
    return check.verdict(readings, cell.limits)


def control_readings(cell: spec.Cell, seed: int, device, sizes: Sizes = SIZES) -> dict:
    """The control: the reference in TF32 put in the program's place, over
    the pool's first ``check_batches`` batches, judged as a run's answers
    are."""
    points, pool = generator.draw(seed, cell.config, cell.mix, device, sizes.pool_mib)
    ref = spec.reference(cell.config["reference"])
    kk = cell.mix["neighbors"] or 1
    readings = []
    for b in range(min(sizes.check_batches, pool.shape[0])):
        idx, scores = reference.answer(points, pool[b], kk, ref, "tf32")
        if cell.mix["neighbors"] is None:
            idx, scores = idx[:, 0], scores[:, 0]
        readings.append(check.judge(points, pool[b], idx.cpu(), scores.cpu(), ref))
    return check.verdict(readings, cell.limits)


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, trace_path: str | None = None, sizes: Sizes = SIZES,
             marks=()):
    """One run. Returns (Run, the check's verdict). ``marks``: (name, host
    clock) at the end of each of the caller's set-up steps after
    ``t_start``."""
    dev = torch.device(device)
    config, mix = cell.config, cell.mix
    cuda = dev.type == "cuda"
    marks = [("start", t_start), *marks]

    def mark(name):
        if cuda:
            torch.cuda.synchronize(dev)
        marks.append((name, time.perf_counter()))

    from tpu_knn_torch.kernels import seeded

    mark("program")
    points, pool = generator.draw(seed, config, mix, dev, sizes.pool_mib)
    mark("data")
    index = build_index(config, points)
    mark("index")
    tracer = _Slice(sizes.trace_skip_s, mix["trace_s"]) if trace else None

    def warm():
        return warm_up(index, pool, mix, sizes.warmup_batches)

    like = tracer.warm(warm) if tracer else warm()
    mark("warm_up")
    tiers0 = dict(seeded.TIERS)
    t0, window_s, lat, ends, answers = window(index, pool, mix, seconds, tracer, like)
    tiers = {t: seeded.TIERS[t] - tiers0.get(t, 0) for t in seeded.TIERS}
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    del index
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    reduced = None
    if tracer is not None:
        trace_path = trace_path or os.path.join(TRACE_DIR, f"{cell.name}.seed{seed}.json.gz")
        os.makedirs(os.path.dirname(trace_path), exist_ok=True)
        reduced = trace_reduce.reduce(tracer.events(trace_path))
        if reduced is not None:
            reduced["profiler_start_s"] = tracer.start_s
    name = torch.cuda.get_device_name(dev) if cuda else "cpu"
    entry = "nn1" if mix["neighbors"] is None else "topk"
    least = roofline.least_seconds(entry, mix["batch"], config["n"], config["k"],
                                   mix["neighbors"] or 1, name)
    run = Run(setup_s=t0 - t_start, window_s=window_s, batches=len(answers),
              queries=len(answers) * mix["batch"], latencies_ms=lat, ends_s=ends,
              answers=answers, tiers=tiers, trace=reduced, least_s=least,
              memory_peak_bytes=peak,
              setup_parts={b[0]: b[1] - a[1] for a, b in zip(marks, marks[1:])})
    verdict = check_window(cell, seed, points, pool, answers, sizes.check_batches)
    return run, verdict


def metrics(cell: spec.Cell, run: Run, trace: bool) -> dict:
    """The cell's end-to-end metrics (``trace`` False) or per-layer ones
    (True), each from its reader; a reader that finds nothing is left out."""
    out = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = spec.metric_reader(m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
