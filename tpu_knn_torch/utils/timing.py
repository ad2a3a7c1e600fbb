"""Timing: CUDA events (chip_smoke.py and the probes), the kernels' own
device time (torch.profiler) and the harness's wall clock."""

from __future__ import annotations

import contextlib
import statistics
import time


def _sync_card() -> None:
    import torch

    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def wall_ms(out: dict):
    """Wall-clock ms around a host-side call, written to out["ms"] (the
    reference harness's clock around each callback, main.cu:69-73). The
    card is synchronized before the clock starts and before it stops, so
    queued work is neither charged to the call nor left out of it."""
    _sync_card()
    t0 = time.perf_counter_ns()
    yield
    _sync_card()
    out["ms"] = (time.perf_counter_ns() - t0) / 1e6


def time_ms(fns: dict, reps: int, warmup: int = 2) -> dict:
    """Median ms per call of each fn, by CUDA events, the fns run in turns
    (forward then reverse order each round) so drift hits all alike."""
    import torch

    for fn in fns.values():
        for _ in range(warmup):
            fn()
    torch.cuda.synchronize()
    samples = {name: [] for name in fns}
    order = list(fns)
    for rep in range(reps):
        for name in (order if rep % 2 == 0 else order[::-1]):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fns[name]()
            end.record()
            end.synchronize()
            samples[name].append(start.elapsed_time(end))
    return {name: statistics.median(v) for name, v in samples.items()}


def device_ms(fns: dict, kernel: str, reps: int) -> dict:
    """Mean device time per round, by kernel name, of the kernels whose
    name holds `kernel`, from torch.profiler, the fns run once each a
    round: the kernels alone, without the host's launch path (argument
    checks, allocations, small set-up kernels) that a CUDA-event span
    around a call also holds while the card waits."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            for fn in fns.values():
                fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and kernel in e.name:
            out[e.name] = out.get(e.name, 0.0) + e.device_time / 1e3 / reps
    return out
