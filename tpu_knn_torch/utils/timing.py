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


#: Idle seconds at each end of a profile's capture window (see device_ms).
PROFILE_PAD_S = 0.01


def device_ms(fns: dict, kernel, reps: int, attempts: int = 3) -> dict:
    """Mean device time per round, by kernel name, of the kernels whose
    name holds `kernel` (a string, or any of a tuple of strings), from
    torch.profiler, the fns run once each a
    round: the kernels alone, without the host's launch path (argument
    checks, allocations, small set-up kernels) that a CUDA-event span
    around a call also holds while the card waits.

    The profiler keeps only the kernels whose device timestamps fall
    inside its capture window, which its host clock opens and closes; a
    profile of a few kernels of a few microseconds each can come back
    holding some or none of them. So the card idles PROFILE_PAD_S at each
    end of the window, and every matching kernel's launches must be a
    whole, nonzero multiple of reps: a profile that lost launches is
    taken again (noted on stderr), up to `attempts` profiles, and then
    this raises."""
    import sys

    import torch
    from torch.profiler import ProfilerActivity, profile

    names = (kernel,) if isinstance(kernel, str) else tuple(kernel)
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    for attempt in range(1, attempts + 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            time.sleep(PROFILE_PAD_S)
            for _ in range(reps):
                for fn in fns.values():
                    fn()
            torch.cuda.synchronize()
            time.sleep(PROFILE_PAD_S)
        total, count = {}, {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA and any(k in e.name for k in names):
                total[e.name] = total.get(e.name, 0.0) + e.device_time / 1e3
                count[e.name] = count.get(e.name, 0) + 1
        if count and all(c % reps == 0 for c in count.values()):
            return {name: t / reps for name, t in total.items()}
        print(f"device_ms: profile {attempt} of {attempts} held {sorted(count.values())} "
              f"launches of {kernel!r} kernels over {reps} rounds", file=sys.stderr, flush=True)
    raise RuntimeError(f"torch.profiler lost launches of {kernel!r} kernels in "
                       f"{attempts} profiles")
