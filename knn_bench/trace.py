"""Reduction of a torch.profiler trace (its Chrome-trace events) over the
traced slice of a window.

The slice runs from the start of the first ``knn_bench.batch`` span, which
the harness records around each traced batch, to the end of the last. On
the device it counts what ran (kernels, copies, memsets) and the union of
their intervals (busy time); on the host, the CUDA runtime's waits for
the device. Each idle gap on the device is split by what the thread that
sent the batches was doing: each stretch of it goes to the innermost host
span open there, or to "(no host span)".
"""

from __future__ import annotations

import collections

BATCH_SPAN = "knn_bench.batch"

#: Categories of operations on the device.
DEVICE_CATS = frozenset({"kernel", "gpu_memcpy", "gpu_memset"})

#: Categories of host spans that can name an idle gap.
HOST_CATS = frozenset({"cpu_op", "user_annotation", "cuda_runtime", "cuda_driver",
                       "python_function"})

#: CUDA API calls in which the host waits for the device.
SYNC_CALLS = frozenset({
    "cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
    "cudaMemcpy", "cudaMemcpy2D", "cuStreamSynchronize", "cuCtxSynchronize",
    "cuEventSynchronize", "cuMemcpyDtoH_v2", "cuMemcpyHtoD_v2",
})

#: Entries kept in each list of the breakdown, and letters of a name.
TOP = 10
NAME_CHARS = 120


def _merged(intervals):
    out = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return out


def _segments(spans):
    """One thread's nested spans as ordered (start, end, name) stretches,
    each named by the innermost span open in it."""
    out, stack, t = [], [], None

    def close(until):
        nonlocal t
        while stack and stack[-1][0] <= until:
            done, name = stack.pop()
            if done > t:
                out.append((t, done, name))
                t = done

    for e in sorted(spans, key=lambda e: (e["ts"], -e["dur"])):
        s, end = e["ts"], e["ts"] + e["dur"]
        close(s)
        if stack and s > t:
            out.append((t, s, stack[-1][1]))
        stack.append((min(end, stack[-1][0]) if stack else end, e["name"]))
        t = s
    close(float("inf"))
    return out


def _split(gaps, segments) -> collections.Counter:
    """Seconds of the ``gaps`` (ordered, apart) in each named stretch; what
    no stretch covers goes to "(no host span)"."""
    idle, j = collections.Counter(), 0
    for a, b in gaps:
        while j < len(segments) and segments[j][1] <= a:
            j += 1
        covered, k = 0.0, j
        while k < len(segments) and segments[k][0] < b:
            lo, hi, name = segments[k]
            overlap = min(b, hi) - max(a, lo)
            if overlap > 0:
                idle[name] += overlap * 1e-6
                covered += overlap
            k += 1
        if b - a > covered:
            idle["(no host span)"] += (b - a - covered) * 1e-6
    return idle


def _top(totals: dict) -> list:
    ranked = sorted(totals.items(), key=lambda kv: -kv[1])[:TOP]
    return [[name[:NAME_CHARS], seconds] for name, seconds in ranked]


def reduce(events: list) -> dict | None:
    """Numbers of the traced slice (times in seconds), or None when the
    trace holds no batch span."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    batches = [e for e in xs if e.get("name") == BATCH_SPAN
               and e.get("cat") == "user_annotation"]
    if not batches:
        return None
    lo = min(e["ts"] for e in batches)
    hi = max(e["ts"] + e["dur"] for e in batches)
    thread = batches[0].get("tid")

    def inside(e):
        return lo <= e["ts"] <= hi

    device = [e for e in xs if e.get("cat") in DEVICE_CATS and inside(e)]
    busy = _merged([(max(e["ts"], lo), min(e["ts"] + e["dur"], hi)) for e in device])
    busy_us = sum(b - a for a, b in busy)
    ops = collections.Counter()
    for e in device:
        ops[e["name"]] += e["dur"] * 1e-6
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
    host = [e for e in xs if e.get("cat") in HOST_CATS and e.get("tid") == thread]
    idle = _split(gaps, _segments(host))
    syncs = sum(1 for e in xs if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and e.get("name") in SYNC_CALLS and inside(e))
    return {
        "batches": len(batches),
        "span_s": (hi - lo) * 1e-6,
        "busy_s": busy_us * 1e-6,
        "kernels": sum(1 for e in device if e.get("cat") == "kernel"),
        "syncs": syncs,
        "device_ops": _top(ops),
        "idle_gaps": _top(idle),
        "categories": dict(collections.Counter(e.get("cat") for e in xs)),
    }
