"""Device times of the top-K kernels B5 and B6, of the selection over their
candidates, and of the top-K serving calls.

    PYTHONPATH=<checkout> python3 tpu_knn_torch/probes/topk_profile.py [OUT.json]

Measures whichever checkout is on the path: run an older tree and this one
in turns in one chip call to compare them. The kernels are reached through
the public calls, so the probe runs on trees whose kernel arguments and
candidate layouts differ: a spy on topk.sweep_candidates and
topk.smallm_topk_candidates records each launch of one call, and the
recorded launch is then timed alone. Prints, beside the card's name and
power limit (nvidia-smi):

1. B5 as topk_knn gives it at (k=16, m=8, n=2^20) K=32 and (16, 32, 2^20)
   K=8, and B6 as NNIndex.query(neighbors=16) gives it at (16, 4, 2^24):
   the launch's candidates per row, its CUDA-event median and its device
   time (torch.profiler, utils/timing.device_ms), and topk._finalize_topk
   over its candidates (events, and the device time of all its kernels);
2. the serving calls topk_knn (16, 8, 2^20) K=32, topk_knn (16, 32, 2^20)
   K=8 and NNIndex.query(neighbors=16) at (16, 4, 2^24) and at m = 1:
   CUDA-event medians, and each call's device time split into the top-K
   kernels, sorting and selection kernels and the rest.

Every number is also written, with the card, to OUT.json where given.
"""

from __future__ import annotations

import json
import subprocess
import sys

#: Event medians over this many calls; device times over as many.
REPS = 20


def _card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def _recorded(module, name, call):
    """The (args, output) of each launch of module.<name> during call()."""
    real, seen = getattr(module, name), []

    def spy(*args):
        out = real(*args)
        seen.append((args, out))
        return out

    spy.launches = real.launches
    setattr(module, name, spy)
    try:
        call()
    finally:
        setattr(module, name, real)
    return seen


def _split(fn, reps):
    """Device ms a call of fn by kind of kernel: the top-K kernels (B2, B5,
    B6), sorting and selection, the rest."""
    from tpu_knn_torch.utils.timing import device_ms

    parts = {"kernels": 0.0, "sort/select": 0.0, "other": 0.0}
    for name, ms in device_ms({"fn": fn}, "", reps).items():
        low = name.lower()
        if "sweep_" in low or "smallm_" in low:
            parts["kernels"] += ms
        elif any(s in low for s in ("sort", "topk", "radix", "select")):
            parts["sort/select"] += ms
        else:
            parts["other"] += ms
    return parts


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("topk_profile: no CUDA device", file=sys.stderr)
        return 2
    import tpu_knn_torch
    from tpu_knn_torch.kernels import topk
    from tpu_knn_torch.utils.timing import device_ms, time_ms

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    card = _card()
    print(card)
    result = {"card": card, "ms": {}, "candidates a row": {}}

    def rand(shape):
        return torch.rand(shape, generator=gen, device=dev)

    def show(name, ms):
        result["ms"][name] = ms
        print(f"{name}: {ms:.4f} ms [{card}]", flush=True)

    n20, n24 = 1 << 20, 1 << 24
    r20, r24 = rand((n20, 16)), rand((n24, 16))
    index24 = tpu_knn_torch.NNIndex(r24, strategy="fused")
    q8, q32, q4 = rand((8, 16)), rand((32, 16)), rand((4, 16))
    calls = {
        "topk_knn (16, 8, 2^20) K=32 [B5]": (lambda: topk.topk_knn(q8, r20, 32), q8, r20, 32),
        "topk_knn (16, 32, 2^20) K=8 [B5]": (lambda: topk.topk_knn(q32, r20, 8), q32, r20, 8),
        "NNIndex.query (16, 4, 2^24) K=16 [B2+B6]":
            (lambda: index24.query(q4, neighbors=16), q4, r24, 16),
        "NNIndex.query (16, 1, 2^24) K=16": (lambda: index24.query(q4[:1], neighbors=16),
                                             q4[:1], r24, 16),
    }

    for label, key, kernel, name in (
            ("B5 (16, 8, 2^20) K=32", "topk_knn (16, 8, 2^20) K=32 [B5]", "sweep_candidates",
             "sweep_"),
            ("B5 (16, 32, 2^20) K=8", "topk_knn (16, 32, 2^20) K=8 [B5]", "sweep_candidates",
             "sweep_"),
            ("B6 (16, 4, 2^24) K=16", "NNIndex.query (16, 4, 2^24) K=16 [B2+B6]",
             "smallm_topk_candidates", "smallm_")):
        call, q, r, kk = calls[key]
        (args, out), = _recorded(topk, kernel, call)
        fn = getattr(topk, kernel)
        n = args[2]
        print(f"{label}: {out[0].shape[1]} candidates a row (P = {args[3]})")
        result["candidates a row"][label] = out[0].shape[1]
        show(f"{label} kernel", time_ms({"k": lambda: fn(*args)}, REPS)["k"])
        got = device_ms({"k": lambda: fn(*args)}, name, REPS)
        show(f"{label} kernel device", sum(got.values()))

        def select(q=q, r=r, out=out, kk=kk, n=n):
            return topk._finalize_topk(q, r, *out, kk, n)

        show(f"{label} selection", time_ms({"s": select}, REPS)["s"])
        show(f"{label} selection device", sum(device_ms({"s": select}, "", REPS).values()))

    for label, (call, *_) in calls.items():
        show(label, time_ms({"c": call}, REPS)["c"])
        parts = _split(call, REPS)
        show(f"{label} device", sum(parts.values()))
        for kind, ms in parts.items():
            show(f"{label} device {kind}", ms)
    if len(argv) > 1:
        with open(argv[1], "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
