"""Host time of a mutable index's small-batch queries.

    PYTHONPATH=<checkout> python3 tpu_knn_torch/probes/mutable_host.py [OUT.json]

Builds a mutable f32 index as chip_smoke.py's phase 2 leaves it after
compact (k = 16, about 1.9·2^20 live points, capacity 2^22) and times its
m = 4 1-NN and m = 4 K = 8 queries two ways in turns: with `n_live` as the
index keeps it (a count) and with `n_live` recounted from the (capacity,)
live mask on every read. For each it prints, beside the card's name and
power limit (nvidia-smi), the CUDA-event median per call, the device time
of the call's kernels (utils/timing.device_ms) and the host functions that
take the most of the call's own time (cProfile over `PROFILE_CALLS`
calls). Every number is also written, with the card, to OUT.json where
given.
"""

from __future__ import annotations

import cProfile
import io
import json
import pstats
import subprocess
import sys

#: Event medians over this many calls; device times over as many.
REPS = 50
#: Calls under cProfile for the host breakdown.
PROFILE_CALLS = 200


def _card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def _host_top(fn, rows: int = 8) -> list[str]:
    """The functions with the most own time over PROFILE_CALLS calls, as
    'ms per call  function' lines."""
    import torch

    prof = cProfile.Profile()
    prof.enable()
    for _ in range(PROFILE_CALLS):
        fn()
    torch.cuda.synchronize()
    prof.disable()
    stats = pstats.Stats(prof, stream=io.StringIO())
    top = sorted(stats.stats.items(), key=lambda kv: kv[1][2], reverse=True)[:rows]
    return [f"{tt * 1e3 / PROFILE_CALLS:.4f}  {pstats.func_std_string(func)}"
            for func, (_, _, tt, _, _) in top]


def main(out_path: str | None = None) -> int:
    import numpy as np
    import torch

    from tpu_knn_torch import NNIndex
    from tpu_knn_torch.utils.timing import device_ms, time_ms

    card = _card()
    print(card, flush=True)
    gen = torch.Generator(device="cuda").manual_seed(5)
    k, n = 16, 1 << 20
    ix = NNIndex(torch.rand((n, k), generator=gen, device="cuda"), mutable=True)
    ix.add(torch.rand((ix.capacity - n + 1, k), generator=gen, device="cuda"))   # grows
    rng = np.random.default_rng(5)
    ix.remove(rng.choice(np.nonzero(ix._live)[0], 1 << 17, replace=False))
    ix.compact()
    q4 = torch.rand((4, k), generator=gen, device="cuda")
    print(f"mutable f32 index: capacity {ix.capacity}, n_live {ix.n_live}", flush=True)
    calls = {"m=4 1-NN": lambda: ix.query(q4), "m=4 K=8": lambda: ix.query(q4, neighbors=8)}

    kept = NNIndex.n_live
    recount = property(lambda self: int(self._live[: self._n_slots].sum()) if self.mutable
                       else kept.fget(self))
    result = {"card": card, "capacity": ix.capacity, "n_live": ix.n_live, "calls": {}}
    for name, fn in calls.items():
        want = fn()
        row = {}
        for variant, prop in (("count", kept), ("recount", recount)):
            NNIndex.n_live = prop
            try:
                got = fn()
                if not all(torch.equal(a, b) for a, b in zip(got, want)):
                    raise SystemExit(f"{name} {variant}: answers differ")
                row[variant] = {"host": _host_top(fn)}
            finally:
                NNIndex.n_live = kept
        # Event medians of the two variants in turns.
        fns = {}
        for variant, prop in (("count", kept), ("recount", recount)):
            def timed(prop=prop):
                NNIndex.n_live = prop
                try:
                    return fn()
                finally:
                    NNIndex.n_live = kept
            fns[variant] = timed
        events = time_ms(fns, REPS)
        dev = sum(device_ms({"call": fn}, "", REPS).values())
        for variant in fns:
            row[variant]["event_ms"] = events[variant]
        row["device_ms"] = dev
        result["calls"][name] = row
        print(f"{name}: events count {events['count']:.4f} ms, recount "
              f"{events['recount']:.4f} ms; device {dev:.4f} ms [{card}]", flush=True)
        for variant in ("count", "recount"):
            print(f"  host, own time per call ({variant}):", flush=True)
            for line in row[variant]["host"]:
                print(f"    {line}", flush=True)
    if out_path:
        with open(out_path, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:2]))
