"""v10's KD-tree traversal on its own: its times over a built tree, and the
work its queries need.

    PYTHONPATH=<checkout> python3 tpu_knn_torch/probes/kd_traverse.py time [OUT.json]
    python3 tpu_knn_torch/probes/kd_traverse.py counts [cpu|cuda]

Run by path with PYTHONPATH=<checkout>, `time` measures whichever
checkout's tpu_knn_torch is on the path, so two checkouts compare in one
chip call (parent, change, change, parent). At each shape of SHAPES
(the reference's KD row (3, 1024, 2^16), ds10 (3, 1024, 2^20), (16,
1024, 2^16), and k = 4, 5 and 8 over 2^16 points, on each side of the
lanes' choice), over uniform points made from a seed and the port's host
build:

- time: DeviceKDTree's construction (host wall, the records' build where
  the checkout has one), then DeviceKDTree.query's traversal by CUDA events
  (median) and the kernel's own device time (torch.profiler), its answer
  held to traverse_plain bit for bit (indices and d2); where the checkout
  has lane groups (traversal.KERNEL_LANES), also at each group size; each
  also for the shape's first query alone (its time a step: the latency of
  one link of the chain); the last line is one JSON object of them;
- counts: the pops and visits a query of the one-query traversal
  (traverse_records_plain at one lane, traverse_plain's order, its visits
  checked against traverse_plain's count), the warp maximum of the pops
  (32 queries a warp), the longest query, and the steps a query and their
  warp maximum at 8 and 32 lanes a query (32 / lanes queries a warp); no
  card needed.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

SHAPES = [("KD row (3, 1024, 2^16)", (3, 1024, 1 << 16)),
          ("ds10 (3, 1024, 2^20)", (3, 1024, 1 << 20)),
          ("(16, 1024, 2^16)", (16, 1024, 1 << 16)),
          *[(f"({k}, 1024, 2^16)", (k, 1024, 1 << 16)) for k in (4, 5, 8)]]


def _points(k, m, n, seed):
    import numpy as np

    rng = np.random.default_rng(seed)
    return rng.random((n, k), np.float32), rng.random((m, k), np.float32)


def _card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def time_shapes(out_path=None) -> int:
    import torch

    from tpu_knn_torch.kdtree import traversal
    from tpu_knn_torch.kdtree.build import build_kdtree
    from tpu_knn_torch.utils.timing import device_ms, time_ms

    if not torch.cuda.is_available():
        print("kd_traverse: no CUDA device", file=sys.stderr)
        return 2
    card = _card()
    print(card)
    out = {"card": card}
    for i, (label, (k, m, n)) in enumerate(SHAPES):
        r, q = _points(k, m, n, 4100 + i)
        tree = build_kdtree(r)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dev = traversal.DeviceKDTree(tree, "cuda")
        torch.cuda.synchronize()
        build_ms = (time.perf_counter() - t0) * 1e3
        qt = torch.from_numpy(q).cuda()
        want = traversal.traverse_plain(qt, dev.ref, dev.p, dev.dim, dev.split_val)
        row = {"DeviceKDTree_ms": build_ms}
        # The checkout's own launch (DeviceKDTree.query), then, where it has
        # lane groups, each group size; each also for the first query alone.
        calls = {"query": lambda qq: dev.query(qq)}
        if hasattr(traversal, "KERNEL_LANES"):
            row["lanes"] = traversal.traverse_lanes(k)
            for g in traversal.KERNEL_LANES:
                calls[f"lanes {g}"] = lambda qq, g=g: traversal._launch(qq, dev.records, g)
        for name, call in calls.items():
            got = call(qt)
            if not (torch.equal(got[0], want[0])
                    and torch.equal(got[1].view(torch.int32), want[1].view(torch.int32))):
                print(f"{label}: {name} is not traverse_plain's bit for bit", file=sys.stderr)
                return 1
            res = {}
            for tag, qq in (("", qt), (" m=1", qt[:1].contiguous())):
                ev = time_ms({"v10": lambda: call(qq)}, 20)["v10"]
                dv = sum(device_ms({"fn": lambda: call(qq)}, ("kdtree_traverse",), 20).values())
                res[f"ms{tag}"], res[f"device_ms{tag}"] = ev, dv
            row[name] = res
            print(f"{label}: {name}: {res['ms']:.4f} ms (device {res['device_ms']:.4f}); the "
                  f"first query alone {res['ms m=1']:.4f} ms (device {res['device_ms m=1']:.4f}); "
                  f"DeviceKDTree {build_ms:.1f} ms [{card}]")
        out[label] = row
        del dev, qt
        torch.cuda.empty_cache()
    print(json.dumps(out))
    if out_path:
        with open(out_path, "w") as f:
            json.dump(out, f, indent=1)
    return 0


def counts(device="cpu") -> int:
    import torch

    from tpu_knn_torch.kdtree import traversal
    from tpu_knn_torch.kdtree.build import build_kdtree

    torch.set_num_threads(min(4, torch.get_num_threads()))
    out = {}
    for i, (label, (k, m, n)) in enumerate(SHAPES):
        r, q = _points(k, m, n, 4100 + i)
        dev = traversal.DeviceKDTree(build_kdtree(r), device)
        qt = torch.from_numpy(q).to(device)
        args = (qt, dev.ref, dev.p, dev.dim, dev.split_val)
        _, _, visits, nodes = traversal.traverse_plain(*args, count_visits=True)
        rec = traversal.kd_records(dev.ref, dev.p, dev.dim, dev.split_val)
        row = {"visits_total": visits, "distinct_nodes": nodes}
        for lanes in (1, 8, 32):
            _, _, steps, pops, vis = traversal.traverse_records_plain(qt, rec, lanes, counts=True)
            if lanes == 1 and int(vis.sum()) != visits:
                print(f"{label}: {int(vis.sum())} visits, traverse_plain counts {visits}",
                      file=sys.stderr)
                return 1
            warp = steps.view(-1, 32 // lanes).max(dim=1).values.double()
            row[f"lanes {lanes}"] = {
                "steps_mean": steps.double().mean().item(), "warp_max_mean": warp.mean().item(),
                "longest": int(steps.max()), "first_query_steps": int(steps[0]),
                "pops_mean": pops.double().mean().item(),
                "visits_mean": vis.double().mean().item(),
                "longest_visits": int(vis[steps.argmax()])}
            print(f"{label}: lanes {lanes}: {row[f'lanes {lanes}']}")
        out[label] = row
    print(json.dumps(out))
    return 0


def main(argv) -> int:
    if argv[:1] == ["time"] and len(argv) <= 2:
        return time_shapes(argv[1] if len(argv) == 2 else None)
    if argv[:1] == ["counts"] and len(argv) <= 2:
        return counts(argv[1] if len(argv) == 2 else "cpu")
    print(__doc__, file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
