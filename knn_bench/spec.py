"""The benchmark's data, found by name: BENCHMARK.json at the checkout's
root names each cell's configuration and traffic; the configuration's
file is the one BENCHMARK.json gives, the traffic mix is
``mixes/<traffic>.json``, the limits of the cell's output check are
``cells/<cell>.json``, a metric's reader is ``metrics/<metric>.py`` and a
configuration's plain reference is ``references/<reference>.py``.
A later cell, mix, configuration or metric is a new file and a new entry;
nothing here changes for it.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import re

#: The checkout's root (the directory that holds BENCHMARK.json).
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _checked(name: str) -> str:
    if not isinstance(name, str) or not _NAME.match(name):
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return _load_json(os.path.join(root, "BENCHMARK.json"))


def mix(name: str, root: str = ROOT) -> dict:
    return _load_json(os.path.join(root, "knn_bench", "mixes", _checked(name) + ".json"))


def limits(cell: str, root: str = ROOT) -> dict:
    return _load_json(os.path.join(root, "knn_bench", "cells", _checked(cell) + ".json"))


def _module(kind: str, name: str, root: str):
    path = os.path.join(root, "knn_bench", kind, _checked(name) + ".py")
    spec = importlib.util.spec_from_file_location(f"knn_bench_{kind}_{name}", path)
    if spec is None or not os.path.exists(path):
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metric_reader(name: str, root: str = ROOT):
    """``metrics/<name>.py``: its ``read(run) -> float | None``."""
    return _module("metrics", name, root)


def reference(name: str, root: str = ROOT):
    """``references/<name>.py``: the plain reference's score (``keys``,
    ``pair_keys``, ``score``, ``score_key``, ``RELATIVE``)."""
    return _module("references", name, root)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    limits: dict
    #: BENCHMARK.json's metric entries that this cell reports.
    end_to_end: list
    per_layer: list


def _reports(metric: dict, cell: str, e2e_names: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in e2e_names


def cell(name: str, root: str = ROOT) -> Cell:
    spec = benchmark(root)
    entry = next((w for w in spec["workloads"] if w["name"] == _checked(name)), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in spec["configs"] if c["name"] == entry["config"])
    config = _load_json(os.path.join(root, conf["file"]))
    e2e = [m for m in spec["end_to_end"] if _reports(m, name, set())]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"] if _reports(m, name, names)]
    return Cell(name=name, chips=int(entry["chips"]), config=config,
                mix=mix(entry["traffic"], root), limits=limits(name, root)["limits"],
                end_to_end=e2e, per_layer=per_layer)
