"""Version registry and dispatcher (counterpart of tpu_knn/engine/registry.py).

Every version self-registers with a uniform callback signature

    fn(k, m, n, search: (m,k) f32 tensor, ref: (n,k) f32 tensor) -> (m,) int32

and declares its preconditions via a `guard` plus a `fallback` version, as
in tpu_knn. The port registers the one-device ladder: v0 (its copy of
tpu_knn's NumPy oracle), v1 and v2 (two-phase torch ops), v3 and v6 (B1's
AoS and constant-query variants), v4 (B1), v5 (B10), v7 (B1 over
partitions), v9 (the host KD-tree), v10 (the host-built tree traversed on
the card), v11 (the projection index, B11) and v8 (the points sharded
over a mesh of every visible card, distributed/sharded.py). The preference
order is tpu_knn's: the default dispatch lands on v8, whose guard hands
one device (or small n) to v7, as tpu_knn's does, and never on v9/v10.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np

CallbackFn = Callable[[int, int, int, object, object], np.ndarray]
GuardFn = Callable[[int, int, int], bool]


@dataclasses.dataclass(frozen=True)
class Version:
    name: str
    fn: CallbackFn
    description: str = ""
    # guard(k, m, n) -> True when this version can handle the problem; when
    # False the dispatcher delegates to `fallback`.
    guard: Optional[GuardFn] = None
    fallback: Optional[str] = None

    def __call__(self, k: int, m: int, n: int, search, ref) -> np.ndarray:
        if self.guard is not None and not self.guard(k, m, n):
            if self.fallback is None:
                raise ValueError(
                    f"version {self.name} cannot handle (k={k}, m={m}, n={n}) "
                    "and has no fallback"
                )
            return get_version(self.fallback)(k, m, n, search, ref)
        return self.fn(k, m, n, search, ref)


_REGISTRY: Dict[str, Version] = {}
_BUILTINS_LOADED = False


def register_version(
    name: str,
    fn: CallbackFn,
    description: str = "",
    guard: Optional[GuardFn] = None,
    fallback: Optional[str] = None,
) -> Version:
    v = Version(name=name, fn=fn, description=description, guard=guard, fallback=fallback)
    _REGISTRY[name] = v
    return v


def _oracle_callback(k, m, n, search, ref) -> np.ndarray:
    """v0: the NumPy host oracle (tpu_knn_torch/oracle.py) on host copies."""
    from tpu_knn_torch.oracle import oracle_callback

    return oracle_callback(k, m, n, search.cpu().numpy(), ref.cpu().numpy())


def _ensure_builtins() -> None:
    """Import built-in version modules (each registers itself on import)."""
    global _BUILTINS_LOADED
    if _BUILTINS_LOADED:
        return
    _BUILTINS_LOADED = True

    register_version(
        "v0",
        _oracle_callback,
        "serial-semantics NumPy oracle (reference core.cu:25-63)",
    )

    import importlib

    for mod in (
        "tpu_knn_torch.kernels.twophase",
        "tpu_knn_torch.kernels.fused",
        "tpu_knn_torch.kernels.dma_pipeline",
        "tpu_knn_torch.kernels.twolevel",
        "tpu_knn_torch.kernels.projection",
        "tpu_knn_torch.distributed.sharded",
        "tpu_knn_torch.kdtree.versions",
    ):
        importlib.import_module(mod)


def get_version(name: str) -> Version:
    _ensure_builtins()
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown version {name!r}; available: {sorted(_REGISTRY)}"
        ) from None


def list_versions() -> List[str]:
    _ensure_builtins()
    return sorted(_REGISTRY)


#: Production preference order, best first — tpu_knn's (reference
#: core.cu:865-872) applied to whatever versions are registered.
PREFERENCE_ORDER = ("v8", "v7", "v6", "v5", "v4", "v3", "v2", "v1", "v0")


def best_available_version() -> Version:
    _ensure_builtins()
    for name in PREFERENCE_ORDER:
        if name in _REGISTRY:
            return _REGISTRY[name]
    raise RuntimeError("no versions registered")
