"""The port's device mesh and the arrays laid out over it.

tpu_knn's sharded tier is single-controller: one call over a
`jax.sharding.Mesh` returns the global answer. The port keeps that form in
one process. `Mesh` stands in for JAX's (which the port cannot import): an
ndarray of `torch.device`s with axis names, `.shape` a dict from axis to
size, hashable so that the builders can be cached on it. A device may
repeat: logical shards on one card, or on the CPU, as tpu_knn's tests run
their mesh on virtual CPU devices. Every shard's work runs under its own
device (`on_device`).

The axes are tpu_knn's: ("dp", "sp"), queries data-parallel over "dp" and
the points sharded over "sp", or ("dcn", "dp", "sp"), the points sharded
hierarchically over ("dcn", "sp"): shard s = dcn_i · sp + sp_i, laid out
[dcn-major, sp-minor] along n.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from tpu_knn_torch.utils.platform import check_device

#: The axis sets the sharded builders serve (any order in the array).
MESH_AXES = (frozenset({"dp", "sp"}), frozenset({"dcn", "dp", "sp"}))


def _as_device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return check_device(d)


class Mesh:
    """A named grid of devices (the counterpart of `jax.sharding.Mesh`).

    ``devices``: an array-like of devices (torch.device or strings) whose
    number of dimensions equals ``len(axis_names)``; repeats are allowed.
    """

    def __init__(self, devices, axis_names):
        arr = np.asarray(devices, dtype=object)
        flat = [_as_device(d) for d in arr.ravel()]
        self.devices = np.empty(arr.shape, dtype=object)
        self.devices.ravel()[:] = flat
        self.axis_names = tuple(str(a) for a in axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"devices of shape {arr.shape} do not fit axes {self.axis_names}")
        if len(set(self.axis_names)) != len(self.axis_names) or not flat:
            raise ValueError(f"a mesh needs distinct axis names and a device, got "
                             f"{self.axis_names}")

    @property
    def shape(self) -> dict:
        """Axis name -> size, in axis order (JAX's `Mesh.shape`)."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def home(self) -> torch.device:
        """The first device: where answers come back."""
        return self.devices.flat[0]

    @property
    def distinct_devices(self) -> list:
        """The devices of the mesh, each once, in mesh order."""
        return list(dict.fromkeys(self.devices.flat))

    def _key(self):
        return (self.axis_names, self.devices.shape, tuple(str(d) for d in self.devices.flat))

    def __eq__(self, other):
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self):
        return hash(self._key())

    def __repr__(self):
        return f"Mesh({self.shape}, devices={[str(d) for d in self.distinct_devices]})"


def axis_sizes(mesh: Mesh) -> tuple[int, int, int]:
    """(dcn, dp, sp) of a sharded tier's mesh (dcn 1 without that axis)."""
    if frozenset(mesh.axis_names) not in MESH_AXES:
        raise ValueError(f"the sharded tier takes a ('dp', 'sp') or ('dcn', 'dp', 'sp') "
                         f"mesh, got axes {mesh.axis_names}")
    shape = mesh.shape
    return shape.get("dcn", 1), shape["dp"], shape["sp"]


def device_at(mesh: Mesh, dcn: int, dp: int, sp: int) -> torch.device:
    pos = {"dcn": dcn, "dp": dp, "sp": sp}
    return mesh.devices[tuple(pos[a] for a in mesh.axis_names)]


def positions(mesh: Mesh):
    """Every mesh position as (dcn_i, dp_i, sp_i, shard id, device)."""
    dcn, dp, sp = axis_sizes(mesh)
    return [(c, d, s, c * sp + s, device_at(mesh, c, d, s))
            for c in range(dcn) for d in range(dp) for s in range(sp)]


def shard_devices(mesh: Mesh, shard: int) -> list:
    """The distinct devices that scan reference shard ``shard`` (one a dp
    row)."""
    _, dp, sp = axis_sizes(mesh)
    return list(dict.fromkeys(device_at(mesh, shard // sp, d, shard % sp) for d in range(dp)))


def on_device(device: torch.device):
    """The context a shard's work runs in: its card as the current CUDA
    device (kernel launches go to the current device), nothing on the
    CPU."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


class ShardedArray:
    """An array cut into equal blocks along ``axis`` over a mesh's reference
    axes: block s (shard s, [dcn-major, sp-minor]) is held once on each
    distinct device that scans it. ``blocks`` are fresh tensors (the array
    takes them over: in-place updates write them)."""

    def __init__(self, mesh: Mesh, blocks, axis: int):
        if len(blocks) != axis_sizes(mesh)[0] * axis_sizes(mesh)[2]:
            raise ValueError(f"{len(blocks)} blocks for a mesh of shape {mesh.shape}")
        self.mesh, self.axis = mesh, axis
        self.width = blocks[0].shape[axis]
        self._copies = []
        for s, block in enumerate(blocks):
            if block.shape != blocks[0].shape:
                raise ValueError("the blocks of a sharded array must have one shape")
            self._copies.append({dev: block.to(dev) for dev in shard_devices(mesh, s)})

    @property
    def num_shards(self) -> int:
        return len(self._copies)

    @property
    def dtype(self) -> torch.dtype:
        return self.block(0).dtype

    @property
    def shape(self) -> tuple:
        shape = list(self.block(0).shape)
        shape[self.axis] *= self.num_shards
        return tuple(shape)

    def block(self, shard: int) -> torch.Tensor:
        """Shard ``shard``'s first copy."""
        return next(iter(self._copies[shard].values()))

    def local(self, shard: int, device: torch.device) -> torch.Tensor:
        """Shard ``shard``'s copy on ``device``."""
        return self._copies[shard][device]

    def copies_of(self, shard: int) -> list:
        """Every copy of shard ``shard``, for in-place updates."""
        return list(self._copies[shard].values())

    def gather(self, device=None) -> torch.Tensor:
        """The whole array on ``device`` (the mesh's first by default)."""
        device = self.mesh.home if device is None else device
        return torch.cat([self.block(s).to(device) for s in range(self.num_shards)],
                         dim=self.axis)

    def rows(self, ids: torch.Tensor) -> torch.Tensor:
        """The rows (axis 0) at global positions ``ids`` (any shape, each in
        range), on ``ids``' device."""
        flat = ids.reshape(-1).long()
        out = torch.empty((flat.numel(), *self.block(0).shape[1:]), dtype=self.dtype,
                          device=ids.device)
        owner = flat // self.width
        for s in range(self.num_shards):
            at = torch.nonzero(owner == s).squeeze(1)
            if at.numel():
                blk = self.block(s)
                out[at] = blk[(flat[at] - s * self.width).to(blk.device)].to(ids.device)
        return out.reshape(*ids.shape, *out.shape[1:])
