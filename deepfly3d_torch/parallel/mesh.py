"""Device mesh and placement helpers.

Counterpart of ``deepfly3d_tpu/parallel/mesh.py``.  As in JAX, one process
drives every device: a ``Mesh`` is an array of ``torch.device`` entries with
named axes, not a process group, and a sharded array is a list of tensors,
one per entry.

Axes:

* ``data`` -- recordings / frames / images (pure data parallelism: every
  frame is independent until triangulation);
* ``time`` -- the frame axis inside one recording (sharded triangulation).

There is no tensor or pipeline split: the hourglass is a small CNN whose
weights replicate cheaply.

``data_mesh()`` takes every visible card and raises where there is none;
the CPU is an explicit choice, ``data_mesh(devices=["cpu"] * 8)`` being the
analogue of JAX's 8 virtual CPU devices.  Entries may repeat a device (two
entries on ``cuda:0``): each is one replica and one shard.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from deepfly3d_torch.utils.devices import resolve_device


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """``devices``: an object array of ``torch.device``, one axis per name."""

    devices: np.ndarray
    axis_names: Tuple[str, ...]

    def __post_init__(self):
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"mesh of shape {self.devices.shape} with axes {self.axis_names}")

    @property
    def shape(self) -> dict:
        """{axis name: size}, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """Where an array goes on ``mesh``: ``spec[i]`` names the mesh axis that
    splits array axis i (None: not split); an empty spec replicates."""

    mesh: Mesh
    spec: Tuple[Optional[str], ...] = ()


def _devices(devices: Optional[Sequence]) -> list:
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n == 0:
            raise RuntimeError("no CUDA device is visible; pass devices=[...] (e.g. "
                               "['cpu'] * 8) for a mesh on the CPU")
        return [torch.device("cuda", i) for i in range(n)]
    out = [resolve_device(d) for d in devices]
    if not out:
        raise ValueError("a mesh needs at least one device")
    return out


def data_mesh(n_devices: Optional[int] = None, axis_name: str = "data",
              devices: Optional[Sequence] = None) -> Mesh:
    """1-D mesh over the first ``n_devices`` of ``devices`` (default: every
    visible card)."""
    devs = _devices(devices)
    if n_devices is not None:
        if not 1 <= n_devices <= len(devs):
            raise ValueError(f"{n_devices} devices asked for, {len(devs)} available")
        devs = devs[:n_devices]
    arr = np.empty(len(devs), dtype=object)
    arr[:] = devs
    return Mesh(arr, (axis_name,))


def grid_mesh(shape: Sequence[int], axis_names: Sequence[str],
              devices: Optional[Sequence] = None) -> Mesh:
    """N-D mesh, e.g. ('data', 'time') for recording x frame sharding."""
    devs = _devices(devices)
    n = int(np.prod(shape))
    if n > len(devs):
        raise ValueError(f"a {tuple(shape)} mesh needs {n} devices, {len(devs)} available")
    arr = np.empty(n, dtype=object)
    arr[:] = devs[:n]
    return Mesh(arr.reshape(tuple(shape)), tuple(axis_names))


def batch_sharding(mesh: Mesh, ndim: int, axis_name: str = "data") -> Sharding:
    """The leading axis split over ``axis_name``, the rest whole."""
    return Sharding(mesh, (axis_name,) + (None,) * (ndim - 1))


def replicated_sharding(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


def _split(x: torch.Tensor, spec: Tuple[Optional[str], ...], mesh: Mesh, index) -> torch.Tensor:
    """The block of ``x`` that the mesh entry at ``index`` holds."""
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        parts = mesh.shape[axis]
        if x.shape[dim] % parts:
            raise ValueError(f"axis {dim} of length {x.shape[dim]} does not split evenly over "
                             f"the {parts} entries of mesh axis {axis!r}")
        size = x.shape[dim] // parts
        x = x.narrow(dim, index[mesh.axis_names.index(axis)] * size, size)
    return x


def blocks(x, sharding: Sharding) -> list:
    """``x`` (a tensor or numpy array) cut by ``sharding``: [(entry index,
    device, the block that entry holds)], in ``mesh.devices.flat`` order.
    The blocks are views of ``x``, not yet on their devices."""
    x = torch.as_tensor(x)
    mesh = sharding.mesh
    if len(sharding.spec) > x.dim():
        raise ValueError(f"sharding spec {sharding.spec} for a {x.dim()}-d array")
    return [(index, dev, _split(x, sharding.spec, mesh, index))
            for index, dev in np.ndenumerate(mesh.devices)]


def shard_batch(mesh, x, axis_name: str = "data") -> list:
    """``x`` with its leading axis split over ``axis_name`` (its length must
    divide evenly); ``mesh`` may be a ``Sharding`` (``batch_sharding``)."""
    sharding = mesh if isinstance(mesh, Sharding) else \
        batch_sharding(mesh, np.ndim(x), axis_name)
    return [block.to(dev) for _, dev, block in blocks(x, sharding)]


def replicate(mesh, tree) -> list:
    """One copy of ``tree`` (nested dicts, lists and tuples of arrays) per mesh
    entry, on its device; ``mesh`` may be a ``Sharding`` (``replicated_sharding``)."""
    if isinstance(mesh, Sharding):
        if mesh.spec:
            raise ValueError(f"replicate takes a replicated sharding, not {mesh.spec}")
        mesh = mesh.mesh

    def copy(node, dev):
        if isinstance(node, dict):
            return {k: copy(v, dev) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(copy(v, dev) for v in node)
        return torch.as_tensor(node).to(dev)

    return [copy(tree, dev) for dev in mesh.devices.flat]
