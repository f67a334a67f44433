"""Device mesh and collectives for the port (from ``tdr/parallel/mesh.py``).

``tdr``'s mesh is one controller: one Python process holds a
``jax.sharding.Mesh`` of devices, and ``shard_map`` runs one program on
every shard with named-axis collectives.  The port keeps that model
without ``torch.distributed``:

* a ``Mesh`` is a 2-D array of ``torch.device`` with the axes
  ``("data", "model")``; a device may appear more than once, as XLA's
  forced host device count gives virtual devices;
* a shard is a tensor (or an index of tensors) on its mesh device;
* a collective is a function over the list of per-shard tensors: copies to
  the destination (``non_blocking`` between CUDA devices), then a stack, a
  sum or a sum-and-split.

On several cards each shard's kernels go to its own device asynchronously;
on one card they run in sequence, and a copy to the same device is no copy.

Axes: ``data`` shards the document axis (index shards) or the query batch
(data parallelism); ``model`` shards the vocab axis (vocab TP) or, in the
grid layout, the documents.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from tdr_torch.utils.config import MeshConfig
from tdr_torch.utils.device import DeviceLike, resolve_device

AXES = ("data", "model")


@dataclass(frozen=True, eq=False)
class Mesh:
    """``devices`` is an object array of ``torch.device``, shape (data,
    model)."""

    devices: np.ndarray
    axis_names: tuple = AXES

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def axis_devices(self, axis: str, index: int = 0) -> List[torch.device]:
        """The devices along ``axis`` at position ``index`` of the other
        axis (shard s of an axis-sharded array lives on entry s)."""
        ax = self.axis_names.index(axis)
        line = self.devices[:, index] if ax == 0 else self.devices[index, :]
        return list(line)

    @property
    def first(self) -> torch.device:
        """The device that collectives without a destination gather to."""
        return self.devices.flat[0]


def make_mesh(data: int = 0, model: int = 1,
              devices: Optional[Sequence[DeviceLike]] = None,
              cfg: Optional[MeshConfig] = None) -> Mesh:
    """Build a (data, model) mesh; ``data=0`` uses every remaining device.
    Without ``devices`` the mesh takes every CUDA device, and raises (the
    ``resolve_device`` rule) when there is none.  Entries may repeat."""
    if cfg is not None:
        data, model = cfg.data_parallel, cfg.model_parallel
    if devices is None:
        resolve_device(None)
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devs = [resolve_device(d) for d in devices]
    if data <= 0:
        data = len(devs) // max(model, 1)
    n = data * model
    if n > len(devs) or n <= 0:
        raise ValueError(f"mesh {data}x{model} needs {n} devices, have "
                         f"{len(devs)}")
    arr = np.empty(n, dtype=object)
    arr[:] = devs[:n]
    return Mesh(arr.reshape(data, model))


def _copy(x: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """``x`` on ``dev``: asynchronous between CUDA devices; a no-op on its
    own device.  A copy to the host waits (its bytes are read next)."""
    return x.to(dev, non_blocking=x.is_cuda and dev.type == "cuda")


def data_sharding(mesh: Mesh, x: torch.Tensor, axis: int = 0
                  ) -> List[torch.Tensor]:
    """Split dimension ``axis`` of ``x`` evenly over the "data" devices:
    one block per device, on that device."""
    devs = mesh.axis_devices("data")
    if x.shape[axis] % len(devs):
        raise ValueError(f"dimension {axis} of size {x.shape[axis]} does not "
                         f"split over {len(devs)} devices")
    return [_copy(b, d) for b, d in zip(torch.chunk(x, len(devs), dim=axis),
                                        devs)]


def replicated(mesh: Mesh, x) -> list:
    """One copy of ``x`` (a tensor, or an object with ``.to(device)``) per
    "data" device; on a repeated device the copies are ``x``."""
    if isinstance(x, torch.Tensor):
        return [_copy(x, d) for d in mesh.axis_devices("data")]
    return [x.to(d) for d in mesh.axis_devices("data")]


def all_gather(shards: Sequence[torch.Tensor], dest: DeviceLike
               ) -> torch.Tensor:
    """Stack the per-shard tensors on ``dest``: (S, ...)."""
    dev = torch.device(dest)
    return torch.stack([_copy(s, dev) for s in shards])


def psum(shards: Sequence[torch.Tensor], dest: DeviceLike) -> torch.Tensor:
    """Sum of the per-shard tensors on ``dest``, in shard order."""
    dev = torch.device(dest)
    out = _copy(shards[0], dev)
    for s in shards[1:]:
        out = out + _copy(s, dev)
    return out


def psum_scatter(shards: Sequence[torch.Tensor],
                 dests: Sequence[DeviceLike], dim: int = 0,
                 tiled: bool = True) -> List[torch.Tensor]:
    """Sum the per-shard tensors and split the sum along ``dim``: device i
    gets block i.  ``tiled=True`` keeps ``dim`` (its size must divide by
    the shard count); ``tiled=False`` needs ``dim`` of the shard count's
    size and removes it.  Each block is summed on its own device, in shard
    order, from the blocks of every shard."""
    S = len(shards)
    size = shards[0].shape[dim]
    if (size % S) if tiled else (size != S):
        raise ValueError(f"psum_scatter: dimension {dim} of size {size} over "
                         f"{S} shards (tiled={tiled})")
    out = []
    for i, dest in enumerate(dests):
        blocks = [torch.chunk(s, S, dim=dim)[i] for s in shards]
        total = psum(blocks, dest)
        out.append(total if tiled else total.squeeze(dim))
    return out
