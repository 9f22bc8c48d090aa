"""Device mesh and sharding of the freezing grid (PyTorch).

The counterpart of ``porousfreezethaw_tpu/parallel/sharding.py``.  The
reference decomposes the grid in z over MPI ranks
(``intertrack.c:1776-1789``); the JAX package shards the state
``(VAR, Z, Y, X)`` over a named device mesh, Z over axis ``z`` and
optionally Y over axis ``y``, with one program driving every device.

The port keeps that single-controller design: one process drives every
shard.  A mesh is a named array of ``torch.device``s, and a sharded state is
the list of per-shard tensors in mesh order (row-major over the mesh's
axes, so z-major then y for ``'z2,y2'``), each on its device.  A device may
appear more than once: several virtual shards on one card (or on the CPU)
run the same code as shards on several cards, the counterpart of the
virtual CPU devices of the JAX tests.  The halo exchange
(``parallel/fused.py``) is a tensor copy into the neighbour's ghost buffer,
and the global error max a max over the shards' partials.  DEM particle
sharding is not ported yet.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.device import resolve_device


class Mesh:
    """Named axes over an array of devices (``devices.shape`` follows
    ``axis_names``)."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def device_list(self) -> List[torch.device]:
        """The devices in mesh order: the order of a sharded state."""
        return list(self.devices.flat)

    def coords(self, i: int) -> Dict[str, int]:
        """The mesh coordinates of shard ``i``."""
        return dict(zip(self.axis_names,
                        (int(c) for c in np.unravel_index(
                            i, self.devices.shape))))

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {self.device_list()})"


def make_mesh(spec: str = "z", devices: Optional[Sequence] = None, *,
              device: str | torch.device = "cuda") -> Mesh:
    """Build a device mesh from a spec like ``'z'``, ``'z4'``, ``'z2,y4'``.

    An axis without an explicit size absorbs all remaining devices.
    ``devices`` defaults to every visible CUDA device (``device="cuda"``,
    which raises without one) or to the CPU (``device="cpu"``); an explicit
    list may repeat a device."""
    if devices is None:
        dev = resolve_device(device)
        devices = ([torch.device("cuda", i)
                    for i in range(torch.cuda.device_count())]
                   if dev.type == "cuda" else [dev])
    devices = [torch.device(d) for d in devices]
    # a tensor's device always has an index; so does a mesh's
    devices = [torch.device("cuda", torch.cuda.current_device())
               if d.type == "cuda" and d.index is None else d
               for d in devices]
    axes = []
    free_axis = None
    fixed = 1
    for part in spec.split(","):
        m = re.fullmatch(r"([a-z]+)(\d*)", part.strip())
        if not m:
            raise ValueError(f"bad mesh spec part {part!r}")
        name, size = m.group(1), m.group(2)
        if size:
            axes.append((name, int(size)))
            fixed *= int(size)
        else:
            if free_axis is not None:
                raise ValueError("only one mesh axis may have implicit size")
            free_axis = name
            axes.append((name, None))
    if free_axis is not None:
        if len(devices) % fixed:
            raise ValueError(
                f"{len(devices)} devices not divisible by fixed axes "
                f"({fixed})")
        axes = [(n, s if s else len(devices) // fixed) for n, s in axes]
    total = int(np.prod([s for _, s in axes]))
    if total > len(devices):
        raise ValueError(f"mesh needs {total} devices, have {len(devices)}")
    arr = np.empty(total, dtype=object)
    for i, d in enumerate(devices[:total]):
        arr[i] = d
    return Mesh(arr.reshape([s for _, s in axes]), [n for n, _ in axes])


def shard_block(mesh: Mesh, i: int, grid: Tuple[int, int, int]
                ) -> Tuple[slice, slice]:
    """The (z, y) slices of the grid ``(n3, n2, n1)`` that shard ``i``
    holds: Z over axis ``z`` and Y over axis ``y`` where the mesh has them;
    other axes replicate."""
    shape, at = mesh.shape, mesh.coords(i)
    zl = grid[0] // shape.get("z", 1)
    yl = grid[1] // shape.get("y", 1)
    iz, iy = at.get("z", 0), at.get("y", 0)
    return slice(iz * zl, (iz + 1) * zl), slice(iy * yl, (iy + 1) * yl)


def shard_freezing_state(w: torch.Tensor, mesh: Mesh) -> List[torch.Tensor]:
    """The state ``(nv, n3, n2, n1)`` as the list of its shards in mesh
    order, each a contiguous copy on its device.  The sharded dimensions
    must be divisible by the mesh axis sizes."""
    zsize = mesh.shape.get("z", 1)
    ysize = mesh.shape.get("y", 1)
    if w.shape[1] % zsize or w.shape[2] % ysize:
        raise ValueError(
            f"grid {tuple(w.shape[1:])} not divisible by mesh z={zsize}, "
            f"y={ysize}")
    out = []
    for i, dev in enumerate(mesh.device_list()):
        zs, ys = shard_block(mesh, i, tuple(w.shape[1:]))
        block = w[:, zs, ys]
        out.append(torch.empty(block.shape, dtype=w.dtype,
                               device=dev).copy_(block))
    return out


def gather_freezing_state(shards: Sequence[torch.Tensor], mesh: Mesh,
                          device: Optional[torch.device] = None
                          ) -> torch.Tensor:
    """The whole state from its shards, on ``device`` (the first shard's
    by default)."""
    nv, zl, yl, n1 = shards[0].shape
    grid = (zl * mesh.shape.get("z", 1), yl * mesh.shape.get("y", 1), n1)
    out = torch.empty((nv,) + grid, dtype=shards[0].dtype,
                      device=device or shards[0].device)
    for i, s in enumerate(shards):
        zs, ys = shard_block(mesh, i, grid)
        out[:, zs, ys] = s
    return out
