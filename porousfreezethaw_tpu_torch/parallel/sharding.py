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
(``parallel/fused.py``, ``parallel/halo.py``) is a tensor copy into the
neighbour's ghost buffer, and the global error max a max over the shards'
partials.

The DEM state ``{'pos', 'vel'[, 'angvel']}`` of ``(n, 3)`` leaves shards
its particles over a mesh axis (``'p'`` by default) in equal row blocks:
the list of the shards' dicts in mesh order (:func:`shard_dem_state`),
the counterpart of the JAX package's ``dem_sharding``.
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
    which raises without one) or to the CPU (``device="cpu"``), which is
    one device: a spec of sized axes there repeats it, one virtual shard a
    slot.  An explicit list may repeat a device."""
    if devices is None:
        dev = resolve_device(device)
        if dev.type == "cuda":
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
        else:
            sizes = [int(m) for m in re.findall(r"[a-z]+(\d+)", spec)]
            devices = [dev] * max(1, int(np.prod(sizes)))
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


def split_rows(n: int, parts: int, j: int) -> slice:
    """Part ``j`` of ``n`` rows split into ``parts`` windows the way
    ``np.array_split`` splits them: the first ``n % parts`` windows take
    one row more."""
    q, r = divmod(n, parts)
    start = j * q + min(j, r)
    return slice(start, start + q + (j < r))


def shard_block(mesh: Mesh, i: int, grid: Tuple[int, int, int]
                ) -> Tuple[slice, slice]:
    """The (z, y) slices of the grid ``(n3, n2, n1)`` that shard ``i``
    holds: Z over axis ``z`` and Y over axis ``y`` in the windows of
    :func:`split_rows` (equal parts where the axis divides the grid),
    where the mesh has them; other axes replicate."""
    shape, at = mesh.shape, mesh.coords(i)
    return (split_rows(grid[0], shape.get("z", 1), at.get("z", 0)),
            split_rows(grid[1], shape.get("y", 1), at.get("y", 0)))


def shard_freezing_state(w: torch.Tensor, mesh: Mesh) -> List[torch.Tensor]:
    """The state ``(nv, n3, n2, n1)`` as the list of its shards in mesh
    order, each a contiguous copy on its device, in the windows of
    :func:`shard_block`; every window holds at least one plane and one
    row.  (The kernel paths also need n3 divisible by the z axis and
    check it themselves.)"""
    zsize = mesh.shape.get("z", 1)
    ysize = mesh.shape.get("y", 1)
    if w.shape[1] < zsize:
        raise ValueError(f"grid {tuple(w.shape[1:])}: fewer planes than "
                         f"mesh z={zsize}")
    if w.shape[2] < ysize:
        raise ValueError(f"grid {tuple(w.shape[1:])}: fewer rows than mesh "
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
    nv, _, _, n1 = shards[0].shape

    def extent(axis, dim):
        # the windows along one mesh axis: the shards at coordinate 0 on
        # every other axis
        return sum(s.shape[dim] for i, s in enumerate(shards)
                   if all(c == 0 for a, c in mesh.coords(i).items()
                          if a != axis))

    grid = (extent("z", 1), extent("y", 2), n1)
    out = torch.empty((nv,) + grid, dtype=shards[0].dtype,
                      device=device or shards[0].device)
    for i, s in enumerate(shards):
        zs, ys = shard_block(mesh, i, grid)
        out[:, zs, ys] = s
    return out


def dem_sharding(mesh: Mesh, n: int, axis: str = "p") -> List[slice]:
    """The particle rows of each shard of a DEM state of ``n`` particles,
    in mesh order: equal blocks over ``axis``, the mesh's only axis
    (``n`` divisible by its size, as in the JAX package)."""
    if mesh.axis_names != (axis,):
        raise ValueError(f"a DEM mesh has the one axis {axis!r}, got "
                         f"{mesh.axis_names}")
    size = mesh.size
    if n % size:
        raise ValueError(f"n={n} not divisible by mesh {axis}={size}")
    nl = n // size
    return [slice(i * nl, (i + 1) * nl) for i in range(size)]


def shard_dem_state(y: Dict[str, torch.Tensor], mesh: Mesh,
                    axis: str = "p") -> List[Dict[str, torch.Tensor]]:
    """A DEM state ``{'pos','vel'[,'angvel']}: (n, 3)`` as the list of its
    shards' dicts in mesh order, the particles split over ``axis``; each
    leaf a contiguous copy on its shard's device."""
    n = y["pos"].shape[0]
    return [{k: torch.empty((sl.stop - sl.start,) + tuple(v.shape[1:]),
                            dtype=v.dtype, device=dev).copy_(v[sl])
             for k, v in y.items()}
            for sl, dev in zip(dem_sharding(mesh, n, axis),
                               mesh.device_list())]


def gather_dem_state(shards: Sequence[Dict[str, torch.Tensor]],
                     device: Optional[torch.device] = None
                     ) -> Dict[str, torch.Tensor]:
    """The whole DEM state from its shards' dicts, on ``device`` (the
    first shard's by default)."""
    dev = device or shards[0]["pos"].device
    return {k: torch.cat([s[k].to(dev) for s in shards])
            for k in shards[0]}
