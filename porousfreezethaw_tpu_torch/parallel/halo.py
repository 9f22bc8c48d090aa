"""The plain right-hand side over a mesh, with explicit halo copies
(PyTorch).

The counterpart of ``porousfreezethaw_tpu/parallel/halo.py`` and of the
JAX app's GSPMD branch (``porousfreezethaw_tpu/apps/intertrack.py:300-301``),
the reference's distributed design (``sync_solution``,
``equation.c:290-326``): each shard owns a block of the grid, receives one
ghost plane from each z neighbour and one ghost row from each y neighbour
(:func:`halo_exchange_z`, :func:`halo_exchange_y`: tensor copies onto the
shard's device), and the plain single-device ``make_rhs`` runs on the
block with its ghosts.  The ghost outputs are sliced away.

A block side at a true end of the domain gets no ghost: there the local
right-hand side applies the physical boundary conditions itself (mirror
at z = 0 and at the y ends, the Dirichlet temperature and mirrored p, gl
at the top), as the global one does.  The stencil is 7-point, so a kept
cell never reads a corner of the block; the corners hold zeros.  Each
block gets the global ``inv_h``, so every kept output is the
single-device output bit for bit.

Windows follow :func:`.sharding.split_rows` in z and in y, so any grid
with at least one plane and one row a shard runs, whatever the mesh; the
mesh has axes ``z`` and ``y`` only.  The noise field is windowed with the
state.

On the device-resident loop (``models/freezing/attempt.py``
``PlainAttempt`` with ``mesh=``) this right-hand side is captured as it
is: the halo copies, each shard's zero block and its slices are PyTorch
operations whose memory the captured graph's pool holds.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.grid import GridGeometry
from ..models.freezing.equation import make_rhs
from ..models.freezing.parameters import FreezingParams
from .sharding import Mesh, shard_block

Ghosts = List[Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]]


def _neighbours(mesh: Mesh, axis: str) -> List[Tuple[Optional[int],
                                                     Optional[int]]]:
    """(lower, upper) neighbour of each shard along ``axis``, None at the
    chain ends."""
    shape = mesh.devices.shape
    k = mesh.axis_names.index(axis) if axis in mesh.axis_names else None
    out = []
    for i in range(mesh.size):
        if k is None:
            out.append((None, None))
            continue
        at = list(np.unravel_index(i, shape))
        nb = []
        for step in (-1, 1):
            c = at[k] + step
            nb.append(None if not 0 <= c < shape[k] else int(
                np.ravel_multi_index(tuple(at[:k] + [c] + at[k + 1:]),
                                     shape)))
        out.append(tuple(nb))
    return out


def halo_exchange_z(shards: Sequence[torch.Tensor], mesh: Mesh) -> Ghosts:
    """(from_below, from_above) of each shard: its z neighbours' edge
    planes ``(nv, 1, Yl, n1)`` copied onto its device, None at the chain
    ends (the counterpart of the two ``ppermute`` rings of the JAX
    package)."""
    out = []
    for s, (lo, hi) in zip(shards, _neighbours(mesh, "z")):
        out.append((None if lo is None else shards[lo][:, -1:].to(s.device),
                    None if hi is None else shards[hi][:, :1].to(s.device)))
    return out


def halo_exchange_y(shards: Sequence[torch.Tensor], mesh: Mesh) -> Ghosts:
    """(from_left, from_right) of each shard: its y neighbours' edge rows
    ``(nv, Zl, 1, n1)`` on its device, None at the chain ends."""
    out = []
    for s, (lo, hi) in zip(shards, _neighbours(mesh, "y")):
        out.append((None if lo is None
                    else shards[lo][:, :, -1:].to(s.device),
                    None if hi is None else shards[hi][:, :, :1].to(s.device)))
    return out


def make_halo_rhs(geom: GridGeometry, params: FreezingParams, calc_mode: int,
                  mesh: Mesh, noise: Optional[np.ndarray] = None):
    """``rhs(t, shards) -> list of dw/dt shards`` over ``mesh``: the plain
    ``make_rhs`` on each shard's block with its ghost planes and rows
    (the counterpart of the JAX package's ``make_shard_map_rhs``, extended
    to y).  ``shards`` is a state sharded by ``shard_freezing_state``;
    ``noise`` the global noise field (numpy, ``make_noise_field``) or
    None."""
    extra = set(mesh.axis_names) - {"z", "y"}
    if extra:
        raise ValueError(f"mesh axes {sorted(extra)} are not grid axes")
    nz, ny = mesh.shape.get("z", 1), mesh.shape.get("y", 1)
    if geom.n3 < nz or geom.n2 < ny:
        raise ValueError(f"grid {geom.shape}: fewer planes or rows than "
                         f"mesh z={nz}, y={ny}")
    devices = mesh.device_list()
    zn, yn = _neighbours(mesh, "z"), _neighbours(mesh, "y")
    blocks = []        # (ghost sides (below, above, left, right), rhs)
    for i, dev in enumerate(devices):
        zs, ys = shard_block(mesh, i, geom.shape)
        g = (int(zn[i][0] is not None), int(zn[i][1] is not None),
             int(yn[i][0] is not None), int(yn[i][1] is not None))
        z0, z1 = zs.start - g[0], zs.stop + g[1]
        y0, y1 = ys.start - g[2], ys.stop + g[3]
        local = GridGeometry(geom.L1, geom.L2, geom.L3, geom.n1, y1 - y0,
                             z1 - z0)
        local_noise = None if noise is None else np.ascontiguousarray(
            noise[z0:z1, y0:y1])
        blocks.append((g, make_rhs(local, params, calc_mode, dev,
                                   noise=local_noise, inv_h=geom.inv_h)))

    def rhs(t, shards: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        if len(shards) != len(blocks):
            raise ValueError(f"{len(shards)} shards for a mesh of "
                             f"{len(blocks)}")
        from_z = halo_exchange_z(shards, mesh)
        from_y = halo_exchange_y(shards, mesh)
        out = []
        for s, (g, local_rhs), (below, above), (left, right) in zip(
                shards, blocks, from_z, from_y):
            nv, zl, yl, n1 = s.shape
            block = torch.zeros((nv, zl + g[0] + g[1], yl + g[2] + g[3], n1),
                                dtype=s.dtype, device=s.device)
            zin, yin = slice(g[0], g[0] + zl), slice(g[2], g[2] + yl)
            block[:, zin, yin] = s
            if below is not None:
                block[:, :1, yin] = below
            if above is not None:
                block[:, -1:, yin] = above
            if left is not None:
                block[:, zin, :1] = left
            if right is not None:
                block[:, zin, -1:] = right
            out.append(local_rhs(t, block)[:, zin, yin])
        return out

    return rhs
