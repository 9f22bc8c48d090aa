"""The fused stage kernels on a device mesh (PyTorch/CUDA).

The counterpart of ``porousfreezethaw_tpu/parallel/fused.py``: the
reference's distributed hot path, where every Merson stage exchanges one
ghost plane with each z-neighbour inside the right-hand side
(``equation.c:290-326``), over the single-process mesh of
``parallel/sharding.py``.

* The state is the list of per-shard ``(3, zl, Yl, n1)`` tensors.
* Per stage, each shard's ghost stacks receive the *raw* edge planes of w
  and of every K entering the stage's combination from its z-neighbours
  (a tensor copy, peer to peer when the devices differ).  The shard
  kernels (``fused_stage_shard`` K1s and K3, ``delta_g_shard`` K2s in
  ``ops/cuda/stencil.py``) combine them with the arithmetic they apply to
  their own planes, so sharded and single-device results agree bit for
  bit.
* The chain ends carry the physical boundaries in the ghost content:
  the own edge planes (the mirror), and at the top of the classic stage
  the Dirichlet value on w's temperature plane and 0 on the K temperature
  planes, so that the combined ghost is exactly the Dirichlet value.  The
  increment form applies its Dirichlet overwrites in the kernel, on the
  global top shard only (``is_top``).
* The overlap split (``make_sharded_fused_stage``, ``overlap=True``):
  the ghost copies run on a side stream while the interior pass (planes
  [1, zl - 1), no ghost read) runs on the compute stream; the edge pass
  waits for the copies and writes planes 0 and zl - 1 into the interior
  pass's output.  The copies start after an event recorded once the
  previous stage was queued.
* On a 2-D (z, y) mesh each input is first extended by one raw edge row
  from each y-neighbour (the only rows a 7-point stencil reads); the
  z-plane protocol then runs on the extended arrays, and the kernels
  decide the y mirror on global rows, so a chain-end ghost row (filled
  with NaN here) is never read.
* The stage-5 tail's eps partials of all shards are gathered onto the
  mesh's first device, where ``merson_solve`` takes their max: the
  reference's ``MPI_Allreduce(MAX)``.
"""

from __future__ import annotations

import contextlib
from typing import List, Optional

import numpy as np
import torch

from ..core.grid import GridGeometry
from ..models.freezing import physics
from ..models.freezing.delta import two_sum
from ..models.freezing.parameters import FreezingParams
from ..ops.cuda.stencil import (
    K_VARS, N_VARS, StencilSpec, commit, delta_g_shard, fused_stage_shard,
    ghost_planes)
from .sharding import Mesh

Shards = List[torch.Tensor]


def halo_bytes_per_attempt(geom: GridGeometry, nz: int = 1, ny: int = 1, *,
                           delta: bool = False, dtype_bytes: int = 4) -> int:
    """Halo copies of one Merson attempt per shard, both directions, in the
    plain layout (shards of n3/nz planes and n2/ny rows).

    z: each stage receives one raw edge plane of w (3 variables) and of
    every K entering its combination (2 each) from each z-neighbour; the
    stages take (0, 1, 2, 3, 3) K's in the classic attempt and
    (0, 1, 2, 2, 3) in the increment form.  On a 2-D mesh the planes carry
    the two ghost rows, and y adds one raw edge row per side of w once per
    attempt and of K1, G2, G3 and G4 once each (the increment form)."""
    stage_k = (0, 1, 2, 2, 3) if delta else (0, 1, 2, 3, 3)
    rows = geom.n2 // ny + (2 if ny > 1 else 0)
    z = sum(ghost_planes(nk) for nk in stage_k) * 2 * rows * geom.n1
    y = ((N_VARS + 4 * K_VARS) * 2 * (geom.n3 // nz) * geom.n1
         if ny > 1 else 0)
    return (z + y) * dtype_bytes


class _Topology:
    """The shards of a z (and, with ``y_axis``, y) decomposition: their
    devices, positions and windows, the halo copies and their streams."""

    def __init__(self, geom: GridGeometry, mesh: Mesh, z_axis: str = "z",
                 y_axis: Optional[str] = None):
        extra = set(mesh.axis_names) - {z_axis, y_axis}
        if extra:
            raise ValueError(f"mesh axes {sorted(extra)} are not grid axes "
                             f"of this decomposition")
        shape = mesh.shape
        self.nz = shape.get(z_axis, 1)
        self.ny = shape.get(y_axis, 1) if y_axis else 1
        if geom.n3 % self.nz:
            raise ValueError(f"n3={geom.n3} not divisible by mesh "
                             f"{z_axis}={self.nz}")
        if geom.n2 % self.ny:
            raise ValueError(f"n2={geom.n2} not divisible by mesh "
                             f"{y_axis}={self.ny}")
        self.zl, self.yl = geom.n3 // self.nz, geom.n2 // self.ny
        if self.zl < 2:
            raise ValueError(f"shards need >= 2 z planes, have {self.zl}")
        self.extended = y_axis is not None
        self.devices = mesh.device_list()
        self.pos = []
        for i in range(mesh.size):
            c = mesh.coords(i)
            self.pos.append((c.get(z_axis, 0),
                             c.get(y_axis, 0) if y_axis else 0))
        self._at = {p: i for i, p in enumerate(self.pos)}
        self._cuda = sorted({d for d in self.devices if d.type == "cuda"},
                            key=str)
        self._side = {}

    @property
    def size(self) -> int:
        return len(self.devices)

    def check(self, ys: Shards, nv: int) -> None:
        """Raise unless ``ys`` are this mesh's ``nv``-plane state shards."""
        if len(ys) != self.size:
            raise ValueError(f"expected {self.size} shards, got {len(ys)}")
        for y, dev in zip(ys, self.devices):
            want = (nv, self.zl, self.yl)
            if tuple(y.shape[:3]) != want or y.device != dev:
                raise ValueError(f"expected a shard {want} + (n1,) on {dev}, "
                                 f"got {tuple(y.shape)} on {y.device}")

    def window(self, i: int):
        """(r0, Yl, y0) of shard ``i``'s inputs (see ops/cuda/stencil.py)."""
        return (int(self.extended), self.yl, self.pos[i][1] * self.yl)

    def is_top(self, i: int) -> bool:
        return self.pos[i][0] == self.nz - 1

    def _nbr(self, i: int, dz: int, dy: int) -> Optional[int]:
        iz, iy = self.pos[i]
        return self._at.get((iz + dz, iy + dy))

    # -- the halo copies --------------------------------------------------

    def extend_y(self, arrs: Shards) -> Shards:
        """Each shard's (nv, zl, Yl, X) array with one raw edge row of each
        y-neighbour around its rows; NaN rows at the chain ends."""
        out = []
        for i, a in enumerate(arrs):
            e = torch.empty(a.shape[:2] + (a.shape[2] + 2, a.shape[3]),
                            dtype=a.dtype, device=a.device)
            e[:, :, 1:-1].copy_(a)
            for row, dy, src_row in ((0, -1, -1), (-1, 1, 0)):
                j = self._nbr(i, 0, dy)
                if j is None:
                    e[:, :, row].fill_(float("nan"))
                else:
                    e[:, :, row].copy_(arrs[j][:, :, src_row])
            out.append(e)
        return out

    def alloc_ghosts(self, arrs: List[Shards]):
        """Empty (lo, hi) ghost stacks of every shard; ``arrs[i]`` is
        shard ``i``'s inputs, w first.  Allocated on the current streams,
        which run every kernel that reads them."""
        out = []
        for a in arrs:
            shape = (ghost_planes(len(a) - 1),) + tuple(a[0].shape[2:])
            out.append(tuple(torch.empty(shape, dtype=a[0].dtype,
                                         device=a[0].device)
                             for _ in range(2)))
        return out

    def fill_ghosts(self, ghosts, arrs: List[Shards],
                    dirichlet: Optional[float] = None) -> None:
        """Copy the raw edge planes of the z-neighbours' inputs into the
        ghost stacks; the own edge planes at the chain ends, and there,
        with ``dirichlet``, the top stack's w temperature plane := that
        value and its K temperature planes := 0."""
        for i, (lo, hi) in enumerate(ghosts):
            for g, dz, own, other in ((lo, -1, 0, -1), (hi, 1, -1, 0)):
                j = self._nbr(i, dz, 0)
                src, plane = (arrs[i], own) if j is None else (arrs[j], other)
                pieces = [a[:, plane] for a in src]
                if all(p.device == g.device for p in pieces):
                    torch.cat(pieces, dim=0, out=g)
                else:
                    first = 0
                    for p in pieces:
                        g[first:first + p.shape[0]].copy_(p)
                        first += p.shape[0]
                if dz > 0 and j is None and dirichlet is not None:
                    g[0].fill_(dirichlet)
                    for q in range(len(src) - 1):
                        g[N_VARS + K_VARS * q].zero_()

    def on_side(self, fn):
        """Queue ``fn``'s work on a side stream of each CUDA device of the
        mesh, after the work queued so far on the current streams of all of
        them; returns the events that mark its end (run in place on the
        CPU, no events)."""
        if not self._cuda:
            fn()
            return []
        start = [torch.cuda.current_stream(d).record_event()
                 for d in self._cuda]
        with contextlib.ExitStack() as stack:
            for d in self._cuda:
                if d not in self._side:
                    self._side[d] = torch.cuda.Stream(device=d)
                side = self._side[d]
                for e in start:
                    side.wait_event(e)
                stack.enter_context(torch.cuda.stream(side))
            fn()
            return [torch.cuda.current_stream(d).record_event()
                    for d in self._cuda]

    def wait(self, events) -> None:
        """Make the current streams wait for ``events``."""
        for d in self._cuda:
            s = torch.cuda.current_stream(d)
            for e in events:
                s.wait_event(e)

    def gather_eps(self, parts: Shards) -> torch.Tensor:
        """The shards' eps partials as one tensor on the first device."""
        first = self.devices[0]
        return torch.cat([e.to(first) for e in parts])


def _classic_stage(topo: _Topology, spec: StencilSpec, t, h, ws: Shards,
                   ks, stage5: bool, split: bool):
    """One classic stage on every shard: K shards, or ``(y_spec shards,
    eps)`` with ``stage5``.  ``ks`` is ``[(c, K shards)]``."""
    n = topo.size
    arrs = [[ws[i]] + [K[i] for _, K in ks] for i in range(n)]
    kss = [[(c, K[i]) for c, K in ks] for i in range(n)]
    D = physics.dirichlet_top_f32(t, spec.params)
    ghosts = topo.alloc_ghosts(arrs)
    kw = [dict(window=topo.window(i), stage5=stage5) for i in range(n)]
    if split:
        done = topo.on_side(lambda: topo.fill_ghosts(ghosts, arrs, D))
        prev = [fused_stage_shard(spec, t, h, ws[i], kss[i], None,
                                  part="interior", **kw[i])
                for i in range(n)]
        topo.wait(done)
        outs = [fused_stage_shard(spec, t, h, ws[i], kss[i], ghosts[i],
                                  part="edge",
                                  prev=prev[i] if stage5 else (prev[i],),
                                  **kw[i])
                for i in range(n)]
    else:
        topo.fill_ghosts(ghosts, arrs, D)
        outs = [fused_stage_shard(spec, t, h, ws[i], kss[i], ghosts[i],
                                  **kw[i])
                for i in range(n)]
    if stage5:
        return [o[0] for o in outs], topo.gather_eps([o[1] for o in outs])
    return outs


def make_sharded_fused_stage(geom: GridGeometry, params: FreezingParams,
                             calc_mode: int, mesh: Mesh,
                             axis_name: str = "z", *, overlap: bool = True):
    """``stage(t, h, ws, ks) -> K shards`` (with ``.stage5``, ``.commit``
    and ``.k_partial``) over the mesh: ``make_fused_stage``'s protocol on
    the per-shard lists, usable as ``merson_solve``'s ``stage_fn`` with the
    list of state shards.

    ``overlap`` splits each shard's launch into the interior pass and the
    edge pass (K3) when the shards hold >= 3 planes, so the halo copies
    overlap the interior pass; ``overlap=False`` launches the whole shard
    once (K1s).  The results are the same either way."""
    topo = _Topology(geom, mesh, z_axis=axis_name)
    spec = StencilSpec.of(geom, params, calc_mode)
    split = overlap and topo.zl >= 3

    def stage(t, h, ws, ks):
        return _classic_stage(topo, spec, t, h, ws, ks, False, split)

    def stage5(t, h, ws, ks):
        if len(ks) != 3:
            raise ValueError("stage5 takes the 3-term K1/K3/K4 combination")
        return _classic_stage(topo, spec, t, h, ws, ks, True, split)

    def commit_shards(ys, y_specs, accept):
        for y, s in zip(ys, y_specs):
            commit(y, s, accept)
        return ys

    stage.stage5 = stage5
    stage.commit = commit_shards
    stage.k_partial = True
    stage.split = split
    return stage


class ShardedDeltaAttempt:
    """The increment-form (delta) Merson attempt over a z mesh: the
    counterpart of the JAX ``ShardedDeltaAttempt``.

    Stage 1 (``K1 = f(w)``) is the classic sharded stage, with the overlap
    split where the shards allow it; stages 2-5 are the shard delta kernel
    (K2s), which assembles the increment's ghost from the raw ghost planes
    of K1 and the G's itself.  Bit for bit the single-device
    ``DeltaAttempt`` (``DeltaAttemptComp`` with ``compensated``).

    Implements ``merson_solve``'s ``attempt_fn`` protocol on the list of
    ``(3, zl, n2, n1)`` float32 state shards (5 planes, [u, p, gl, u_lo,
    p_lo], with ``compensated``): ``pack`` copies the shards once per solve
    call and ``commit`` writes into the copies in place."""

    def __init__(self, geom: GridGeometry, params: FreezingParams,
                 calc_mode: int, mesh: Mesh, axis_name: str = "z", *,
                 compensated: bool = False, overlap: bool = True):
        self._init(geom, params, calc_mode,
                   _Topology(geom, mesh, z_axis=axis_name), overlap)
        self.compensated = compensated

    def _init(self, geom, params, calc_mode, topo, overlap):
        self.geom = geom
        self._prm = params
        self._topo = topo
        self._spec = StencilSpec.of(geom, params, calc_mode)
        self._split = overlap and topo.zl >= 3

    def _delta_stage(self, h, D1, dDi, ws, ks, stage5=False, emit="y"):
        topo = self._topo
        n = topo.size
        arrs = [[ws[i]] + [K[i] for _, K in ks] for i in range(n)]
        ghosts = topo.alloc_ghosts(arrs)
        topo.fill_ghosts(ghosts, arrs)
        outs = [delta_g_shard(self._spec, h, D1, dDi, ws[i],
                        [(c, K[i]) for c, K in ks], ghosts[i],
                        is_top=topo.is_top(i), window=topo.window(i),
                        stage5=stage5, emit=emit)
                for i in range(n)]
        if stage5:
            return [o[0] for o in outs], topo.gather_eps([o[1] for o in outs])
        return outs

    def _stages(self, t: float, h: float, ws: Shards, emit: str):
        """The five stages on the shards ``ws``: the stage-5 tail's output
        shards (y_spec or dy) and the eps partials."""
        prm, topo = self._prm, self._topo
        ext = topo.extend_y if topo.extended else (lambda a: a)
        D1 = physics.dirichlet_top(t, prm)

        def dD(ts):
            # exact: both values are parameter constants
            return float(np.float32(physics.dirichlet_top(ts, prm) - D1))

        we = ext(ws)
        K1 = ext(_classic_stage(topo, self._spec, t, h, we, [], False,
                                self._split))
        G2 = ext(self._delta_stage(h, D1, dD(t + h / 3), we,
                                   [(1.0 / 3.0, K1)]))
        G3 = ext(self._delta_stage(h, D1, dD(t + h / 3), we,
                                   [(1.0 / 3.0, K1), (1.0 / 6.0, G2)]))
        G4 = ext(self._delta_stage(h, D1, dD(t + h / 2), we,
                                   [(0.5, K1), (0.375, G3)]))
        return self._delta_stage(h, D1, dD(t + h), we,
                                 [(1.0, K1), (-1.5, G3), (2.0, G4)],
                                 stage5=True, emit=emit)

    # --- merson_solve attempt_fn protocol (as DeltaAttempt) ---

    def pack(self, ys: Shards) -> Shards:
        nv = ys[0].shape[0] if ys else 0
        full = N_VARS + K_VARS if self.compensated else N_VARS
        self._topo.check(ys, nv)
        if nv not in (N_VARS, full) or ys[0].dtype != torch.float32:
            raise ValueError(f"{type(self).__name__} expects float32 state "
                             f"shards of {N_VARS} planes, got {nv} planes "
                             f"of {ys[0].dtype}")
        out = [y.clone(memory_format=torch.contiguous_format) for y in ys]
        if nv != full:
            out = [torch.cat([y, torch.zeros_like(y[:K_VARS])]) for y in out]
        return out

    def attempt(self, t: float, h: float, ys: Shards):
        ws = [y[:N_VARS] for y in ys]
        out, eps = self._stages(t, h, ws, "dy" if self.compensated else "y")
        return (ys, out), eps

    def commit(self, carry_spec, accept: bool) -> Shards:
        ys, outs = carry_spec
        for y, o in zip(ys, outs):
            if not self.compensated:
                commit(y, o, accept)
            elif accept:
                hi, lo = y[:K_VARS], y[N_VARS:]
                s, err = two_sum(hi, lo, o)
                hi.copy_(s)
                lo.copy_(err)
        return ys

    def unpack(self, ys: Shards) -> Shards:
        return ys


def make_sharded_delta_attempt(geom: GridGeometry, params: FreezingParams,
                               calc_mode: int, mesh: Mesh,
                               axis_name: str = "z", *,
                               compensated: bool = False,
                               overlap: bool = True) -> ShardedDeltaAttempt:
    return ShardedDeltaAttempt(geom, params, calc_mode, mesh, axis_name,
                               compensated=compensated, overlap=overlap)


class ShardedDeltaAttempt2D(ShardedDeltaAttempt):
    """The increment-form attempt over a 2-D (z, y) mesh: the counterpart
    of the JAX ``ShardedDeltaAttempt2D``.

    Every input of a stage is extended by one raw edge row of each
    y-neighbour (the JAX package's ``_extend_y``, with one row in place of
    its 8 lane rows of 128), then the z-plane protocol of
    ``ShardedDeltaAttempt`` runs on the extended arrays; stage 1 launches
    each shard whole (K1s), as the JAX class does.  The kernels decide the
    x/y mirror on global rows and write the own rows only, so the result is
    bit for bit the single-device ``DeltaAttempt``.  The mesh has a ``y``
    axis and optionally a ``z`` axis; the state is the list of ``(3, zl,
    Yl, n1)`` shards.  As in the JAX package there is no compensated
    variant."""

    def __init__(self, geom: GridGeometry, params: FreezingParams,
                 calc_mode: int, mesh: Mesh):
        if "y" not in mesh.axis_names:
            raise ValueError(f"ShardedDeltaAttempt2D needs a y mesh axis, "
                             f"got {mesh.axis_names}")
        self._init(geom, params, calc_mode,
                   _Topology(geom, mesh, z_axis="z", y_axis="y"), False)
        self.compensated = False
